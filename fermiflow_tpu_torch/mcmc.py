"""Metropolis random-walk sampler (port of ``fermiflow_tpu/mcmc.py``).

Explicit ``torch.Generator``s replace JAX keys; the two never give the same
numbers, so tests compare samplers by distribution or on injected noise.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = ["MCMCState", "metropolis", "adapt_tau"]


class MCMCState(NamedTuple):
    x: torch.Tensor  # (batch, n, dim) walker positions
    logp: torch.Tensor  # (batch,)
    tau: torch.Tensor  # scalar or (batch,) proposal step size(s)
    accept_rate: torch.Tensor  # (batch,)


def metropolis(log_prob_fn: Callable[[torch.Tensor], torch.Tensor],
               generator: torch.Generator, x0: torch.Tensor, steps: int,
               tau) -> MCMCState:
    """Run ``steps`` Metropolis steps from x0 (batch, n, dim) with proposals
    x + tau N(0, 1) and acceptance u < exp(logp_new - logp)."""
    tau = torch.as_tensor(tau, dtype=x0.dtype, device=x0.device)
    tau_b = tau[..., None, None] if tau.ndim == 1 else tau
    x = x0
    logp = log_prob_fn(x0)
    n_acc = torch.zeros_like(logp)
    for _ in range(steps):
        noise = torch.randn(x.shape, dtype=x.dtype, device=x.device,
                            generator=generator)
        x_new = x + tau_b * noise
        logp_new = log_prob_fn(x_new)
        u = torch.rand(logp.shape, dtype=logp.dtype, device=logp.device,
                       generator=generator)
        accept = u < torch.exp(logp_new - logp)
        x = torch.where(accept[..., None, None], x_new, x)
        logp = torch.where(accept, logp_new, logp)
        n_acc = n_acc + accept.to(logp.dtype)
    return MCMCState(x=x, logp=logp, tau=tau, accept_rate=n_acc / max(steps, 1))


def adapt_tau(state: MCMCState, target: float = 0.5, gain: float = 0.1):
    """tau <- tau * exp(gain * (accept_rate - target)), per walker or global."""
    rate = state.accept_rate
    if state.tau.ndim == 0:
        rate = torch.mean(rate)
    return state.tau * torch.exp(gain * (rate - target))
