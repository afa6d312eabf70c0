"""Ground-state training iteration (port of the GS half of ``fermiflow_tpu/train.py``).

One chunk of K iterations = one multi-segment sampler launch (the K
iterations' base chains are parameter-independent) followed, per iteration,
by the kernel-chain update (``GSVMC.loss_metrics_grads_cm``) and one
``torch.optim.Adam`` step.  Walkers stay coordinate-major (d, B) from the
sampler through the update.
"""

from __future__ import annotations

import dataclasses

import torch

from fermiflow_tpu_torch.config import Config
from fermiflow_tpu_torch.nn.backflow import Backflow
from fermiflow_tpu_torch.ops.metropolis import metropolis_chains
from fermiflow_tpu_torch.vmc.gs import GSVMC

__all__ = ["TrainState", "init_gs_state", "make_adam",
           "make_gs_fused_multi_step"]


@dataclasses.dataclass
class TrainState:
    flow: Backflow  # owns the parameters
    optimizer: torch.optim.Optimizer
    generator: torch.Generator  # host stream: sampler seeds, fresh walkers
    step: int
    walkers_cm: torch.Tensor  # (n*dim, batch) persistent chain positions
    tau: torch.Tensor  # (batch,) per-walker proposal scales

    @property
    def params(self) -> dict:
        return self.flow.params()

    @property
    def walkers(self) -> torch.Tensor:
        """Chain positions in the JAX layout (batch, n, dim)."""
        d, B = self.walkers_cm.shape
        return self.walkers_cm.T.reshape(B, d // 2, 2)


def make_adam(flow: Backflow, lr: float) -> torch.optim.Adam:
    """Adam with ``optax.adam``'s defaults (b1=0.9, b2=0.999, eps=1e-8)."""
    return torch.optim.Adam(flow.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def init_gs_state(model: GSVMC, params: dict, cfg: Config,
                  device: torch.device) -> TrainState:
    """Fresh state: Gaussian walkers and tau = cfg.tau, from ``cfg.seed``."""
    dtype = cfg.torch_dtype()
    gen = torch.Generator().manual_seed(cfg.seed)
    d = model.n * model.basedist.dim
    walkers = torch.randn((d, cfg.batch), generator=gen, dtype=dtype)
    flow = Backflow({k: None if v is None else
                     {kk: t.to(device=device, dtype=dtype) for kk, t in v.items()}
                     for k, v in params.items()})
    return TrainState(
        flow=flow,
        optimizer=make_adam(flow, cfg.lr),
        generator=gen,
        step=0,
        walkers_cm=walkers.to(device),
        tau=torch.full((cfg.batch,), cfg.tau, dtype=dtype, device=device),
    )


def _make_gs_update(model: GSVMC):
    """(state, z_cm) -> (loss, metrics): Eloc, REINFORCE gradient and one
    Adam step; the gradient comes from the kernel chain, not autograd."""

    def update(state: TrainState, z_cm: torch.Tensor):
        loss, metrics, grads = model.loss_metrics_grads_cm(state.params, z_cm)
        for name, mod in (("eta", state.flow.eta), ("mu", state.flow.mu)):
            if mod is None:
                continue
            for k, p in mod.items():
                p.grad = grads[name][k].to(p.dtype)
        state.optimizer.step()
        return loss, metrics

    return update


def make_gs_fused_multi_step(model: GSVMC, cfg: Config, steps_per_call: int):
    """K training iterations per call with ONE multi-segment sampler launch.

    Persistent walkers continue their chains for ``cfg.mcmc_steps`` per
    segment with per-walker tau adaptation; otherwise every segment starts
    from fresh Gaussians and runs ``cfg.equilibrium_steps`` at fixed tau.
    Returns ``multi(state) -> (state, metrics)`` with each metric stacked to
    shape (K,) on the state's device.
    """
    nx_up, ny_up, nx_dn, ny_dn, kshells = model.occ_qnums()
    update = _make_gs_update(model)
    K = steps_per_call

    def multi(state: TrainState):
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=state.generator))
        dev, dtype = state.walkers_cm.device, state.walkers_cm.dtype
        if cfg.persistent_walkers:
            z0, n_steps, tau, reinit = (state.walkers_cm, cfg.mcmc_steps,
                                        state.tau, False)
        else:
            z0 = torch.randn(state.walkers_cm.shape, generator=state.generator,
                             dtype=dtype).to(dev)
            n_steps, reinit = cfg.equilibrium_steps, True
            tau = torch.full_like(state.tau, cfg.tau)
        zs, _, rates, tau_out = metropolis_chains(
            z0, tau, seed, steps=n_steps, segments=K, nx_occ=nx_up,
            ny_occ=ny_up, nx_dn=nx_dn, ny_dn=ny_dn, num_shells=kshells,
            target=cfg.tau_target_accept, gain=cfg.tau_gain, reinit=reinit)
        rows = []
        for k in range(K):
            loss, metrics = update(state, zs[k])
            rows.append(dict(metrics, accept_rate=rates[k].mean(), loss=loss))
            state.step += 1
        state.walkers_cm = zs[-1]
        if cfg.persistent_walkers:
            state.tau = tau_out
        return state, {k: torch.stack([r[k] for r in rows]) for k in rows[0]}

    return multi
