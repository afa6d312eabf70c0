"""Free-fermion base distribution (port of ``fermiflow_tpu/physics/base_dist.py``).

``log_prob`` and ``log_prob_vgh`` (and their mixed-state counterparts, each
walker in its own Slater state) are the plain math behind the Metropolis and
Slater-VGH kernels (``ops/metropolis.py``, ``ops/slater_vgh.py``).
"""

from __future__ import annotations

import torch

from fermiflow_tpu_torch import mcmc
from fermiflow_tpu_torch.physics.orbitals import HO2D
from fermiflow_tpu_torch.physics.slater import (
    log_abs_slater_det,
    log_abs_slater_det_multstates,
    logdet_vgh,
    slater_derivs,
    slater_derivs_multstates,
)

__all__ = ["FreeFermion"]


class FreeFermion:
    """Product of spin-up and spin-down Slater determinants in a 2D trap;
    ``x[..., :nup, :]`` are the spin-up coordinates."""

    def __init__(self, orbitals: HO2D, dim: int = 2):
        self.orbitals = orbitals
        self.dim = dim

    def log_prob(self, occ_up, occ_down, x: torch.Tensor) -> torch.Tensor:
        """log p(x) = 2 log|Psi(x)| for a static (occ_up, occ_down) state."""
        nup, ndown = len(occ_up), len(occ_down)
        logabspsi = torch.zeros(x.shape[:-2], dtype=x.dtype, device=x.device)
        if nup:
            logabspsi = logabspsi + log_abs_slater_det(
                self.orbitals, occ_up, x[..., :nup, :])
        if ndown:
            logabspsi = logabspsi + log_abs_slater_det(
                self.orbitals, occ_down, x[..., nup:, :])
        return 2.0 * logabspsi

    def log_prob_vgh(self, occ_up, occ_down, x: torch.Tensor):
        """(log p, grad, Hessian) in closed form; H is block-diagonal across
        spin sectors.  Returns (...,), (..., n*dim), (..., n*dim, n*dim)."""
        nup, ndown = len(occ_up), len(occ_down)
        parts = []
        if nup:
            parts.append(logdet_vgh(
                *slater_derivs(self.orbitals, occ_up, x[..., :nup, :])))
        if ndown:
            parts.append(logdet_vgh(
                *slater_derivs(self.orbitals, occ_down, x[..., nup:, :])))
        y = 2.0 * sum(p[0] for p in parts)
        g = 2.0 * torch.cat([p[1] for p in parts], dim=-1)
        H = 2.0 * _block_diag(*[p[2] for p in parts])
        return y, g, H

    def sample(self, occ_up, occ_down, generator: torch.Generator,
               sample_shape: tuple, equilibrium_steps: int = 100,
               tau: float = 0.1, dtype=torch.float64,
               use_pallas: bool = False, return_accept: bool = False):
        """Metropolis-sample the Slater density from a fresh Gaussian init;
        draws from ``generator`` on its device.

        ``use_pallas=True`` routes the polarized float32 case through the
        single-chain sampler kernel (``ops/metropolis.py``
        ``metropolis_free_fermion``, kernel #5): on a CUDA generator the
        kernel or an exception, on the CPU its plain version.  Its stream is
        Philox keyed by a seed drawn from ``generator``.  With
        ``return_accept`` also each walker's acceptance rate."""
        n = len(occ_up) + len(occ_down)
        x0 = torch.randn((*sample_shape, n, self.dim), dtype=dtype,
                         device=generator.device, generator=generator)
        if use_pallas and len(occ_down) == 0 and dtype == torch.float32:
            from fermiflow_tpu_torch.ops.metropolis import (
                metropolis_free_fermion,
            )

            seed = int(torch.randint(0, 2**31 - 1, (), generator=generator,
                                     device=generator.device))
            nx = tuple(int(v) for v in self.orbitals.nx[list(occ_up)])
            ny = tuple(int(v) for v in self.orbitals.ny[list(occ_up)])
            flat = x0.reshape(-1, n, self.dim)
            x, _, acc = metropolis_free_fermion(
                flat, seed, tau, equilibrium_steps, nx, ny,
                max(nx + ny) + 1)
            x, acc = x.reshape(x0.shape), acc.reshape(x0.shape[:-2])
        else:
            state = mcmc.metropolis(
                lambda x: self.log_prob(occ_up, occ_down, x),
                generator, x0, equilibrium_steps, tau)
            x, acc = state.x, state.accept_rate
        return (x, acc) if return_accept else x

    # ---- mixed-state (finite-temperature) path, spin-polarized ----

    def log_prob_multstates(self, occ_table, state_idx: torch.Tensor,
                            x: torch.Tensor) -> torch.Tensor:
        """log p per walker, each in its own Slater state: occ_table
        (Nstates, n), state_idx (batch,), x (batch, n, dim) -> (batch,)."""
        return 2.0 * log_abs_slater_det_multstates(
            self.orbitals, occ_table, state_idx, x)

    def log_prob_vgh_multstates(self, occ_table, state_idx: torch.Tensor,
                                x: torch.Tensor):
        """Mixed-state (log p, grad, Hessian) per walker, closed form."""
        y, g, H = logdet_vgh(*slater_derivs_multstates(
            self.orbitals, occ_table, state_idx, x))
        return 2.0 * y, 2.0 * g, 2.0 * H

    def sample_multstates(self, occ_table, state_idx: torch.Tensor,
                          generator: torch.Generator,
                          equilibrium_steps: int = 100, tau: float = 0.1,
                          dtype=torch.float64) -> torch.Tensor:
        """Metropolis-sample the per-walker mixed-state Slater densities from
        a fresh Gaussian init; draws from ``generator`` on its device."""
        n = len(occ_table[0])
        x0 = torch.randn((state_idx.shape[0], n, self.dim), dtype=dtype,
                         device=state_idx.device, generator=generator)
        state = mcmc.metropolis(
            lambda x: self.log_prob_multstates(occ_table, state_idx, x),
            generator, x0, equilibrium_steps, tau)
        return state.x


def _block_diag(*blocks: torch.Tensor) -> torch.Tensor:
    """Batched block-diagonal assembly of (..., m_k, m_k) blocks."""
    if len(blocks) == 1:
        return blocks[0]
    sizes = [b.shape[-1] for b in blocks]
    total = sum(sizes)
    out = blocks[0].new_zeros(blocks[0].shape[:-2] + (total, total))
    lo = 0
    for b, m in zip(blocks, sizes):
        out[..., lo:lo + m, lo:lo + m] = b
        lo += m
    return out
