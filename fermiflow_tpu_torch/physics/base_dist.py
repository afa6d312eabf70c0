"""Free-fermion base distribution (port of ``fermiflow_tpu/physics/base_dist.py``).

``log_prob`` and ``log_prob_vgh`` are the plain versions behind the
Metropolis and Slater-VGH kernels (``ops/metropolis.py``, ``ops/slater_vgh.py``).
"""

from __future__ import annotations

import torch

from fermiflow_tpu_torch.physics.orbitals import HO2D
from fermiflow_tpu_torch.physics.slater import (
    log_abs_slater_det,
    logdet_vgh,
    slater_derivs,
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
