"""Trap and interaction potentials (port of ``fermiflow_tpu/physics/potentials.py``)."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["pairwise_distances", "HOPotential", "CoulombPairPotential"]


def pairwise_distances(x: torch.Tensor):
    """(..., n, dim) -> distances (..., n, n) with a dummy 1 on the diagonal,
    and the off-diagonal mask."""
    n = x.shape[-2]
    rij = x[..., :, None, :] - x[..., None, :, :]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    dij = torch.linalg.norm(rij + eye[..., :, :, None], dim=-1)
    return dij, 1.0 - eye


class HOPotential:
    """Harmonic trap V = 1/2 sum_i r_i^2."""

    def V(self, x: torch.Tensor) -> torch.Tensor:
        return 0.5 * torch.sum(x**2, dim=(-2, -1))

    def V_rows(self, xd: torch.Tensor, n: int, dim: int) -> torch.Tensor:
        """Coordinate-major variant: xd (n*dim, B) -> (B,)."""
        return 0.5 * torch.sum(xd * xd, dim=0)

    __call__ = V


class CoulombPairPotential:
    """V = sum_{i<j} Z / |r_i - r_j|."""

    def __init__(self, Z: float):
        self.Z = Z
        self._pairs = {}  # (n, device) -> (2, n(n-1)/2) i<j indices

    def V(self, x: torch.Tensor) -> torch.Tensor:
        dij, mask = pairwise_distances(x)
        return 0.5 * self.Z * torch.sum(mask / dij, dim=(-2, -1))

    def V_rows(self, xd: torch.Tensor, n: int, dim: int) -> torch.Tensor:
        """Coordinate-major variant: xd (n*dim, B) -> (B,), the i<j pair sum
        as one expression (six launches: the pairs' gather, their
        difference, its norm over dim, the reciprocal, the sum over pairs,
        the factor Z), where the JAX function unrolls the pairs and XLA
        fuses them.  The pair indices are built once per (n, device)."""
        key = (n, xd.device)
        pairs = self._pairs.get(key)
        if pairs is None:
            pairs = self._pairs[key] = torch.as_tensor(
                np.stack(np.triu_indices(n, 1)), device=xd.device)
        ends = xd.view(n, dim, xd.shape[-1])[pairs]  # (2, pairs, dim, B)
        r = torch.linalg.vector_norm(ends[0] - ends[1], dim=1)
        return torch.sum(torch.reciprocal(r), dim=0) * self.Z

    __call__ = V
