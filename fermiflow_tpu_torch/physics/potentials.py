"""Trap and interaction potentials (port of ``fermiflow_tpu/physics/potentials.py``)."""

from __future__ import annotations

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

    def V(self, x: torch.Tensor) -> torch.Tensor:
        dij, mask = pairwise_distances(x)
        return 0.5 * self.Z * torch.sum(mask / dij, dim=(-2, -1))

    def V_rows(self, xd: torch.Tensor, n: int, dim: int) -> torch.Tensor:
        """Coordinate-major variant: unrolled i<j pair sum over rows of xd."""
        V = torch.zeros(xd.shape[-1], dtype=xd.dtype, device=xd.device)
        for i in range(n):
            for j in range(i + 1, n):
                r2 = sum(
                    (xd[i * dim + a] - xd[j * dim + a]) ** 2 for a in range(dim)
                )
                V = V + self.Z / torch.sqrt(r2)
        return V

    __call__ = V
