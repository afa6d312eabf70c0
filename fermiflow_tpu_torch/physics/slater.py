"""Slater-determinant primitives, ground-state subset
(port of ``fermiflow_tpu/physics/slater.py``)."""

from __future__ import annotations

import numpy as np
import torch

from fermiflow_tpu_torch.ops.logdet import gauss_jordan_inv, logabsdet
from fermiflow_tpu_torch.physics.orbitals import HO2D, hermite_functions

__all__ = [
    "slater_matrix",
    "log_abs_slater_det",
    "slater_derivs",
    "logdet_vgh",
]


def _ho1d_val_d1_d2(u: torch.Tensor, num: int):
    """1D HO eigenfunctions psi_0..psi_{num-1} and their first and second
    derivatives from the ladder identity psi_n' = sqrt(n/2) psi_{n-1}
    - sqrt((n+1)/2) psi_{n+1} and psi_n'' = (u^2 - 2n - 1) psi_n.

    Returns (psi, dpsi, d2psi), each ``u.shape + (num,)``.
    """
    h = hermite_functions(u, num + 1)
    gauss = torch.exp(-0.5 * u**2) * float(np.pi**-0.25)
    psi_ext = gauss[..., None] * h
    psi = psi_ext[..., :num]
    m = np.arange(num)
    lo = torch.as_tensor(np.sqrt(m / 2.0), dtype=u.dtype, device=u.device)
    hi = torch.as_tensor(np.sqrt((m + 1) / 2.0), dtype=u.dtype, device=u.device)
    psi_m1 = torch.cat([torch.zeros_like(psi[..., :1]), psi[..., :-1]], dim=-1)
    dpsi = lo * psi_m1 - hi * psi_ext[..., 1:]
    two_m1 = torch.as_tensor(2 * m + 1, dtype=u.dtype, device=u.device)
    d2psi = (u[..., None] ** 2 - two_m1) * psi
    return psi, dpsi, d2psi


def _derivs_from_1d(ax, adx, ad2x, ay, ady, ad2y):
    """Assemble (D, D1, D2) from per-axis selected orbital factors."""
    D = ax * ay
    D1 = torch.stack([adx * ay, ax * ady], dim=-1)  # (..., n, k, 2)
    Dxy = adx * ady
    D2 = torch.stack(
        [
            torch.stack([ad2x * ay, Dxy], dim=-1),
            torch.stack([Dxy, ax * ad2y], dim=-1),
        ],
        dim=-2,
    )  # (..., n, k, 2, 2)
    return D, D1, D2


def slater_derivs(orbitals: HO2D, occ, x: torch.Tensor):
    """Slater matrix D (..., n, n) and its per-row coordinate derivatives
    D1 (..., n, n, 2), D2 (..., n, n, 2, 2), closed form."""
    occ = np.asarray(occ, dtype=np.int64)
    nx = torch.as_tensor(orbitals.nx[occ], dtype=torch.long, device=x.device)
    ny = torch.as_tensor(orbitals.ny[occ], dtype=torch.long, device=x.device)
    K = orbitals.num_shells
    vx, dvx, d2vx = _ho1d_val_d1_d2(x[..., 0], K)
    vy, dvy, d2vy = _ho1d_val_d1_d2(x[..., 1], K)
    return _derivs_from_1d(
        vx[..., nx], dvx[..., nx], d2vx[..., nx],
        vy[..., ny], dvy[..., ny], d2vy[..., ny],
    )


def logdet_vgh(D: torch.Tensor, D1: torch.Tensor, D2: torch.Tensor):
    """(value, gradient, Hessian) of log|det D(x)| by determinant calculus.

    With A = D^{-1}, B[i,a,k] = sum_j D1[i,j,a] A[j,k] and
    C[i,a,b] = sum_j A[j,i] D2[i,j,a,b]:
        d log|det| / dx_{i,a} = B[i,a,i]
        d^2 log|det| / dx_{i,a} dx_{k,b} = delta_ik C[i,a,b] - B[k,b,i] B[i,a,k]

    Returns y (...,), g (..., n*dim), H (..., n*dim, n*dim).
    """
    n = D.shape[-1]
    dim = D1.shape[-1]
    A = gauss_jordan_inv(D)
    y = logabsdet(D)
    B = torch.einsum("...ija,...jk->...iak", D1, A)
    g = torch.einsum("...iai->...ia", B)
    C = torch.einsum("...ji,...ijab->...iab", A, D2)
    cross = torch.einsum("...kbi,...iak->...iakb", B, B)
    eye = torch.eye(n, dtype=D.dtype, device=D.device)
    H = torch.einsum("...iab,ik->...iakb", C, eye) - cross
    batch = D.shape[:-2]
    return y, g.reshape(batch + (n * dim,)), H.reshape(batch + (n * dim, n * dim))


def slater_matrix(orbitals: HO2D, occ, x: torch.Tensor) -> torch.Tensor:
    """D[..., i, j] = phi_{occ[j]}(r_i) for a static orbital set."""
    occ = np.asarray(occ, dtype=np.int32)
    if len(occ) != x.shape[-2]:
        raise ValueError(
            f"need {x.shape[-2]} orbitals for {x.shape[-2]} particles, got {len(occ)}"
        )
    return orbitals.eval_orbitals(occ, x)


def log_abs_slater_det(orbitals: HO2D, occ, x: torch.Tensor) -> torch.Tensor:
    """log|det D| by unrolled Gaussian elimination: (..., n, dim) -> (...,)."""
    return logabsdet(slater_matrix(orbitals, occ, x))
