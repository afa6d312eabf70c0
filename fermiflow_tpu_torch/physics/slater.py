"""Slater-determinant primitives (port of ``fermiflow_tpu/physics/slater.py``).

The mixed-state functions take per-walker occupations as a dense (batch,)
state index into an (Nstates, n) occupation table, as the JAX package does;
the orbital columns are picked by ``gather`` where JAX multiplies by one-hot
masks (the same values: a one-hot product adds exact zeros).
"""

from __future__ import annotations

import numpy as np
import torch

from fermiflow_tpu_torch.ops.logdet import gauss_jordan_inv, logabsdet
from fermiflow_tpu_torch.physics.orbitals import (
    HO2D,
    device_table,
    hermite_functions,
)

__all__ = [
    "slater_matrix",
    "log_abs_slater_det",
    "slater_matrix_multstates",
    "slater_matrix_qnums",
    "log_abs_slater_det_multstates",
    "slater_derivs",
    "slater_derivs_multstates",
    "derivs_from_qnums",
    "walker_qnums",
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
    lo = device_table(np.sqrt(m / 2.0), u.dtype, u.device)
    hi = device_table(np.sqrt((m + 1) / 2.0), u.dtype, u.device)
    psi_m1 = torch.cat([torch.zeros_like(psi[..., :1]), psi[..., :-1]], dim=-1)
    dpsi = lo * psi_m1 - hi * psi_ext[..., 1:]
    two_m1 = device_table(2 * m + 1, u.dtype, u.device)
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
    nx = device_table(orbitals.nx[occ], torch.long, x.device)
    ny = device_table(orbitals.ny[occ], torch.long, x.device)
    K = orbitals.num_shells
    vx, dvx, d2vx = _ho1d_val_d1_d2(x[..., 0], K)
    vy, dvy, d2vy = _ho1d_val_d1_d2(x[..., 1], K)
    return _derivs_from_1d(
        vx[..., nx], dvx[..., nx], d2vx[..., nx],
        vy[..., ny], dvy[..., ny], d2vy[..., ny],
    )


def walker_qnums(orbitals: HO2D, occ_table, state_idx: torch.Tensor):
    """Per-walker 1D quantum numbers (nx, ny), each ``state_idx.shape + (n,)``
    long, of the orbitals ``occ_table[state_idx]`` occupies."""
    dev = state_idx.device
    table = device_table(occ_table, torch.long, dev)
    # index_select, not table[state_idx]: indexing by a 0-d tensor reads it
    # on the host, which torch.func.vmap cannot do over walkers.
    idx = state_idx.long()
    occ = table.index_select(0, idx.reshape(-1)).reshape(
        idx.shape + table.shape[1:])
    nx = device_table(orbitals.nx, torch.long, dev)[occ]
    ny = device_table(orbitals.ny, torch.long, dev)[occ]
    return nx, ny


def _pick(V: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """V (..., n, K), q (..., n) -> (..., n, n) with [..., i, j] = V[..., i, q[..., j]]."""
    idx = q[..., None, :].expand(V.shape[:-1] + (q.shape[-1],))
    return V.gather(-1, idx)


def derivs_from_qnums(x: torch.Tensor, nx: torch.Tensor, ny: torch.Tensor,
                      num_shells: int):
    """(D, D1, D2) as ``slater_derivs`` with per-walker quantum numbers
    nx, ny (..., n) below ``num_shells``; x (..., n, 2)."""
    vx, dvx, d2vx = _ho1d_val_d1_d2(x[..., 0], num_shells)
    vy, dvy, d2vy = _ho1d_val_d1_d2(x[..., 1], num_shells)
    nx, ny = nx.long(), ny.long()
    return _derivs_from_1d(
        _pick(vx, nx), _pick(dvx, nx), _pick(d2vx, nx),
        _pick(vy, ny), _pick(dvy, ny), _pick(d2vy, ny),
    )


def slater_derivs_multstates(orbitals: HO2D, occ_table, state_idx: torch.Tensor,
                             x: torch.Tensor):
    """Per-walker (D, D1, D2) for per-walker occupations ``occ_table[state_idx]``."""
    nx, ny = walker_qnums(orbitals, occ_table, state_idx)
    return derivs_from_qnums(x, nx, ny, orbitals.num_shells)


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


def slater_matrix_qnums(x: torch.Tensor, nx: torch.Tensor, ny: torch.Tensor,
                        num_shells: int) -> torch.Tensor:
    """D[..., i, j] = phi_{(nx[..., j], ny[..., j])}(x[..., i]) for per-walker
    quantum numbers nx, ny (..., n) below ``num_shells``: (..., n, n)."""
    gauss = torch.exp(-0.5 * torch.sum(x * x, dim=-1)) * float(1 / np.sqrt(np.pi))
    hx = hermite_functions(x[..., 0], num_shells)
    hy = hermite_functions(x[..., 1], num_shells)
    return gauss[..., :, None] * _pick(hx, nx.long()) * _pick(hy, ny.long())


def slater_matrix_multstates(orbitals: HO2D, occ_table, state_idx: torch.Tensor,
                             x: torch.Tensor) -> torch.Tensor:
    """D[b, i, j] = phi_{occ_table[state_idx[b], j]}(x[b, i]): (batch, n, n)."""
    nx, ny = walker_qnums(orbitals, occ_table, state_idx)
    return slater_matrix_qnums(x, nx, ny, orbitals.num_shells)


def log_abs_slater_det_multstates(orbitals: HO2D, occ_table,
                                  state_idx: torch.Tensor,
                                  x: torch.Tensor) -> torch.Tensor:
    """log|det D| per walker for per-walker states -> (batch,)."""
    return logabsdet(slater_matrix_multstates(orbitals, occ_table, state_idx, x))
