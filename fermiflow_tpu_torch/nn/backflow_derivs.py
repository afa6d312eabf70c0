"""Closed-form derivative tensors of the backflow velocity field
(port of ``fermiflow_tpu/nn/backflow_derivs.py``).

For the field v_i = sum_{j!=i} eta(r_ij)(x_i - x_j) + mu(|x_i|) x_i this
assembles, per walker, v, div v, A = dv/dx, grad(div v), S = grad^2(div v)
and T = g_c d^2 v_c / dx dx from the MLP derivatives up to third order.
This is the plain version of the Hessian-flow kernel's right-hand side.
"""

from __future__ import annotations

import torch

from fermiflow_tpu_torch.nn.mlp import mlp_derivs3

__all__ = ["backflow_field_tensors"]


def _pair_block_matrix(K: torch.Tensor, eye_n: torch.Tensor) -> torch.Tensor:
    """(..., n, dim, n, dim) block matrix with off-diagonal blocks -K[i, j]
    and diagonal blocks sum_j K[i, j]."""
    off = -torch.movedim(K, -2, -3)  # (..., i, b, j, c)
    diag = torch.sum(K, dim=-3)  # (..., i, b, c)
    return off + torch.einsum("...iab,ik->...iakb", diag, eye_n)


def backflow_field_tensors(params: dict, x: torch.Tensor, g: torch.Tensor) -> dict:
    """All field-derivative tensors of the Hessian-flow RHS.

    Args:
      x: (..., n, dim) positions; g: (..., n, dim) current score.

    Returns:
      dict with v (..., n, dim); div (...,); gdiv (..., nd); A, S, T (..., nd, nd).
    """
    n, dim = x.shape[-2:]
    nd = n * dim
    batch = x.shape[:-2]
    eye_n = torch.eye(n, dtype=x.dtype, device=x.device)
    I_d = torch.eye(dim, dtype=x.dtype, device=x.device)

    u = x[..., :, None, :] - x[..., None, :, :]
    r = torch.linalg.norm(u + eye_n[:, :, None], dim=-1)
    inv_r = 1.0 / r
    mask = 1.0 - eye_n
    e0, e1, e2, e3 = (e * mask for e in mlp_derivs3(params["eta"], r))

    uu = u[..., :, None] * u[..., None, :]
    v = torch.sum(e0[..., None] * u, dim=-2)
    div = torch.sum(e1 * r + dim * e0, dim=(-2, -1))

    Puv = (e1 * inv_r)[..., None, None] * uu + e0[..., None, None] * I_d
    A = _pair_block_matrix(Puv, eye_n)

    phi1 = e2 * r + (dim + 1) * e1
    phi2 = e3 * r + (dim + 2) * e2
    gdiv = torch.sum(2.0 * (phi1 * inv_r)[..., None] * u, dim=-2)

    Phi = (phi2 * inv_r**2)[..., None, None] * uu + phi1[..., None, None] * (
        inv_r[..., None, None] * I_d - (inv_r**3)[..., None, None] * uu
    )
    S = _pair_block_matrix(2.0 * Phi, eye_n)

    gi = g[..., :, None, :]
    gu = torch.sum(gi * u, dim=-1)
    g_sym = gi[..., :, None] * u[..., None, :]
    g_sym = g_sym + torch.swapaxes(g_sym, -1, -2)
    qa = e1 * inv_r
    qb = (e2 * inv_r**2 - e1 * inv_r**3) * gu
    Gq = qa[..., None, None] * (g_sym + gu[..., None, None] * I_d) \
        + qb[..., None, None] * uu
    T = _pair_block_matrix(Gq + torch.swapaxes(Gq, -4, -3), eye_n)

    if params.get("mu") is not None:
        rho = torch.linalg.norm(x, dim=-1)
        inv_rho = 1.0 / rho
        m0, m1, m2, m3 = mlp_derivs3(params["mu"], rho)
        xx = x[..., :, None] * x[..., None, :]

        v = v + m0[..., None] * x
        div = div + torch.sum(m1 * rho + dim * m0, dim=-1)
        A1 = (m1 * inv_rho)[..., None, None] * xx + m0[..., None, None] * I_d
        psi1 = m2 * rho + (dim + 1) * m1
        psi2 = m3 * rho + (dim + 2) * m2
        gdiv = gdiv + (psi1 * inv_rho)[..., None] * x
        S1 = (psi2 * inv_rho**2)[..., None, None] * xx + psi1[..., None, None] * (
            inv_rho[..., None, None] * I_d - (inv_rho**3)[..., None, None] * xx
        )
        gx = torch.sum(g * x, dim=-1)
        gx_sym = g[..., :, None] * x[..., None, :]
        gx_sym = gx_sym + torch.swapaxes(gx_sym, -1, -2)
        Gq1 = (m1 * inv_rho)[..., None, None] * (gx_sym + gx[..., None, None] * I_d) \
            + ((m2 * inv_rho**2 - m1 * inv_rho**3) * gx)[..., None, None] * xx

        A = A + torch.einsum("...iab,ik->...iakb", A1, eye_n)
        S = S + torch.einsum("...iab,ik->...iakb", S1, eye_n)
        T = T + torch.einsum("...iab,ik->...iakb", Gq1, eye_n)

    flat = batch + (nd, nd)
    return {
        "v": v,
        "div": div,
        "gdiv": gdiv.reshape(batch + (nd,)),
        "A": A.reshape(flat),
        "S": S.reshape(flat),
        "T": T.reshape(flat),
    }
