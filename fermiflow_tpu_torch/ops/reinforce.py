"""Closed-form REINFORCE adjoint gradient, coordinate-major.

grad_theta sum_i w_i log p_theta(x_i) with the samples held fixed, by the
continuous adjoint integrated backward on the flow's grid:

    dx/dt = v(x),  da/dt = -A^T a + w grad(div),  a(t1) = -w g,
    theta_bar = int_{t0}^{t1} [(dv/dtheta)^T a - w d(div)/dtheta] dt.

Kernels: ``csrc/reinforce.cu`` (replaces the TPU kernel
``fermiflow_tpu/ops/pallas_reinforce.py:reinforce_flow_grad_pallas``), an
adjoint pass writing per-block partial sums and a reduce pass summing them
in a fixed pairwise order.  Plain version: the same closed form batched in PyTorch
(``reinforce_cm_plain``); the reduce pass's plain version is
``partials.sum(0)``.  The plain versions run only for CPU tensors; a CUDA
tensor launches the kernels or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from fermiflow_tpu_torch.ode.integrators import TABLEAUS
from fermiflow_tpu_torch.ops import _build
from fermiflow_tpu_torch.ops.hessian_flow import tableau_args
from fermiflow_tpu_torch.ops.metropolis import SUPPORTED_N

__all__ = ["reinforce_cm", "reinforce_cm_plain", "reinforce_partials",
           "block_sum", "reinforce_flow_grad", "grads_from_rows"]


def _mlp_sources(r, sp, w, mlp, div_pair, div_one):
    """Sigmoid terms and the per-walker theta integrand of one MLP.

    r, sp: (B, M) distances and u.da (or |x| and x.a); returns
    (e0, e1, e2) (B, M) and q (B, 3h) ordered [w2 rows, w1 rows, b1 rows].
    div_pair/div_one: the divergence coefficients (2, 4 for pairs; 1, 2 for
    the one-body term: div = div_pair r eta' + div_one eta per element).
    """
    w1 = mlp["w1"][0]
    b1 = mlp["b1"]
    w2 = mlp["w2"][:, 0]
    s = torch.sigmoid(r[..., None] * w1 + b1)
    s1 = s * (1.0 - s)
    s2 = s1 * (1.0 - 2.0 * s)
    e0 = s @ w2
    e1 = s1 @ (w2 * w1)
    e2 = s2 @ (w2 * w1 * w1)
    wr = w[:, None] * r
    t_ss = torch.einsum("bm,bmh->bh", sp, s)
    t_sd = torch.einsum("bm,bmh->bh", sp, s1)
    t_srd = torch.einsum("bm,bmh->bh", sp * r, s1)
    t_s = s.sum(1)
    t_d = s1.sum(1)
    t_wrd = torch.einsum("bm,bmh->bh", wr, s1)
    t_wrd2 = torch.einsum("bm,bmh->bh", wr, s2)
    t_wr2d2 = torch.einsum("bm,bmh->bh", wr * r, s2)
    wc = w[:, None]
    q = torch.cat([
        t_ss - div_pair * w1 * t_wrd - div_one * (wc * t_s),
        w2 * (t_srd - (div_pair + div_one) * t_wrd - div_pair * w1 * t_wr2d2),
        w2 * (t_sd - div_pair * w1 * t_wrd2 - div_one * (wc * t_d)),
    ], dim=-1)
    return e0, e1, e2, q


def _adjoint_rhs_plain(params, x, a, w):
    """(dx/dt, da/dt, q) for x, a (B, n, 2) and w (B,); q (B, nq)."""
    n = x.shape[1]
    iu, ju = np.triu_indices(n, 1)
    u = x[:, iu] - x[:, ju]
    da = a[:, iu] - a[:, ju]
    r = torch.linalg.norm(u, dim=-1)
    sp = torch.sum(u * da, dim=-1)
    e0, e1, e2, q = _mlp_sources(r, sp, w, params["eta"], 2.0, 4.0)
    iu_t = torch.as_tensor(iu, device=x.device)
    ju_t = torch.as_tensor(ju, device=x.device)
    vp = e0[..., None] * u
    v = torch.zeros_like(x).index_add(1, iu_t, vp).index_add(1, ju_t, -vp)
    m = (e1 / r * sp)[..., None] * u + e0[..., None] * da
    cg = (2.0 * (e2 * r + 3.0 * e1)) / r * w[:, None]
    dp = -m + cg[..., None] * u
    dadt = torch.zeros_like(a).index_add(1, iu_t, dp).index_add(1, ju_t, -dp)
    qs = [q]
    mu = params.get("mu")
    if mu is not None:
        rho = torch.linalg.norm(x, dim=-1)
        sx = torch.sum(x * a, dim=-1)
        m0, m1, m2, qm = _mlp_sources(rho, sx, w, mu, 1.0, 2.0)
        v = v + m0[..., None] * x
        cu = m1 / rho * sx
        cgm = (m2 * rho + 3.0 * m1) / rho * w[:, None]
        dadt = dadt - (cu[..., None] * x + m0[..., None] * a) + cgm[..., None] * x
        qs.append(qm)
    return v, dadt, torch.cat(qs, dim=-1)


def grads_from_rows(q: torch.Tensor, params: dict) -> dict:
    """(nq,) theta rows -> a gradient dict shaped like ``params``."""
    def unpack(rows, mlp):
        h = mlp["w1"].shape[1]
        return {"w2": rows[:h, None], "w1": rows[h:2 * h][None, :],
                "b1": rows[2 * h:3 * h]}

    h_eta = params["eta"]["w1"].shape[1]
    out = {"eta": unpack(q[:3 * h_eta], params["eta"]), "mu": None}
    if params.get("mu") is not None:
        out["mu"] = unpack(q[3 * h_eta:], params["mu"])
    return out


def reinforce_cm_plain(params: dict, x_cm: torch.Tensor, g_cm: torch.Tensor,
                       w: torch.Tensor, t0: float, t1: float, steps: int = 8,
                       method: str = "dopri5"):
    """Plain PyTorch version of ``reinforce_cm`` (same arguments and
    returns), on any device."""
    d, B = x_cm.shape
    x = x_cm.T.reshape(B, d // 2, 2)
    a = (-w[:, None] * g_cm.T).reshape(B, d // 2, 2)
    tab = TABLEAUS[method]
    h = (float(t0) - float(t1)) / steps
    q = None
    for _ in range(steps):
        ks = []
        for i in range(tab.stages):
            xi, ai = x, a
            for cj, (kx, ka) in zip(tab.a[i], ks):
                if cj != 0.0:
                    xi = xi + (h * cj) * kx
                    ai = ai + (h * cj) * ka
            vx, va, qi = _adjoint_rhs_plain(params, xi, ai, w)
            ks.append((vx, va))
            if tab.b[i] != 0.0:
                q = (-h * tab.b[i]) * qi if q is None else q + (-h * tab.b[i]) * qi
        for bj, (kx, ka) in zip(tab.b, ks):
            if bj != 0.0:
                x = x + (h * bj) * kx
                a = a + (h * bj) * ka
    return grads_from_rows(q.sum(0), params), x.reshape(B, d).T.contiguous()


def _weights_f32(mlp: dict | None):
    if mlp is None:
        return None, None, None, 0
    f32 = lambda t: t.detach().to(torch.float32).reshape(-1).contiguous()
    w1 = f32(mlp["w1"])
    return w1, f32(mlp["b1"]), f32(mlp["w2"]), w1.shape[0]


def reinforce_partials(params: dict, x_cm: torch.Tensor, g_cm: torch.Tensor,
                       w: torch.Tensor, t0: float, t1: float, steps: int = 8,
                       method: str = "dopri5"):
    """The adjoint kernel alone (CUDA tensors only): returns the per-block
    theta partial sums (num_blocks, nq) and z_back (d, B)."""
    d, B = x_cm.shape
    n = d // 2
    if n not in SUPPORTED_N:
        raise ValueError(f"CUDA REINFORCE built for n in {SUPPORTED_N}")
    ew1, eb1, ew2, d_eta = _weights_f32(params["eta"])
    mw1, mb1, mw2, d_mu = _weights_f32(params.get("mu"))
    _build.check_cuda_f32(x=x_cm, g=g_cm, w=w, eta_w1=ew1, mu_w1=mw1)
    if tuple(g_cm.shape) != (d, B) or tuple(w.shape) != (B,):
        raise ValueError("expected x, g (d, B) and w (B,)")
    nq = 3 * (d_eta + d_mu)
    lib = _build.library("reinforce")
    nblocks = lib.ff_reinforce_blocks(ctypes.c_int(B))
    kw = dict(device=x_cm.device, dtype=torch.float32)
    z = torch.empty((d, B), **kw)
    partials = torch.empty((nblocks, nq), **kw)
    stages, ha, hb = tableau_args(method, (float(t0) - float(t1)) / steps)
    P = _build.ptr
    fn = lib.ff_reinforce_adjoint
    fn.restype = ctypes.c_int
    rc = fn(P(x_cm), P(g_cm), P(w), P(z), P(partials), ctypes.c_int(B),
            ctypes.c_int(n), P(ew1), P(eb1), P(ew2), ctypes.c_int(d_eta),
            P(mw1), P(mb1), P(mw2), ctypes.c_int(d_mu), ctypes.c_int(steps),
            ctypes.c_int(stages), ha, hb, _build.stream_ptr(x_cm.device))
    _build.check_rc(rc, "reinforce_adjoint")
    _build.LAUNCHES["reinforce_adjoint"] += 1
    return partials, z


def block_sum(partials: torch.Tensor) -> torch.Tensor:
    """(num_blocks, nq) -> (nq,), summed over blocks in a fixed order.

    The reduce kernel on a CUDA tensor; ``partials.sum(0)`` (its plain
    version) on a CPU tensor."""
    if partials.device.type == "cpu":
        return partials.sum(0)
    _build.check_cuda_f32(partials=partials)
    nblocks, nq = partials.shape
    rows = torch.empty((nq,), device=partials.device, dtype=torch.float32)
    red = _build.library("reinforce").ff_reinforce_reduce
    red.restype = ctypes.c_int
    rc = red(_build.ptr(partials), _build.ptr(rows), ctypes.c_int(nblocks),
             ctypes.c_int(nq), _build.stream_ptr(partials.device))
    _build.check_rc(rc, "reinforce_reduce")
    _build.LAUNCHES["reinforce_reduce"] += 1
    return rows


def reinforce_cm(params: dict, x_cm: torch.Tensor, g_cm: torch.Tensor,
                 w: torch.Tensor, t0: float, t1: float, steps: int = 8,
                 method: str = "dopri5"):
    """grad_theta sum_i w_i log p_theta(x_i) for the backflow field.

    x_cm: (d, B) samples at t1; g_cm: (d, B) grad_x log p at x; w: (B,)
    REINFORCE weights.  Returns (grads shaped like params, z_back (d, B)).
    """
    if x_cm.device.type == "cpu":
        return reinforce_cm_plain(params, x_cm, g_cm, w, t0, t1, steps, method)
    partials, z = reinforce_partials(params, x_cm, g_cm, w, t0, t1, steps,
                                     method)
    return grads_from_rows(block_sum(partials), params), z


def reinforce_flow_grad(params: dict, x1: torch.Tensor, ghat: torch.Tensor,
                        w: torch.Tensor, t0: float, t1: float, steps: int = 8,
                        method: str = "dopri5"):
    """JAX-layout wrapper: x1 (B, n, 2), ghat (B, d), w (B,) ->
    (grads, z_back (B, n, 2)), as ``reinforce_flow_grad_pallas``."""
    B, n, dim = x1.shape
    grads, z = reinforce_cm(params, x1.reshape(B, n * dim).T.contiguous(),
                            ghat.T.contiguous(), w.contiguous(), t0, t1,
                            steps, method)
    return grads, z.T.reshape(B, n, dim)
