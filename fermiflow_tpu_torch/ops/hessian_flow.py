"""Fixed-grid Hessian-flow integration, coordinate-major with packed H.

Kernel: ``csrc/hessian_flow.cu`` (replaces the TPU kernel
``fermiflow_tpu/ops/pallas_hessian_flow.py:hessian_flow_pallas``).  Plain
version: ``vmc.hessian_flow.hessian_flow`` with the closed-form field
tensors, on the unpacked Hessian.  The plain version runs only for CPU
tensors; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from fermiflow_tpu_torch.nn.backflow_derivs import backflow_field_tensors
from fermiflow_tpu_torch.ode.integrators import TABLEAUS
from fermiflow_tpu_torch.ops import _build
from fermiflow_tpu_torch.ops.metropolis import SUPPORTED_N
from fermiflow_tpu_torch.ops.slater_vgh import pack_triu, unpack_triu

__all__ = ["hessian_flow_cm", "hessian_flow_cm_plain", "hessian_flow_packed",
           "tableau_args", "w2k"]

_MAXSTAGES = 6  # FF_MAXSTAGES in csrc/common.cuh


def tableau_args(method: str, h: float):
    """(stages, h*a, h*b) as ctypes float arrays for the kernels."""
    tab = TABLEAUS[method]
    if tab.stages > _MAXSTAGES:
        raise ValueError(f"tableau {method} has more than {_MAXSTAGES} stages")
    ha = (ctypes.c_float * (_MAXSTAGES * _MAXSTAGES))()
    hb = (ctypes.c_float * _MAXSTAGES)()
    for i in range(tab.stages):
        hb[i] = h * tab.b[i]
        for j, a in enumerate(tab.a[i]):
            ha[i * _MAXSTAGES + j] = h * a
    return tab.stages, ha, hb


def w2k(mlp: dict) -> torch.Tensor:
    """(4, h) table w2 * w1^k, k = 0..3 (the TPU kernel's ``_w2k``)."""
    w1 = mlp["w1"][0]
    w2 = mlp["w2"][:, 0]
    return torch.stack([w2, w2 * w1, w2 * w1**2, w2 * w1**3]).contiguous()


def hessian_flow_cm_plain(params: dict, x_cm: torch.Tensor,
                          logp: torch.Tensor, g_cm: torch.Tensor,
                          Hp_cm: torch.Tensor, t0: float, t1: float,
                          steps: int = 16, method: str = "dopri5"):
    """Plain PyTorch version of ``hessian_flow_cm`` (same arguments and
    returns), on any device: the closed-form field tensors on the unpacked
    Hessian."""
    # Imported here: vmc/ imports this module (vmc.gs chains the kernels).
    from fermiflow_tpu_torch.vmc.hessian_flow import hessian_flow

    d, B = x_cm.shape
    z = x_cm.T.reshape(B, d // 2, 2)
    H0 = unpack_triu(Hp_cm.T, d)
    x, lp, g, H = hessian_flow(backflow_field_tensors, params, z, logp,
                               g_cm.T, H0, t0, t1, steps=steps, method=method)
    return (x.reshape(B, d).T.contiguous(), lp, g.T.contiguous(),
            pack_triu(H).T.contiguous())


def _hflow_cuda(params, x_cm, logp, g_cm, Hp_cm, t0, t1, steps, method):
    d, B = x_cm.shape
    n = d // 2
    eta, mu = params["eta"], params.get("mu")
    f32 = lambda t: t.detach().to(torch.float32).contiguous()
    ew1, eb1, ew2k = f32(eta["w1"][0]), f32(eta["b1"]), f32(w2k(eta))
    if mu is not None:
        mw1, mb1, mw2k = f32(mu["w1"][0]), f32(mu["b1"]), f32(w2k(mu))
        d_mu = mw1.shape[0]
    else:
        mw1 = mb1 = mw2k = None
        d_mu = 0
    _build.check_cuda_f32(x=x_cm, logp=logp, g=g_cm, H=Hp_cm, eta_w1=ew1,
                          mu_w1=mw1)
    nut = d * (d + 1) // 2
    if tuple(Hp_cm.shape) != (nut, B) or tuple(g_cm.shape) != (d, B) \
            or tuple(logp.shape) != (B,):
        raise ValueError("expected x, g (d, B), logp (B,), Hp (d(d+1)/2, B)")
    xo, lpo, go, Ho = (torch.empty_like(a) for a in (x_cm, logp, g_cm, Hp_cm))
    stages, ha, hb = tableau_args(method, (float(t1) - float(t0)) / steps)
    fn = _build.library("hessian_flow").ff_hessian_flow
    fn.restype = ctypes.c_int
    P = _build.ptr
    rc = fn(P(x_cm), P(logp), P(g_cm), P(Hp_cm), P(xo), P(lpo), P(go), P(Ho),
            ctypes.c_int(B), ctypes.c_int(n), P(ew1), P(eb1), P(ew2k),
            ctypes.c_int(ew1.shape[0]), P(mw1), P(mb1), P(mw2k),
            ctypes.c_int(d_mu), ctypes.c_int(steps), ctypes.c_int(stages),
            ha, hb, _build.stream_ptr(x_cm.device))
    _build.check_rc(rc, "hessian_flow")
    _build.LAUNCHES["hessian_flow"] += 1
    return xo, lpo, go, Ho


def hessian_flow_cm(params: dict, x_cm: torch.Tensor, logp: torch.Tensor,
                    g_cm: torch.Tensor, Hp_cm: torch.Tensor, t0: float,
                    t1: float, steps: int = 16, method: str = "dopri5"):
    """Integrate (x, logp, g, packed H) from t0 to t1 for the backflow field.

    x_cm, g_cm (d, B); logp (B,); Hp_cm (d(d+1)/2, B) in np.triu_indices
    order.  Returns the same four at t1.
    """
    if x_cm.device.type == "cpu":
        return hessian_flow_cm_plain(params, x_cm, logp, g_cm, Hp_cm, t0, t1,
                                     steps, method)
    if x_cm.shape[0] // 2 not in SUPPORTED_N:
        raise ValueError(f"CUDA Hessian flow built for n in {SUPPORTED_N}")
    return _hflow_cuda(params, x_cm, logp, g_cm, Hp_cm, t0, t1, steps, method)


def hessian_flow_packed(params: dict, z: torch.Tensor, y0: torch.Tensor,
                        g0: torch.Tensor, Hp0: torch.Tensor, t0: float,
                        t1: float, steps: int = 16, method: str = "dopri5"):
    """JAX-layout wrapper: z (B, n, 2), y0 (B,), g0 (B, d), Hp0 (B, nut) ->
    (x (B, n, 2), logp (B,), g (B, d), Hp (B, nut))."""
    B, n, dim = z.shape
    x, lp, g, Hp = hessian_flow_cm(
        params, z.reshape(B, n * dim).T.contiguous(), y0.contiguous(),
        g0.T.contiguous(), Hp0.T.contiguous(), t0, t1, steps, method)
    return x.T.reshape(B, n, dim), lp, g.T, Hp.T
