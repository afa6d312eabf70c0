"""Fixed-grid Hessian-flow integration, coordinate-major with packed H.

Kernel: ``csrc/hessian_flow.cu`` (replaces the TPU kernel
``fermiflow_tpu/ops/pallas_hessian_flow.py:hessian_flow_pallas``), a group
of ``lanes_for(n)`` lanes per walker (``lane_plan`` says which lane owns
what).
Plain version: ``vmc.hessian_flow.hessian_flow`` with the closed-form field
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
           "hessian_flow_occupancy", "lane_plan", "lanes_for",
           "reciprocal_margin", "tableau_args", "w2k",
           "hessian_flow_pallas_sharded"]

_MAXSTAGES = 6  # FF_MAXSTAGES in csrc/common.cuh


def lanes_for(n: int) -> int:
    """Lanes of a warp per walker in ``csrc/hessian_flow.cu`` (its
    ``lanes_for``): 8 up to n = 6, the whole warp from n = 7, where 8 lanes
    could not hold their state entries' running stage inputs in
    registers."""
    return 8 if n <= 6 else 32


def lane_plan(n: int, lanes: int | None = None) -> dict:
    """Which lane of a walker's group owns what in ``csrc/hessian_flow.cu``
    (at ``lanes_for(n)`` lanes unless ``lanes`` is given).

    State entry e (x, logp, g, packed H) goes to lane e % lanes, register
    slot e // lanes.  A lane runs all its MLP inputs in one hidden-unit
    loop; ``"mlp_inputs"`` lists them as ``("pair", p)`` (pair p in
    ``np.triu_indices`` order) and ``("one_body", i)`` (particle i).  Up to
    n = 6 (8 lanes) pair p goes to lane p % lanes, slot p // lanes, and
    particle i to lane i % lanes, slot QP + i // lanes, where QP is the
    pair slots of every lane.  From n = 7 (a warp) the pairs and then the
    particles form one list, item k to lane k % lanes, slot k // lanes, so
    that no lane holds more than ceil((P + n) / lanes) inputs.  Returns
    ``{kind: (per-lane lists of (item, slot), slots the kernel compiles)}``;
    the slot counts are the kernel's ``E`` and ``QM``.
    """
    lanes = lanes or lanes_for(n)
    d = 2 * n
    n_entries = 2 * d + 1 + d * (d + 1) // 2
    n_pairs = n * (n - 1) // 2
    deal = lambda items, first=0: [
        [(item, first + i // lanes) for i, item in enumerate(items)
         if i % lanes == lane] for lane in range(lanes)]
    plan = {"entries": (deal(range(n_entries)), -(-n_entries // lanes))}
    pairs = [("pair", p) for p in range(n_pairs)]
    ones = [("one_body", i) for i in range(n)]
    if lanes_for(n) == 32:
        plan["mlp_inputs"] = (deal(pairs + ones), -(-(n_pairs + n) // lanes))
        return plan
    qp, qn = -(-n_pairs // lanes), -(-n // lanes)
    plan["mlp_inputs"] = ([a + b for a, b in zip(deal(pairs), deal(ones, qp))],
                          qp + qn)
    return plan


def reciprocal_margin(params: dict, z: torch.Tensor) -> dict:
    """How far a batch lies inside the range check of the kernels' sigmoid
    (``rcp_in_range``, ``csrc/common.cuh``): a lane of the Hessian flow
    (``csrc/hessian_flow.cu``) takes the reciprocal without the division's
    range branch while r |w1|max + |b1|max < 80 for every MLP input it
    holds, a warp of the adjoint (``csrc/reinforce.cu``) while that holds
    for every input of its walkers, with r a pair distance and the eta
    MLP's weights, or a particle's distance from the origin and mu's.
    z (B, n, 2).  Returns the largest such sum over the batch
    (``"largest"``), the limit (``"limit"``) and the share of walkers whose
    every input lies under it (``"share_under"``).  The kernels check the
    positions of every stage; these are the positions given.
    """
    reach = lambda mlp: (mlp["w1"].detach().abs().max(),
                         mlp["b1"].detach().abs().max())
    w, b = reach(params["eta"])
    z = z.detach()
    r = (z[:, :, None] - z[:, None]).square().sum(-1).sqrt()
    iu = torch.triu_indices(z.shape[1], z.shape[1], 1, device=z.device)
    sums = [r[:, iu[0], iu[1]] * w + b]
    if params.get("mu") is not None:
        wm, bm = reach(params["mu"])
        sums.append(z.square().sum(-1).sqrt() * wm + bm)
    per_walker = torch.cat(sums, dim=1).amax(dim=1)
    return {"largest": float(per_walker.max()), "limit": 80.0,
            "share_under": float((per_walker < 80.0).double().mean())}


def hessian_flow_occupancy(n: int, d_eta: int, d_mu: int | None) -> int:
    """Resident warps per SM of the CUDA kernel at these widths (needs the
    card)."""
    warps = ctypes.c_int(0)
    rc = _build.library("hessian_flow").ff_hessian_flow_occupancy(
        ctypes.c_int(n), ctypes.c_int(d_eta), ctypes.c_int(d_mu or 0),
        ctypes.byref(warps))
    _build.check_rc(rc, "hessian_flow occupancy")
    return warps.value


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
        raise ValueError(f"CUDA Hessian flow built for 2 ≤ N ≤ 10; got "
                         f"N={x_cm.shape[0] // 2}")
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


def hessian_flow_pallas_sharded(mesh, params: dict, z: torch.Tensor,
                                y0: torch.Tensor, g0: torch.Tensor,
                                Hp0: torch.Tensor, t0: float, t1: float,
                                steps: int = 16, method: str = "dopri5"):
    """``hessian_flow_packed`` on this rank's rows of ``mesh`` (a walker
    mesh, ``parallel/mesh.py``): the augmented flow of a walker depends on
    that walker alone, so each rank launches on its rows, the parameters
    replicated, with no collective."""
    return hessian_flow_packed(params, z, y0, g0, Hp0, t0, t1, steps, method)
