"""Slater base (value, gradient, packed Hessian), coordinate-major.

Two kernels, each with its plain version here: ``FreeFermion``'s closed
form (``physics/slater.py``), packed into ``np.triu_indices`` order.  A plain
version runs only for CPU tensors; a CUDA tensor launches the kernel or
raises.

* ``slater_vgh_cm``: static occupations.  Kernel ``csrc/slater_vgh.cu``
  (replaces ``fermiflow_tpu/ops/pallas_slater_vgh.py:slater_vgh_pallas``).
* ``slater_vgh_ms_cm``: per-walker occupations, one spin sector (finite T).
  Kernel ``csrc/slater_vgh_ms.cu`` (replaces ``slater_vgh_ms_pallas``).

Each kernel works on a walker with a group of ``LANES`` lanes of a warp
(``csrc/vgh.cuh``: lane l owns Slater rows l, l + LANES, ...), with the
arithmetic of one thread per walker.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from fermiflow_tpu_torch.ops import _build
from fermiflow_tpu_torch.ops.metropolis import KMAX, SUPPORTED_N, ms_depth
from fermiflow_tpu_torch.physics.slater import (
    _derivs_from_1d,
    _ho1d_val_d1_d2,
    derivs_from_qnums,
    logdet_vgh,
)

__all__ = ["slater_vgh_cm", "slater_vgh_cm_plain", "slater_vgh",
           "slater_vgh_ms_cm", "slater_vgh_ms_cm_plain", "slater_vgh_ms",
           "pack_triu", "unpack_triu", "slater_vgh_occupancy",
           "slater_vgh_ms_occupancy", "LANES"]

LANES = 8  # kVghLanes in csrc/vgh.cuh: lanes of a warp per walker


def slater_vgh_occupancy(n: int, batch: int) -> dict:
    """The static kernel's launch for n particles over ``batch`` walkers, as
    the library reports it: resident warps per SM, the warps of the grid its
    launcher makes, and lanes per walker (needs the card)."""
    return _build.occupancy("slater_vgh", n, batch)


def slater_vgh_ms_occupancy(n: int, num_shells: int, batch: int) -> dict:
    """``slater_vgh_occupancy`` of the mixed-state kernel (needs the card)."""
    return _build.occupancy("slater_vgh_ms", n, ms_depth(num_shells), batch)


def pack_triu(H: torch.Tensor) -> torch.Tensor:
    """(..., d, d) -> (..., d(d+1)/2) upper triangle in np.triu_indices order."""
    d = H.shape[-1]
    iu = np.triu_indices(d)
    return H[..., iu[0], iu[1]]


def unpack_triu(Hp: torch.Tensor, d: int) -> torch.Tensor:
    """(..., d(d+1)/2) packed upper triangle -> symmetric (..., d, d)."""
    iu = np.triu_indices(d)
    H = Hp.new_zeros(Hp.shape[:-1] + (d, d))
    H[..., iu[0], iu[1]] = Hp
    H[..., iu[1], iu[0]] = Hp
    return H


def _sector_vgh(x, nx, ny, num_shells):
    vx, dvx, d2vx = _ho1d_val_d1_d2(x[..., 0], num_shells)
    vy, dvy, d2vy = _ho1d_val_d1_d2(x[..., 1], num_shells)
    ix = torch.as_tensor(nx, dtype=torch.long, device=x.device)
    iy = torch.as_tensor(ny, dtype=torch.long, device=x.device)
    return logdet_vgh(*_derivs_from_1d(
        vx[..., ix], dvx[..., ix], d2vx[..., ix],
        vy[..., iy], dvy[..., iy], d2vy[..., iy]))


def slater_vgh_cm_plain(x_cm: torch.Tensor, nx_occ: tuple, ny_occ: tuple,
                        num_shells: int = 3, nx_dn: tuple = (),
                        ny_dn: tuple = ()):
    """Plain PyTorch version of ``slater_vgh_cm`` (same arguments and
    returns), on any device."""
    nx_up, ny_up = tuple(nx_occ), tuple(ny_occ)
    nx_dn, ny_dn = tuple(nx_dn), tuple(ny_dn)
    d, B = x_cm.shape
    nup = len(nx_up)
    x = x_cm.T.reshape(B, d // 2, 2)
    parts = [_sector_vgh(x[:, :nup], nx_up, ny_up, num_shells)]
    if nx_dn:
        parts.append(_sector_vgh(x[:, nup:], nx_dn, ny_dn, num_shells))
    y = 2.0 * sum(p[0] for p in parts)
    g = 2.0 * torch.cat([p[1] for p in parts], dim=-1)
    H = x.new_zeros((B, d, d))
    lo = 0
    for p in parts:
        m = p[2].shape[-1]
        H[:, lo:lo + m, lo:lo + m] = 2.0 * p[2]
        lo += m
    return y, g.T.contiguous(), pack_triu(H).T.contiguous()


def _vgh_cuda(x_cm, nx, ny, nup):
    d, B = x_cm.shape
    n = d // 2
    _build.check_cuda_f32(x=x_cm)
    nut = d * (d + 1) // 2
    kw = dict(device=x_cm.device, dtype=torch.float32)
    y = torch.empty((B,), **kw)
    g = torch.empty((d, B), **kw)
    Hp = torch.empty((nut, B), **kw)
    fn = _build.library("slater_vgh").ff_slater_vgh
    fn.restype = ctypes.c_int
    ints = ctypes.c_int * n
    rc = fn(_build.ptr(x_cm), _build.ptr(y), _build.ptr(g), _build.ptr(Hp),
            ctypes.c_int(B), ctypes.c_int(n), ctypes.c_int(nup), ints(*nx),
            ints(*ny), _build.stream_ptr(x_cm.device))
    _build.check_rc(rc, "slater_vgh")
    _build.LAUNCHES["slater_vgh"] += 1
    return y, g, Hp


def slater_vgh_cm(x_cm: torch.Tensor, nx_occ: tuple, ny_occ: tuple,
                  num_shells: int = 3, nx_dn: tuple = (), ny_dn: tuple = ()):
    """x_cm (d, B) -> y (B,), g (d, B), Hp (d(d+1)/2, B) of the base
    log-density 2 sum_sectors log|det|, dim = 2."""
    nx = tuple(nx_occ) + tuple(nx_dn)
    ny = tuple(ny_occ) + tuple(ny_dn)
    if len(nx) * 2 != x_cm.shape[0]:
        raise ValueError("occupations must cover all particles (dim = 2)")
    if x_cm.device.type == "cpu":
        return slater_vgh_cm_plain(x_cm, nx_occ, ny_occ, num_shells, nx_dn,
                                   ny_dn)
    if len(nx) not in SUPPORTED_N or max(nx + ny) >= KMAX:
        raise ValueError(f"CUDA Slater VGH built for n in {SUPPORTED_N} with "
                         f"quantum numbers < {KMAX}; got n={len(nx)}")
    return _vgh_cuda(x_cm, nx, ny, len(nx_occ))


def slater_vgh(x: torch.Tensor, nx_occ: tuple, ny_occ: tuple,
               num_shells: int = 3, nx_dn: tuple = (), ny_dn: tuple = ()):
    """JAX-layout wrapper (``slater_vgh_pallas(..., packed=True)``):
    x (B, n, 2) -> y (B,), g (B, d), Hp (B, d(d+1)/2)."""
    B, n, dim = x.shape
    y, g, Hp = slater_vgh_cm(x.reshape(B, n * dim).T.contiguous(), nx_occ,
                             ny_occ, num_shells, nx_dn, ny_dn)
    return y, g.T, Hp.T


# ---- per-walker occupations (finite T) ----


def slater_vgh_ms_cm_plain(x_cm: torch.Tensor, nx_cm: torch.Tensor,
                           ny_cm: torch.Tensor, num_shells: int):
    """Plain PyTorch version of ``slater_vgh_ms_cm`` (same arguments and
    returns), on any device."""
    d, B = x_cm.shape
    x = x_cm.T.reshape(B, d // 2, 2)
    y, g, H = logdet_vgh(*derivs_from_qnums(x, nx_cm.T, ny_cm.T, num_shells))
    return 2.0 * y, (2.0 * g).T.contiguous(), pack_triu(2.0 * H).T.contiguous()


def _vgh_ms_cuda(x_cm, nx_cm, ny_cm, num_shells):
    d, B = x_cm.shape
    n = d // 2
    _build.check_cuda_f32(x=x_cm)
    _build.check_cuda_i32(nx=nx_cm, ny=ny_cm)
    if tuple(nx_cm.shape) != (n, B) or tuple(ny_cm.shape) != (n, B):
        raise ValueError(f"nx, ny must be ({n}, {B}) per-walker quantum numbers")
    nut = d * (d + 1) // 2
    kw = dict(device=x_cm.device, dtype=torch.float32)
    y = torch.empty((B,), **kw)
    g = torch.empty((d, B), **kw)
    Hp = torch.empty((nut, B), **kw)
    fn = _build.library("slater_vgh_ms").ff_slater_vgh_ms
    fn.restype = ctypes.c_int
    P = _build.ptr
    rc = fn(P(x_cm), P(nx_cm), P(ny_cm), P(y), P(g), P(Hp), ctypes.c_int(B),
            ctypes.c_int(n), ctypes.c_int(ms_depth(num_shells)),
            _build.stream_ptr(x_cm.device))
    _build.check_rc(rc, "slater_vgh_ms")
    _build.LAUNCHES["slater_vgh_ms"] += 1
    return y, g, Hp


def slater_vgh_ms_cm(x_cm: torch.Tensor, nx_cm: torch.Tensor,
                     ny_cm: torch.Tensor, num_shells: int):
    """x_cm (d, B), nx_cm/ny_cm (n, B) int32 quantum numbers below
    ``num_shells`` -> y (B,), g (d, B), Hp (d(d+1)/2, B) of each walker's own
    base log-density 2 log|det|, dim = 2.  On the GPU a walker with a
    quantum number outside the compiled depth comes back NaN."""
    if nx_cm.shape[0] * 2 != x_cm.shape[0]:
        raise ValueError("occupations must cover all particles (dim = 2)")
    if x_cm.device.type == "cpu":
        return slater_vgh_ms_cm_plain(x_cm, nx_cm, ny_cm, num_shells)
    if nx_cm.shape[0] not in SUPPORTED_N:
        raise ValueError(f"CUDA Slater VGH built for n in {SUPPORTED_N}; "
                         f"got n={nx_cm.shape[0]}")
    return _vgh_ms_cuda(x_cm, nx_cm, ny_cm, num_shells)


def slater_vgh_ms(x: torch.Tensor, nx: torch.Tensor, ny: torch.Tensor,
                  num_shells: int = 8):
    """JAX-layout wrapper (``slater_vgh_ms_pallas(..., packed=True)``):
    x (B, n, 2), nx/ny (B, n) -> y (B,), g (B, d), Hp (B, d(d+1)/2)."""
    B, n, dim = x.shape
    y, g, Hp = slater_vgh_ms_cm(x.reshape(B, n * dim).T.contiguous(),
                                nx.T.to(torch.int32).contiguous(),
                                ny.T.to(torch.int32).contiguous(), num_shells)
    return y, g.T, Hp.T
