"""Multi-segment Metropolis sampler of the free-fermion base density.

Kernel: ``csrc/metropolis.cu`` (replaces the TPU kernel
``fermiflow_tpu/ops/pallas_metropolis.py:metropolis_free_fermion_chains``).
Plain version: ``metropolis_chains_plain`` below, batched PyTorch over the same
Hermite-table + pivoted-elimination log-density.  The plain version runs only
for CPU tensors; a CUDA tensor launches the kernel or raises.

Both take an optional ``noise = (normals, uniforms)`` with normals shaped
(segments, steps + 1, d, B) (slot ``steps`` feeds the ``reinit`` restart)
and uniforms (segments, steps, B), so the two can be compared on one random
stream.  Without it the kernel draws from Philox keyed by ``seed`` and the
plain version from a ``torch.Generator`` seeded with ``seed``: the two
streams differ and are compared by distribution.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from fermiflow_tpu_torch.ops import _build
from fermiflow_tpu_torch.ops.logdet import logabsdet
from fermiflow_tpu_torch.physics.orbitals import hermite_functions

__all__ = ["metropolis_chains", "metropolis_chains_plain",
           "metropolis_free_fermion_chains", "slater_logp_qn", "SUPPORTED_N",
           "KMAX"]

SUPPORTED_N = (2, 3, 4, 5, 6)  # instantiations in csrc/*.cu
KMAX = 3  # Hermite orders the kernels tabulate (FF_KMAX)


def slater_logp_qn(x: torch.Tensor, nx: tuple, ny: tuple, nup: int,
                   num_shells: int) -> torch.Tensor:
    """2 sum_sectors log|det| from the occupied orbitals' quantum numbers.

    x (B, n, 2).  Column j holds orbital (nx[j], ny[j]); columns and particles
    [0, nup) are spin-up.  Cross-sector entries are zero, so one n x n
    elimination gives the product of the sector determinants.
    """
    n = x.shape[-2]
    gauss = torch.exp(-0.5 * torch.sum(x * x, dim=-1)) * float(1 / np.sqrt(np.pi))
    hx = hermite_functions(x[..., 0], num_shells)
    hy = hermite_functions(x[..., 1], num_shells)
    ix = torch.as_tensor(nx, dtype=torch.long, device=x.device)
    iy = torch.as_tensor(ny, dtype=torch.long, device=x.device)
    D = gauss[..., None] * hx[..., ix] * hy[..., iy]
    up = torch.arange(n, device=x.device) < nup
    same = (up[:, None] == up[None, :]).to(x.dtype)
    return 2.0 * logabsdet(D * same, tiny=1e-30)


def metropolis_chains_plain(x0_cm: torch.Tensor, tau: torch.Tensor, seed: int,
                            *, steps: int, segments: int, nx_occ: tuple,
                            ny_occ: tuple, nx_dn: tuple = (), ny_dn: tuple = (),
                            num_shells: int = 3, target: float = 0.5,
                            gain: float = 0.1, reinit: bool = False,
                            noise=None,
                            generator: torch.Generator | None = None):
    """Plain PyTorch version of ``metropolis_chains`` (same arguments and
    returns), on any device.  Without ``noise`` it draws from ``generator``,
    or from a new one seeded with ``seed`` on the walkers' device."""
    nx = tuple(nx_occ) + tuple(nx_dn)
    ny = tuple(ny_occ) + tuple(ny_dn)
    nup = len(nx_occ)
    if noise is None and generator is None:
        generator = torch.Generator(x0_cm.device).manual_seed(int(seed))
    d, B = x0_cm.shape
    n = d // 2
    to_walkers = lambda a: a.T.reshape(B, n, 2)
    logp_fn = lambda x: slater_logp_qn(x, nx, ny, nup, num_shells)
    kw = dict(dtype=x0_cm.dtype, device=x0_cm.device)

    def normals(s, t):
        if noise is not None:
            return noise[0][s, t]
        return torch.randn((d, B), generator=generator, **kw)

    def uniform(s, t):
        if noise is not None:
            return noise[1][s, t]
        return torch.rand((B,), generator=generator, **kw).clamp_min(1e-12)

    x = to_walkers(x0_cm)
    tau = tau.clone()
    logp = logp_fn(x)
    xs, logps, rates = [], [], []
    for s in range(segments):
        if reinit and s > 0:
            x = to_walkers(normals(s, steps))
            logp = logp_fn(x)
        acc = torch.zeros(B, **kw)
        for t in range(steps):
            xn = x + tau[:, None, None] * to_walkers(normals(s, t))
            lpn = logp_fn(xn)
            accept = uniform(s, t) < torch.exp(torch.clamp(lpn - logp, max=0.0))
            x = torch.where(accept[:, None, None], xn, x)
            logp = torch.where(accept, lpn, logp)
            acc = acc + accept.to(acc.dtype)
        rate = acc / max(steps, 1)
        xs.append(x.reshape(B, d).T)
        logps.append(logp)
        rates.append(rate)
        if not reinit:
            tau = tau * torch.exp(gain * (rate - target))
    return torch.stack(xs), torch.stack(logps), torch.stack(rates), tau


def _chains_cuda(x0_cm, tau, seed, steps, segments, nx, ny, nup, target, gain,
                 reinit, noise):
    d, B = x0_cm.shape
    n = d // 2
    normals, uniforms = noise if noise is not None else (None, None)
    _build.check_cuda_f32(x0=x0_cm, tau=tau, normals=normals, uniforms=uniforms)
    if tuple(tau.shape) != (B,):
        raise ValueError(f"tau must be ({B},), got {tuple(tau.shape)}")
    if normals is not None and (tuple(normals.shape) != (segments, steps + 1, d, B)
                                or tuple(uniforms.shape) != (segments, steps, B)):
        raise ValueError("noise must be (normals (S, steps+1, d, B), "
                         "uniforms (S, steps, B))")
    out = dict(device=x0_cm.device, dtype=torch.float32)
    xs = torch.empty((segments, d, B), **out)
    logps = torch.empty((segments, B), **out)
    rates = torch.empty((segments, B), **out)
    tau_out = torch.empty((B,), **out)
    lib = _build.library("metropolis")
    fn = lib.ff_metropolis_chains
    fn.restype = ctypes.c_int
    ints = ctypes.c_int * n
    rc = fn(_build.ptr(x0_cm), _build.ptr(tau), _build.ptr(xs),
            _build.ptr(logps), _build.ptr(rates), _build.ptr(tau_out),
            _build.ptr(normals), _build.ptr(uniforms), ctypes.c_int(B),
            ctypes.c_int(n), ctypes.c_int(nup), ints(*nx), ints(*ny),
            ctypes.c_uint(seed & 0xFFFFFFFF), ctypes.c_int(steps),
            ctypes.c_int(segments), ctypes.c_float(target),
            ctypes.c_float(gain), ctypes.c_int(int(reinit)),
            _build.stream_ptr(x0_cm.device))
    _build.check_rc(rc, "metropolis_chains")
    _build.LAUNCHES["metropolis_chains"] += 1
    return xs, logps, rates, tau_out


def metropolis_chains(x0_cm: torch.Tensor, tau: torch.Tensor, seed: int, *,
                      steps: int, segments: int, nx_occ: tuple, ny_occ: tuple,
                      nx_dn: tuple = (), ny_dn: tuple = (), num_shells: int = 3,
                      target: float = 0.5, gain: float = 0.1,
                      reinit: bool = False, noise=None,
                      generator: torch.Generator | None = None):
    """K segments of ``steps`` Metropolis steps, coordinate-major.

    Args:
      x0_cm: (d, B) walker coordinates, walkers contiguous.
      tau: (B,) per-walker proposal scale.
      seed: stream seed (Philox key on the GPU; generator seed on the CPU).
      nx_occ/ny_occ (+ nx_dn/ny_dn): occupied orbitals' 1D quantum numbers
        of the spin-up (and spin-down) sector.
      target, gain: tau adaptation between segments (ignored with reinit).
      reinit: restart each segment after the first from fresh Gaussians.
      noise: optional shared random stream, see the module docstring.

    Returns:
      xs (segments, d, B), logps (segments, B), rates (segments, B),
      tau_out (B,).
    """
    nx = tuple(nx_occ) + tuple(nx_dn)
    ny = tuple(ny_occ) + tuple(ny_dn)
    nup = len(nx_occ)
    if len(nx) * 2 != x0_cm.shape[0]:
        raise ValueError("occupations must cover all particles (dim = 2)")
    if x0_cm.device.type == "cpu":
        return metropolis_chains_plain(
            x0_cm, tau, seed, steps=steps, segments=segments, nx_occ=nx_occ,
            ny_occ=ny_occ, nx_dn=nx_dn, ny_dn=ny_dn, num_shells=num_shells,
            target=target, gain=gain, reinit=reinit, noise=noise,
            generator=generator)
    if len(nx) not in SUPPORTED_N or max(nx + ny) >= KMAX:
        raise ValueError(f"CUDA sampler built for n in {SUPPORTED_N} with "
                         f"quantum numbers < {KMAX}; got n={len(nx)}")
    return _chains_cuda(x0_cm, tau, int(seed), steps, segments, nx, ny, nup,
                        target, gain, reinit, noise)


def metropolis_free_fermion_chains(x0: torch.Tensor, seed: int, tau, steps: int,
                                   segments: int, nx_occ: tuple, ny_occ: tuple,
                                   num_shells: int = 3, nx_dn: tuple = (),
                                   ny_dn: tuple = (), target: float = 0.5,
                                   gain: float = 0.1, reinit: bool = False,
                                   noise=None, generator=None):
    """JAX-layout wrapper: x0 (B, n, dim) -> (xs (S, B, n, dim), logps (S, B),
    rates (S, B), tau_out (B,)), as the TPU function returns."""
    B, n, dim = x0.shape
    tau = torch.broadcast_to(torch.as_tensor(tau, dtype=x0.dtype, device=x0.device),
                             (B,)).contiguous()
    xs, logps, rates, tau_out = metropolis_chains(
        x0.reshape(B, n * dim).T.contiguous(), tau, seed, steps=steps,
        segments=segments, nx_occ=nx_occ, ny_occ=ny_occ, nx_dn=nx_dn,
        ny_dn=ny_dn, num_shells=num_shells, target=target, gain=gain,
        reinit=reinit, noise=noise, generator=generator)
    return xs.transpose(1, 2).reshape(segments, B, n, dim), logps, rates, tau_out
