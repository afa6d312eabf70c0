"""Metropolis samplers of the free-fermion base density.

Three kernels, each with its plain PyTorch version in this module (batched
over the same Hermite-table + pivoted-elimination log-density).  A plain
version runs only for CPU tensors; a CUDA tensor launches the kernel or
raises.

* ``metropolis_chains``: K segments with tau adapted between them.  Kernel
  ``csrc/metropolis.cu`` (replaces
  ``fermiflow_tpu/ops/pallas_metropolis.py:metropolis_free_fermion_chains``).
* ``metropolis_single_cm``: one fixed-tau chain, the per-iteration sampler.
  Kernel ``csrc/metropolis.cu``, entry ``ff_metropolis_free_fermion`` (the
  one-segment case of the kernel above; replaces ``metropolis_free_fermion``).
* ``metropolis_multistate_cm``: one fixed-tau chain with per-walker
  occupations, one spin sector.  Kernel ``csrc/metropolis_ms.cu`` (replaces
  ``metropolis_free_fermion_multistate``).

Each kernel walks a chain with a group of ``LANES`` lanes of a warp
(``csrc/sampler.cuh``: lane l owns particles l, l + LANES, ...), on the
Philox stream that one thread per chain would draw.

Each takes an optional ``noise = (normals, uniforms)`` so that a kernel and
its plain version can be compared on one random stream: for the chains
normals (segments, steps + 1, d, B) (slot ``steps`` feeds the ``reinit``
restart) and uniforms (segments, steps, B); for the single chains normals
(steps, d, B) and uniforms (steps, B).  Without it a kernel draws from
Philox keyed by ``seed`` and a plain version from a ``torch.Generator``
seeded with ``seed``: the two streams differ and are compared by
distribution.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from fermiflow_tpu_torch.ops import _build
from fermiflow_tpu_torch.ops.logdet import logabsdet
from fermiflow_tpu_torch.physics.orbitals import hermite_functions
from fermiflow_tpu_torch.physics.slater import slater_matrix_qnums

__all__ = ["metropolis_chains", "metropolis_chains_plain",
           "metropolis_free_fermion_chains", "metropolis_single_cm",
           "metropolis_single_cm_plain", "metropolis_free_fermion",
           "metropolis_multistate_cm", "metropolis_multistate_cm_plain",
           "metropolis_free_fermion_multistate", "slater_logp_qn",
           "slater_logp_ms", "ms_depth", "metropolis_occupancy",
           "metropolis_ms_occupancy", "SUPPORTED_N", "KMAX", "MS_DEPTHS",
           "LANES"]

SUPPORTED_N = (2, 3, 4, 5, 6)  # instantiations in csrc/*.cu
KMAX = 3  # Hermite orders the ground-state kernels tabulate (FF_KMAX)
MS_DEPTHS = (4, 5, 6, 8)  # Hermite depths the mixed-state kernels are built for
LANES = 8  # kSamplerLanes in csrc/sampler.cuh: lanes of a warp per chain


def ms_depth(num_shells: int) -> int:
    """The smallest compiled mixed-state Hermite depth covering num_shells."""
    for k in MS_DEPTHS:
        if num_shells <= k:
            return k
    raise ValueError(f"mixed-state CUDA kernels are built for Hermite depths "
                     f"up to {MS_DEPTHS[-1]}; got num_shells={num_shells}")


def metropolis_occupancy(n: int, batch: int) -> dict:
    """The chains kernel's launch (``metropolis_chains`` and
    ``metropolis_single_cm``) for n particles over ``batch`` walkers, as the
    library reports it: resident warps per SM, the warps of the grid its
    launcher makes, and lanes per chain (needs the card)."""
    return _build.occupancy("metropolis", n, batch)


def metropolis_ms_occupancy(n: int, num_shells: int, batch: int) -> dict:
    """``metropolis_occupancy`` of the mixed-state kernel (needs the card)."""
    return _build.occupancy("metropolis_ms", n, ms_depth(num_shells), batch)


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


def _chain_plain(x, logp, tau, logp_fn, steps, draws):
    """``steps`` Metropolis steps of walkers x (B, n, 2) at per-walker tau
    (B,); ``draws(t)`` gives step t's normals (B, n, 2) and uniforms (B,).
    Returns (x, logp, accept rate)."""
    acc = torch.zeros_like(logp)
    for t in range(steps):
        z, u = draws(t)
        xn = x + tau[:, None, None] * z
        lpn = logp_fn(xn)
        accept = u < torch.exp(torch.clamp(lpn - logp, max=0.0))
        x = torch.where(accept[:, None, None], xn, x)
        logp = torch.where(accept, lpn, logp)
        acc = acc + accept.to(acc.dtype)
    return x, logp, acc / max(steps, 1)


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
        x, logp, rate = _chain_plain(
            x, logp, tau, logp_fn, steps,
            lambda t: (to_walkers(normals(s, t)), uniform(s, t)))
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


# ---- one fixed-tau chain (the per-iteration ground-state sampler) ----


def metropolis_single_cm_plain(x0_cm: torch.Tensor, tau: torch.Tensor,
                               seed: int, *, steps: int, nx_occ: tuple,
                               ny_occ: tuple, nx_dn: tuple = (),
                               ny_dn: tuple = (), num_shells: int = 3,
                               noise=None,
                               generator: torch.Generator | None = None):
    """Plain PyTorch version of ``metropolis_single_cm`` (same arguments and
    returns), on any device: ``metropolis_chains_plain`` at one segment."""
    if noise is not None:
        noise = (noise[0][None], noise[1][None])
    xs, logps, rates, _ = metropolis_chains_plain(
        x0_cm, tau, seed, steps=steps, segments=1, nx_occ=nx_occ,
        ny_occ=ny_occ, nx_dn=nx_dn, ny_dn=ny_dn, num_shells=num_shells,
        noise=noise, generator=generator)
    return xs[0], logps[0], rates[0]


def _single_cuda(x0_cm, tau, seed, steps, nx, ny, nup, noise):
    d, B = x0_cm.shape
    n = d // 2
    normals, uniforms = noise if noise is not None else (None, None)
    _build.check_cuda_f32(x0=x0_cm, tau=tau, normals=normals, uniforms=uniforms)
    if tuple(tau.shape) != (B,):
        raise ValueError(f"tau must be ({B},), got {tuple(tau.shape)}")
    if normals is not None and (tuple(normals.shape) != (steps, d, B)
                                or tuple(uniforms.shape) != (steps, B)):
        raise ValueError("noise must be (normals (steps, d, B), "
                         "uniforms (steps, B))")
    out = dict(device=x0_cm.device, dtype=torch.float32)
    x = torch.empty((d, B), **out)
    logp = torch.empty((B,), **out)
    acc = torch.empty((B,), **out)
    fn = _build.library("metropolis").ff_metropolis_free_fermion
    fn.restype = ctypes.c_int
    ints = ctypes.c_int * n
    rc = fn(_build.ptr(x0_cm), _build.ptr(tau), _build.ptr(x), _build.ptr(logp),
            _build.ptr(acc), _build.ptr(normals), _build.ptr(uniforms),
            ctypes.c_int(B), ctypes.c_int(n), ctypes.c_int(nup), ints(*nx),
            ints(*ny), ctypes.c_uint(seed & 0xFFFFFFFF), ctypes.c_int(steps),
            _build.stream_ptr(x0_cm.device))
    _build.check_rc(rc, "metropolis_single")
    _build.LAUNCHES["metropolis_single"] += 1
    return x, logp, acc


def metropolis_single_cm(x0_cm: torch.Tensor, tau: torch.Tensor, seed: int, *,
                         steps: int, nx_occ: tuple, ny_occ: tuple,
                         nx_dn: tuple = (), ny_dn: tuple = (),
                         num_shells: int = 3, noise=None,
                         generator: torch.Generator | None = None):
    """One chain of ``steps`` Metropolis steps at fixed per-walker tau.

    x0_cm (d, B), tau (B,) -> x (d, B), logp (B,), accept rate (B,).
    Occupations and ``noise`` as for ``metropolis_chains`` (noise shapes in
    the module docstring).
    """
    nx = tuple(nx_occ) + tuple(nx_dn)
    ny = tuple(ny_occ) + tuple(ny_dn)
    if len(nx) * 2 != x0_cm.shape[0]:
        raise ValueError("occupations must cover all particles (dim = 2)")
    if x0_cm.device.type == "cpu":
        return metropolis_single_cm_plain(
            x0_cm, tau, seed, steps=steps, nx_occ=nx_occ, ny_occ=ny_occ,
            nx_dn=nx_dn, ny_dn=ny_dn, num_shells=num_shells, noise=noise,
            generator=generator)
    if len(nx) not in SUPPORTED_N or max(nx + ny) >= KMAX:
        raise ValueError(f"CUDA sampler built for n in {SUPPORTED_N} with "
                         f"quantum numbers < {KMAX}; got n={len(nx)}")
    return _single_cuda(x0_cm, tau, int(seed), steps, nx, ny, len(nx_occ),
                        noise)


def metropolis_free_fermion(x0: torch.Tensor, seed: int, tau, steps: int,
                            nx_occ: tuple, ny_occ: tuple, num_shells: int = 8,
                            nx_dn: tuple = (), ny_dn: tuple = (), noise=None,
                            generator=None):
    """JAX-layout wrapper: x0 (B, n, dim), tau scalar or (B,) -> (x (B, n, dim),
    logp (B,), accept_rate (B,)), as the TPU function returns."""
    B, n, dim = x0.shape
    tau = torch.broadcast_to(torch.as_tensor(tau, dtype=x0.dtype, device=x0.device),
                             (B,)).contiguous()
    x, logp, acc = metropolis_single_cm(
        x0.reshape(B, n * dim).T.contiguous(), tau, seed, steps=steps,
        nx_occ=nx_occ, ny_occ=ny_occ, nx_dn=nx_dn, ny_dn=ny_dn,
        num_shells=num_shells, noise=noise, generator=generator)
    return x.T.reshape(B, n, dim), logp, acc


# ---- one fixed-tau chain with per-walker occupations (finite T) ----


def slater_logp_ms(x: torch.Tensor, nx: torch.Tensor, ny: torch.Tensor,
                   num_shells: int) -> torch.Tensor:
    """2 log|det| with per-walker occupations, one spin sector.

    x (B, n, 2); nx, ny (B, n) integer quantum numbers: column j of walker
    b's Slater matrix holds orbital (nx[b, j], ny[b, j]).
    """
    return 2.0 * logabsdet(slater_matrix_qnums(x, nx, ny, num_shells),
                           tiny=1e-30)


def metropolis_multistate_cm_plain(x0_cm: torch.Tensor, tau: torch.Tensor,
                                   seed: int, *, steps: int,
                                   nx_cm: torch.Tensor, ny_cm: torch.Tensor,
                                   num_shells: int, noise=None,
                                   generator: torch.Generator | None = None):
    """Plain PyTorch version of ``metropolis_multistate_cm`` (same arguments
    and returns), on any device."""
    if noise is None and generator is None:
        generator = torch.Generator(x0_cm.device).manual_seed(int(seed))
    d, B = x0_cm.shape
    n = d // 2
    to_walkers = lambda a: a.T.reshape(B, n, 2)
    nx, ny = nx_cm.T, ny_cm.T
    logp_fn = lambda x: slater_logp_ms(x, nx, ny, num_shells)
    kw = dict(dtype=x0_cm.dtype, device=x0_cm.device)

    def draws(t):
        if noise is not None:
            return to_walkers(noise[0][t]), noise[1][t]
        z = torch.randn((d, B), generator=generator, **kw)
        return to_walkers(z), torch.rand((B,), generator=generator,
                                         **kw).clamp_min(1e-12)

    x = to_walkers(x0_cm)
    x, logp, rate = _chain_plain(x, logp_fn(x), tau, logp_fn, steps, draws)
    return x.reshape(B, d).T.contiguous(), logp, rate


def _multistate_cuda(x0_cm, tau, seed, steps, nx_cm, ny_cm, num_shells, noise):
    d, B = x0_cm.shape
    n = d // 2
    normals, uniforms = noise if noise is not None else (None, None)
    _build.check_cuda_f32(x0=x0_cm, tau=tau, normals=normals, uniforms=uniforms)
    _build.check_cuda_i32(nx=nx_cm, ny=ny_cm)
    if tuple(tau.shape) != (B,):
        raise ValueError(f"tau must be ({B},), got {tuple(tau.shape)}")
    if tuple(nx_cm.shape) != (n, B) or tuple(ny_cm.shape) != (n, B):
        raise ValueError(f"nx, ny must be ({n}, {B}) per-walker quantum numbers")
    if normals is not None and (tuple(normals.shape) != (steps, d, B)
                                or tuple(uniforms.shape) != (steps, B)):
        raise ValueError("noise must be (normals (steps, d, B), "
                         "uniforms (steps, B))")
    out = dict(device=x0_cm.device, dtype=torch.float32)
    x = torch.empty((d, B), **out)
    logp = torch.empty((B,), **out)
    acc = torch.empty((B,), **out)
    fn = _build.library("metropolis_ms").ff_metropolis_multistate
    fn.restype = ctypes.c_int
    P = _build.ptr
    rc = fn(P(x0_cm), P(tau), P(nx_cm), P(ny_cm), P(x), P(logp), P(acc),
            P(normals), P(uniforms), ctypes.c_int(B), ctypes.c_int(n),
            ctypes.c_int(ms_depth(num_shells)),
            ctypes.c_uint(seed & 0xFFFFFFFF), ctypes.c_int(steps),
            _build.stream_ptr(x0_cm.device))
    _build.check_rc(rc, "metropolis_multistate")
    _build.LAUNCHES["metropolis_multistate"] += 1
    return x, logp, acc


def metropolis_multistate_cm(x0_cm: torch.Tensor, tau: torch.Tensor,
                             seed: int, *, steps: int, nx_cm: torch.Tensor,
                             ny_cm: torch.Tensor, num_shells: int, noise=None,
                             generator: torch.Generator | None = None):
    """One fixed-tau chain per walker on its own Slater state's density.

    Args:
      x0_cm: (d, B) walker coordinates, walkers contiguous.
      tau: (B,) per-walker proposal scale.
      seed: stream seed (Philox key on the GPU; generator seed on the CPU).
      nx_cm, ny_cm: (n, B) int32 quantum numbers of each walker's occupied
        orbitals (one spin sector), all below ``num_shells``.
      num_shells: Hermite depth covering the quantum numbers.
      noise: optional shared random stream, see the module docstring.

    Returns:
      x (d, B), logp (B,), accept rate (B,).  On the GPU a walker with a
      quantum number outside the compiled depth comes back NaN.
    """
    if nx_cm.shape[0] * 2 != x0_cm.shape[0]:
        raise ValueError("occupations must cover all particles (dim = 2)")
    if x0_cm.device.type == "cpu":
        return metropolis_multistate_cm_plain(
            x0_cm, tau, seed, steps=steps, nx_cm=nx_cm, ny_cm=ny_cm,
            num_shells=num_shells, noise=noise, generator=generator)
    if nx_cm.shape[0] not in SUPPORTED_N:
        raise ValueError(f"CUDA sampler built for n in {SUPPORTED_N}; "
                         f"got n={nx_cm.shape[0]}")
    return _multistate_cuda(x0_cm, tau, int(seed), steps, nx_cm, ny_cm,
                            num_shells, noise)


def metropolis_free_fermion_multistate(x0: torch.Tensor, seed: int, tau,
                                       steps: int, nx: torch.Tensor,
                                       ny: torch.Tensor, num_shells: int = 8,
                                       noise=None, generator=None):
    """JAX-layout wrapper: x0 (B, n, dim), tau scalar or (B,), nx/ny (B, n)
    -> (x (B, n, dim), logp (B,), accept_rate (B,)), as the TPU function
    returns."""
    B, n, dim = x0.shape
    tau = torch.broadcast_to(torch.as_tensor(tau, dtype=x0.dtype, device=x0.device),
                             (B,)).contiguous()
    x, logp, acc = metropolis_multistate_cm(
        x0.reshape(B, n * dim).T.contiguous(), tau, seed, steps=steps,
        nx_cm=nx.T.to(torch.int32).contiguous(),
        ny_cm=ny.T.to(torch.int32).contiguous(), num_shells=num_shells,
        noise=noise, generator=generator)
    return x.T.reshape(B, n, dim), logp, acc
