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

Walker-axis data parallelism (``parallel/mesh.py``): each entry takes
``walker0``, the global index of its first walker, and its plain version
also ``global_batch``.  A kernel keys its Philox stream by (seed, walker0 +
walker); a plain version draws the global (d, B) normals and (B,) uniforms
and keeps its rows.  So a rank launching on its rows walks bitwise the
chains of those rows in the one-process launch, whatever the process
count; walker0 = 0 is the one-process stream.  This replaces the JAX
package's ``_per_shard_seed`` (seed + shard << 16), whose streams depend on
the shard count (the port's streams never matched JAX's).  The
``*_sharded`` entry points take a rank's rows in the JAX layout.

``seed`` is an ``int`` or a one-element int32 tensor on the walkers'
device holding the seed's 32 bits.  The kernels read it from device memory
at launch (an ``int`` is written to a new device word first), so a
captured CUDA graph that rewrites the word between replays draws a new
stream each time (``train.py``); a plain version reads its value.  Either
form of one value gives bitwise the same output.

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
from fermiflow_tpu_torch.parallel.mesh import sampler_rows
from fermiflow_tpu_torch.physics.orbitals import device_table, hermite_functions
from fermiflow_tpu_torch.physics.slater import slater_matrix_qnums

__all__ = ["metropolis_chains", "metropolis_chains_plain",
           "metropolis_free_fermion_chains", "metropolis_single_cm",
           "metropolis_single_cm_plain", "metropolis_free_fermion",
           "metropolis_multistate_cm", "metropolis_multistate_cm_plain",
           "metropolis_free_fermion_multistate",
           "metropolis_free_fermion_chains_sharded",
           "metropolis_free_fermion_sharded",
           "metropolis_free_fermion_multistate_sharded", "slater_logp_qn",
           "slater_logp_ms", "ms_depth", "metropolis_occupancy",
           "metropolis_ms_occupancy", "SUPPORTED_N", "MS_SUPPORTED_N",
           "gs_orders", "check_gs_occupation", "check_ms_occupation",
           "MS_DEPTHS", "LANES"]

# Particle counts of the ground-state kernels (metropolis.cu, slater_vgh.cu,
# hessian_flow.cu, reinforce.cu) and of the mixed-state ones
# (metropolis_ms.cu, slater_vgh_ms.cu).
SUPPORTED_N = tuple(range(2, 11))
MS_SUPPORTED_N = SUPPORTED_N
MS_DEPTHS = (4, 5, 6, 8)  # Hermite depths the mixed-state kernels are built for
LANES = 8  # kSamplerLanes in csrc/sampler.cuh: lanes of a warp per chain


def gs_orders(n: int) -> int:
    """Hermite orders 0..K-1 that the ground-state kernels tabulate at n
    particles (``gs_orders`` in csrc/common.cuh): the closed shells up to
    n = 6 use quantum numbers <= 2, those up to n = 10 <= 3."""
    return 3 if n <= 6 else 4


def check_gs_occupation(what: str, nx: tuple, ny: tuple) -> None:
    """Raise unless a ground-state kernel is built for this occupation."""
    n = len(nx)
    if n not in SUPPORTED_N or max(nx + ny) >= gs_orders(n):
        raise ValueError(
            f"CUDA {what} built for 2 ≤ N ≤ 10 with quantum numbers below 3 "
            f"(N ≤ 6) or 4 (N ≤ 10); got N={n}, largest quantum number "
            f"{max(nx + ny)}")


def ms_depth(num_shells: int) -> int:
    """The smallest compiled mixed-state Hermite depth covering num_shells."""
    for k in MS_DEPTHS:
        if num_shells <= k:
            return k
    raise ValueError(f"mixed-state CUDA kernels are built for Hermite depths "
                     f"up to {MS_DEPTHS[-1]}; got num_shells={num_shells}")


def check_ms_occupation(what: str, n: int, num_shells: int) -> None:
    """Raise unless a mixed-state kernel is built for n particles at a depth
    covering num_shells."""
    if n not in MS_SUPPORTED_N:
        raise ValueError(f"CUDA mixed-state {what} built for 2 ≤ N ≤ 10; "
                         f"got N={n}")
    ms_depth(num_shells)


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
    ix = device_table(nx, torch.long, x.device)
    iy = device_table(ny, torch.long, x.device)
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


def _seed_value(seed) -> int:
    """A plain version's generator seed from an ``int`` or a one-element
    int32 tensor (its 32 bits, read on the host)."""
    if isinstance(seed, torch.Tensor):
        return int(seed.reshape(-1)[0]) & 0xFFFFFFFF
    return int(seed)


def _seed_word(seed, device: torch.device) -> torch.Tensor:
    """The kernels' seed: the one-element int32 tensor the caller gave (on
    ``device``), or a new one holding an ``int``'s low 32 bits."""
    if isinstance(seed, torch.Tensor):
        if (seed.dtype != torch.int32 or seed.numel() != 1
                or seed.device != device or not seed.is_contiguous()):
            raise ValueError(f"seed must be a one-element contiguous int32 "
                             f"tensor on {device}, got {seed.dtype} "
                             f"{tuple(seed.shape)} on {seed.device}")
        return seed
    word = int(seed) & 0xFFFFFFFF
    return torch.full((1,), word - (1 << 32) if word >> 31 else word,
                      dtype=torch.int32, device=device)


def _global_rows(B: int, walker0: int, global_batch: int | None):
    """(global batch, slice of this launch's rows) of a plain sampler."""
    Bg = B if global_batch is None else int(global_batch)
    if not 0 <= walker0 <= Bg - B:
        raise ValueError(f"rows {walker0}..{walker0 + B} lie outside the "
                         f"global batch {Bg}")
    return Bg, slice(walker0, walker0 + B)


def metropolis_chains_plain(x0_cm: torch.Tensor, tau: torch.Tensor,
                            seed: int | torch.Tensor,
                            *, steps: int, segments: int, nx_occ: tuple,
                            ny_occ: tuple, nx_dn: tuple = (), ny_dn: tuple = (),
                            num_shells: int = 3, target: float = 0.5,
                            gain: float = 0.1, reinit: bool = False,
                            noise=None,
                            generator: torch.Generator | None = None,
                            walker0: int = 0, global_batch: int | None = None):
    """Plain PyTorch version of ``metropolis_chains`` (same arguments and
    returns), on any device.  Without ``noise`` it draws from ``generator``,
    or from a new one seeded with ``seed`` on the walkers' device: the
    ``global_batch`` (default B) walkers' draws, keeping rows
    ``walker0``.. of them."""
    nx = tuple(nx_occ) + tuple(nx_dn)
    ny = tuple(ny_occ) + tuple(ny_dn)
    nup = len(nx_occ)
    if noise is None and generator is None:
        generator = torch.Generator(x0_cm.device).manual_seed(
            _seed_value(seed))
    d, B = x0_cm.shape
    n = d // 2
    Bg, rows = _global_rows(B, walker0, global_batch)
    to_walkers = lambda a: a.T.reshape(B, n, 2)
    logp_fn = lambda x: slater_logp_qn(x, nx, ny, nup, num_shells)
    kw = dict(dtype=x0_cm.dtype, device=x0_cm.device)

    def normals(s, t):
        if noise is not None:
            return noise[0][s, t]
        return torch.randn((d, Bg), generator=generator, **kw)[:, rows]

    def uniform(s, t):
        if noise is not None:
            return noise[1][s, t]
        return torch.rand((Bg,), generator=generator,
                          **kw)[rows].clamp_min(1e-12)

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
                 reinit, noise, walker0=0):
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
    seed_word = _seed_word(seed, x0_cm.device)
    lib = _build.library("metropolis")
    fn = lib.ff_metropolis_chains
    fn.restype = ctypes.c_int
    ints = ctypes.c_int * n
    rc = fn(_build.ptr(x0_cm), _build.ptr(tau), _build.ptr(xs),
            _build.ptr(logps), _build.ptr(rates), _build.ptr(tau_out),
            _build.ptr(normals), _build.ptr(uniforms), ctypes.c_int(B),
            ctypes.c_int(n), ctypes.c_int(nup), ints(*nx), ints(*ny),
            _build.ptr(seed_word), ctypes.c_uint(walker0),
            ctypes.c_int(steps), ctypes.c_int(segments), ctypes.c_float(target),
            ctypes.c_float(gain), ctypes.c_int(int(reinit)),
            _build.stream_ptr(x0_cm.device))
    _build.check_rc(rc, "metropolis_chains")
    _build.LAUNCHES["metropolis_chains"] += 1
    return xs, logps, rates, tau_out


def metropolis_chains(x0_cm: torch.Tensor, tau: torch.Tensor,
                      seed: int | torch.Tensor, *,
                      steps: int, segments: int, nx_occ: tuple, ny_occ: tuple,
                      nx_dn: tuple = (), ny_dn: tuple = (), num_shells: int = 3,
                      target: float = 0.5, gain: float = 0.1,
                      reinit: bool = False, noise=None,
                      generator: torch.Generator | None = None,
                      walker0: int = 0, global_batch: int | None = None):
    """K segments of ``steps`` Metropolis steps, coordinate-major.

    Args:
      x0_cm: (d, B) walker coordinates, walkers contiguous.
      tau: (B,) per-walker proposal scale.
      seed: stream seed (Philox key on the GPU; generator seed on the CPU),
        an ``int`` or a one-element int32 tensor (module docstring).
      nx_occ/ny_occ (+ nx_dn/ny_dn): occupied orbitals' 1D quantum numbers
        of the spin-up (and spin-down) sector.
      target, gain: tau adaptation between segments (ignored with reinit).
      reinit: restart each segment after the first from fresh Gaussians.
      noise: optional shared random stream, see the module docstring.
      walker0, global_batch: the global index of the first walker, and the
        global walker count (the plain version's draws), see the module
        docstring.

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
            generator=generator, walker0=walker0, global_batch=global_batch)
    check_gs_occupation("sampler", nx, ny)
    return _chains_cuda(x0_cm, tau, seed, steps, segments, nx, ny, nup,
                        target, gain, reinit, noise, int(walker0))


def metropolis_free_fermion_chains(x0: torch.Tensor,
                                   seed: int | torch.Tensor, tau, steps: int,
                                   segments: int, nx_occ: tuple, ny_occ: tuple,
                                   num_shells: int = 3, nx_dn: tuple = (),
                                   ny_dn: tuple = (), target: float = 0.5,
                                   gain: float = 0.1, reinit: bool = False,
                                   noise=None, generator=None, walker0=0,
                                   global_batch=None):
    """JAX-layout wrapper: x0 (B, n, dim) -> (xs (S, B, n, dim), logps (S, B),
    rates (S, B), tau_out (B,)), as the TPU function returns."""
    B, n, dim = x0.shape
    tau = torch.broadcast_to(torch.as_tensor(tau, dtype=x0.dtype, device=x0.device),
                             (B,)).contiguous()
    xs, logps, rates, tau_out = metropolis_chains(
        x0.reshape(B, n * dim).T.contiguous(), tau, seed, steps=steps,
        segments=segments, nx_occ=nx_occ, ny_occ=ny_occ, nx_dn=nx_dn,
        ny_dn=ny_dn, num_shells=num_shells, target=target, gain=gain,
        reinit=reinit, noise=noise, generator=generator, walker0=walker0,
        global_batch=global_batch)
    return xs.transpose(1, 2).reshape(segments, B, n, dim), logps, rates, tau_out


# ---- one fixed-tau chain (the per-iteration ground-state sampler) ----


def metropolis_single_cm_plain(x0_cm: torch.Tensor, tau: torch.Tensor,

                               seed: int | torch.Tensor, *, steps: int,
                               nx_occ: tuple,
                               ny_occ: tuple, nx_dn: tuple = (),
                               ny_dn: tuple = (), num_shells: int = 3,
                               noise=None,
                               generator: torch.Generator | None = None,
                               walker0: int = 0,
                               global_batch: int | None = None):
    """Plain PyTorch version of ``metropolis_single_cm`` (same arguments and
    returns), on any device: ``metropolis_chains_plain`` at one segment."""
    if noise is not None:
        noise = (noise[0][None], noise[1][None])
    xs, logps, rates, _ = metropolis_chains_plain(
        x0_cm, tau, seed, steps=steps, segments=1, nx_occ=nx_occ,
        ny_occ=ny_occ, nx_dn=nx_dn, ny_dn=ny_dn, num_shells=num_shells,
        noise=noise, generator=generator, walker0=walker0,
        global_batch=global_batch)
    return xs[0], logps[0], rates[0]


def _single_cuda(x0_cm, tau, seed, steps, nx, ny, nup, noise, walker0=0):
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
    seed_word = _seed_word(seed, x0_cm.device)
    fn = _build.library("metropolis").ff_metropolis_free_fermion
    fn.restype = ctypes.c_int
    ints = ctypes.c_int * n
    rc = fn(_build.ptr(x0_cm), _build.ptr(tau), _build.ptr(x), _build.ptr(logp),
            _build.ptr(acc), _build.ptr(normals), _build.ptr(uniforms),
            ctypes.c_int(B), ctypes.c_int(n), ctypes.c_int(nup), ints(*nx),
            ints(*ny), _build.ptr(seed_word),
            ctypes.c_uint(walker0),
            ctypes.c_int(steps), _build.stream_ptr(x0_cm.device))
    _build.check_rc(rc, "metropolis_single")
    _build.LAUNCHES["metropolis_single"] += 1
    return x, logp, acc


def metropolis_single_cm(x0_cm: torch.Tensor, tau: torch.Tensor,
                         seed: int | torch.Tensor, *,
                         steps: int, nx_occ: tuple, ny_occ: tuple,
                         nx_dn: tuple = (), ny_dn: tuple = (),
                         num_shells: int = 3, noise=None,
                         generator: torch.Generator | None = None,
                         walker0: int = 0, global_batch: int | None = None):
    """One chain of ``steps`` Metropolis steps at fixed per-walker tau.

    x0_cm (d, B), tau (B,) -> x (d, B), logp (B,), accept rate (B,).
    Occupations, ``noise``, ``walker0`` and ``global_batch`` as for
    ``metropolis_chains`` (noise shapes in the module docstring).
    """
    nx = tuple(nx_occ) + tuple(nx_dn)
    ny = tuple(ny_occ) + tuple(ny_dn)
    if len(nx) * 2 != x0_cm.shape[0]:
        raise ValueError("occupations must cover all particles (dim = 2)")
    if x0_cm.device.type == "cpu":
        return metropolis_single_cm_plain(
            x0_cm, tau, seed, steps=steps, nx_occ=nx_occ, ny_occ=ny_occ,
            nx_dn=nx_dn, ny_dn=ny_dn, num_shells=num_shells, noise=noise,
            generator=generator, walker0=walker0, global_batch=global_batch)
    check_gs_occupation("sampler", nx, ny)
    return _single_cuda(x0_cm, tau, seed, steps, nx, ny, len(nx_occ),
                        noise, int(walker0))


def metropolis_free_fermion(x0: torch.Tensor,
                            seed: int | torch.Tensor, tau, steps: int,
                            nx_occ: tuple, ny_occ: tuple, num_shells: int = 8,
                            nx_dn: tuple = (), ny_dn: tuple = (), noise=None,
                            generator=None, walker0=0, global_batch=None):
    """JAX-layout wrapper: x0 (B, n, dim), tau scalar or (B,) -> (x (B, n, dim),
    logp (B,), accept_rate (B,)), as the TPU function returns."""
    B, n, dim = x0.shape
    tau = torch.broadcast_to(torch.as_tensor(tau, dtype=x0.dtype, device=x0.device),
                             (B,)).contiguous()
    x, logp, acc = metropolis_single_cm(
        x0.reshape(B, n * dim).T.contiguous(), tau, seed, steps=steps,
        nx_occ=nx_occ, ny_occ=ny_occ, nx_dn=nx_dn, ny_dn=ny_dn,
        num_shells=num_shells, noise=noise, generator=generator,
        walker0=walker0, global_batch=global_batch)
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
                                   seed: int | torch.Tensor, *, steps: int,
                                   nx_cm: torch.Tensor, ny_cm: torch.Tensor,
                                   num_shells: int, noise=None,
                                   generator: torch.Generator | None = None,
                                   walker0: int = 0,
                                   global_batch: int | None = None):
    """Plain PyTorch version of ``metropolis_multistate_cm`` (same arguments
    and returns), on any device."""
    if noise is None and generator is None:
        generator = torch.Generator(x0_cm.device).manual_seed(
            _seed_value(seed))
    d, B = x0_cm.shape
    n = d // 2
    Bg, rows = _global_rows(B, walker0, global_batch)
    to_walkers = lambda a: a.T.reshape(B, n, 2)
    nx, ny = nx_cm.T, ny_cm.T
    logp_fn = lambda x: slater_logp_ms(x, nx, ny, num_shells)
    kw = dict(dtype=x0_cm.dtype, device=x0_cm.device)

    def draws(t):
        if noise is not None:
            return to_walkers(noise[0][t]), noise[1][t]
        z = torch.randn((d, Bg), generator=generator, **kw)[:, rows]
        return to_walkers(z), torch.rand((Bg,), generator=generator,
                                         **kw)[rows].clamp_min(1e-12)

    x = to_walkers(x0_cm)
    x, logp, rate = _chain_plain(x, logp_fn(x), tau, logp_fn, steps, draws)
    return x.reshape(B, d).T.contiguous(), logp, rate


def _multistate_cuda(x0_cm, tau, seed, steps, nx_cm, ny_cm, num_shells, noise,
                     walker0=0):
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
    seed_word = _seed_word(seed, x0_cm.device)
    fn = _build.library("metropolis_ms").ff_metropolis_multistate
    fn.restype = ctypes.c_int
    P = _build.ptr
    rc = fn(P(x0_cm), P(tau), P(nx_cm), P(ny_cm), P(x), P(logp), P(acc),
            P(normals), P(uniforms), ctypes.c_int(B), ctypes.c_int(n),
            ctypes.c_int(ms_depth(num_shells)),
            P(seed_word), ctypes.c_uint(walker0),
            ctypes.c_int(steps), _build.stream_ptr(x0_cm.device))
    _build.check_rc(rc, "metropolis_multistate")
    _build.LAUNCHES["metropolis_multistate"] += 1
    return x, logp, acc


def metropolis_multistate_cm(x0_cm: torch.Tensor, tau: torch.Tensor,

                             seed: int | torch.Tensor, *, steps: int,
                             nx_cm: torch.Tensor,
                             ny_cm: torch.Tensor, num_shells: int, noise=None,
                             generator: torch.Generator | None = None,
                             walker0: int = 0, global_batch: int | None = None):
    """One fixed-tau chain per walker on its own Slater state's density.

    Args:
      x0_cm: (d, B) walker coordinates, walkers contiguous.
      tau: (B,) per-walker proposal scale.
      seed: stream seed (Philox key on the GPU; generator seed on the CPU),
        an ``int`` or a one-element int32 tensor (module docstring).
      nx_cm, ny_cm: (n, B) int32 quantum numbers of each walker's occupied
        orbitals (one spin sector), all below ``num_shells``.
      num_shells: Hermite depth covering the quantum numbers.
      noise: optional shared random stream, see the module docstring.
      walker0, global_batch: as for ``metropolis_chains``.

    Returns:
      x (d, B), logp (B,), accept rate (B,).  On the GPU a walker with a
      quantum number outside the compiled depth comes back NaN.
    """
    if nx_cm.shape[0] * 2 != x0_cm.shape[0]:
        raise ValueError("occupations must cover all particles (dim = 2)")
    if x0_cm.device.type == "cpu":
        return metropolis_multistate_cm_plain(
            x0_cm, tau, seed, steps=steps, nx_cm=nx_cm, ny_cm=ny_cm,
            num_shells=num_shells, noise=noise, generator=generator,
            walker0=walker0, global_batch=global_batch)
    check_ms_occupation("sampler", nx_cm.shape[0], num_shells)
    return _multistate_cuda(x0_cm, tau, seed, steps, nx_cm, ny_cm,
                            num_shells, noise, int(walker0))


def metropolis_free_fermion_multistate(x0: torch.Tensor,
                                       seed: int | torch.Tensor, tau,
                                       steps: int, nx: torch.Tensor,
                                       ny: torch.Tensor, num_shells: int = 8,
                                       noise=None, generator=None, walker0=0,
                                       global_batch=None):
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
        noise=noise, generator=generator, walker0=walker0,
        global_batch=global_batch)
    return x.T.reshape(B, n, dim), logp, acc


# ---- over a walker mesh: one launch per rank on its rows ----


def metropolis_free_fermion_chains_sharded(mesh, x0: torch.Tensor,
                                           seed: int | torch.Tensor,
                                           tau, steps: int, segments: int,
                                           nx_occ: tuple, ny_occ: tuple,
                                           num_shells: int = 3,
                                           nx_dn: tuple = (), ny_dn: tuple = (),
                                           target: float = 0.5,
                                           gain: float = 0.1,
                                           reinit: bool = False):
    """``metropolis_free_fermion_chains`` on this rank's rows x0 (B, n, dim)
    of a walker mesh (``parallel/mesh.py``): one launch, no collective, the
    rows' chains of the one-process launch bitwise (module docstring)."""
    return metropolis_free_fermion_chains(
        x0, seed, tau, steps, segments, nx_occ, ny_occ, num_shells, nx_dn,
        ny_dn, target, gain, reinit, **sampler_rows(mesh, x0.shape[0]))


def metropolis_free_fermion_sharded(mesh, x0: torch.Tensor,
                                    seed: int | torch.Tensor, tau,
                                    steps: int, nx_occ: tuple, ny_occ: tuple,
                                    num_shells: int = 8, nx_dn: tuple = (),
                                    ny_dn: tuple = ()):
    """``metropolis_free_fermion`` on this rank's rows of a walker mesh."""
    return metropolis_free_fermion(
        x0, seed, tau, steps, nx_occ, ny_occ, num_shells, nx_dn, ny_dn,
        **sampler_rows(mesh, x0.shape[0]))


def metropolis_free_fermion_multistate_sharded(mesh, x0: torch.Tensor,

                                               seed: int | torch.Tensor, tau,
                                               steps: int,
                                               nx: torch.Tensor,
                                               ny: torch.Tensor,
                                               num_shells: int = 8):
    """``metropolis_free_fermion_multistate`` on this rank's rows of a
    walker mesh; the occupations nx, ny (B, n) are the rows' own."""
    return metropolis_free_fermion_multistate(
        x0, seed, tau, steps, nx, ny, num_shells,
        **sampler_rows(mesh, x0.shape[0]))
