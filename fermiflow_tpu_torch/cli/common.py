"""Shared CLI plumbing for the two drivers (port of
``fermiflow_tpu/cli/common.py``): flags, config, model builders, the
chunked training loop with checkpoints and the restart watchdog, and the
density movie.

Every flag of the JAX CLI is parsed.  ``--pallas-interpret`` has no CUDA
counterpart: ``config_from_args`` raises ``NotImplementedError`` for it
instead of ignoring it.

Multi-process runs (``parallel/mesh.py``): every rank runs the same command
with ``--coordinator HOST:PORT --num-processes W --process-id r``;
``maybe_init_distributed`` brings the process group up and forces
``--shard``, and ``--batch`` stays the global walker count.  Only rank 0
prints rows, writes ``--metrics``, traces ``--profile-dir`` and writes the
``--movie``; every rank runs every collective and checkpoint, on
replicated values, so all take the same branches.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import math
import time

import numpy as np
import torch

from fermiflow_tpu_torch import resolve_device
from fermiflow_tpu_torch.config import Config
from fermiflow_tpu_torch.flow import CNF
from fermiflow_tpu_torch.nn.backflow import (
    backflow_apply,
    backflow_divergence,
    backflow_init_zeros,
)
from fermiflow_tpu_torch.nn.backflow_derivs import backflow_field_tensors
from fermiflow_tpu_torch.ops.metropolis import (
    metropolis_multistate_cm,
    metropolis_single_cm,
)
from fermiflow_tpu_torch.physics import (
    HO2D,
    CoulombPairPotential,
    FreeFermion,
    HOPotential,
)
from fermiflow_tpu_torch.parallel.mesh import (
    all_sum,
    init_distributed,
    make_walker_mesh,
    process_index,
    shutdown_distributed,
)
from fermiflow_tpu_torch.utils.checkpointing import (
    named_tensors,
    restore_checkpoint,
    save_checkpoint,
)
from fermiflow_tpu_torch.utils.profiling import SPANS, trace
from fermiflow_tpu_torch.vmc import BetaVMC, GSVMC
from fermiflow_tpu_torch.vmc.gs import _detach

__all__ = ["add_flags", "config_from_args", "make_cnf", "build_gs",
           "build_beta", "restore", "run_training_loop", "derived_seed",
           "dump_density_movie", "maybe_init_distributed", "distributed",
           "walker_mesh"]


def add_flags(parser: argparse.ArgumentParser, finite_t: bool = False):
    d = Config()
    # Reference-compatible flags (src/FermionHO2D.py:18-30).
    parser.add_argument("--nup", type=int, default=d.nup)
    parser.add_argument("--ndown", type=int, default=d.ndown)
    parser.add_argument("--Z", type=float, default=d.Z)
    parser.add_argument("--Deta", type=int, default=d.d_eta)
    parser.add_argument("--nomu", action="store_true")
    parser.add_argument("--Dmu", type=int, default=d.d_mu)
    parser.add_argument("--t0", type=float, default=d.t0)
    parser.add_argument("--t1", type=float, default=d.t1)
    parser.add_argument("--iternum", type=int, default=d.iternum)
    parser.add_argument("--batch", type=int, default=d.batch)
    if finite_t:
        parser.add_argument("--beta", type=float, default=d.beta)
        parser.add_argument("--deltaE", type=float, default=d.deltaE)
        parser.add_argument("--boltzmann", action="store_true")
    # Extensions shared with the JAX driver.
    parser.add_argument("--lr", type=float, default=d.lr)
    parser.add_argument("--ode-steps", type=int, default=d.ode_steps)
    parser.add_argument("--ode-method", type=str, default=d.ode_method)
    parser.add_argument("--dtype", type=str, default=d.dtype,
                        choices=["float64", "float32"])
    parser.add_argument("--seed", type=int, default=d.seed)
    parser.add_argument("--equilibrium-steps", type=int,
                        default=d.equilibrium_steps)
    parser.add_argument("--mcmc-steps", type=int, default=d.mcmc_steps)
    parser.add_argument("--tau", type=float, default=d.tau)
    parser.add_argument("--persistent", action="store_true",
                        help="persistent walkers + per-walker tau adaptation")
    parser.add_argument("--steps-per-call", type=int, default=d.steps_per_call,
                        help="iterations per metrics fetch (ground state: "
                             "per multi-segment sampler launch when > 1); "
                             "metrics stay per-iteration")
    parser.add_argument("--metrics", type=str, default=None,
                        help="jsonl metrics output path")
    parser.add_argument("--device", type=str, default=d.device,
                        help="cuda (default; the kernels) or cpu (the plain "
                             "PyTorch versions)")
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="capture a torch.profiler trace of iterations "
                             "2-4 (of the second chunk when --steps-per-call "
                             "> 1) into this directory: trace.json and "
                             "summary.json")
    parser.add_argument("--divergence-window", type=int,
                        default=d.divergence_window,
                        help="trailing healthy-iteration window for the "
                             "divergence watchdog (0 disables)")
    parser.add_argument("--divergence-nsigma", type=float,
                        default=d.divergence_nsigma,
                        help="restore when the energy exceeds the window "
                             "mean by this many window standard deviations "
                             "(finite-divergence watchdog; <=0 disables)")
    parser.add_argument("--checkpoint-dir", type=str, default=None,
                        help="save the full training state here and resume "
                             "from its latest checkpoint at start")
    parser.add_argument("--checkpoint-every", type=int,
                        default=d.checkpoint_every,
                        help="iterations between checkpoints (chunks are "
                             "clipped to this cadence)")
    parser.add_argument("--max-restarts", type=int, default=d.max_restarts,
                        help="automatic recovery: on a non-finite or "
                             "diverged energy, restore the latest checkpoint "
                             "with reseeded chains, up to N times (requires "
                             "--checkpoint-dir)")
    parser.add_argument("--ode-solver", type=str, default=d.ode_solver,
                        choices=["fixed", "adaptive", "adjoint"],
                        help="generative-flow integrator (CNF.generate: the "
                             "nested-jvp path and the movie): fixed grid, "
                             "adaptive dopri5 (--rtol/--atol) or the "
                             "O(1)-memory adjoint")
    parser.add_argument("--rtol", type=float, default=d.rtol,
                        help="adaptive-solver relative tolerance")
    parser.add_argument("--atol", type=float, default=d.atol,
                        help="adaptive-solver absolute tolerance")
    parser.add_argument("--local-energy", type=str, default=d.local_energy,
                        choices=["auto", "hessian_flow", "nested_jvp"],
                        help="local-energy engine: the Hessian flow (the "
                             "kernel chain) or the nested-jvp Laplacian "
                             "through the reverse ODE (autograd gradient)")
    parser.add_argument("--movie", type=str, default=None,
                        help="after training, save density-movie trajectory "
                             "frames (.npy) to this path")
    parser.add_argument("--movie-frames", type=int, default=50)
    parser.add_argument("--movie-walkers", type=int, default=2000)
    parser.add_argument("--debug-nans", action="store_true",
                        help="autograd anomaly detection, and stop at the "
                             "first non-finite state tensor of a chunk")
    parser.add_argument("--no-pallas-sampler", action="store_true",
                        help="the plain samplers instead of kernels #1, #5 "
                             "and #7 (an A/B switch)")
    parser.add_argument("--no-pallas-local-energy", action="store_true",
                        help="the plain Hessian flow and an autograd "
                             "gradient instead of the VGH, Hessian-flow and "
                             "adjoint kernels (an A/B switch)")
    parser.add_argument("--no-pallas-reinforce", action="store_true",
                        help="the REINFORCE gradient by autograd through "
                             "the reverse-ODE logp instead of the adjoint "
                             "kernel (an A/B switch)")
    # The walker mesh (parallel/mesh.py): one process per rank.
    parser.add_argument("--shard", action="store_true",
                        help="split the walkers over the ranks of the "
                             "process group (a 1-rank mesh without one; "
                             "forced on a multi-process run)")
    parser.add_argument("--coordinator", type=str, default=None,
                        help="HOST:PORT of rank 0 for torch.distributed "
                             "(tcp://) bring-up")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--init-timeout", type=int, default=120,
                        help="seconds that bring-up, and every later "
                             "collective, may wait for the other ranks")
    # Parsed but refused by config_from_args.
    parser.add_argument("--pallas-interpret", action="store_true")


def config_from_args(args, finite_t: bool = False) -> Config:
    if args.pallas_interpret:
        raise NotImplementedError(
            "--pallas-interpret: the Pallas TPU interpreter has no CUDA "
            "counterpart; the port's kernels run on the card, their plain "
            "PyTorch versions on --device cpu")
    cfg = Config(
        nup=args.nup,
        ndown=args.ndown,
        Z=args.Z,
        d_eta=args.Deta,
        d_mu=None if args.nomu else args.Dmu,
        t0=args.t0,
        t1=args.t1,
        iternum=args.iternum,
        batch=args.batch,
        lr=args.lr,
        ode_steps=args.ode_steps,
        ode_method=args.ode_method,
        dtype=args.dtype,
        seed=args.seed,
        equilibrium_steps=args.equilibrium_steps,
        mcmc_steps=args.mcmc_steps,
        tau=args.tau,
        persistent_walkers=args.persistent,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        metrics_path=args.metrics,
        local_energy=args.local_energy,
        steps_per_call=args.steps_per_call,
        max_restarts=args.max_restarts,
        divergence_window=args.divergence_window,
        divergence_nsigma=args.divergence_nsigma,
        ode_solver=args.ode_solver,
        rtol=args.rtol,
        atol=args.atol,
        pallas_sampler=not args.no_pallas_sampler,
        pallas_local_energy=not args.no_pallas_local_energy,
        pallas_reinforce=not args.no_pallas_reinforce,
        device=args.device,
    )
    if finite_t:
        cfg.beta = args.beta
        cfg.deltaE = args.deltaE
        cfg.boltzmann = args.boltzmann
    return cfg


def maybe_init_distributed(args) -> bool:
    """Bring the process group up when the flags ask for one (before any
    tensor is made) and return whether this process is the primary one
    (rank 0).  A run of more than one process forces ``--shard``."""
    if init_distributed(args.coordinator, args.num_processes,
                        args.process_id, args.init_timeout, args.device):
        args.shard = True
    return process_index() == 0


@contextlib.contextmanager
def distributed(args):
    """``maybe_init_distributed`` for the body of a driver, yielding
    whether this process is the primary one; the process group it brought
    up, if any, is torn down after the body."""
    owned = not torch.distributed.is_initialized()
    try:
        yield maybe_init_distributed(args)
    finally:
        if owned:
            shutdown_distributed()


def walker_mesh(args, cfg: Config):
    """The walker mesh ``--shard`` asks for (None without it), on the
    device that ``cfg`` resolves to."""
    return make_walker_mesh(_device(cfg)) if args.shard else None


def _collectives_line(mesh, iterations: int) -> str | None:
    """What the mesh's collectives cost this process: count and host ms,
    in all and per iteration, and how many of them ran in replayed CUDA
    graphs (None without a process group)."""
    if mesh is None or mesh.group is None or iterations <= 0:
        return None
    count, ms = mesh.stats["count"], 1e3 * mesh.stats["seconds"]
    return (f"mesh: {mesh.world} ranks over {mesh.backend}, {count} "
            f"collectives in {ms:.3f} ms, {count / iterations:.1f} and "
            f"{ms / iterations:.4f} ms per iteration ({mesh.stats['replayed']}"
            f" of them in replayed chunks, timed by the replays' host "
            f"seconds)")


def make_cnf(cfg: Config) -> CNF:
    return CNF(
        velocity=backflow_apply,
        divergence=backflow_divergence,
        field_tensors=backflow_field_tensors,
        t0=cfg.t0,
        t1=cfg.t1,
        steps=cfg.ode_steps,
        method=cfg.ode_method,
        solver=cfg.ode_solver,
        rtol=cfg.rtol,
        atol=cfg.atol,
    )


def _device(cfg: Config):
    """The device ``cfg`` asks for; raises where it cannot run ``cfg``."""
    device = resolve_device(cfg.device)
    if device.type == "cuda" and cfg.dtype != "float32":
        raise ValueError("the CUDA kernels run in float32: pass --dtype "
                         "float32 (float64 runs on --device cpu)")
    return device


def build_gs(cfg: Config):
    """(model, identity-flow params on ``cfg.device``); raises where the
    device cannot run this configuration."""
    device = _device(cfg)
    model = GSVMC(cfg.nup, cfg.ndown, FreeFermion(HO2D()), make_cnf(cfg),
                  CoulombPairPotential(cfg.Z), HOPotential(),
                  laplacian_chunk=cfg.laplacian_chunk)
    params = backflow_init_zeros(cfg.d_eta, cfg.d_mu, dtype=cfg.torch_dtype(),
                                 device=device)
    return model, params


def build_beta(cfg: Config):
    """(model, {"flow": identity-flow params, "log_state_weights": Boltzmann
    or Gaussian logits (seed + 7)}) on ``cfg.device``; raises where the
    device cannot run this configuration."""
    device = _device(cfg)
    dtype = cfg.torch_dtype()
    orbitals = HO2D()
    model = BetaVMC(cfg.beta, cfg.nup, cfg.ndown, cfg.deltaE, orbitals,
                    FreeFermion(orbitals), make_cnf(cfg),
                    CoulombPairPotential(cfg.Z), HOPotential(),
                    laplacian_chunk=cfg.laplacian_chunk)
    gen = None if cfg.boltzmann else torch.Generator().manual_seed(cfg.seed + 7)
    params = {
        "flow": backflow_init_zeros(cfg.d_eta, cfg.d_mu, dtype=dtype,
                                    device=device),
        "log_state_weights": model.init_log_state_weights(
            cfg.boltzmann, generator=gen, dtype=dtype, device=device),
    }
    return model, params


def _diverged(cfg: Config, window: list, key: str, recs: list):
    """Finite-divergence check of ``recs`` against the trailing healthy
    ``window`` of (metric, metric_std): the reason, or None."""
    if (cfg.divergence_nsigma <= 0 or cfg.divergence_window <= 0
            or len(window) < cfg.divergence_window):
        return None
    vals = [w[0] for w in window]
    stds = sorted(w[1] for w in window)
    m = sum(vals) / len(vals)
    var = sum((v - m) ** 2 for v in vals) / len(vals)
    # Sigma floor: a fully converged window can have ~zero scatter; a
    # relative floor keeps the threshold meaningful there.
    s = max(var ** 0.5, 1e-3 * max(abs(m), 1.0))
    smed = stds[len(stds) // 2]
    for r in recs:
        v = float(r[key])
        if v > m + cfg.divergence_nsigma * s:
            return (f"divergence ({key}={v:.6g} > window mean {m:.6g} + "
                    f"{cfg.divergence_nsigma:g} x sigma {s:.3g})")
        vs = float(r.get(key + "_std", 0.0))
        if smed > 0 and math.isfinite(vs) and vs > 10.0 * smed:
            return (f"divergence ({key}_std={vs:.6g} > 10 x window "
                    f"median {smed:.6g})")
    return None


def _bad(cfg: Config, window: list, recs: list):
    """Why ``recs`` stop the run (a non-finite primary metric, F when the
    records have one, else E; or a finite divergence), or None."""
    key = "F" if "F" in recs[0] else "E"
    for r in recs:
        if not math.isfinite(float(r[key])):
            return f"non-finite energy ({key}={float(r[key])})"
    return _diverged(cfg, window, key, recs)


def _note_healthy(cfg: Config, window: list, recs: list) -> None:
    """Append healthy records to the trailing window, kept at
    ``divergence_window`` entries; a disabled check keeps it empty."""
    if cfg.divergence_window <= 0:
        return
    key = "F" if "F" in recs[0] else "E"
    window.extend((float(r[key]), float(r.get(key + "_std", 0.0)))
                  for r in recs)
    del window[:-cfg.divergence_window]


def derived_seed(generator: torch.Generator, salt: int) -> int:
    """A 63-bit seed that is a fixed function of ``generator``'s state and
    ``salt`` (the counterpart of ``jax.random.fold_in``); draws nothing."""
    h = hashlib.sha256(generator.get_state().numpy().tobytes())
    h.update(int(salt).to_bytes(8, "little"))
    return int.from_bytes(h.digest()[:8], "little") >> 1


def _reseed(state, salt: int) -> None:
    """Reseed the host generator, and the device one where the state has
    it, by a fixed function of the (restored) host generator and ``salt``."""
    seed = derived_seed(state.generator, salt)
    if state.device_generator is not None:
        state.device_generator.manual_seed(
            derived_seed(state.generator, salt + 2**32))
    state.generator.manual_seed(seed)


def _first_nonfinite(state):
    """The name of the first state tensor holding a NaN or inf, or None."""
    for name, t in named_tensors(state).items():
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            return name
    return None


def restore(state, cfg: Config, primary: bool = True):
    """Resume from ``cfg.checkpoint_dir``'s latest checkpoint, as the JAX
    drivers do at start: (state, start step), (state, 0) without one."""
    if not cfg.checkpoint_dir:
        return state, 0
    state, step = restore_checkpoint(cfg.checkpoint_dir, state)
    if step and primary:
        print(f"resumed from checkpoint step {step} in {cfg.checkpoint_dir}")
    return state, step


def run_training_loop(state, cfg: Config, make_chunk, logger, print_row,
                      profile_dir: str | None = None, start_step: int = 0,
                      debug_nans: bool = False, primary: bool = True,
                      mesh=None):
    """Drive iterations ``start_step`` + 1 .. ``cfg.iternum`` in chunks of
    ``cfg.steps_per_call``, clipped to the checkpoint cadence.

    ``make_chunk(K)`` returns the K-iteration function, made once per chunk
    length (a captured CUDA graph, ``train.py``) and made anew after a
    restore.  The metrics fetch
    at the end of a chunk waits for the device, so its wall time over K is
    the per-iteration speed; at K = 1 each row is timed from the previous
    row (``MetricsLogger.log``), and the first has no time.  Each chunk is checked whole before its rows
    are printed: a non-finite primary metric (F when the records have one,
    else E), or a finite divergence (the metric ``divergence_nsigma``
    window-sigmas above the mean of the trailing ``divergence_window``
    healthy iterations, or its per-walker std 10x over the window median)
    restores the latest checkpoint of ``cfg.checkpoint_dir`` with reseeded
    generators, up to ``cfg.max_restarts`` times, and otherwise raises
    ``FloatingPointError`` with the JAX CLI's message.  After the rows are
    printed, a chunk that ends on the cadence saves a checkpoint.  With
    ``profile_dir`` it traces chunks 2-4 at K = 1 (the JAX CLI's iterations
    2-4), else chunk 2: replays, on a captured path.  ``debug_nans`` turns on autograd's anomaly
    detection and raises ``FloatingPointError`` naming the first non-finite
    state tensor after a chunk.

    Each chunk's host path goes into ``utils.profiling.SPANS``, reset here
    and numbered by chunk from 1: ``loop.chunk`` around the chunk call,
    ``loop.wait`` and ``loop.fetch`` (the logger's), ``loop.watchdog``
    around the check and ``loop.print`` around the rows.

    On a walker ``mesh`` every rank runs the loop: the metrics are
    replicated, so all ranks stop, restore and reseed alike; the
    non-finite check of ``debug_nans`` is summed over ranks.  Only the
    ``primary`` rank prints and traces; at the end it prints the mesh's
    collectives (count, host ms, per iteration).
    """
    K = max(1, int(cfg.steps_per_call))
    last_traced = 4 if K == 1 else 2
    chunk_fns = {}
    window = []  # (metric, metric_std) of the trailing healthy iterations
    restarts = 0

    def recover(state, at_iter, reason):
        nonlocal restarts
        if not cfg.checkpoint_dir or restarts >= cfg.max_restarts:
            raise FloatingPointError(
                f"{reason} at iteration {at_iter}"
                + ("" if cfg.checkpoint_dir else " (no --checkpoint-dir)")
                + f"; {restarts}/{cfg.max_restarts} restarts used")
        restarts += 1
        state, step = restore_checkpoint(cfg.checkpoint_dir, state)
        if step == 0:
            # No checkpoint yet: the state is the diverged one, unchanged.
            raise FloatingPointError(
                f"{reason} at iteration {at_iter} before the first "
                f"checkpoint was written (nothing to restore)")
        # A new stream, so the retried trajectory differs from the one that
        # blew up; the window restarts from the restored point.  The restore
        # replaced Adam's state tensors: captured chunks are made anew.
        _reseed(state, 7919 + restarts)
        window.clear()
        chunk_fns.clear()
        if primary:
            print(f"WATCHDOG: {reason} at iteration {at_iter}; restored "
                  f"checkpoint step {step} with reseeded chains (restart "
                  f"{restarts}/{cfg.max_restarts})")
        return state, step

    i = start_step
    n_chunk = 0
    SPANS.reset()
    anomaly = (torch.autograd.set_detect_anomaly(True) if debug_nans
               else contextlib.nullcontext())
    with anomaly, contextlib.ExitStack() as profiling:
        while i < cfg.iternum:
            n_chunk += 1
            SPANS.chunk = n_chunk
            if profile_dir and primary and n_chunk == 2:
                profiling.enter_context(
                    trace(profile_dir, cuda=cfg.device != "cpu"))
            chunk = min(K, cfg.iternum - i)
            if cfg.checkpoint_dir:
                chunk = min(chunk, cfg.checkpoint_every
                            - i % cfg.checkpoint_every)
            fn = chunk_fns.get(chunk)
            if fn is None:
                fn = chunk_fns[chunk] = make_chunk(chunk)
            t0 = time.time()
            with SPANS.span("loop.chunk"):
                state, stacked = fn(state)
            if debug_nans:
                name = _first_nonfinite(state)
                bad = torch.tensor([float(name is not None)],
                                   device=state.walkers_cm.device)
                if float(all_sum(mesh, bad)) > 0:
                    raise FloatingPointError(
                        f"--debug-nans: non-finite "
                        f"{name or 'state tensor on another rank'} after "
                        f"iteration {i + chunk}")
            # At K = 1 one record an iteration, timed from the previous
            # one (the JAX loop's ``log``); else the chunk's rows, timed
            # from its start.
            rows = ([logger.log(i + 1, stacked)] if K == 1
                    else logger.log_many(i + 1, stacked, t0))
            if n_chunk == last_traced:
                profiling.close()
            with SPANS.span("loop.watchdog"):
                reason = _bad(cfg, window, rows)
                if not reason:
                    _note_healthy(cfg, window, rows)
            if reason:
                state, i = recover(state, i + chunk, reason)
                continue
            if primary:
                with SPANS.span("loop.print"):
                    for rec in rows:
                        print_row(rec)
            i += chunk
            if cfg.checkpoint_dir and i % cfg.checkpoint_every == 0:
                save_checkpoint(cfg.checkpoint_dir, i, state)
    line = _collectives_line(mesh, cfg.iternum - start_step)
    if primary and line:
        print(line)
    return state


def dump_density_movie(path: str, model, flow_params: dict,
                       generator: torch.Generator, nframes: int,
                       nwalkers: int, cfg: Config, state_logits=None):
    """Save generative-flow trajectory frames (nframes, nwalkers, n, dim)
    as .npy, the reference's density-movie path.

    The base walkers start Gaussian and equilibrate for
    ``cfg.equilibrium_steps`` at ``cfg.tau`` through the sampler wrappers
    (kernel #5, or #7 with ``state_logits``: each walker in a state drawn
    from their Categorical); every draw comes from ``generator``, on the
    parameters' device.
    """
    dim = model.basedist.dim
    d = model.n * dim
    dev = generator.device
    kw = dict(dtype=cfg.torch_dtype(), device=dev)
    z0 = torch.randn((d, nwalkers), generator=generator, **kw)
    tau = torch.full((nwalkers,), cfg.tau, **kw)
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator,
                             device=dev))
    if state_logits is not None:
        probs = torch.softmax(state_logits.detach(), dim=-1)
        state_idx = torch.multinomial(probs, nwalkers, replacement=True,
                                      generator=generator).to(torch.int32)
        nx_cm, ny_cm = model.qnums_cm(state_idx)
        z, _, _ = metropolis_multistate_cm(
            z0, tau, seed, steps=cfg.equilibrium_steps, nx_cm=nx_cm,
            ny_cm=ny_cm, num_shells=model._qnum_tables()[2])
    else:
        nx_up, ny_up, nx_dn, ny_dn, ks = model.occ_qnums()
        z, _, _ = metropolis_single_cm(
            z0, tau, seed, steps=cfg.equilibrium_steps, nx_occ=nx_up,
            ny_occ=ny_up, nx_dn=nx_dn, ny_dn=ny_dn, num_shells=ks)
    with torch.no_grad():
        frames = model.cnf.generate_trajectory(
            _detach(flow_params), z.T.reshape(nwalkers, model.n, dim), nframes)
    np.save(path, frames.cpu().numpy())
    print(f"density movie: saved {nframes} frames x {nwalkers} walkers to {path}")
    return frames
