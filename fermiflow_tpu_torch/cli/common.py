"""Shared CLI plumbing for the two drivers (port of
``fermiflow_tpu/cli/common.py``): flags, config, model builders and the
chunked training loop.

Flags whose machinery is not ported yet (sharding, checkpoints and restarts,
the adaptive/adjoint solvers, the nested-jvp engine, density movies) are
still parsed so that a command written for the JAX CLI fails loudly here:
``config_from_args`` raises ``NotImplementedError`` for them instead of
ignoring them.
"""

from __future__ import annotations

import argparse
import contextlib
import math
import time

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
from fermiflow_tpu_torch.physics import (
    HO2D,
    CoulombPairPotential,
    FreeFermion,
    HOPotential,
)
from fermiflow_tpu_torch.utils.profiling import trace
from fermiflow_tpu_torch.vmc import BetaVMC, GSVMC

__all__ = ["add_flags", "config_from_args", "make_cnf", "build_gs",
           "build_beta", "run_training_loop"]


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
                        help="stop when the energy exceeds the window "
                             "mean by this many window standard deviations "
                             "(finite-divergence watchdog; <=0 disables)")
    # Parsed but not ported: config_from_args refuses them.
    parser.add_argument("--shard", action="store_true")
    parser.add_argument("--checkpoint-dir", type=str, default=None)
    parser.add_argument("--max-restarts", type=int, default=d.max_restarts)
    parser.add_argument("--ode-solver", type=str, default=d.ode_solver,
                        choices=["fixed", "adaptive", "adjoint"])
    parser.add_argument("--local-energy", type=str, default=d.local_energy,
                        choices=["auto", "hessian_flow", "nested_jvp"])
    parser.add_argument("--movie", type=str, default=None)


def _refuse_unported(args):
    unported = {
        "--shard": args.shard,
        "--checkpoint-dir": args.checkpoint_dir is not None,
        "--max-restarts": args.max_restarts != 0,
        f"--ode-solver {args.ode_solver}": args.ode_solver != "fixed",
        "--local-energy nested_jvp": args.local_energy == "nested_jvp",
        "--movie": args.movie is not None,
    }
    asked = [flag for flag, on in unported.items() if on]
    if asked:
        raise NotImplementedError(
            f"{', '.join(asked)}: not ported to fermiflow_tpu_torch yet "
            "(see ROADMAP.md); use the JAX driver fermiflow_tpu.cli")


def config_from_args(args, finite_t: bool = False) -> Config:
    _refuse_unported(args)
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
        metrics_path=args.metrics,
        local_energy=args.local_energy,
        steps_per_call=args.steps_per_call,
        divergence_window=args.divergence_window,
        divergence_nsigma=args.divergence_nsigma,
        device=args.device,
    )
    if finite_t:
        cfg.beta = args.beta
        cfg.deltaE = args.deltaE
        cfg.boltzmann = args.boltzmann
    return cfg


def make_cnf(cfg: Config) -> CNF:
    return CNF(
        velocity=backflow_apply,
        divergence=backflow_divergence,
        field_tensors=backflow_field_tensors,
        t0=cfg.t0,
        t1=cfg.t1,
        steps=cfg.ode_steps,
        method=cfg.ode_method,
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
                  CoulombPairPotential(cfg.Z), HOPotential())
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
                    CoulombPairPotential(cfg.Z), HOPotential())
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


def run_training_loop(state, cfg: Config, make_chunk, logger, print_row,
                      profile_dir: str | None = None):
    """Drive ``cfg.iternum`` iterations in chunks of ``cfg.steps_per_call``.

    ``make_chunk(K)`` returns the K-iteration function.  The metrics fetch
    at the end of a chunk waits for the device, so its wall time over K is
    the per-iteration speed.  Each chunk is checked whole before its rows
    are printed: a non-finite primary metric (F when the records have one,
    else E), or a finite divergence (the metric ``divergence_nsigma``
    window-sigmas above the mean of the trailing ``divergence_window``
    healthy iterations, or its per-walker std 10x over the window median)
    raises ``FloatingPointError`` with the JAX CLI's message at
    ``max_restarts`` = 0 (no checkpoint restore is ported).  With
    ``profile_dir`` it traces chunks 2-4 at K = 1 (the JAX CLI's iterations
    2-4), else chunk 2.
    """
    K = max(1, int(cfg.steps_per_call))
    last_traced = 4 if K == 1 else 2
    chunk_fns = {}
    window = []  # (metric, metric_std) of the trailing healthy iterations
    i = n_chunk = 0
    with contextlib.ExitStack() as profiling:
        while i < cfg.iternum:
            n_chunk += 1
            if profile_dir and n_chunk == 2:
                profiling.enter_context(
                    trace(profile_dir, cuda=cfg.device != "cpu"))
            chunk = min(K, cfg.iternum - i)
            fn = chunk_fns.get(chunk)
            if fn is None:
                fn = chunk_fns[chunk] = make_chunk(chunk)
            t0 = time.time()
            state, stacked = fn(state)
            rows = logger.log_many(i + 1, stacked, t0)
            if n_chunk == last_traced:
                profiling.close()
            reason = _bad(cfg, window, rows)
            if reason:
                raise FloatingPointError(
                    f"{reason} at iteration {i + chunk} (no --checkpoint-dir)"
                    f"; 0/{cfg.max_restarts} restarts used")
            _note_healthy(cfg, window, rows)
            for rec in rows:
                print_row(rec)
            i += chunk
    return state
