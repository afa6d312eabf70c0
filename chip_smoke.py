#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``fermiflow_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases; any failure ends the run with a non-zero exit code and no result:

  1. the card's name and power limit; every CUDA kernel built from
     ``fermiflow_tpu_torch/csrc`` (one nvcc per source, in parallel), with
     the build seconds and ptxas' register/spill report per kernel (the
     two Slater VGH kernels must not spill at N=6); the ``occupancy:``
     line, resident warps per SM of the Hessian flow and the REINFORCE
     adjoint at the paths' widths (each must reach 8) and their lane plans,
     of the three sampler entries with their lanes per chain and the warps
     per SM that the batch-8192 grid places (each must reach 7), and of
     the two VGH kernels with their lanes per walker and placed warps per
     SM (each must reach 8);
  2. each kernel against its plain PyTorch version on the card, at the
     paths' shapes (N=6, batch 8192, d_eta=d_mu=50, dopri5 with 4 steps,
     30 Metropolis steps per iteration, 10 sampler segments) on equilibrated
     walkers and Gaussian flow parameters; the samplers also on one shared
     random stream and by their distribution (acceptance at tau=0.1, logp
     against log_prob).  The finite-T kernels (mixed-state sampler and
     VGH) run on states drawn from the Boltzmann probabilities at beta=2,
     deltaE=2 (54 states).  A CUDA graph of 50 launches of each Slater VGH
     kernel, of the reduce pass and of ``Tensor.sum`` on its partials must
     recompute the captured output on replay;
  3. the oracles through the kernels: the identity flow at N=6, Z=0 gives
     Eloc = 14; at finite T (beta=2, deltaE=2, Boltzmann logits) every
     walker's Floc is the exact free energy 13.391808;
  4. the paths, each with every kernel's launch count set to 0 just before
     and read just after: the ground-state main path
     (``cli.ground_state.main``, 20 iterations, --nup 6 --Z 0.5 --batch 8192
     --dtype float32 --persistent --steps-per-call 10); the finite-T path
     (``cli.finite_t.main``, 20 iterations, --beta 2.0 --deltaE 2.0
     --boltzmann, otherwise alike); the ground-state per-iteration path
     (--steps-per-call 1, 3 iterations).  Each CLI runs its default, one
     captured CUDA graph a chunk (``train.py``);
  5. one ground-state and one finite-T update against the plain-PyTorch
     updates on the card;
  6. the ground state at N=10 (docs/VALIDATION.md:19): each ground-state
     kernel (chains, VGH, Hessian flow, adjoint and its block sum, single
     chain) against its plain version at N=10, batch 4096, with the same
     widths and steps (acceptance 0.633 at tau=0.1, the JAX sampler's);
     the identity-flow oracle (Z=0: Eloc = 30); the path through
     ``cli.ground_state.main`` with --nup 10 --Z 0.5 --batch 4096 --lr 3e-3
     --dtype float32 --persistent --steps-per-call 10 (20 iterations, every
     E finite and >= 41.0) and at --steps-per-call 1 (3 iterations); one
     update against the plain update.  Phase 1 also fails if an N=10
     instantiation of the ground-state kernels spills, and prints an
     ``occupancy: N=10`` line (lane plans, resident warps, the warps the
     batch-4096 grids place) held to the floors the designs set;
  7. the finite-T path at N=10 (docs/VALIDATION.md:20: beta=1, deltaE=4,
     1781 states, Hermite depth 8): the mixed-state sampler and VGH against
     their plain versions at batch 2048 on walkers the kernel equilibrated
     in Boltzmann-drawn states (acceptance at tau=0.1 on uniformly drawn
     states against the JAX sampler's 0.616); the Z=0 Boltzmann oracle
     (F = 25.831155, F_std 0, S = S_analytical); the path through
     ``cli.finite_t.main`` with --nup 10 --Z 0.5 --beta 1.0 --deltaE 4.0
     --boltzmann --batch 2048 --lr 3e-3 --dtype float32 --persistent
     --steps-per-call 10 (20 iterations, every F finite and >= 36.5, the
     first within 1.0 of the JAX CLI's 41.12); one update against the plain
     update.  Phase 1 also fails if an N=10 instantiation of the two
     mixed-state kernels spills, and prints an ``occupancy: finite-T N=10``
     line (resident warps, and whether the batch-2048 grids fit in one
     wave).

  8. restartable runs, the nested-jvp engine and the solvers (N=6), the
     runs through captured chunks, made anew after each restore: the GS
     path (batch 8192, K=10) for 30 iterations with checkpoints every 10,
     and again cut at 20, its checkpoint restored in this process bitwise
     (every tensor, Adam and both generators; the file size printed) and
     resumed to 30 in a fresh process of the CLI: rows 21-30 and the final
     checkpoint bitwise equal to the uninterrupted run's; the same for finite T (20 iterations, cut at 10);
     the fused GS chunks with chunk 2's metrics poisoned on the original
     stream, restored and completed at --max-restarts 1 (the WATCHDOG line),
     the JAX message at 0; the nested-jvp engine: the Z=0 identity oracle,
     E against the Hessian-flow kernels' within a tolerance measured on the
     CPU, 3 iterations of --local-energy nested_jvp (E in (17, 21), kernel
     #1 alone) and 1 at K=1 (#5 alone), at batch 8192 with its peak
     memory, through captured chunks; 2 iterations each at --ode-solver
     adaptive and adjoint (eager), the adjoint's gradient against the fixed
     grid's, the --movie frames against generate; the three --no-pallas-*
     flags (captured chunks) launching no kernel, their update against the
     kernel chain's within phase 5's bounds;
  9. the walker mesh (``parallel/mesh.py``, N=6): (a) the ground-state
     path of phase 4 at 20 iterations with checkpoints every 10, as 2
     ranks of a gloo process group sharing the card (two CLI processes,
     batch 8192 global) against one process: walkers and tau bitwise at
     steps 10 and 20, E within 1e-6 (first row) and 1e-4 (every row);
     (b) (a)'s step-10 shards resumed in one process, its step-20 walkers
     bitwise the one-process run's; (c) the finite-T path (10 iterations)
     as 2 ranks: F within 1e-6 (first row) and 1e-3 (every row); (d) one
     NCCL rank with --shard, 40 iterations (the warm-up chunk and three
     replays), its chunks captured (the collectives inside the graph,
     counted once per replay) against the same rank eager: rows and state
     bitwise; against the run without a process group: the first 20 E
     within 1e-6;
 10. converged physics at N=2 (the Taut anchors, docs/VALIDATION.md:195-218):
     (a) kernels #1-#5 against their plain versions at nup=1, ndown=1,
     batch 8192, with phase 2's tolerances (acceptance 0.894 at tau=0.1,
     the JAX sampler's); their rows on a ``phase 10 kernels (1, 1):`` line;
     (b) the Taut singlet (--nup 1 --ndown 1 --Z 1) and triplet (--nup 2
     --Z sqrt 3), 1000 iterations each of ``cli.ground_state.main`` at
     batch 8192, --ode-steps 8, lr 3e-3, K=10 (launch counts reset before
     each): the mean E of rows 701-1000 in (2.998, 3.03) and (3.999, 4.01),
     the exact 3 and 4 less ~4 sem above (a wrong Laplacian falls below);
     (c) ``cli.eval_at_checkpoint`` on the singlet's final checkpoint, both
     engines, 2 rounds of fresh chains: E within 3 combined sems + 0.005
     of (b)'s tail, the engines within phase 8's nested-jvp tolerance of
     each other on the same walkers.  The phase's seconds on a line of
     their own;
 11. strong coupling (the crossover, docs/VALIDATION.md:23-96): (a)
     ``FreeFermion.sample(use_pallas=True)`` at 32768 walkers, 600 steps at
     tau=0.1, through kernel #5 (one launch) against the plain sampler on
     the card by distribution (<sum x^2> within 5 standard errors,
     acceptance within 0.01); (b) the ground-state path
     at N=6, Z=8, batch 8192, ode 4, K=10, lr 3e-3, 300 iterations (launch
     counts reset before): the mean E of rows 281-300 in [60.9, 61.8]; (c)
     ``cli.crossover_analysis`` at (b)'s checkpoint (32768 walkers):
     2 pi sum r n(r) dr = N x (share inside rmax) to 1e-6 and V_int against
     a float64 recomputation on the same walkers to rtol 1e-5.
 12. the compiled chunk (``train.py``): (a) the captured chunk against the
     eager one from the same seed, side by side, 3 chunks each (the first
     eager, then two replays): GS N=6 at K=10 (30 iterations) and K=1 (3), finite T N=6 at
     K=10 (30), each with persistent walkers and with fresh ones (the CLIs'
     default: every iteration 100 steps at tau 0.1 from Gaussians drawn on
     the card); after every chunk the walkers, tau, the flow's parameters
     and logits, the states and their probabilities, Adam's step and both
     moments, both generators and every metric bitwise equal; (b) the
     captured chunk alone for 25 chunks of K=10 (250 iterations), or 250
     of K=1, every E or F finite, at GS N=6, GS N=10 (batch 4096), finite
     T N=6 and finite T N=10 (batch 2048), and with fresh walkers at GS
     N=6 (K=10 and K=1) and finite T N=6; (c) the CLI's ``--profile-dir``
     trace of chunk 2, a replay, of the four persistent paths and the
     fresh GS N=6 path: the kernels the card ran, ``cudaGraphLaunch``,
     ``cudaLaunchKernel`` and ``cudaStreamSynchronize`` calls, the kernels
     launched outside a graph, the host-to-card copies' bytes and the
     run's launches per kernel; the GS N=6 replay must be one graph
     launch, at most 10 launches and no wait for the card before the
     replay's end, the fresh one the same with no launch of its own but
     the registered device generator's two fills and no host-to-card copy
     beyond the seed word.  A line ``phase 12 traces:`` holds (c) as JSON.
     Then (a) and (c) of the autograd A/B paths, captured as the kernel
     chain is: (a) GS K=10 and finite T K=10 with every ``--no-pallas-*``
     flag, GS K=3 on the nested-jvp engine and GS K=10 with
     ``--no-pallas-reinforce`` alone, 3 chunks captured and eager side by
     side after each of which every state tensor, Adam, both generators
     and every metric are bitwise equal, with persistent walkers at batch
     8192 and with fresh ones at batch 2048; (c) the trace of a replayed
     chunk 2 of the ``--no-pallas-reinforce`` path, held to one graph
     launch, no launch but the registered generator's fills, no
     host-to-card copy but the seed word and no wait before the replay's
     end, on a line ``phase 12 A/B trace:``.

Kernel times come from ``kernel_turns.py``, the paths' from ``portbench/``.

The kernels JSON line has a row per kernel at N=6 and, named ``<kernel>_n10``,
at N=10 (with ptxas' registers, stack and spill bytes).
The last lines of standard output are the kernels JSON line, the card line
and ``{"ok": true, "device": {...}}``.  With no CUDA device, or without the
repository beside it, the script exits non-zero before printing any of them.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import subprocess
import sys
import tempfile
import time

SEED = 1234
N, BATCH, D_ETA, D_MU = 6, 8192, 50, 50
ODE_STEPS, SEGMENTS, MCMC_STEPS = 4, 10, 30
PARAM_STD = 0.1  # Gaussian flow weights: a field well away from the identity
# At N=10 each particle has 9 partners and the field grows with them: at
# 0.1 a draw of the weights took the walkers up to ~1e5 apart (E ~ 2e10),
# where f32 itself cannot hold the update to 1e-4 of an f32 plain chain;
# at 0.03 the field is still far from the identity (the update phases print
# its E), and f32 holds the updates to those bounds.
PARAM_STD_N10 = 0.03
MAIN_ITERS = 20
SINGLE_ITERS = 3  # the ground-state per-iteration path
ACCEPT_TAU01 = 0.72  # the JAX sampler's acceptance at tau=0.1, N=6
# The JAX mixed-state sampler's acceptance at tau=0.1, N=6, on uniformly
# drawn deltaE=2 states (BENCH_r05.json "mixed_state_accept").
ACCEPT_MS_TAU01 = 0.732
BETA, DELTA_E = 2.0, 2.0
F_EXACT_N6 = 13.391808  # E0 - log sum_s exp(-beta (E_s - E0)) / beta, E0 = 14
# The ground state at N = 10 (docs/VALIDATION.md:19): Z = 0.5, batch 4096,
# lr 3e-3, the same widths, ODE and sampler settings as the N = 6 cell.
N10, BATCH10, LR10 = 10, 4096, "3e-3"
# The JAX sampler's acceptance at tau=0.1, N=10 (BENCH_r05.json
# "n10_sampler_accept").
ACCEPT_TAU01_N10 = 0.633
# The JAX package's converged N=10 energy is 41.5519 (docs/VALIDATION.md:19):
# every variational energy lies above it less Monte Carlo error.  No top:
# the first Adam steps at lr 3e-3 from the identity flow move the energy
# far up and back (the plain versions on the CPU take the same path).
E_RANGE_N10 = (41.0, math.inf)
# The finite-T path at N = 10 (docs/VALIDATION.md:20): beta 1, deltaE 4
# (1781 states, quantum numbers to 7: Hermite depth 8), Z = 0.5, Boltzmann
# logits, batch 2048, lr 3e-3, the same widths, ODE and sampler settings.
BETA10, DELTA_E10, BATCH_BETA10, LR_BETA10 = 1.0, 4.0, 2048, "3e-3"
F_EXACT_BETA10 = 25.831155  # E0 - log sum_s exp(-beta (E_s - E0)) / beta, E0 = 30
# The JAX package's mixed-state sampler (its plain XLA version, on a CPU) at
# tau=0.1 on uniformly drawn states of the 1781 after 300 steps at tau=0.2
# from Gaussians, the protocol of phase_kernels_ms: 0.6165 and 0.6159 over
# 8192 walkers each (tests/test_torch_beta_n10.py recomputes it).
ACCEPT_MS_TAU01_N10 = 0.616
# The JAX CLI's first iteration of that run (validation/runs/beta_n10_de4.jsonl,
# step 1: F 41.1228 from Gaussian walkers after 30 steps), and the converged
# F, 37.2113, less a margin: no variational F of the run falls below it.
F_FIRST_BETA10, F_FLOOR_BETA10 = 41.12, 36.5

# Phase 10: the Taut anchors (docs/VALIDATION.md:195-218) at the
# production protocol, 1000 iterations each.  The JAX sampler's acceptance
# at tau=0.1 for nup=1, ndown=1 after 300 steps at tau=0.2 from Gaussians:
# 0.8944 and 0.8946 over 8192 walkers (tests/test_torch_eval.py recomputes
# it).  The gates on the mean E of rows 701-1000: the exact energy less
# about 4 sem below, the JAX records' 3.0086 and 4.0012 over the same rows
# well inside above.
ACCEPT_TAU01_11 = 0.894
TAUT_ITERS, TAUT_TAIL = 1000, 300
TAUT = {
    "singlet": dict(argv=["--nup", "1", "--ndown", "1", "--Z", "1.0",
                          "--divergence-window", "0"], e_range=(2.998, 3.03)),
    "triplet": dict(argv=["--nup", "2", "--Z", "1.7320508075688772"],
                    e_range=(3.999, 4.01)),
}
EVAL_REPS, EVAL_EQUIL = 2, 600

# Phase 11: strong coupling, the paper's crossover (docs/VALIDATION.md:23-96).
# (a) fresh draws at the crossover analysis' size and length; (b) the GS
# path at Z = 8 under the r3 protocol (lr 3e-3) at ode 4: the JAX r3 record
# (validation/runs/gs_n6_z80_r3.jsonl, ode 8) has a mean E of 61.31 over
# rows 281-300, the identity flow ~85.7; (c) the structure at (b)'s
# checkpoint, its V_int against a float64 recomputation on the same walkers.
XOVER_Z, XOVER_ITERS, XOVER_TAIL = 8.0, 300, 20
XOVER_E_RANGE = (60.9, 61.8)
XOVER_WALKERS, XOVER_EQUIL = 32768, 600
XOVER_NORM_TOL, XOVER_VINT_RTOL = 1e-6, 1e-5

REPLACES = {
    "metropolis_chains": "fermiflow_tpu/ops/pallas_metropolis.py:461",
    "slater_vgh": "fermiflow_tpu/ops/pallas_slater_vgh.py:352",
    "hessian_flow": "fermiflow_tpu/ops/pallas_hessian_flow.py:387",
    "reinforce_adjoint": "fermiflow_tpu/ops/pallas_reinforce.py:341",
    # The TPU kernel summed the theta rows across walker blocks in one
    # revisited output block (sequential grid); here a second kernel does.
    "reinforce_reduce": "fermiflow_tpu/ops/pallas_reinforce.py:319",
    "metropolis_single": "fermiflow_tpu/ops/pallas_metropolis.py:298",
    "slater_vgh_ms": "fermiflow_tpu/ops/pallas_slater_vgh.py:470",
    "metropolis_multistate": "fermiflow_tpu/ops/pallas_metropolis.py:640",
}
SOURCES = {
    "metropolis_chains": "fermiflow_tpu_torch/csrc/metropolis.cu",
    "slater_vgh": "fermiflow_tpu_torch/csrc/slater_vgh.cu",
    "hessian_flow": "fermiflow_tpu_torch/csrc/hessian_flow.cu",
    "reinforce_adjoint": "fermiflow_tpu_torch/csrc/reinforce.cu",
    "reinforce_reduce": "fermiflow_tpu_torch/csrc/reinforce.cu",
    "metropolis_single": "fermiflow_tpu_torch/csrc/metropolis.cu",
    "slater_vgh_ms": "fermiflow_tpu_torch/csrc/slater_vgh_ms.cu",
    "metropolis_multistate": "fermiflow_tpu_torch/csrc/metropolis_ms.cu",
}
# The path whose launch counts each kernel's row reports; the N=10 rows
# (name + "_n10") report the N=10 paths'.
PATH_OF = {
    "metropolis_chains": "gs", "slater_vgh": "gs", "hessian_flow": "gs",
    "reinforce_adjoint": "gs", "reinforce_reduce": "gs",
    "metropolis_single": "gs_single", "slater_vgh_ms": "beta",
    "metropolis_multistate": "beta",
    "metropolis_chains_n10": "gs_n10", "slater_vgh_n10": "gs_n10",
    "hessian_flow_n10": "gs_n10", "reinforce_adjoint_n10": "gs_n10",
    "reinforce_reduce_n10": "gs_n10", "metropolis_single_n10": "gs_single_n10",
    "slater_vgh_ms_n10": "beta_n10", "metropolis_multistate_n10": "beta_n10",
}


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    print(("PASS " if ok else "FAIL ") + what, flush=True)
    if not ok:
        raise SmokeFailure(what)


def captured(fn, reps: int = 50):
    """A CUDA graph that captures ``reps`` launches of ``fn``.  Fails unless
    a replay recomputes the last captured output (proof that the launch was
    captured).  Returns (the graph, that output)."""
    import torch

    expected = fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            out = fn()
    out.fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    check(torch.equal(out, expected), "graph replay recomputes the captured "
          "launch's output")
    return graph, out


def maxabs(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def allclose64(a, b, rtol: float, atol: float) -> bool:
    import torch

    return bool(torch.allclose(a.double(), b.double(), rtol=rtol, atol=atol))


def logp_violations(lp, lp_ref) -> float:
    """Fraction of walkers whose logp is off the f64 reference by more than
    1e-3 relative."""
    err = (lp.double() - lp_ref).abs()
    return float((err > 1e-3 * lp_ref.abs().clamp_min(1.0)).double().mean())


VGH_TOLERANCE = ("vs f64 plain: y 2e-4, g 3e-3, H 5e-3 (rtol=atol), <=0.1% of "
                 "entries outside")
SINGLE_CHAIN_TOLERANCE = ("x exact; rate 1e-6; logp 1e-3; <=0.1% walkers "
                          "diverged by accept flips")


def vgh_against_plain(what, out_k, out_p, out_r):
    """A Slater VGH kernel's (y, g, H) against its plain version in f32
    (out_p) and f64 (out_r): returns (max error vs f64, max error vs f32)."""
    import torch

    viol = {}
    for name, k, r, tol in zip(("y", "g", "H"), out_k, out_r,
                               (2e-4, 3e-3, 5e-3)):
        bad = ~torch.isclose(k.double(), r, rtol=tol, atol=tol)
        viol[name] = float(bad.double().mean())
    err_p = max(maxabs(k, p) for k, p in zip(out_k, out_p))
    err_r = max(maxabs(k, r) for k, r in zip(out_k, out_r))
    print(f"{what}: max|kernel - plain f32| {err_p:.3e}, "
          f"max|kernel - plain f64| {err_r:.3e}, violations {viol}")
    check(max(viol.values()) <= 1e-3, f"{what}: y/g/H within 2e-4/3e-3/5e-3 "
          "of the f64 plain version on >= 99.9% of entries")
    return err_r, err_p


def flow_grads_close(g_k, g_p):
    """(max |difference|, all within rtol 1e-4, atol 1e-6) over the flow
    gradient leaves."""
    worst, ok = 0.0, True
    for m in ("eta", "mu"):
        for k in ("w2", "w1", "b1"):
            worst = max(worst, maxabs(g_k[m][k], g_p[m][k]))
            ok &= allclose64(g_k[m][k], g_p[m][k], 1e-4, 1e-6)
    return worst, ok


def ptxas_kernels(report: str):
    """[(kernel<template args>, registers, stack bytes, spill stores, spill
    loads)] from an ``nvcc -Xptxas -v`` report."""
    out, name, frame = [], None, (0, 0, 0)
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            k = re.search(r"\d+([a-z_]+_kernel)I((?:Li\d+E)+)E", m.group(1))
            name = (f"{k.group(1)}<{','.join(re.findall(r'Li(\d+)E', k.group(2)))}>"
                    if k else m.group(1))
            frame = (0, 0, 0)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            frame = tuple(int(v) for v in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1))) + frame)
            name = None
    return out


# The ground-state kernels' N=10 instantiations (lanes per walker in the
# Hessian flow's and the adjoint's template arguments): none may spill.
N10_PTXAS = {"metropolis_chains": "metropolis_chains_kernel<10>",
             "metropolis_single": "metropolis_chains_kernel<10>",
             "slater_vgh": "slater_vgh_kernel<10>",
             "hessian_flow": "hessian_flow_kernel<10,32>",
             "reinforce_adjoint": "reinforce_kernel<10,16>"}
N10_KERNELS = tuple(sorted(set(N10_PTXAS.values())))
# The mixed-state kernels' N=10 instantiations at the finite-T path's depth;
# phase 1 holds every depth of N=10 to no spills.
MS_N10_PTXAS = {"metropolis_multistate": "metropolis_ms_kernel<10,8>",
                "slater_vgh_ms": "slater_vgh_ms_kernel<10,8>"}


def phase_build():
    """Build every source; returns {kernel<args>: (registers, stack, spill
    stores, spill loads)} from ptxas."""
    from fermiflow_tpu_torch.ops import _build

    t0 = time.perf_counter()
    per_source = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s wall, per source "
          + json.dumps({k: round(v, 1) for k, v in per_source.items()}),
          flush=True)
    spills, ptxas = {}, {}
    for name in _build.SOURCES:
        _build.library(name)
        report = _build.BUILD_DIR / f"{name}.ptxas.txt"
        if report.exists():
            for kern, regs, stack, st, ld in ptxas_kernels(report.read_text()):
                print(f"ptxas {name}: {kern}: {regs} registers, stack {stack} "
                      f"B, spill stores {st} B, spill loads {ld} B")
                ptxas[kern] = (regs, stack, st, ld)
                if kern.startswith((f"slater_vgh_kernel<{N}>",
                                    f"slater_vgh_ms_kernel<{N},")):
                    spills[kern] = st + ld
    # Every build leaves its report beside the library.
    check(bool(spills) and not any(spills.values()), "slater_vgh, "
          f"slater_vgh_ms: no spills at N={N} ({len(spills)} instantiations)")
    check(all(k in ptxas and ptxas[k][2] + ptxas[k][3] == 0
              for k in N10_KERNELS),
          "ground-state kernels: no spills at N=10 (" + ", ".join(N10_KERNELS)
          + ")")
    ms10 = [k for k in ptxas if k.startswith(("metropolis_ms_kernel<10,",
                                              "slater_vgh_ms_kernel<10,"))]
    check(len(ms10) == 8 and all(ptxas[k][2] + ptxas[k][3] == 0 for k in ms10),
          "mixed-state kernels: no spills at N=10, depths 4, 5, 6, 8 ("
          + ", ".join(sorted(ms10)) + ")")
    return ptxas


def phase_occupancy(device):
    """Resident warps per SM of the lane-group kernels at the paths' widths,
    and the warps per SM that the samplers' batch-8192 grids place."""
    import torch

    from fermiflow_tpu_torch.ops import hessian_flow as hf
    from fermiflow_tpu_torch.ops import metropolis as mp
    from fermiflow_tpu_torch.ops import reinforce as rf
    from fermiflow_tpu_torch.ops import slater_vgh as sv

    _, _, kms = make_beta_model(0.0, device)[0]._qnum_tables()
    chains = mp.metropolis_occupancy(N, BATCH)
    launches = {"metropolis_chains": chains, "metropolis_single": chains,
                "metropolis_multistate": mp.metropolis_ms_occupancy(N, kms,
                                                                    BATCH),
                "slater_vgh": sv.slater_vgh_occupancy(N, BATCH),
                "slater_vgh_ms": sv.slater_vgh_ms_occupancy(N, kms, BATCH)}
    warps = {"hessian_flow": hf.hessian_flow_occupancy(N, D_ETA, D_MU),
             "reinforce_adjoint": rf.reinforce_occupancy(N, D_ETA, D_MU),
             **{k: v["warps_per_sm"] for k, v in launches.items()}}
    # The lane-group grids as their launchers make them, over the SMs, and
    # no more than can be resident at once.
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    placed = {k: min(v["grid_warps"], v["warps_per_sm"] * sms) / sms
              for k, v in launches.items()}
    lanes = {k: v["lanes"] for k, v in launches.items()}
    plan = hf.lane_plan(N)
    rplan = rf.lane_plan(N, D_ETA, D_MU)
    units = [len(items) for items in rplan["eta_units"][0]]
    print(f"occupancy: {json.dumps(warps)} resident warps per SM; "
          f"hessian_flow: {hf.lanes_for(N)} lanes per walker, per lane "
          f"{plan['entries'][1]} state entries, {plan['mlp_inputs'][1]} MLP "
          f"input slots (pairs, then one-body) in one hidden-unit loop; "
          f"reinforce_adjoint: "
          f"{rf.lanes_for(N)} lanes per walker, per lane {rplan['entries'][1]} state "
          f"entries, eta/mu hidden units {units} by lane and the last "
          f"{rplan['eta_last'][1]} on every lane, coefficient totals "
          f"of {rplan['pairs'][1]} pair and {rplan['one_body'][1]} one-body "
          f"inputs; samplers and VGH kernels: lanes per chain or walker "
          f"{json.dumps(lanes)}, the batch-{BATCH} grid places "
          f"{json.dumps(placed)} warps per SM on {sms} SMs", flush=True)
    for name in ("hessian_flow", "reinforce_adjoint"):
        check(warps[name] >= 8, f"{name}: >= 8 resident warps per SM")
    for name, w in placed.items():
        vgh = name.startswith("slater_vgh")
        built, least = (sv.LANES, 8) if vgh else (mp.LANES, 7)
        check(lanes[name] == built, f"{name}: built for {built} lanes per "
              + ("walker" if vgh else "chain"))
        check(w >= least, f"{name}: the batch-{BATCH} grid places >= {least} "
              "warps per SM on average")
    return warps, placed, lanes


def phase_occupancy_n10(device):
    """The N=10 lane plans, resident warps per SM and the warps per SM that
    the batch-4096 grids place, each against the floor its design sets."""
    import ctypes

    import torch

    from fermiflow_tpu_torch.ops import _build
    from fermiflow_tpu_torch.ops import hessian_flow as hf
    from fermiflow_tpu_torch.ops import metropolis as mp
    from fermiflow_tpu_torch.ops import reinforce as rf
    from fermiflow_tpu_torch.ops import slater_vgh as sv

    n, B = N10, BATCH10
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    launches = {"metropolis_chains": mp.metropolis_occupancy(n, B),
                "slater_vgh": sv.slater_vgh_occupancy(n, B)}
    launches["metropolis_single"] = launches["metropolis_chains"]
    for name, src, mod, occupancy in (
            ("hessian_flow", "hessian_flow", hf, hf.hessian_flow_occupancy),
            ("reinforce_adjoint", "reinforce", rf, rf.reinforce_occupancy)):
        built = getattr(_build.library(src), f"ff_{src}_lanes")(ctypes.c_int(n))
        check(built == mod.lanes_for(n), f"{name}: the library's lanes per "
              f"walker at N={n} ({built}) are the wrapper's lane plan's")
        resident = occupancy(n, D_ETA, D_MU)
        per_block = 128 // built  # walkers per 128-thread block
        launches[name] = dict(warps_per_sm=resident, lanes=built,
                              grid_warps=-(-B // per_block) * 4)
    placed = {k: min(v["grid_warps"], v["warps_per_sm"] * sms) / sms
              for k, v in launches.items()}
    plan = hf.lane_plan(n)
    rplan = rf.lane_plan(n, D_ETA, D_MU)
    units = [len(items) for items in rplan["eta_units"][0]]
    print(f"occupancy: N={n}: resident warps per SM "
          f"{json.dumps({k: v['warps_per_sm'] for k, v in launches.items()})}; "
          f"lanes per walker or chain "
          f"{json.dumps({k: v['lanes'] for k, v in launches.items()})}; the "
          f"batch-{B} grid places {json.dumps(placed)} warps per SM on {sms} "
          f"SMs; hessian_flow per lane {plan['entries'][1]} state entries, "
          f"{plan['mlp_inputs'][1]} MLP input slots (pairs, then one-body, "
          f"as one list) in one hidden-unit loop; reinforce_adjoint per lane {rplan['entries'][1]} state "
          f"entries, eta/mu hidden units {units} by lane and the last "
          f"{rplan['eta_last'][1]} on every lane, coefficient totals "
          f"of {rplan['pairs'][1]} pair and {rplan['one_body'][1]} one-body "
          f"inputs", flush=True)
    # The floors the N=10 designs set: 4 resident 4-warp blocks at <= 128
    # registers (Hessian flow, adjoint, samplers; the VGH kernel 2 of 8
    # warps); the batch-4096 grids place 7.76 warps per SM (samplers, VGH),
    # min(31, 16) (Hessian flow) and min(15.5, 16) (adjoint).
    floors = {"metropolis_chains": (16, 7), "metropolis_single": (16, 7),
              "slater_vgh": (16, 7), "hessian_flow": (16, 15),
              "reinforce_adjoint": (16, 15)}
    for name, (resident, least) in floors.items():
        check(launches[name]["warps_per_sm"] >= resident
              and placed[name] >= least,
              f"{name} N={n}: >= {resident} resident warps per SM, the "
              f"batch-{B} grid places >= {least}")
    return ({k: v["warps_per_sm"] for k, v in launches.items()}, placed,
            {k: v["lanes"] for k, v in launches.items()})


def phase_occupancy_beta10(device):
    """The mixed-state kernels at N=10 and the finite-T path's depth over
    its batch: resident warps per SM, lanes, and the warps per SM the grids
    place.  2048 walkers make 512 warps of either 8-lane grid, 3.9 per SM:
    what that launch can show is that its whole grid is resident at once."""
    import torch

    from fermiflow_tpu_torch.ops import metropolis as mp
    from fermiflow_tpu_torch.ops import slater_vgh as sv

    n, B = N10, BATCH_BETA10
    model, _ = make_beta_model(0.0, device, n, BETA10, DELTA_E10, B)
    _, _, kms = model._qnum_tables()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    launches = {"metropolis_multistate": mp.metropolis_ms_occupancy(n, kms, B),
                "slater_vgh_ms": sv.slater_vgh_ms_occupancy(n, kms, B)}
    placed = {k: min(v["grid_warps"], v["warps_per_sm"] * sms) / sms
              for k, v in launches.items()}
    print(f"occupancy: finite-T N={n}, depth {kms}, {model.Nstates} states: "
          f"resident warps per SM "
          f"{json.dumps({k: v['warps_per_sm'] for k, v in launches.items()})}; "
          f"lanes {json.dumps({k: v['lanes'] for k, v in launches.items()})}; "
          f"the batch-{B} grids of "
          f"{json.dumps({k: v['grid_warps'] for k, v in launches.items()})} "
          f"warps place {json.dumps(placed)} warps per SM on {sms} SMs",
          flush=True)
    check(kms == 8 and model.Nstates == 1781, "finite-T N=10: 1781 states, "
          "Hermite depth 8")
    for name, v in launches.items():
        built = sv.LANES if name.startswith("slater_vgh") else mp.LANES
        check(v["lanes"] == built and v["warps_per_sm"] * sms >= v["grid_warps"],
              f"{name} N={n}: built for {built} lanes; the batch-{B} grid "
              f"({v['grid_warps']} warps) is resident at once")
    return ({k: v["warps_per_sm"] for k, v in launches.items()}, placed,
            {k: v["lanes"] for k, v in launches.items()})


def make_model(Z: float, device, n=N, batch=BATCH, ndown=0):
    """The ground-state model of n particles, ndown of them spin down."""
    from fermiflow_tpu_torch.cli import common
    from fermiflow_tpu_torch.config import Config

    cfg = Config(nup=n - ndown, ndown=ndown, Z=Z, d_eta=D_ETA, d_mu=D_MU, batch=batch,
                 ode_steps=ODE_STEPS, ode_method="dopri5", dtype="float32",
                 device=str(device))
    return common.build_gs(cfg)


def gaussian_params(gen, device, dtype, std=PARAM_STD):
    from fermiflow_tpu_torch.nn.backflow import backflow_init_gaussian

    return backflow_init_gaussian(gen, D_ETA, D_MU, std=std, dtype=dtype,
                                  device=device)


def to_f64(params):
    return {k: None if v is None else {kk: t.double() for kk, t in v.items()}
            for k, v in params.items()}


def phase_kernels(device, rows, n=N, batch=BATCH, accept=ACCEPT_TAU01,
                  tag="", std=PARAM_STD, ndown=0):
    """Each ground-state kernel against its plain version at n particles
    (ndown of them spin down) over ``batch`` walkers, rows keyed ``name +
    tag``; returns equilibrated walkers and Gaussian parameters for the
    later phases."""
    import torch

    from fermiflow_tpu_torch.ops.hessian_flow import (
        hessian_flow_cm,
        hessian_flow_cm_plain,
    )
    from fermiflow_tpu_torch.ops.metropolis import (
        metropolis_chains,
        metropolis_chains_plain,
    )
    from fermiflow_tpu_torch.ops.reinforce import (
        block_sum,
        reinforce_cm_plain,
        reinforce_partials,
    )
    from fermiflow_tpu_torch.ops.slater_vgh import (
        slater_vgh_cm,
        slater_vgh_cm_plain,
    )

    model, _ = make_model(0.5, device, n, batch, ndown)
    nx_up, ny_up, nx_dn, ny_dn, ks = model.occ_qnums()
    d = 2 * n
    gen = torch.Generator(device=device).manual_seed(SEED + n - N)
    f32 = dict(device=device, dtype=torch.float32)
    occ = dict(nx_occ=nx_up, ny_occ=ny_up, nx_dn=nx_dn, ny_dn=ny_dn,
               num_shells=ks)

    # ---- 1. Metropolis sampler ----
    x0 = torch.randn((d, batch), generator=gen, **f32)
    tau0 = torch.full((batch,), 0.1, **f32)
    chain = dict(steps=MCMC_STEPS, segments=SEGMENTS, target=0.5, gain=0.1,
                 **occ)
    # Equilibrate: 10 x 30 steps from Gaussians, then 10 x 30 more.
    xs, _, _, tau_eq = metropolis_chains(x0, tau0, 11, **chain)
    xs, _, _, tau_eq = metropolis_chains(xs[-1].contiguous(), tau_eq, 12,
                                         **chain)
    z_eq = xs[-1].contiguous()

    # (a) one shared random stream: exact agreement but for the rare walker
    # whose accept/reject flips on the last bit of exp(dlogp).
    normals = torch.randn((SEGMENTS, MCMC_STEPS + 1, d, batch), generator=gen,
                          **f32)
    uniforms = torch.rand((SEGMENTS, MCMC_STEPS, batch), generator=gen,
                          **f32).clamp_min(1e-12)
    noise = (normals, uniforms)
    k_out = metropolis_chains(z_eq, tau_eq, 0, noise=noise, **chain)
    p_out = metropolis_chains_plain(z_eq, tau_eq, 0, noise=noise, **chain)
    torch.cuda.synchronize()
    walker_err = (k_out[0] - p_out[0]).abs().amax(dim=(0, 1))  # (B,)
    agree = walker_err <= 1e-4
    frac_flip = 1.0 - float(agree.double().mean())
    err_x = float(walker_err[agree].max())
    err_lp = float((k_out[1] - p_out[1]).abs()[:, agree].max())
    err_rate = float((k_out[2] - p_out[2]).abs()[:, agree].max())
    err_tau = float((k_out[3] - p_out[3]).abs()[agree].max())
    print(f"metropolis{tag} shared stream: diverged walkers {frac_flip:.2e}, "
          f"max|dx| {err_x:.3e}, max|dlogp| {err_lp:.3e}, "
          f"max|drate| {err_rate:.3e}, max|dtau| {err_tau:.3e}")
    check(frac_flip <= 1e-3, "sampler: <= 0.1% of walkers diverge on the "
          "shared stream (accept flips on the last bit of exp)")
    # Positions take the same two roundings in both; PyTorch divides the
    # accept count by the step count as a multiply by its reciprocal.
    check(err_x == 0.0 and err_rate <= 1e-6,
          "sampler: identical trajectories, rates within 1e-6, on agreeing "
          "walkers")
    check(err_lp <= 1e-3 and err_tau <= 1e-6,
          "sampler: logp within 1e-3, tau_out within 1e-6")

    # (b) distribution on the kernel's own Philox stream, fixed tau = 0.1.
    fixed = dict(chain, gain=0.0)
    xs_f, lp_f, rate_f, _ = metropolis_chains(z_eq, tau0, 21, **fixed)
    acc = float(rate_f.mean())
    x_w = xs_f[-1].T.reshape(batch, n, 2).double()
    lp_ref = model.basedist.log_prob(model.occ_up, model.occ_down, x_w)
    lp_bad = logp_violations(lp_f[-1], lp_ref)
    print(f"metropolis{tag} distribution: accept {acc:.4f} at tau=0.1; logp vs "
          f"log_prob max|d| {maxabs(lp_f[-1], lp_ref):.3e}, "
          f"violations {lp_bad:.2e}")
    check(abs(acc - accept) < 0.03, f"sampler: acceptance "
          f"{accept} +- 0.03 at tau=0.1 (the JAX sampler's figure)")
    check(lp_bad <= 1e-3, "sampler: logp = log_prob (f64) within 1e-3 "
          "relative on >= 99.9% of walkers")

    rows["metropolis_chains" + tag] = dict(
        max_abs_err=max(err_x, err_lp, err_rate, err_tau),
        tolerance="x exact; rate, tau 1e-6; logp 1e-3; <=0.1% walkers "
                  "diverged by accept flips",
        diverged_frac=frac_flip)

    # ---- 2. Slater value / gradient / packed Hessian ----
    y_k, g_k, H_k = out_vgh = slater_vgh_cm(z_eq, **occ)
    out_p = slater_vgh_cm_plain(z_eq, **occ)
    out_r = slater_vgh_cm_plain(z_eq.double(), **occ)
    torch.cuda.synchronize()
    err_vgh64, err_vgh = vgh_against_plain("slater_vgh" + tag, out_vgh, out_p, out_r)
    captured(lambda: slater_vgh_cm(z_eq, **occ)[2])
    rows["slater_vgh" + tag] = dict(
        max_abs_err=err_vgh64, max_abs_err_vs_plain_f32=err_vgh,
        tolerance=VGH_TOLERANCE)

    # ---- 3. Hessian flow ----
    params = gaussian_params(gen, device, torch.float32, std)
    p64 = to_f64(params)
    ts = (0.0, 1.0, ODE_STEPS, "dopri5")
    out_k = hessian_flow_cm(params, z_eq, y_k, g_k, H_k, *ts)
    out_p = hessian_flow_cm_plain(params, z_eq, y_k, g_k, H_k, *ts)
    out_r = hessian_flow_cm_plain(p64, z_eq.double(), y_k.double(),
                                  g_k.double(), H_k.double(), *ts)
    torch.cuda.synchronize()
    err_hf, err_hf32 = 0.0, 0.0
    for name, k, p, r in zip(("x", "logp", "g", "H"), out_k, out_p, out_r):
        e_k, e_p = maxabs(k, r), maxabs(p, r)
        scale = float(r.abs().max())
        err_hf, err_hf32 = max(err_hf, e_k), max(err_hf32, e_p)
        print(f"hessian_flow{tag} {name}: |kernel - f64| {e_k:.3e}, "
              f"|plain f32 - f64| {e_p:.3e}, scale {scale:.3e}")
        check(math.isfinite(e_k) and e_k <= max(3.0 * e_p, 1e-5 * scale + 1e-6),
              f"hessian_flow {name}: kernel error <= 3x the plain f32 error")
    rows["hessian_flow" + tag] = dict(
        max_abs_err=err_hf, plain_f32_max_abs_err=err_hf32,
        tolerance="per output, error vs f64 plain <= max(3 x plain f32 "
                  "error, 1e-5 max|ref| + 1e-6)")

    # ---- 4. REINFORCE adjoint and its block reduction ----
    x1, logp1, g1, H1 = out_k
    d_ = d
    diag = [p * d_ - p * (p - 1) // 2 for p in range(d_)]
    eloc = (-0.25 * H1[diag].sum(0) - 0.125 * (g1 * g1).sum(0)
            + model.potential_rows(x1))
    w = ((eloc - eloc.mean()) / batch).contiguous()
    partials, zb_k = reinforce_partials(params, x1, g1, w, *ts)
    rows_k = block_sum(partials)
    gr_p, zb_p = reinforce_cm_plain(params, x1, g1, w, *ts)
    gr_r, _ = reinforce_cm_plain(p64, x1.double(), g1.double(), w.double(),
                                 *ts)
    torch.cuda.synchronize()
    flat = lambda gr: torch.cat([gr[m][k].reshape(-1).double()
                                 for m in ("eta", "mu")
                                 for k in ("w2", "w1", "b1")])
    rk, rp, rr = rows_k.double(), flat(gr_p), flat(gr_r)
    e_k, e_p = float((rk - rr).abs().max()), float((rp - rr).abs().max())
    scale = float(rr.abs().max())
    print(f"reinforce{tag} grads: |kernel - f64| {e_k:.3e}, |plain f32 - f64| "
          f"{e_p:.3e}, scale {scale:.3e}; z_back max|k - p| "
          f"{maxabs(zb_k, zb_p):.3e}")
    check(e_k <= max(3.0 * e_p, 1e-5 * scale + 1e-7),
          "reinforce: gradient error <= 3x the plain f32 error")
    ref_rows = partials.double().sum(0)
    red_err = (rows_k.double() - ref_rows).abs()
    red_tol = partials.shape[0] * 2.0**-24 * partials.double().abs().sum(0)
    check(bool((red_err <= red_tol + 1e-30).all()),
          "reinforce_reduce: block sum within nblocks * 2^-24 * sum|partials|")
    check(torch.equal(block_sum(partials), rows_k),
          "reinforce_reduce: two sums of the same partials are bitwise equal")
    rows["reinforce_adjoint" + tag] = dict(
        max_abs_err=e_k, plain_f32_max_abs_err=e_p,
        tolerance="gradient error vs f64 plain <= max(3 x plain f32 error, "
                  "1e-5 max|ref| + 1e-7)")
    captured(lambda: block_sum(partials))
    captured(lambda: partials.sum(0))
    rows["reinforce_reduce" + tag] = dict(
        max_abs_err=float(red_err.max()),
        tolerance="nblocks * 2^-24 * sum_b |partials[b]| per row")
    return z_eq, params


def make_beta_model(Z: float, device, n=N, beta=BETA, deltaE=DELTA_E,
                    batch=BATCH):
    """The finite-T model (by default beta=2, deltaE=2) with identity-flow
    parameters and Boltzmann logits."""
    from fermiflow_tpu_torch.cli import common
    from fermiflow_tpu_torch.config import Config

    cfg = Config(nup=n, ndown=0, Z=Z, beta=beta, deltaE=deltaE,
                 boltzmann=True, d_eta=D_ETA, d_mu=D_MU, batch=batch,
                 ode_steps=ODE_STEPS, ode_method="dopri5", dtype="float32",
                 device=str(device))
    return common.build_beta(cfg)


def shared_stream_agreement(k_out, p_out, what):
    """A single-chain kernel against its plain version on one injected
    stream: positions identical but for walkers whose accept decision flips
    on the last bit of exp(); logp and rates close on the rest."""
    walker_err = (k_out[0] - p_out[0]).abs().amax(dim=0)  # (B,)
    agree = walker_err <= 1e-4
    frac_flip = 1.0 - float(agree.double().mean())
    err_x = float(walker_err[agree].max())
    err_lp = float((k_out[1] - p_out[1]).abs()[agree].max())
    err_rate = float((k_out[2] - p_out[2]).abs()[agree].max())
    print(f"{what} shared stream: diverged walkers {frac_flip:.2e}, max|dx| "
          f"{err_x:.3e}, max|dlogp| {err_lp:.3e}, max|drate| {err_rate:.3e}")
    check(frac_flip <= 1e-3, f"{what}: <= 0.1% of walkers diverge on the "
          "shared stream (accept flips on the last bit of exp)")
    check(err_x == 0.0 and err_rate <= 1e-6 and err_lp <= 1e-3,
          f"{what}: identical trajectories, rates within 1e-6, logp within "
          "1e-3 on agreeing walkers")
    return frac_flip, max(err_x, err_lp, err_rate)


def phase_single_chain(device, rows, z_eq, gen, n=N, batch=BATCH,
                       accept=ACCEPT_TAU01, tag="", ndown=0):
    """The per-iteration sampler (kernel 5) against its plain version at n
    particles (ndown of them spin down), on walkers z_eq that the chains
    equilibrated."""
    import torch

    from fermiflow_tpu_torch.ops.metropolis import (
        metropolis_single_cm,
        metropolis_single_cm_plain,
    )

    d = 2 * n
    f32 = dict(device=device, dtype=torch.float32)
    tau01 = torch.full((batch,), 0.1, **f32)
    gs_model, _ = make_model(0.5, device, n, batch, ndown)
    nx_up, ny_up, nx_dn, ny_dn, ks = gs_model.occ_qnums()
    occ = dict(nx_occ=nx_up, ny_occ=ny_up, nx_dn=nx_dn, ny_dn=ny_dn,
               num_shells=ks)
    noise = (torch.randn((MCMC_STEPS, d, batch), generator=gen, **f32),
             torch.rand((MCMC_STEPS, batch), generator=gen,
                        **f32).clamp_min(1e-12))
    k_out = metropolis_single_cm(z_eq, tau01, 0, steps=MCMC_STEPS,
                                 noise=noise, **occ)
    p_out = metropolis_single_cm_plain(z_eq, tau01, 0, steps=MCMC_STEPS,
                                       noise=noise, **occ)
    torch.cuda.synchronize()
    what = "metropolis_single" + tag
    frac, err = shared_stream_agreement(k_out, p_out, what)
    x1, lp1, acc1 = metropolis_single_cm(z_eq, tau01, 41, steps=MCMC_STEPS,
                                         **occ)
    lp_bad = logp_violations(lp1, gs_model.basedist.log_prob(
        gs_model.occ_up, gs_model.occ_down, x1.T.reshape(batch, n, 2).double()))
    print(f"{what} distribution: accept {float(acc1.mean()):.4f} "
          f"at tau=0.1; logp vs log_prob violations {lp_bad:.2e}")
    check(abs(float(acc1.mean()) - accept) < 0.03 and lp_bad <= 1e-3,
          f"{what}: acceptance {accept} +- 0.03 at tau=0.1; "
          "logp = log_prob (f64) within 1e-3 relative on >= 99.9% of walkers")
    rows[what] = dict(max_abs_err=err, diverged_frac=frac,
                      tolerance=SINGLE_CHAIN_TOLERANCE)


def phase_kernels_ms(device, rows, z_eq=None, n=N, beta=BETA, deltaE=DELTA_E,
                     batch=BATCH, accept=ACCEPT_MS_TAU01, tag="", seed=SEED + 1):
    """The per-iteration sampler (kernel 5, at N=6 on the walkers z_eq)
    and the finite-T kernels (mixed-state sampler 7 and VGH 6) against
    their plain versions at n particles over ``batch`` walkers, rows keyed
    ``name + tag``.  Returns walkers equilibrated in Boltzmann-drawn states
    and the states."""
    import torch

    from fermiflow_tpu_torch.ops.metropolis import (
        metropolis_multistate_cm,
        metropolis_multistate_cm_plain,
    )
    from fermiflow_tpu_torch.ops.slater_vgh import (
        slater_vgh_ms_cm,
        slater_vgh_ms_cm_plain,
    )

    d = 2 * n
    gen = torch.Generator(device=device).manual_seed(seed)
    f32 = dict(device=device, dtype=torch.float32)
    tau01 = torch.full((batch,), 0.1, **f32)
    tau02 = torch.full((batch,), 0.2, **f32)

    def shared_noise():
        return (torch.randn((MCMC_STEPS, d, batch), generator=gen, **f32),
                torch.rand((MCMC_STEPS, batch), generator=gen,
                           **f32).clamp_min(1e-12))

    # ---- 5. single fixed-tau chain (ground state) ----
    if z_eq is not None:
        phase_single_chain(device, rows, z_eq, gen)

    # ---- 7. mixed-state sampler, Boltzmann-drawn states ----
    model, params = make_beta_model(0.0, device, n, beta, deltaE, batch)
    _, _, kms = model._qnum_tables()
    probs = torch.softmax(params["log_state_weights"], dim=-1)
    idx = torch.multinomial(probs, batch, replacement=True,
                            generator=gen).to(torch.int32)
    ms = dict(zip(("nx_cm", "ny_cm"), model.qnums_cm(idx)), num_shells=kms)
    z = torch.randn((d, batch), generator=gen, **f32)
    for s in (31, 32):
        z, _, _ = metropolis_multistate_cm(z, tau02, s, steps=150, **ms)
    z_ms = z.contiguous()
    noise = shared_noise()
    k_out = metropolis_multistate_cm(z_ms, tau01, 0, steps=MCMC_STEPS,
                                     noise=noise, **ms)
    p_out = metropolis_multistate_cm_plain(z_ms, tau01, 0, steps=MCMC_STEPS,
                                           noise=noise, **ms)
    torch.cuda.synchronize()
    what = "metropolis_multistate" + tag
    frac, err = shared_stream_agreement(k_out, p_out, what)
    # Distribution on the kernel's own stream: uniformly drawn states.
    idx_u = torch.randint(0, model.Nstates, (batch,), generator=gen,
                          device=device, dtype=torch.int32)
    ms_u = dict(zip(("nx_cm", "ny_cm"), model.qnums_cm(idx_u)), num_shells=kms)
    zu = torch.randn((d, batch), generator=gen, **f32)
    zu, _, _ = metropolis_multistate_cm(zu, tau02, 33, steps=300, **ms_u)
    xu, lpu, accu = metropolis_multistate_cm(zu, tau01, 34, steps=MCMC_STEPS,
                                             **ms_u)
    lp_bad = logp_violations(lpu, model.basedist.log_prob_multstates(
        model.occ_table, idx_u, xu.T.reshape(batch, n, 2).double()))
    acc = float(accu.mean())
    print(f"{what} distribution: {model.Nstates} states, depth {kms}: accept "
          f"{acc:.4f} at tau=0.1 on uniformly drawn states; logp vs "
          f"log_prob_multstates violations {lp_bad:.2e}")
    check(abs(acc - accept) < 0.03, f"{what}: acceptance {accept} +- 0.03 at "
          "tau=0.1 (the JAX mixed-state sampler's figure)")
    check(lp_bad <= 1e-3, f"{what}: logp = log_prob_multstates (f64) within "
          "1e-3 relative on >= 99.9% of walkers")
    rows[what] = dict(max_abs_err=err, diverged_frac=frac,
                      tolerance=SINGLE_CHAIN_TOLERANCE)

    # ---- 6. mixed-state Slater value / gradient / packed Hessian ----
    what = "slater_vgh_ms" + tag
    vgh = (ms["nx_cm"], ms["ny_cm"], kms)
    out_k = slater_vgh_ms_cm(z_ms, *vgh)
    out_p = slater_vgh_ms_cm_plain(z_ms, *vgh)
    out_r = slater_vgh_ms_cm_plain(z_ms.double(), *vgh)
    torch.cuda.synchronize()
    err_r, err_p = vgh_against_plain(what, out_k, out_p, out_r)
    captured(lambda: slater_vgh_ms_cm(z_ms, *vgh)[2])
    rows[what] = dict(max_abs_err=err_r, max_abs_err_vs_plain_f32=err_p,
                      tolerance=VGH_TOLERANCE)
    return z_ms, idx


def flocs_identity(model, params, idx, z_ms):
    """Each walker's Floc of the finite-T oracle (identity flow), through the
    model's kernel chain in f32 and through the plain versions in f64."""
    import copy

    import torch

    from fermiflow_tpu_torch.vmc.gs import PLAIN_OPS, flow_local_energy_cm

    lps = torch.log_softmax(params["log_state_weights"].double(), -1)[idx.long()]
    nx, ny = model.qnums_cm(idx)
    _, _, ks = model._qnum_tables()
    out = []
    for ops, dtype in ((model.ops, torch.float32), (PLAIN_OPS, torch.float64)):
        chain = copy.copy(model)
        chain.ops = ops
        flow = {k: None if v is None else {kk: t.to(dtype) for kk, t in v.items()}
                for k, v in params["flow"].items()}
        z = z_ms.to(dtype)
        y, g0, Hp0 = ops.slater_vgh_ms(z, nx, ny, ks)
        _, eloc, _, _ = flow_local_energy_cm(chain, flow, z, y, g0, Hp0)
        out.append(eloc.double() + lps / model.beta)
    return out


def phase_beta_oracle(device, z_ms, idx, n=N, beta=BETA, deltaE=DELTA_E,
                      f_known=F_EXACT_N6):
    """Z=0, identity flow, Boltzmann logits: every walker's Floc is the
    exact free energy, through the mixed-state VGH, Hessian flow and
    REINFORCE kernels on walkers the mixed-state kernel equilibrated."""
    import numpy as np
    import torch

    batch = z_ms.shape[1]
    model, params = make_beta_model(0.0, device, n, beta, deltaE, batch)
    Es = model.Es_original
    f_exact = Es[0] - np.log(np.sum(np.exp(-beta * (Es - Es[0])))) / beta
    _, m, _ = model.loss_metrics_grads_cm(params, idx, z_ms)
    torch.cuda.synchronize()
    lps = torch.log_softmax(params["log_state_weights"].double(), -1)[idx.long()]
    se = float(lps.std()) / math.sqrt(batch)
    F, F_std = float(m["F"]), float(m["F_std"])
    S, S_an = float(m["S"]), float(m["S_analytical"])
    print(f"finite-T oracle N={n} Z=0 beta={beta:g}: {model.Nstates} states, "
          f"F {F:.6f} (exact {f_exact:.6f}), F_std {F_std:.3e}, S {S:.4f} "
          f"+- {se:.4f}, S_analytical {S_an:.4f}")
    if F_std >= 1e-3:
        # Which walkers' Floc is off the exact one, in f32 and in f64,
        # before the gate fails.
        for what, floc in zip(("kernels f32", "plain f64"),
                              flocs_identity(model, params, idx, z_ms)):
            off = (floc - f_exact).abs()
            print(f"finite-T oracle N={n} {what}: walkers with |Floc - F| > "
                  f"1e-3: {int((off > 1e-3).sum())} of {batch}, largest "
                  f"{float(off.max()):.3e} (walkers "
                  f"{(off > 1e-3).nonzero().flatten()[:8].tolist()})")
    check(abs(f_exact - f_known) < 1e-6 and abs(F - f_exact) <= 1e-3
          and F_std < 1e-3,
          f"finite-T oracle: F = {f_known} within 1e-3, F_std < 1e-3")
    check(abs(S - S_an) <= 3.0 * se,
          "finite-T oracle: S within 3 standard errors of S_analytical")


def phase_identity_oracle(device, z_eq, n=N):
    import torch

    model, params0 = make_model(0.0, device, n, z_eq.shape[1])
    # Non-interacting ground state: the n lowest orbital energies (14 at
    # N=6, 30 at N=10).
    e0 = float(model.basedist.orbitals.Es[:n].sum())
    _, eloc, _, _ = model.local_energy_cm(params0, z_eq)
    torch.cuda.synchronize()
    err = (eloc.double() - e0).abs()
    frac = float((err > 1e-3).double().mean())
    print(f"identity oracle N={n} Z=0: Eloc median {float(eloc.median()):.6f}, "
          f"max|Eloc - {e0:g}| {float(err.max()):.3e}, outside 1e-3: "
          f"{frac:.2e}")
    check(bool(torch.isfinite(eloc).all()) and frac <= 1e-3,
          f"identity flow: Eloc = {e0:g} within 1e-3 on >= 99.9% of walkers")


def drive_path(main, argv):
    """Run a CLI ``main`` with every launch count set to 0 just before and
    read just after: (state, per-iteration records, counts)."""
    import tempfile

    import torch

    from fermiflow_tpu_torch.ops import _build

    with tempfile.TemporaryDirectory() as tmp:
        metrics = f"{tmp}/metrics.jsonl"
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        state = main(argv + ["--metrics", metrics])
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        with open(metrics) as fh:
            recs = [json.loads(line) for line in fh]
    return state, recs, counts


@contextlib.contextmanager
def eager_chunks():
    """The CLIs with every chunk eager (``graph=False``): phase 9 (d)'s run
    against the captured one."""
    from fermiflow_tpu_torch.cli import finite_t, ground_state

    patched = [(ground_state, "make_gs_fused_multi_step"),
               (ground_state, "make_gs_train_step"),
               (finite_t, "make_beta_train_step")]
    saved = [getattr(mod, name) for mod, name in patched]
    for (mod, name), fn in zip(patched, saved):
        setattr(mod, name, lambda *a, fn=fn, **k: fn(*a, **{**k,
                                                            "graph": False}))
    try:
        yield
    finally:
        for (mod, name), fn in zip(patched, saved):
            setattr(mod, name, fn)


def path_argv(device, iters, steps_per_call, n=N, batch=BATCH, lr="1e-3",
              persistent=True):
    """The GS CLI's argv: persistent walkers (MCMC_STEPS an iteration), or
    the CLI's default, fresh walkers (100 steps at tau 0.1)."""
    return ["--nup", str(n), "--Z", "0.5", "--batch", str(batch), "--dtype",
            "float32", *(["--persistent"] if persistent else []),
            "--steps-per-call", str(steps_per_call),
            "--iternum", str(iters), "--lr", lr, "--Deta", str(D_ETA),
            "--Dmu", str(D_MU), "--ode-steps", str(ODE_STEPS), "--mcmc-steps",
            str(MCMC_STEPS), "--device", device.type]


GS_KERNELS = ("metropolis_chains", "slater_vgh", "hessian_flow",
              "reinforce_adjoint", "reinforce_reduce")


def phase_main_path(device):
    from fermiflow_tpu_torch.cli import ground_state

    state, recs, counts = drive_path(ground_state.main,
                                     path_argv(device, MAIN_ITERS, SEGMENTS))
    energies = [r["E"] for r in recs]
    print(f"main path: {MAIN_ITERS} iterations; launches {json.dumps(counts)}")
    check(state.step == MAIN_ITERS and len(recs) == MAIN_ITERS,
          "main path: all iterations ran")
    # Variational: above the true ground state (~18.16 at N=6, Z=0.5) and
    # near the identity flow's 14 + <V> (~19) this early in training.
    check(all(math.isfinite(e) and 17.0 < e < 21.0 for e in energies),
          "main path: every energy is finite and in (17, 21)")
    check(all(counts[k] > 0 for k in GS_KERNELS),
          "main path: every kernel of the path was launched")
    return counts


def phase_n10_path(device):
    """The ground-state path at N=10 (docs/VALIDATION.md:19), through the
    CLI as a user runs it: --nup 10 --Z 0.5 --batch 4096 --lr 3e-3 --dtype
    float32 --persistent --steps-per-call 10, 20 iterations."""
    from fermiflow_tpu_torch.cli import ground_state

    state, recs, counts = drive_path(ground_state.main, path_argv(
        device, MAIN_ITERS, SEGMENTS, N10, BATCH10, LR10))
    energies = [r["E"] for r in recs]
    lo = E_RANGE_N10[0]
    print(f"N=10 path: {MAIN_ITERS} iterations; E first/last {energies[0]:.5f}/"
          f"{energies[-1]:.5f}, E_std last {recs[-1]['E_std']:.4f}, accept "
          f"{recs[-1]['accept_rate']:.4f}; launches {json.dumps(counts)}")
    check(state.step == MAIN_ITERS and len(recs) == MAIN_ITERS,
          "N=10 path: all iterations ran")
    check(all(math.isfinite(e) and e >= lo for e in energies),
          f"N=10 path: every energy is finite and >= {lo} (the JAX package "
          "converged to 41.5519)")
    check(all(counts[k] > 0 for k in GS_KERNELS),
          "N=10 path: every kernel of the path was launched")
    return counts


def beta_argv(device, iters, n=N, beta=BETA, deltaE=DELTA_E, batch=BATCH,
              lr="1e-3", persistent=True):
    return ["--beta", str(beta), "--nup", str(n), "--Z", "0.5", "--deltaE",
            str(deltaE), "--boltzmann", "--batch", str(batch), "--dtype",
            "float32", *(["--persistent"] if persistent else []),
            "--steps-per-call", str(SEGMENTS),
            "--iternum", str(iters), "--lr", lr, "--mcmc-steps",
            str(MCMC_STEPS), "--device", device.type]


def phase_beta_path(device, n=N, beta=BETA, deltaE=DELTA_E, batch=BATCH,
                    lr="1e-3", f_range=(16.0, 21.0), f_first=None):
    """The finite-T training path through the port's CLI; every F in
    f_range and, where given, the first within 1.0 of f_first."""
    from fermiflow_tpu_torch.cli import finite_t

    state, recs, counts = drive_path(finite_t.main, beta_argv(
        device, MAIN_ITERS, n, beta, deltaE, batch, lr))
    frees = [r["F"] for r in recs]
    what = "finite-T path" + (f" N={n}" if n != N else "")
    print(f"{what}: {MAIN_ITERS} iterations; F first/last "
          f"{frees[0]:.5f}/{frees[-1]:.5f}; "
          f"S {recs[-1]['S']:.4f}, accept {recs[-1]['accept_rate']:.4f}; "
          f"launches {json.dumps(counts)}")
    if n != N:
        print(f"{what}: F by iteration {[round(f, 4) for f in frees]}")
    check(state.step == MAIN_ITERS and len(recs) == MAIN_ITERS,
          f"{what}: all iterations ran")
    lo, hi = f_range
    check(all(math.isfinite(f) and lo < f < hi for f in frees),
          f"{what}: every F is finite and in ({lo}, {hi})")
    if f_first is not None:
        check(abs(frees[0] - f_first) <= 1.0, f"{what}: the first F within "
              f"1.0 of the JAX CLI's first, {f_first}")
    check(all(counts[k] == MAIN_ITERS for k in (
        "metropolis_multistate", "slater_vgh_ms", "hessian_flow",
        "reinforce_adjoint", "reinforce_reduce")),
        f"{what}: {MAIN_ITERS} launches each of the mixed-state "
        "sampler, mixed-state VGH, Hessian flow and REINFORCE adjoint")
    check(all(counts[k] == 0 for k in ("metropolis_chains", "slater_vgh",
                                       "metropolis_single")),
          f"{what}: no launch of the ground-state sampler or VGH")
    return counts


def phase_gs_single_path(device, n=N, batch=BATCH, lr="1e-3",
                         e_range=(17.0, 21.0)):
    """The ground-state per-iteration path (--steps-per-call 1)."""
    from fermiflow_tpu_torch.cli import ground_state

    _, recs, counts = drive_path(ground_state.main, path_argv(
        device, SINGLE_ITERS, 1, n, batch, lr))
    energies = [r["E"] for r in recs]
    lo, hi = e_range
    print(f"per-iteration path N={n}: {SINGLE_ITERS} iterations; "
          f"E {energies}; launches {json.dumps(counts)}")
    check(all(math.isfinite(e) and lo < e < hi for e in energies),
          f"per-iteration path N={n}: every energy is finite and in "
          f"({lo}, {hi})")
    check(counts["metropolis_single"] == SINGLE_ITERS
          and counts["metropolis_chains"] == 0
          and all(counts[k] == SINGLE_ITERS for k in (
              "slater_vgh", "hessian_flow", "reinforce_adjoint")),
          f"per-iteration path N={n}: {SINGLE_ITERS} launches of the single-chain "
          "sampler and of each update kernel, none of the multi-segment one")
    return counts


def phase_update_vs_plain(device, z_eq, params, n=N):
    import copy

    import torch

    from fermiflow_tpu_torch.vmc.gs import PLAIN_OPS

    model, _ = make_model(0.5, device, n, z_eq.shape[1])
    plain = copy.copy(model)
    plain.ops = PLAIN_OPS
    loss_k, m_k, g_k = model.loss_metrics_grads_cm(params, z_eq)
    loss_p, m_p, g_p = plain.loss_metrics_grads_cm(params, z_eq)
    torch.cuda.synchronize()
    worst, ok_g = flow_grads_close(g_k, g_p)
    print(f"fused update vs plain N={n}: E {float(m_k['E']):.7f} / "
          f"{float(m_p['E']):.7f}, E_std {float(m_k['E_std']):.6f} / "
          f"{float(m_p['E_std']):.6f}, loss {float(loss_k):.4e} / "
          f"{float(loss_p):.4e}, grads max|d| {worst:.3e}")
    check(allclose64(m_k["E"], m_p["E"], 1e-5, 0.0)
          and allclose64(m_k["E_std"], m_p["E_std"], 1e-5, 0.0),
          "update: E and E_std within rtol 1e-5 of the plain update")
    check(allclose64(loss_k, loss_p, 1e-4, 1e-6) and ok_g,
          "update: loss and every gradient leaf within rtol 1e-4, atol 1e-6")


def phase_beta_update_vs_plain(device, z_ms, idx, flow_params, n=N, beta=BETA,
                               deltaE=DELTA_E):
    """The finite-T kernel-chain update against its plain-PyTorch chain."""
    import copy

    import torch

    from fermiflow_tpu_torch.vmc.gs import PLAIN_OPS

    model, params = make_beta_model(0.5, device, n, beta, deltaE, z_ms.shape[1])
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    params = {"flow": flow_params, "log_state_weights": 0.5 * torch.randn(
        (model.Nstates,), generator=gen, device=device)}
    plain = copy.copy(model)
    plain.ops = PLAIN_OPS
    loss_k, m_k, g_k = model.loss_metrics_grads_cm(params, idx, z_ms)
    loss_p, m_p, g_p = plain.loss_metrics_grads_cm(params, idx, z_ms)
    torch.cuda.synchronize()
    worst, ok_g = flow_grads_close(g_k["flow"], g_p["flow"])
    gl_k, gl_p = g_k["log_state_weights"], g_p["log_state_weights"]
    print(f"finite-T update vs plain N={n}: F {float(m_k['F']):.7f} / "
          f"{float(m_p['F']):.7f}, E {float(m_k['E']):.7f} / "
          f"{float(m_p['E']):.7f}, S {float(m_k['S']):.6f} / "
          f"{float(m_p['S']):.6f}, loss {float(loss_k):.4e} / "
          f"{float(loss_p):.4e}, flow grads max|d| {worst:.3e}, logits grad "
          f"max|d| {maxabs(gl_k, gl_p):.3e}")
    check(all(allclose64(m_k[k], m_p[k], 1e-5, 0.0) for k in ("E", "F", "S")),
          "finite-T update: E, F and S within rtol 1e-5 of the plain update")
    check(allclose64(loss_k, loss_p, 1e-4, 1e-6) and ok_g
          and allclose64(gl_k, gl_p, 1e-4, 1e-6),
          "finite-T update: loss, every flow gradient leaf and the logits "
          "gradient within rtol 1e-4, atol 1e-6")


# ---- phase 8: restartable runs, the nested-jvp engine and the solvers ----

CKPT_ITERS, CKPT_EVERY, CKPT_ITERS_BETA = 30, 10, 20
# The nested-jvp engine's E against the Hessian flow's on the same walkers
# and parameters: they integrate the flow in opposite directions, so they
# differ by the fixed grid's error.  Measured on the CPU at N=6, d_eta=d_mu=50,
# dopri5 x 4, weights of std 0.1, 256 walkers equilibrated by the plain
# sampler: 5.50e-5 relative in float64 (and 5.50e-5 in float32).
E_ENGINES_RTOL = 3e-4
# The adjoint's parameter gradient through CNF.generate against the fixed
# grid's autograd gradient, per leaf, relative to the leaf's largest entry:
# measured on the CPU (same shapes, 256 walkers) at <= 4.0e-6 in float64,
# <= 6.6e-6 in float32.
ADJOINT_GRAD_RTOL = 1e-4
SOLVER_BATCH = 1024  # the adaptive and adjoint runs (2 iterations each)
MOVIE_FRAMES, MOVIE_WALKERS = 5, 512
TIMING_KEYS = ("iter_seconds", "hours_per_100_iters")


def _ckpt_argv(device, iters, ckpt_dir, finite):
    argv = path_argv(device, iters, SEGMENTS)
    if finite:
        argv = ["--beta", str(BETA), "--deltaE", str(DELTA_E),
                "--boltzmann"] + argv
    return argv + ["--checkpoint-dir", ckpt_dir, "--checkpoint-every",
                   str(CKPT_EVERY)]


def _rows(path):
    with open(path) as fh:
        return [{k: v for k, v in json.loads(line).items()
                 if k not in TIMING_KEYS} for line in fh]


def _bitwise_dicts(a: dict, b: dict) -> list:
    """Names of the entries of two checkpoint payloads that differ."""
    import torch

    bad = []

    def walk(x, y, name):
        if isinstance(x, torch.Tensor):
            if not (isinstance(y, torch.Tensor) and x.dtype == y.dtype
                    and x.shape == y.shape and torch.equal(x, y)):
                bad.append(name)
        elif isinstance(x, dict):
            if not isinstance(y, dict) or set(x) != set(y):
                bad.append(name)
            else:
                for k in x:
                    walk(x[k], y[k], f"{name}.{k}")
        elif isinstance(x, (list, tuple)):
            if len(x) != len(y):
                bad.append(name)
            for i, (u, v) in enumerate(zip(x, y)):
                walk(u, v, f"{name}[{i}]")
        elif x != y:
            bad.append(name)

    walk(a, b, "ckpt")
    return bad


def _load(path):
    import torch

    return torch.load(path, map_location="cpu", weights_only=True)


def phase_resume_start(device, finite, tmp):
    """The uninterrupted run (checkpoints every 10), and the run cut at step
    20 then restored in this process, bitwise against what it saved.
    Starts the resume to the end in a fresh process (the CLI as a user runs
    it) and returns what ``phase_resume_finish`` needs."""
    import argparse
    import os

    from fermiflow_tpu_torch.cli import common, finite_t, ground_state
    from fermiflow_tpu_torch.train import init_beta_state, init_gs_state
    from fermiflow_tpu_torch.utils import restore_checkpoint, save_checkpoint

    what = "resume finite T" if finite else "resume GS"
    main = finite_t.main if finite else ground_state.main
    iters = CKPT_ITERS_BETA if finite else CKPT_ITERS
    cut_at = iters - CKPT_EVERY
    whole_dir, cut_dir = f"{tmp}/whole", f"{tmp}/cut"
    _, recs_w, counts_w = drive_path(
        main, _ckpt_argv(device, iters, whole_dir, finite))
    print(f"{what}: uninterrupted {iters} iterations, "
          f"checkpoints {sorted(os.listdir(whole_dir))}; launches "
          f"{json.dumps(counts_w)}")
    state_c, _, _ = drive_path(main, _ckpt_argv(device, cut_at, cut_dir,
                                                finite))
    # Restore the cut run's last checkpoint into a fresh state: every tensor
    # and both generators equal what the live run saved.
    parser = argparse.ArgumentParser()
    common.add_flags(parser, finite_t=finite)
    cfg = common.config_from_args(parser.parse_args(
        _ckpt_argv(device, iters, cut_dir, finite)), finite_t=finite)
    build = common.build_beta if finite else common.build_gs
    init = init_beta_state if finite else init_gs_state
    model, params = build(cfg)
    fresh, step = restore_checkpoint(cut_dir,
                                     init(model, params, cfg, device))
    path = save_checkpoint(f"{tmp}/live", step, state_c)
    again = save_checkpoint(f"{tmp}/restored", step, fresh)
    bad = _bitwise_dicts(_load(path), _load(again))
    print(f"{what}: checkpoint step {step}: {os.path.getsize(path)} bytes; "
          f"restored state against the live one: "
          f"{'bitwise equal' if not bad else bad}")
    check(step == cut_at and not bad, f"{what}: the restored tensors and "
          "generator states equal the saved ones bitwise")
    metrics = f"{tmp}/resumed.jsonl"
    mod = "finite_t" if finite else "ground_state"
    proc = subprocess.Popen(
        [sys.executable, "-m", f"fermiflow_tpu_torch.cli.{mod}",
         *_ckpt_argv(device, iters, cut_dir, finite), "--metrics", metrics],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    recs = [{k: v for k, v in r.items() if k not in TIMING_KEYS}
            for r in recs_w]
    return dict(what=what, main=main, finite=finite, iters=iters,
                cut_at=cut_at, tmp=tmp, recs=recs, proc=proc,
                metrics=metrics)


def phase_resume_finish(device, run):
    """Waits for the resumed process; its rows after the cut and its last
    checkpoint against the uninterrupted run's."""
    what, iters, cut_at, tmp = (run["what"], run["iters"], run["cut_at"],
                                run["tmp"])
    out, _ = run["proc"].communicate(timeout=300)
    tail = out.strip().splitlines()[-3:]
    check(run["proc"].returncode == 0 and f"resumed from checkpoint step "
          f"{cut_at}" in out, f"{what}: the resumed process (the CLI) ran "
          f"from step {cut_at} (rc {run['proc'].returncode}; {tail})")
    resumed = _rows(run["metrics"])
    steps = [r["step"] for r in resumed]
    want = run["recs"][cut_at:]
    bitwise = resumed == want
    ckpt = f"ckpt_{iters:08d}.pt"
    bad = _bitwise_dicts(_load(f"{tmp}/whole/{ckpt}"),
                         _load(f"{tmp}/cut/{ckpt}"))
    print(f"{what}: resumed process: rows "
          f"{steps[0]}..{steps[-1]} against the uninterrupted run's: "
          f"{'bitwise equal' if bitwise else 'DIFFERENT'}; final checkpoint: "
          f"{'bitwise equal' if not bad else bad}")
    if not bitwise:
        worst = max(abs(a[k] - b[k]) for a, b in zip(resumed, want)
                    for k in a if k != "step")
        print(f"{what}: max|d| over the rows {worst:.3e}")
    check(steps == list(range(cut_at + 1, iters + 1)) and bitwise and not bad,
          f"{what}: rows {cut_at + 1}-{iters} and the final state equal the "
          "uninterrupted run's bitwise")


def phase_restart(device, tmp):
    """The real fused GS chunks with the metrics of chunk 2 poisoned (NaN)
    on the original stream: at --max-restarts 1 the run restores step 10
    with reseeded chains, prints the WATCHDOG line and completes; at 0 it
    raises the JAX CLI's message."""
    import argparse
    import contextlib
    import io

    import torch

    from fermiflow_tpu_torch.cli import common
    from fermiflow_tpu_torch.ops import _build
    from fermiflow_tpu_torch.train import init_gs_state, make_gs_fused_multi_step
    from fermiflow_tpu_torch.utils import MetricsLogger

    def run(max_restarts, ckpt_dir):
        parser = argparse.ArgumentParser()
        common.add_flags(parser)
        cfg = common.config_from_args(parser.parse_args(
            _ckpt_argv(device, CKPT_ITERS, ckpt_dir, False)
            + ["--max-restarts", str(max_restarts)]))
        model, params = common.build_gs(cfg)
        state = init_gs_state(model, params, cfg, device)
        original = []

        def make_chunk(k):
            fn = make_gs_fused_multi_step(model, cfg, k)

            def chunk(state):
                start, gen = state.step, state.generator.get_state()
                state, stacked = fn(state)
                if start == CKPT_EVERY:
                    if not original:
                        original.append(gen)
                    if torch.equal(gen, original[0]):
                        stacked = dict(stacked, E=stacked["E"] * float("nan"))
                return state, stacked

            return chunk

        printed, out = [], io.StringIO()
        _build.reset_launch_counts()
        with contextlib.redirect_stdout(out):
            try:
                state = common.run_training_loop(
                    state, cfg, make_chunk, MetricsLogger(None),
                    lambda rec: printed.append(rec["step"]))
                raised = None
            except FloatingPointError as e:
                raised = str(e)
        return state, printed, out.getvalue(), raised, dict(_build.LAUNCHES)

    state, printed, out, raised, counts = run(1, f"{tmp}/restart1")
    lines = [l for l in out.splitlines() if l.startswith("WATCHDOG:")]
    print(f"restart: {lines}; printed steps {printed[0]}..{printed[-1]} "
          f"({len(printed)} rows); launches {json.dumps(counts)}")
    check(raised is None and state.step == CKPT_ITERS
          and printed == list(range(1, CKPT_ITERS + 1))
          and lines == [f"WATCHDOG: non-finite energy (E=nan) at iteration "
                        f"{2 * CKPT_EVERY}; restored checkpoint step "
                        f"{CKPT_EVERY} with reseeded chains (restart 1/1)"]
          and counts["metropolis_chains"] == CKPT_ITERS // SEGMENTS + 1,
          "restart: chunk 2 poisoned on the original stream restores step "
          f"{CKPT_EVERY}, prints the WATCHDOG line and completes")
    _, _, _, raised, _ = run(0, f"{tmp}/restart0")
    want = (f"non-finite energy (E=nan) at iteration {2 * CKPT_EVERY}; "
            "0/0 restarts used")
    print(f"restart at --max-restarts 0: FloatingPointError({raised!r})")
    check(raised == want, "restart: at --max-restarts 0 the JAX message is "
          "raised")


def phase_nested(device, z_eq, params):
    """The nested-jvp engine: the Z=0 identity oracle, the path through the
    CLI (3 iterations at K=3, 1 at K=1), its peak memory and its E against
    the Hessian-flow kernels' on the same walkers and parameters."""
    import torch

    from fermiflow_tpu_torch.cli import ground_state

    # The path's batch: it fits (9.2 GiB at its peak on an 80 GB card).
    batch = BATCH
    model0, params0 = make_model(0.0, device, N)
    e0 = float(model0.basedist.orbitals.Es[:N].sum())
    x = z_eq.T.reshape(batch, N, 2)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        eloc, _ = model0.local_energy(params0, x)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    err = (eloc.double() - e0).abs()
    frac = float((err > 1e-3).double().mean())
    print(f"nested jvp identity oracle N={N} Z=0, batch {batch}: "
          f"peak {peak / 2**30:.2f} GiB; max|Eloc - {e0:g}| "
          f"{float(err.max()):.3e}, outside 1e-3: {frac:.2e}")
    check(bool(torch.isfinite(eloc).all()) and frac <= 1e-3,
          f"nested jvp: identity flow Eloc = {e0:g} within 1e-3 on >= 99.9% "
          "of walkers")

    model, _ = make_model(0.5, device, N, batch)
    z = z_eq
    _, e_hf, _, _ = model.local_energy_cm(params, z)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        x = model.cnf.generate(params, z.T.reshape(batch, N, 2))
        e_jvp, _ = model.local_energy(params, x)
    torch.cuda.synchronize()
    peak_engine = torch.cuda.max_memory_allocated()
    E_hf, E_jvp = float(e_hf.double().mean()), float(e_jvp.double().mean())
    rel = abs(E_jvp - E_hf) / abs(E_hf)
    print(f"nested jvp against the Hessian-flow kernels (Gaussian weights, "
          f"batch {batch}): E {E_jvp:.7f} / {E_hf:.7f}, relative {rel:.3e}; "
          f"peak {peak_engine / 2**30:.2f} GiB")
    check(rel <= E_ENGINES_RTOL, f"nested jvp: E within {E_ENGINES_RTOL:g} "
          "(relative) of the Hessian-flow kernels' E")

    torch.cuda.reset_peak_memory_stats()
    _, recs, counts = drive_path(
        ground_state.main, path_argv(device, 3, 3, batch=batch)
        + ["--local-energy", "nested_jvp"])
    peak_path = torch.cuda.max_memory_allocated()
    energies = [r["E"] for r in recs]
    print(f"nested-jvp path: batch {batch}, 3 iterations (one K=3 chunk); "
          f"E {energies}; peak {peak_path / 2**30:.2f} GiB; launches {json.dumps(counts)}")
    check(len(recs) == 3 and all(math.isfinite(e) and 17.0 < e < 21.0
                                 for e in energies),
          "nested-jvp path: 3 iterations, every E finite and in (17, 21)")
    check(counts["metropolis_chains"] == 1 and sum(counts.values()) == 1,
          "nested-jvp path: one launch of kernel #1 and of no other")
    _, recs1, counts1 = drive_path(
        ground_state.main, path_argv(device, 1, 1, batch=batch)
        + ["--local-energy", "nested_jvp"])
    print(f"nested-jvp path K=1: E {recs1[0]['E']:.5f}; launches "
          f"{json.dumps(counts1)}")
    check(counts1["metropolis_single"] == 1 and sum(counts1.values()) == 1
          and 17.0 < recs1[0]["E"] < 21.0,
          "nested-jvp path K=1: one launch of kernel #5 and of no other")


def phase_solvers(device, z_eq, params, tmp):
    """Two iterations each at --ode-solver adaptive and adjoint (the
    nested-jvp path, whose samples come from CNF.generate), the adjoint's
    gradient against the fixed grid's, and the density movie."""
    import dataclasses

    import numpy as np
    import torch

    from fermiflow_tpu_torch.cli import ground_state

    for solver in ("adaptive", "adjoint"):
        _, recs, counts = drive_path(
            ground_state.main, path_argv(device, 2, 2, batch=SOLVER_BATCH)
            + ["--local-energy", "nested_jvp", "--ode-solver", solver])
        energies = [r["E"] for r in recs]
        print(f"--ode-solver {solver}: batch {SOLVER_BATCH}, 2 iterations, "
              f"E {energies}; launches {json.dumps(counts)}")
        check(len(recs) == 2 and all(math.isfinite(e) for e in energies)
              and counts["metropolis_chains"] == 1,
              f"--ode-solver {solver}: 2 iterations with finite E")

    model, _ = make_model(0.5, device, N, SOLVER_BATCH)
    z = z_eq[:, :SOLVER_BATCH].T.reshape(SOLVER_BATCH, N, 2)
    w = torch.randn(z.shape, generator=torch.Generator(device).manual_seed(
        SEED + 31), device=device)
    grads = []
    for cnf in (model.cnf, dataclasses.replace(model.cnf, solver="adjoint")):
        p = {k: {kk: t.detach().clone().requires_grad_(True)
                 for kk, t in v.items()} for k, v in params.items()}
        leaves = [p[m][k] for m in ("eta", "mu") for k in ("w1", "b1", "w2")]
        grads.append(torch.autograd.grad((w * cnf.generate(p, z)).sum(),
                                         leaves))
    worst = max(float((a - b).abs().max() / b.abs().max())
                for a, b in zip(*grads))
    print(f"adjoint gradient against the fixed grid's autograd gradient: max "
          f"over leaves of max|d| / max|g| {worst:.3e}")
    check(worst <= ADJOINT_GRAD_RTOL, "adjoint: the parameter gradient "
          f"within {ADJOINT_GRAD_RTOL:g} of each leaf's largest entry of the "
          "fixed grid's")

    movie = f"{tmp}/movie.npy"
    state, _, counts = drive_path(
        ground_state.main, path_argv(device, 1, 1, batch=SOLVER_BATCH)
        + ["--movie", movie, "--movie-frames", str(MOVIE_FRAMES),
           "--movie-walkers", str(MOVIE_WALKERS)])
    frames = np.load(movie)
    fine = dataclasses.replace(model.cnf, steps=4 * (MOVIE_FRAMES - 1))
    with torch.no_grad():
        z0 = torch.as_tensor(frames[0], device=device)
        x_fine = fine.generate(state.params, z0)
        x_grid = model.cnf.generate(state.params, z0)
    last = torch.as_tensor(frames[-1], device=device)
    d_fine = float((last - x_fine).abs().max())
    d_grid = float((last - x_grid).abs().max())
    scale = 1.0 + float(last.abs().max())
    print(f"movie: frames {frames.shape}; last frame against generate of the "
          f"first on the trajectory's grid max|d| {d_fine:.3e}, on the "
          f"4-step grid {d_grid:.3e}; launches {json.dumps(counts)}")
    check(frames.shape == (MOVIE_FRAMES, MOVIE_WALKERS, N, 2)
          and np.isfinite(frames).all() and d_fine <= 1e-5 * scale,
          "movie: (frames, walkers, n, 2) finite frames, the last equal to "
          "generate of the first within 1e-5 x (1 + max|x|)")


def phase_no_pallas(device, z_eq, params):
    """--no-pallas-sampler --no-pallas-local-energy --no-pallas-reinforce:
    the path launches none of the port's kernels, and the update (plain
    Hessian flow, autograd) matches the kernel chain within phase 5's
    bounds."""
    import torch

    from fermiflow_tpu_torch.cli import ground_state

    flags = ["--no-pallas-sampler", "--no-pallas-local-energy",
             "--no-pallas-reinforce"]
    _, recs, counts = drive_path(
        ground_state.main, path_argv(device, 2, 2) + flags)
    energies = [r["E"] for r in recs]
    print(f"--no-pallas-*: 2 iterations, E {energies}; "
          f"launches {json.dumps(counts)}")
    check(sum(counts.values()) == 0 and all(17.0 < e < 21.0 for e in energies),
          "--no-pallas-*: no kernel launched, every E in (17, 21)")
    model, _ = make_model(0.5, device, N, z_eq.shape[1])
    loss_k, m_k, g_k = model.loss_metrics_grads_cm(params, z_eq)
    p = {k: {kk: t.detach().clone().requires_grad_(True)
             for kk, t in v.items()} for k, v in params.items()}
    loss_a, m_a = model.loss_and_metrics_from_base(
        p, z_eq.T.reshape(z_eq.shape[1], N, 2))
    loss_a.backward()
    g_a = {m: {k: p[m][k].grad for k in p[m]} for m in p}
    torch.cuda.synchronize()
    worst, ok_g = flow_grads_close(g_k, g_a)
    print(f"--no-pallas-* update vs the kernel chain: E {float(m_a['E']):.7f} / "
          f"{float(m_k['E']):.7f}, loss {float(loss_a):.4e} / "
          f"{float(loss_k):.4e}, grads max|d| {worst:.3e}")
    check(allclose64(m_a["E"], m_k["E"], 1e-5, 0.0)
          and allclose64(m_a["E_std"], m_k["E_std"], 1e-5, 0.0)
          and allclose64(loss_a.detach(), loss_k, 1e-4, 1e-6) and ok_g,
          "--no-pallas-*: E, E_std within rtol 1e-5, loss and every gradient "
          "leaf within rtol 1e-4, atol 1e-6 of the kernel chain's")


# ---- phase 9: the walker mesh (parallel/mesh.py) ----

MESH_ITERS = 20  # (a), (b): checkpoints every CKPT_EVERY
# (d): the warm-up chunk and three replays; its first MESH_ITERS rows are
# held to the run without a process group.
MESH_NCCL_ITERS = 40
MESH_BETA_ITERS = 10  # (c)
# f32 sums in another order: the first row's E and F (walkers bitwise, the
# parameters still equal) to 1e-6; later rows after that many Adam steps on
# gradients summed in another order to 1e-4 (GS) and 1e-3 (finite T, whose
# states also follow the logits).
MESH_FIRST_RTOL, MESH_GS_RTOL, MESH_BETA_RTOL = 1e-6, 1e-4, 1e-3
MESH_NCCL_RTOL = 1e-6  # (d): one rank of NCCL against no process group


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _dist_argv(world: int, rank: int, port: int) -> list:
    return ["--coordinator", f"127.0.0.1:{port}", "--num-processes",
            str(world), "--process-id", str(rank), "--init-timeout", "120"]


def _spawn_ranks(mod: str, argv: list, world: int = 2) -> list:
    """``world`` processes of the CLI ``mod``, one per rank, all on this
    card (gloo: NCCL refuses two ranks on one device)."""
    import os

    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, "-m", f"fermiflow_tpu_torch.cli.{mod}", *argv,
         *_dist_argv(world, rank, port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
        for rank in range(world)]


def _wait_ranks(procs: list, what: str) -> list:
    """Every rank's output; all are killed if one fails or hangs."""
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            check(False, f"{what}: rank {rank} exited {p.returncode}; its "
                  f"output ends {out.strip().splitlines()[-8:]}")
    check(True, f"{what}: every rank ran to its end")
    return outs


def _ckpt_walkers(directory: str, step: int, world: int):
    """(walkers_cm, tau) of a checkpoint step, merged over its shards."""
    import torch

    name = f"ckpt_{step:08d}.pt"
    if world == 1:
        t = _load(f"{directory}/{name}")["tensors"]
        return t["walkers_cm"], t["tau"]
    parts = [_load(f"{directory}/proc{r:05d}/{name}")["tensors"]
             for r in range(world)]
    return (torch.cat([p["walkers_cm"] for p in parts], dim=1),
            torch.cat([p["tau"] for p in parts]))


def _same_walkers(a_dir, a_world, b_dir, b_world, step) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(
        _ckpt_walkers(a_dir, step, a_world),
        _ckpt_walkers(b_dir, step, b_world)))


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


@contextlib.contextmanager
def counting_captures(calls: list):
    """Every capture of a chunk (``train._capture``) appended to
    ``calls``."""
    from fermiflow_tpu_torch import train

    capture = train._capture
    train._capture = lambda *a, **k: (calls.append(1), capture(*a, **k))[1]
    try:
        yield
    finally:
        train._capture = capture


def _nccl_rank(device, graph: bool) -> dict:
    """Phase 9 (d)'s run: the GS path as one NCCL rank with --shard,
    captured (the default) or eager: its rows, launch counts, state
    tensors, captures and the CLI's mesh line."""
    import io

    from fermiflow_tpu_torch.cli import ground_state

    captures, out = [], io.StringIO()
    with counting_captures(captures), (
            contextlib.nullcontext() if graph else eager_chunks()), \
            contextlib.redirect_stdout(out):
        state, recs, counts = drive_path(
            ground_state.main, path_argv(device, MESH_NCCL_ITERS, SEGMENTS)
            + _dist_argv(1, 0, _free_port()) + ["--shard"])
    mesh_line = [ln for ln in out.getvalue().splitlines()
                 if ln.startswith("mesh:")]
    return dict(rows=recs, counts=counts, captures=len(captures),
                tensors=_state_snapshot(state),
                mesh_line=mesh_line[0] if mesh_line else "(no mesh line)")


def phase_mesh(device, tmp):
    """(a) the GS production command (batch 8192 global, K=10, 20
    iterations, checkpoints every 10) as 2 ranks sharing the card over
    gloo against one process: walkers and tau bitwise at steps 10 and 20,
    E within MESH_FIRST_RTOL on the first row and MESH_GS_RTOL on every
    row; (b) (a)'s step-10 shards resumed in one process: its step-20
    walkers bitwise the one-process run's; (c) the finite-T path as 2 ranks
    against one process: F within MESH_FIRST_RTOL on the first row,
    MESH_BETA_RTOL on every row; (d) one rank of NCCL with --shard against
    the run without it: every E within MESH_NCCL_RTOL."""
    import os
    import shutil

    from fermiflow_tpu_torch.cli import finite_t, ground_state

    gs2, gs1, resumed = f"{tmp}/gs2", f"{tmp}/gs1", f"{tmp}/resumed"
    gs_argv = _ckpt_argv(device, MESH_ITERS, gs2, False)
    outs = _wait_ranks(_spawn_ranks(
        "ground_state", gs_argv + ["--metrics", f"{tmp}/gs2.jsonl"]),
        "mesh (a)")
    for rank, out in enumerate(outs):
        check(f"torch.distributed: process {rank}/2, backend gloo" in out,
              f"mesh (a): rank {rank} printed its bring-up line")
    check("iter:" not in outs[1] and "iter: 001" in outs[0],
          "mesh (a): rank 0 alone prints rows")
    mesh_line = [ln for ln in outs[0].splitlines() if ln.startswith("mesh:")]
    check(len(mesh_line) == 1, "mesh (a): rank 0 printed the collectives")
    rows2 = _rows(f"{tmp}/gs2.jsonl")

    # The (c) pair runs while this process drives the one-process runs.
    beta_argv = ["--beta", str(BETA), "--deltaE", str(DELTA_E),
                 "--boltzmann"] + path_argv(device, MESH_BETA_ITERS, SEGMENTS)
    beta_procs = _spawn_ranks("finite_t", beta_argv + [
        "--metrics", f"{tmp}/beta2.jsonl"])
    try:
        _, recs1, _ = drive_path(ground_state.main, _ckpt_argv(
            device, MESH_ITERS, gs1, False))
        rows1 = [{k: v for k, v in r.items() if k not in TIMING_KEYS}
                 for r in recs1]
        os.makedirs(resumed)
        for r in range(2):
            shutil.copytree(f"{gs2}/proc{r:05d}", f"{resumed}/proc{r:05d}",
                            ignore=lambda d, names: [
                                n for n in names
                                if n != f"ckpt_{CKPT_EVERY:08d}.pt"])
        drive_path(ground_state.main, _ckpt_argv(device, MESH_ITERS, resumed,
                                                 False))
        nccl = {graph: _nccl_rank(device, graph) for graph in (True, False)}
        _, recs_b1, _ = drive_path(finite_t.main, beta_argv)
    except BaseException:
        for p in beta_procs:
            p.kill()
            p.wait()
        raise
    beta_outs = _wait_ranks(beta_procs, "mesh (c)")
    rows_b2 = _rows(f"{tmp}/beta2.jsonl")

    e_first = _rel(rows2[0]["E"], rows1[0]["E"])
    e_worst = max(_rel(a["E"], b["E"]) for a, b in zip(rows2, rows1))
    same = {step: _same_walkers(gs2, 2, gs1, 1, step)
            for step in (CKPT_EVERY, MESH_ITERS)}
    print(f"mesh (a): GS N={N}, batch {BATCH} as 2 ranks on one card (gloo) "
          f"against one process: walkers and tau bitwise at steps "
          f"{json.dumps(same)}; E rel. diff first row {e_first:.3e}, largest "
          f"{e_worst:.3e}")
    check(len(rows2) == MESH_ITERS and all(same.values()),
          "mesh (a): walkers and tau at steps 10 and 20 bitwise the "
          "one-process run's")
    check(e_first <= MESH_FIRST_RTOL and e_worst <= MESH_GS_RTOL,
          f"mesh (a): E within rtol {MESH_FIRST_RTOL:g} on the first row "
          f"and {MESH_GS_RTOL:g} on every row")
    same_b = _same_walkers(resumed, 1, gs1, 1, MESH_ITERS)
    print(f"mesh (b): step-{CKPT_EVERY} shards of (a) resumed in one "
          f"process: step-{MESH_ITERS} walkers and tau "
          f"{'bitwise equal' if same_b else 'DIFFERENT'}")
    check(same_b, "mesh (b): the 2 -> 1 resume's walkers at step 20 are "
          "bitwise the one-process run's")
    f_first = _rel(rows_b2[0]["F"], recs_b1[0]["F"])
    f_worst = max(_rel(a["F"], b["F"]) for a, b in zip(rows_b2, recs_b1))
    print(f"mesh (c): finite T N={N}, beta {BETA:g}, deltaE {DELTA_E:g} as "
          f"2 ranks: F rel. diff first row {f_first:.3e}, largest "
          f"{f_worst:.3e} over {len(rows_b2)} rows")
    check("total number of states = 54" in beta_outs[0]
          and "iter:" not in beta_outs[1], "mesh (c): rank 0 alone prints")
    check(len(rows_b2) == MESH_BETA_ITERS
          and all(math.isfinite(r["F"]) for r in rows_b2)
          and f_first <= MESH_FIRST_RTOL and f_worst <= MESH_BETA_RTOL,
          f"mesh (c): F finite, within rtol {MESH_FIRST_RTOL:g} on the first "
          f"row and {MESH_BETA_RTOL:g} on every row")
    recs_d, counts_d = nccl[True]["rows"], nccl[True]["counts"]
    d_worst = max(_rel(a["E"], b["E"]) for a, b in zip(recs_d, recs1))
    same_d = _bitwise_dicts(nccl[True]["tensors"], nccl[False]["tensors"])
    rows_d = [{k: v for k, v in r.items() if k not in TIMING_KEYS}
              for r in recs_d]
    rows_e = [{k: v for k, v in r.items() if k not in TIMING_KEYS}
              for r in nccl[False]["rows"]]
    print(f"mesh (d): one NCCL rank with --shard, captured ("
          f"{nccl[True]['captures']} captures) against the same rank eager "
          f"({nccl[False]['captures']}): rows "
          f"{'bitwise equal' if rows_d == rows_e else 'DIFFERENT'}, state "
          f"{'bitwise equal' if not same_d else same_d[:8]}; against no "
          f"process group: E largest rel. diff {d_worst:.3e} over "
          f"{MESH_ITERS} rows; captured {nccl[True]['mesh_line']}; eager "
          f"{nccl[False]['mesh_line']}; launches {json.dumps(counts_d)}")
    check(nccl[True]["captures"] > 0 and nccl[False]["captures"] == 0
          and "replayed" in nccl[True]["mesh_line"]
          and "(0 of them in replayed" not in nccl[True]["mesh_line"],
          "mesh (d): the NCCL rank's chunks were captured and replayed, "
          "its collectives counted per replay")
    check(rows_d == rows_e and not same_d,
          "mesh (d): the captured NCCL rank's rows and state bitwise its "
          "eager run's")
    check(len(recs_d) == MESH_NCCL_ITERS and d_worst <= MESH_NCCL_RTOL,
          f"mesh (d): every E within rtol {MESH_NCCL_RTOL:g}")


def phase_taut(device, tmp):
    """Phase 10 (b): the Taut singlet and triplet, TAUT_ITERS iterations
    each through ``cli.ground_state.main`` at the production protocol, with
    checkpoints; returns each one's (tail mean, tail sem)."""
    from fermiflow_tpu_torch.cli import ground_state

    out = {}
    for name, spec in TAUT.items():
        argv = (spec["argv"] + [
            "--batch", str(BATCH), "--dtype", "float32", "--persistent",
            "--mcmc-steps", str(MCMC_STEPS), "--steps-per-call",
            str(SEGMENTS), "--ode-steps", "8", "--lr", "3e-3", "--seed", "42",
            "--iternum", str(TAUT_ITERS), "--Deta", str(D_ETA), "--Dmu",
            str(D_MU), "--device", device.type, "--checkpoint-dir",
            f"{tmp}/{name}", "--checkpoint-every", str(TAUT_ITERS // 2)])
        state, recs, counts = drive_path(ground_state.main, argv)
        tail = [r["E"] for r in recs[-TAUT_TAIL:]]
        mean = sum(tail) / len(tail)
        sem = math.sqrt(sum((e - mean) ** 2 for e in tail)
                        / (len(tail) - 1) / len(tail))
        lo, hi = spec["e_range"]
        print(f"taut {name}: {TAUT_ITERS} iterations; E of "
              f"rows {TAUT_ITERS - TAUT_TAIL + 1}-{TAUT_ITERS} {mean:.5f} +- "
              f"{sem:.5f}; launches {json.dumps(counts)}")
        check(state.step == TAUT_ITERS and len(recs) == TAUT_ITERS
              and all(math.isfinite(r["E"]) for r in recs),
              f"taut {name}: every iteration ran, every E finite")
        check(lo < mean < hi, f"taut {name}: mean E of rows "
              f"{TAUT_ITERS - TAUT_TAIL + 1}-{TAUT_ITERS} in ({lo}, {hi})")
        check(all(counts[k] > 0 for k in GS_KERNELS),
              f"taut {name}: every kernel of the path was launched")
        out[name] = (mean, sem)
    return out


def phase_eval(device, ckpt, tail_mean, tail_sem, tmp):
    """Phase 10 (c): the checkpoint evaluator on the singlet's final
    checkpoint with both engines on the same fresh walkers."""
    from fermiflow_tpu_torch.cli import eval_at_checkpoint
    from fermiflow_tpu_torch.ops import _build

    res = {}
    for engine in ("hessian_flow", "nested_jvp"):
        _build.reset_launch_counts()
        res[engine] = eval_at_checkpoint.main([
            "--ckpt", ckpt, "--nup", "1", "--ndown", "1", "--Z", "1.0",
            "--batch", str(BATCH), "--train-batch", str(BATCH), "--equil",
            str(EVAL_EQUIL), "--reps", str(EVAL_REPS), "--ode-steps", "8",
            "--Deta", str(D_ETA), "--Dmu", str(D_MU), "--engine", engine, "--device", device.type, "--out",
            f"{tmp}/eval_{engine}.json"])
        counts = {k: v for k, v in _build.LAUNCHES.items() if v}
        r = res[engine]
        tol = 3.0 * math.hypot(r["E_sem"], tail_sem) + 0.005
        print(f"eval {engine}: step {r['step']}, E {r['E']:.5f} +- "
              f"{r['E_sem']:.5f} over {r['n_total']} fresh walkers, tail "
              f"{tail_mean:.5f}, |d| {abs(r['E'] - tail_mean):.5f} (tol "
              f"{tol:.5f}); launches {json.dumps(counts)}")
        check(math.isfinite(r["E"]) and abs(r["E"] - tail_mean) <= tol,
              f"eval {engine}: E within 3 combined sems + 0.005 of the "
              "training tail")
        if engine == "hessian_flow":
            check(counts.get("slater_vgh") == EVAL_REPS
                  and counts.get("hessian_flow") == EVAL_REPS,
                  "eval hessian_flow: the VGH and Hessian-flow kernels, once "
                  "a round")
        else:
            check(not counts, "eval nested_jvp: no kernel launched")
    rel = _rel(res["hessian_flow"]["E"], res["nested_jvp"]["E"])
    print(f"eval engines on the same walkers: E relative {rel:.3e}")
    check(rel <= E_ENGINES_RTOL, f"eval: the engines' E within "
          f"{E_ENGINES_RTOL:g} (relative) of each other")


def phase_converged(device, tmp):
    """Phase 10: (a) kernels #1-#5 at nup=1, ndown=1 against their plain
    versions; (b) the Taut anchors; (c) the evaluator.  Returns the (1, 1)
    kernel rows."""
    import torch

    rows11 = {}
    z11, _ = phase_kernels(device, rows11, 2, BATCH, ACCEPT_TAU01_11, "_11",
                           ndown=1)
    phase_single_chain(device, rows11, z11, torch.Generator(
        device=device).manual_seed(SEED + 31), 2, BATCH, ACCEPT_TAU01_11,
        "_11", ndown=1)
    taut = phase_taut(device, tmp)
    mean, sem = taut["singlet"]
    phase_eval(device, f"{tmp}/singlet", mean, sem, tmp)
    return rows11


def phase_strong_coupling(device, tmp):
    """Phase 11: (a) the kernel route of ``FreeFermion.sample`` against the
    plain sampler; (b) the GS path at Z = 8; (c) the crossover structure at
    (b)'s checkpoint."""
    import numpy as np
    import torch

    from fermiflow_tpu_torch.cli import crossover_analysis, ground_state
    from fermiflow_tpu_torch.cli.eval_at_checkpoint import restore_model
    from fermiflow_tpu_torch.ops import _build
    from fermiflow_tpu_torch.physics import HO2D, FreeFermion

    fb = FreeFermion(HO2D())
    up, dn = np.arange(N), np.arange(0)
    draws = {}
    for name, use in (("kernel", True), ("plain", False)):
        gen = torch.Generator(device=device).manual_seed(SEED + 41)
        before = _build.LAUNCHES["metropolis_single"]
        x, acc = fb.sample(up, dn, gen, (XOVER_WALKERS,),
                           equilibrium_steps=XOVER_EQUIL, tau=0.1,
                           dtype=torch.float32, use_pallas=use,
                           return_accept=True)
        launched = _build.LAUNCHES["metropolis_single"] - before
        check(launched == (1 if use else 0), f"sample {name}: kernel #5 "
              f"launched {int(use)} time(s)")
        r2 = (x.double()**2).sum((-2, -1))
        draws[name] = (r2, float(acc.mean()))
    (r2k, acck), (r2p, accp) = draws["kernel"], draws["plain"]
    se = float(torch.hypot(r2k.std(), r2p.std())) / math.sqrt(XOVER_WALKERS)
    dr2 = float(r2k.mean() - r2p.mean())
    print(f"sample {XOVER_WALKERS} walkers x {XOVER_EQUIL} steps, kernel "
          f"route against plain: <sum x^2> {float(r2k.mean()):.5f}"
          f" against {float(r2p.mean()):.5f} (diff {dr2:+.5f}, se {se:.5f}); "
          f"acceptance {acck:.4f} against {accp:.4f}")
    check(abs(dr2) < 5 * se and abs(acck - accp) < 0.01,
          "sample: kernel route against the plain sampler by distribution")

    ckpt = f"{tmp}/z8"
    argv = ["--nup", str(N), "--Z", str(XOVER_Z), "--batch", str(BATCH),
            "--dtype", "float32", "--persistent", "--mcmc-steps",
            str(MCMC_STEPS), "--steps-per-call", str(SEGMENTS), "--ode-steps",
            str(ODE_STEPS), "--lr", "3e-3", "--seed", "42", "--iternum",
            str(XOVER_ITERS), "--Deta", str(D_ETA), "--Dmu", str(D_MU),
            "--device", device.type, "--checkpoint-dir", ckpt,
            "--checkpoint-every", str(XOVER_ITERS)]
    state, recs, counts = drive_path(ground_state.main, argv)
    tail = [r["E"] for r in recs[-XOVER_TAIL:]]
    mean = sum(tail) / len(tail)
    lo, hi = XOVER_E_RANGE
    print(f"Z={XOVER_Z:g}: {XOVER_ITERS} iterations; E first "
          f"{recs[0]['E']:.4f}, rows {XOVER_ITERS - XOVER_TAIL + 1}-"
          f"{XOVER_ITERS} {mean:.5f}; launches {json.dumps(counts)}")
    check(state.step == XOVER_ITERS and len(recs) == XOVER_ITERS
          and all(math.isfinite(r["E"]) for r in recs),
          f"Z={XOVER_Z:g}: every iteration ran, every E finite")
    check(lo <= mean <= hi, f"Z={XOVER_Z:g}: mean E of rows "
          f"{XOVER_ITERS - XOVER_TAIL + 1}-{XOVER_ITERS} in [{lo}, {hi}]")
    check(all(counts[k] > 0 for k in GS_KERNELS),
          f"Z={XOVER_Z:g}: every kernel of the path was launched")

    flags = ["--ckpt", ckpt, "--nup", str(N), "--Z", str(XOVER_Z),
             "--walkers", str(XOVER_WALKERS), "--train-batch", str(BATCH),
             "--equil", str(XOVER_EQUIL), "--ode-steps", str(ODE_STEPS),
             "--Deta", str(D_ETA), "--Dmu", str(D_MU), "--device",
             device.type, "--out", f"{tmp}/xover.json"]
    _build.reset_launch_counts()
    rec = crossover_analysis.main(flags)
    check(_build.LAUNCHES["metropolis_single"] == 1,
          "crossover: the walkers drawn through kernel #5")
    norm_err = abs(rec["norm_integral"] - N * rec["inside_fraction"])
    # The same walkers again (the same seed; the kernel and the flow are
    # deterministic), and V_int summed pair by pair in float64.
    model, params, _ = restore_model(ckpt, N, 0, XOVER_Z, BATCH, "float32",
                                     ODE_STEPS, device.type, D_ETA, D_MU)
    gen = torch.Generator(device=device).manual_seed(7)
    _, x, _ = crossover_analysis.draw(model, params, gen, XOVER_WALKERS,
                                      XOVER_EQUIL)
    xd = x.double()
    v_int = sum(XOVER_Z / torch.linalg.norm(xd[:, i] - xd[:, j], dim=-1)
                for i in range(N) for j in range(i + 1, N))
    v_plain = float(v_int.mean())
    rel = abs(rec["V_int"] - v_plain) / v_plain
    print(f"crossover at Z={XOVER_Z:g}: rms r "
          f"{rec['rms_r']:.5f}, mean pair distance "
          f"{rec['mean_pair_distance']:.5f}, n(0) {rec['n0']:.5f}, V_int "
          f"{rec['V_int']:.5f} (float64 pair sum {v_plain:.5f}, relative "
          f"{rel:.2e}), V_trap {rec['V_trap']:.5f}; normalisation "
          f"{norm_err:.2e}")
    check(norm_err <= XOVER_NORM_TOL, "crossover: 2 pi sum r n(r) dr = N x "
          f"(share inside rmax) to {XOVER_NORM_TOL:g}")
    check(rel <= XOVER_VINT_RTOL, f"crossover: V_int within "
          f"{XOVER_VINT_RTOL:g} of the float64 recomputation")


# ---- phase 12: the compiled chunk (train.py) ----

GRAPH_CHUNKS = 3  # (a): the warm-up chunk, then two replays
GRAPH_RUN_CHUNKS = 25  # (b): chunks of K=10 (ten times as many at K=1)
GRAPH_TRACE_ITERS = 30  # (c): the CLI traces chunk 2, a replay


def _graph_configs(device):
    """(name, CLI argv at ``iters``, finite T, K, traced) of the paths phase
    12 (b) runs, and (c) traces where ``traced``: the four persistent-walker
    paths and the fresh-walker protocol (the CLIs' default) at GS N=6, K=10
    and K=1, and finite T N=6."""
    return [
        ("GS N=6", lambda it: path_argv(device, it, SEGMENTS), False,
         SEGMENTS, True),
        ("GS N=10", lambda it: path_argv(device, it, SEGMENTS, N10, BATCH10,
                                         LR10), False, SEGMENTS, True),
        ("finite T N=6", lambda it: beta_argv(device, it), True, SEGMENTS,
         True),
        ("finite T N=10", lambda it: beta_argv(
            device, it, N10, BETA10, DELTA_E10, BATCH_BETA10, LR_BETA10),
         True, SEGMENTS, True),
        ("GS N=6 fresh", lambda it: path_argv(device, it, SEGMENTS,
                                              persistent=False), False,
         SEGMENTS, True),
        ("GS N=6 K=1 fresh", lambda it: path_argv(device, it, 1,
                                                  persistent=False), False,
         1, False),
        ("finite T N=6 fresh", lambda it: beta_argv(device, it,
                                                    persistent=False), True,
         SEGMENTS, False),
    ]


def _path_chunk(argv, finite, steps_per_call, graph):
    """A fresh state of the CLI run ``argv`` and its chunk of
    ``steps_per_call`` iterations, captured or eager."""
    import argparse

    import torch

    from fermiflow_tpu_torch.cli import common
    from fermiflow_tpu_torch.train import (
        init_beta_state,
        init_gs_state,
        make_beta_train_step,
        make_gs_fused_multi_step,
        make_gs_train_step,
        make_multi_step,
    )

    parser = argparse.ArgumentParser()
    common.add_flags(parser, finite_t=finite)
    cfg = common.config_from_args(parser.parse_args(argv), finite_t=finite)
    device = torch.device(cfg.device, 0)
    if finite:
        model, params = common.build_beta(cfg)
        state = init_beta_state(model, params, cfg, device)
        chunk = make_multi_step(make_beta_train_step(model, cfg, graph=graph),
                                steps_per_call)
    else:
        model, params = common.build_gs(cfg)
        state = init_gs_state(model, params, cfg, device)
        chunk = (make_gs_fused_multi_step(model, cfg, steps_per_call,
                                          graph=graph)
                 if steps_per_call > 1 else
                 make_multi_step(make_gs_train_step(model, cfg, graph=graph),
                                 1))
    return state, chunk


def _state_snapshot(state):
    """Copies of every tensor a chunk changes: the state's, Adam's step and
    both moments, and both generators' states."""
    from fermiflow_tpu_torch.utils.checkpointing import named_tensors

    out = {k: v.detach().clone() for k, v in named_tensors(state).items()}
    for i, st in enumerate(state.optimizer.state.values()):
        out.update({f"adam{i}.{k}": v.clone() for k, v in st.items()})
    out["generator"] = state.generator.get_state()
    if state.device_generator is not None:
        out["device_generator"] = state.device_generator.get_state()
    return out


def _side_by_side(tag, what, argv, finite, K):
    """GRAPH_CHUNKS chunks of the CLI run ``argv`` captured and eager from
    the same seed, side by side, in turns (captured, eager, then eager,
    captured, ...).  Fails unless every state tensor, Adam's step and
    moments, both generators and every metric are bitwise equal after
    every chunk (phase 12 ``tag``), and unless every E or F is finite."""
    import torch

    from fermiflow_tpu_torch.utils import MetricsLogger

    runs = {g: list(_path_chunk(argv, finite, K, g)) for g in (True, False)}
    bad = set()
    key, finite_rows = ("F" if finite else "E"), True
    for i in range(GRAPH_CHUNKS):
        snaps = {}
        for graph in ((True, False) if i % 2 == 0 else (False, True)):
            state, chunk = runs[graph]
            state, m = chunk(state)
            recs = MetricsLogger(None).log_many(1, m, time.time())
            finite_rows &= all(math.isfinite(r[key]) for r in recs)
            runs[graph][0] = state
            snaps[graph] = dict(_state_snapshot(state),
                                **{"metric." + k: v.clone()
                                   for k, v in m.items()})
        bad |= {f"{k} (chunk {i + 1})" for k in snaps[True]
                if not torch.equal(snaps[True][k].cpu(),
                                   snaps[False][k].cpu())}
    torch.cuda.synchronize()
    chunk = runs[True][1]
    print(f"phase 12 {tag} {what}: {GRAPH_CHUNKS} chunks "
          f"({GRAPH_CHUNKS * K} iterations; the first eager, then replays), "
          f"captured against eager: "
          f"{'bitwise equal' if not bad else sorted(bad)[:8]}", flush=True)
    check(chunk._replay is not None and runs[True][0].step
          == runs[False][0].step == GRAPH_CHUNKS * K and not bad,
          f"phase 12 {tag} {what}: the captured chunk's state, Adam, "
          "generators and metrics equal the eager chunk's bitwise")
    check(finite_rows, f"phase 12 {tag} {what}: every {key} finite")


def phase_graph_bitwise(device):
    """Phase 12 (a): the captured chunk against the eager one from the same
    seed, side by side (``_side_by_side``): GS N=6 at K=10 and K=1, finite
    T N=6 at K=10, each with persistent and with fresh walkers, and GS and
    finite T N=10 at K=10 with persistent walkers (the eager chunk at N=10,
    which the gloo mesh, the adaptive and adjoint solvers and
    ``--debug-nans`` run)."""
    for persistent in (True, False):
        tag = "" if persistent else " fresh"
        for what, argv, finite, K in (
                ("GS N=6 K=10", path_argv(device, 0, SEGMENTS,
                                          persistent=persistent), False,
                 SEGMENTS),
                ("GS N=6 K=1", path_argv(device, 0, 1,
                                         persistent=persistent), False, 1),
                ("finite T N=6 K=10", beta_argv(device, 0,
                                                persistent=persistent),
                 True, SEGMENTS)):
            _side_by_side("(a)", what + tag, argv, finite, K)
    _side_by_side("(a)", "GS N=10 K=10", path_argv(
        device, 0, SEGMENTS, N10, BATCH10, LR10), False, SEGMENTS)
    _side_by_side("(a)", "finite T N=10 K=10", beta_argv(
        device, 0, N10, BETA10, DELTA_E10, BATCH_BETA10, LR_BETA10), True,
        SEGMENTS)


def phase_graph_finite(device):
    """Phase 12 (b): the captured chunk of each path of ``_graph_configs``
    for GRAPH_RUN_CHUNKS chunks of K=10 (ten times as many at K=1), each
    chunk's rows fetched as the CLI fetches them: every E or F finite."""
    import torch

    from fermiflow_tpu_torch.utils import MetricsLogger

    for what, argv, finite, K, _ in _graph_configs(device):
        state, chunk = _path_chunk(argv(0), finite, K, True)
        logger = MetricsLogger(None)
        key, finite_rows = ("F" if finite else "E"), True
        for _ in range(GRAPH_RUN_CHUNKS * SEGMENTS // K):
            state, m = chunk(state)
            recs = (logger.log_many(1, m, time.time()) if K > 1
                    else [logger.log(1, m)])
            finite_rows &= all(math.isfinite(r[key]) for r in recs)
        check(finite_rows, f"phase 12 (b) {what}: every {key} finite")
        del state, chunk
        torch.cuda.empty_cache()


def phase_graph_traces(device, tmp):
    """Phase 12 (c): the CLI's ``--profile-dir`` trace of chunk 2 (K=10), a
    replay, of each traced path (``_trace_row``).  The GS N=6 replay,
    persistent and fresh, must be one graph launch, no wait for the card
    before the replay's end, at most 10 launches (persistent) or only the
    registered device generator's two fills of its seed and offset
    (fresh), and the fresh one no host-to-card copy beyond the seed
    word."""
    out = {}
    for what, argv, finite, _, traced in _graph_configs(device):
        if not traced:
            continue
        out[what] = row = _trace_row(what, argv, finite, tmp)
        print(f"phase 12 (c) {what}: traced chunk 2 (10 iterations): "
              f"{json.dumps(row)}", flush=True)
    g = out["GS N=6"]
    check(g["graph_launches"] == 1 and g["launches"] <= 10
          and g["syncs_before_replay_end"] == 0 and g["kernels"] > 0,
          "phase 12 (c): the GS N=6 replay is one graph launch, at most 10 "
          "launches and no wait for the card before its end")
    f = out["GS N=6 fresh"]
    fills = f["own_launch_kernels"]
    check(f["graph_launches"] == 1 and f["syncs_before_replay_end"] == 0
          and f["kernels"] > 0 and f["launches"] == len(fills) <= 2
          and all("fill" in k.lower() for k in fills)
          and all(b is not None and b <= 4 * SEGMENTS
                  for b in f["htod_bytes"]),
          "phase 12 (c): the fresh GS N=6 replay is one graph launch, no "
          "launch of its own but the registered device generator's fills, "
          "no host-to-card copy beyond the seed word, no wait for the card "
          "before its end")
    return out


def _trace_row(what, argv, finite, tmp):
    """The CLI's ``--profile-dir`` trace of chunk 2, a replay, of ``argv``
    (at GRAPH_TRACE_ITERS iterations): the kernels the card ran, the
    ``cudaGraphLaunch``, ``cudaLaunchKernel`` and ``cudaStreamSynchronize``
    calls, the waits before the replay's end, the kernels launched outside
    the graph, the host-to-card copies' bytes and the run's launch counts."""
    from fermiflow_tpu_torch.cli import finite_t, ground_state

    prof = f"{tmp}/{what.replace(' ', '_')}"
    _, _, counts = drive_path(finite_t.main if finite else ground_state.main,
                              argv(GRAPH_TRACE_ITERS) + ["--profile-dir", prof])
    with open(f"{prof}/summary.json") as fh:
        calls = (summ := json.load(fh))["runtime_calls"]
    with open(f"{prof}/trace.json") as fh:
        evs = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]
    # Kernels launched on their own (by cudaLaunchKernel, not by the graph),
    # and the host-to-card copies with their bytes.
    own = {e.get("args", {}).get("correlation") for e in evs
           if e["name"].startswith("cudaLaunchKernel")}
    ends = [float(e["ts"]) + float(e["dur"]) for e in evs
            if e["name"] == "cudaGraphLaunch"]
    return dict(
        kernels=summ.get("kernels"),
        graph_launches=calls["cudaGraphLaunch"],
        launches=calls["cudaLaunchKernel"] + calls["cudaLaunchKernelExC"],
        syncs=calls["cudaStreamSynchronize"],
        syncs_before_replay_end=sum(
            1 for e in evs if e["name"] == "cudaStreamSynchronize"
            and ends and float(e["ts"]) < max(ends)),
        own_launch_kernels=[e["name"][:80] for e in evs
                            if e.get("cat") == "kernel"
                            and e.get("args", {}).get("correlation") in own],
        htod_bytes=[e.get("args", {}).get("bytes") for e in evs
                    if e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"]],
        kernel_launches={k: v for k, v in counts.items() if v})


# Phase 12 (a) and (c) of the autograd A/B paths, captured like the kernel
# chain.  A chunk of them is tens of thousands of kernels (the plain
# samplers and Hessian flow, autograd) whose eager run and capture take
# seconds of the host's time, so the fresh-walker cases run at
# AB_FRESH_BATCH walkers.
NO_PALLAS = ["--no-pallas-sampler", "--no-pallas-local-energy",
             "--no-pallas-reinforce"]
AB_FRESH_BATCH = 2048


def _ab_configs(device, persistent=True, batch=BATCH):
    """(name, CLI argv, finite T, K) of the autograd A/B paths at N=6:
    GS K=10 and finite T K=10 with every ``--no-pallas-*`` flag, GS K=3 on
    the nested-jvp engine, GS K=10 with ``--no-pallas-reinforce`` alone
    (kernels #1-#3, then autograd)."""
    tag = "" if persistent else f" fresh (batch {batch})"
    gs = lambda K, extra: path_argv(device, 0, K, batch=batch,
                                    persistent=persistent) + extra
    return [
        ("GS N=6 K=10 --no-pallas-*" + tag, gs(SEGMENTS, NO_PALLAS), False,
         SEGMENTS),
        ("GS N=6 K=3 nested-jvp" + tag,
         gs(3, ["--local-energy", "nested_jvp"]), False, 3),
        ("finite T N=6 K=10 --no-pallas-*" + tag,
         beta_argv(device, 0, batch=batch, persistent=persistent)
         + NO_PALLAS, True, SEGMENTS),
        ("GS N=6 K=10 --no-pallas-reinforce" + tag,
         gs(SEGMENTS, ["--no-pallas-reinforce"]), False, SEGMENTS),
    ]


def phase_graph_ab(device, tmp):
    """Phase 12 (a) and (c) of the autograd A/B paths (``_ab_configs``):
    (a) bitwise, persistent at batch 8192 and with fresh walkers at
    AB_FRESH_BATCH (``_side_by_side``); (c) the trace of a replayed chunk 2
    of the GS ``--no-pallas-reinforce`` path: one graph launch, no launch
    of its own but the registered device generator's two fills, no
    host-to-card copy beyond the seed word, no wait for the card before
    the replay's end.  Returns (c)'s row."""
    import torch

    for what, argv, finite, K in (_ab_configs(device) + _ab_configs(
            device, False, AB_FRESH_BATCH)):
        _side_by_side("(a)", what, argv, finite, K)
        torch.cuda.empty_cache()
    what, argv, finite, _ = _ab_configs(device)[3]
    g = _trace_row(what, lambda it: argv + ["--iternum", str(it)], finite,
                   tmp)
    print(f"phase 12 (c) {what}: traced chunk 2 ({SEGMENTS} iterations): "
          f"{json.dumps(g)}", flush=True)
    fills = g["own_launch_kernels"]
    check(g["graph_launches"] == 1 and g["syncs_before_replay_end"] == 0
          and g["kernels"] > 0 and g["launches"] == len(fills) <= 2
          and all("fill" in k.lower() for k in fills)
          and all(b is not None and b <= 4 * SEGMENTS
                  for b in g["htod_bytes"]),
          f"phase 12 (c) {what}: the replay is one graph launch, no launch "
          "of its own but the registered device generator's fills, no "
          "host-to-card copy beyond the seed word, no wait for the card "
          "before its end")
    return g


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable ({e})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test needs a GPU",
              file=sys.stderr)
        return 2
    try:
        import fermiflow_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    device = torch.device("cuda", 0)
    print(f"card: {smi}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)

    rows: dict = {}
    t_all = time.perf_counter()

    def phase(title: str) -> None:
        print(f"== phase {title} (at {time.perf_counter() - t_all:.1f} s)",
              flush=True)

    try:
        phase("1: build")
        ptxas = phase_build()
        warps, placed, lanes = phase_occupancy(device)
        for occ10 in (phase_occupancy_n10(device),
                      phase_occupancy_beta10(device)):
            for name, d in zip(("warps", "placed", "lanes"), occ10):
                {"warps": warps, "placed": placed, "lanes": lanes}[name].update(
                    {k + "_n10": v for k, v in d.items()})
        phase("2: kernels against their plain versions")
        z_eq, params = phase_kernels(device, rows)
        z_ms, idx = phase_kernels_ms(device, rows, z_eq)
        phase("3: oracles")
        phase_identity_oracle(device, z_eq)
        phase_beta_oracle(device, z_ms, idx)
        phase("4: paths")
        counts = {"gs": phase_main_path(device),
                  "beta": phase_beta_path(device),
                  "gs_single": phase_gs_single_path(device)}
        phase("5: updates against the plain updates")
        phase_update_vs_plain(device, z_eq, params)
        phase_beta_update_vs_plain(device, z_ms, idx, params)
        phase(f"6: the ground state at N={N10}, batch {BATCH10}")
        z10, params10 = phase_kernels(device, rows, N10, BATCH10,
                                      ACCEPT_TAU01_N10, "_n10", PARAM_STD_N10)
        phase_single_chain(device, rows, z10, torch.Generator(
            device=device).manual_seed(SEED + 11), N10, BATCH10,
            ACCEPT_TAU01_N10, "_n10")
        phase_identity_oracle(device, z10, N10)
        counts["gs_n10"] = phase_n10_path(device)
        counts["gs_single_n10"] = phase_gs_single_path(
            device, N10, BATCH10, LR10, E_RANGE_N10)
        phase_update_vs_plain(device, z10, params10, N10)
        phase(f"7: the finite-T path at N={N10}, beta {BETA10:g}, deltaE "
              f"{DELTA_E10:g}, batch {BATCH_BETA10}")
        beta10 = dict(n=N10, beta=BETA10, deltaE=DELTA_E10)
        zb10, idx10 = phase_kernels_ms(
            device, rows, batch=BATCH_BETA10, accept=ACCEPT_MS_TAU01_N10,
            tag="_n10", seed=SEED + 21, **beta10)
        phase_beta_oracle(device, zb10, idx10, f_known=F_EXACT_BETA10, **beta10)
        counts["beta_n10"] = phase_beta_path(
            device, batch=BATCH_BETA10, lr=LR_BETA10,
            f_range=(F_FLOOR_BETA10, math.inf), f_first=F_FIRST_BETA10,
            **beta10)
        phase_beta_update_vs_plain(device, zb10, idx10, params10, **beta10)
        phase("8: restartable runs, the nested-jvp engine and the solvers")
        with tempfile.TemporaryDirectory() as tmp8:
            runs = []
            try:
                runs.append(phase_resume_start(device, False, f"{tmp8}/gs"))
                runs.append(phase_resume_start(device, True, f"{tmp8}/beta"))
                phase_restart(device, tmp8)
                for run in runs:
                    phase_resume_finish(device, run)
            finally:
                for run in runs:
                    if run["proc"].poll() is None:
                        run["proc"].kill()
                        run["proc"].wait()
            phase_nested(device, z_eq, params)
            phase_solvers(device, z_eq, params, tmp8)
            phase_no_pallas(device, z_eq, params)
        phase("9: the walker mesh")
        with tempfile.TemporaryDirectory() as tmp9:
            phase_mesh(device, tmp9)
        phase("10: converged physics at N=2")
        t10 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp10:
            rows11 = phase_converged(device, tmp10)
        print(f"phase 10: {time.perf_counter() - t10:.1f} s")
        phase("11: strong coupling")
        t11 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp11:
            phase_strong_coupling(device, tmp11)
        print(f"phase 11: {time.perf_counter() - t11:.1f} s")
        phase("12: the compiled chunk")
        t12 = time.perf_counter()
        phase_graph_bitwise(device)
        phase_graph_finite(device)
        with tempfile.TemporaryDirectory() as tmp12:
            traces = phase_graph_traces(device, tmp12)
        print("phase 12 traces: " + json.dumps(traces))
        t12ab = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp12:
            ab_trace = phase_graph_ab(device, tmp12)
        print("phase 12 A/B trace: " + json.dumps(ab_trace))
        print(f"phase 12: {time.perf_counter() - t12:.1f} s (the A/B "
              f"paths {time.perf_counter() - t12ab:.1f} s)")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    kernels = []
    for name in ("metropolis_chains", "slater_vgh", "hessian_flow",
                 "reinforce_adjoint", "reinforce_reduce", "metropolis_single",
                 "slater_vgh_ms", "metropolis_multistate",
                 *(k + "_n10" for k in GS_KERNELS + (
                     "metropolis_single", "slater_vgh_ms",
                     "metropolis_multistate"))):
        r = rows[name]
        base = name.removesuffix("_n10")
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[base],
            replaces=REPLACES[base], launches=counts[PATH_OF[name]][base],
            launches_path=PATH_OF[name], **r))
        if name in warps:
            kernels[-1]["warps_per_sm"] = warps[name]
        if name in placed:
            per = "walker" if name.startswith(("slater_vgh", "hessian",
                                               "reinforce")) else "chain"
            kernels[-1].update({"warps_placed_per_sm": placed[name],
                                f"lanes_per_{per}": lanes[name]})
        if name.endswith("_n10") and base in {**N10_PTXAS, **MS_N10_PTXAS}:
            regs, stack, st, ld = ptxas[{**N10_PTXAS, **MS_N10_PTXAS}[base]]
            kernels[-1].update(registers=regs, stack_bytes=stack,
                               spill_bytes=st + ld)
    print("phase 10 kernels (1, 1): " + json.dumps(rows11))
    print(f"total: {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
