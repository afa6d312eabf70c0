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
     deltaE=2 (54 states).  Kernels are timed with CUDA events over a run
     of launches; the reduce pass and its yardstick ``Tensor.sum``, and the
     two Slater VGH kernels, by replaying a CUDA graph of 50 launches each
     (device time only), printed beside the dispatch-inclusive times on the
     ``reinforce_reduce timing:`` and ``... timing:`` lines of each VGH
     kernel;
  3. the oracles through the kernels: the identity flow at N=6, Z=0 gives
     Eloc = 14; at finite T (beta=2, deltaE=2, Boltzmann logits) every
     walker's Floc is the exact free energy 13.391808;
  4. the paths, each with every kernel's launch count set to 0 just before
     and read just after: the ground-state main path
     (``cli.ground_state.main``, 20 iterations, --nup 6 --Z 0.5 --batch 8192
     --dtype float32 --persistent --steps-per-call 10); the finite-T path
     (``cli.finite_t.main``, 20 iterations, --beta 2.0 --deltaE 2.0
     --boltzmann, otherwise alike); the ground-state per-iteration path
     (--steps-per-call 1, 3 iterations);
  5. one ground-state and one finite-T update against the plain-PyTorch
     updates on the card.

The last lines of standard output are the kernels JSON line, the card line
and ``{"ok": true, "device": {...}}``.  With no CUDA device, or without the
repository beside it, the script exits non-zero before printing any of them.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time

SEED = 1234
N, BATCH, D_ETA, D_MU = 6, 8192, 50, 50
ODE_STEPS, SEGMENTS, MCMC_STEPS = 4, 10, 30
PARAM_STD = 0.1  # Gaussian flow weights: a field well away from the identity
MAIN_ITERS = 20
SINGLE_ITERS = 3  # the ground-state per-iteration path
ACCEPT_TAU01 = 0.72  # the JAX sampler's acceptance at tau=0.1, N=6
# The JAX mixed-state sampler's acceptance at tau=0.1, N=6, on uniformly
# drawn deltaE=2 states (BENCH_r05.json "mixed_state_accept").
ACCEPT_MS_TAU01 = 0.732
BETA, DELTA_E = 2.0, 2.0
F_EXACT_N6 = 13.391808  # E0 - log sum_s exp(-beta (E_s - E0)) / beta, E0 = 14

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
# The path whose launch counts each kernel's row reports.
PATH_OF = {
    "metropolis_chains": "gs", "slater_vgh": "gs", "hessian_flow": "gs",
    "reinforce_adjoint": "gs", "reinforce_reduce": "gs",
    "metropolis_single": "gs_single", "slater_vgh_ms": "beta",
    "metropolis_multistate": "beta",
}


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    print(("PASS " if ok else "FAIL ") + what, flush=True)
    if not ok:
        raise SmokeFailure(what)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` launches (warmed)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 50, replays: int = 10):
    """Mean device milliseconds of one ``fn`` launch, from a CUDA graph
    that captures ``reps`` launches, timed with CUDA events over
    ``replays`` replays: no host dispatch inside the window.  Fails unless
    the replay recomputes the last captured output (proof that the launch
    was captured).  Returns (ms, that output)."""
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
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays), out


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


def vgh_times(what, fn):
    """A VGH kernel's device time by CUDA-graph replay (``ms``; the replay
    must recompute the captured H) and its dispatch-inclusive time over 50
    back-to-back calls (``ms_dispatch``)."""
    ms, _ = graph_ms(lambda: fn()[2])
    disp = cuda_ms(fn, 50)
    print(f"{what} timing: graph replay (device only) {ms:.6f} ms; "
          f"dispatch-inclusive {disp:.6f} ms")
    return dict(ms=ms, ms_dispatch=disp)


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


def phase_build():
    from fermiflow_tpu_torch.ops import _build

    t0 = time.perf_counter()
    per_source = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s wall, per source "
          + json.dumps({k: round(v, 1) for k, v in per_source.items()}),
          flush=True)
    spills = {}
    for name in _build.SOURCES:
        _build.library(name)
        report = _build.BUILD_DIR / f"{name}.ptxas.txt"
        if report.exists():
            for kern, regs, stack, st, ld in ptxas_kernels(report.read_text()):
                print(f"ptxas {name}: {kern}: {regs} registers, stack {stack} "
                      f"B, spill stores {st} B, spill loads {ld} B")
                if kern.startswith((f"slater_vgh_kernel<{N}>",
                                    f"slater_vgh_ms_kernel<{N},")):
                    spills[kern] = st + ld
    # Every build leaves its report beside the library.
    check(bool(spills) and not any(spills.values()), "slater_vgh, "
          f"slater_vgh_ms: no spills at N={N} ({len(spills)} instantiations)")


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
          f"hessian_flow: {hf.LANES} lanes per walker, per lane "
          f"{plan['entries'][1]} state entries, {plan['pairs'][1]} pair and "
          f"{plan['one_body'][1]} one-body MLP inputs; reinforce_adjoint: "
          f"{rf.LANES} lanes per walker, per lane {rplan['entries'][1]} state "
          f"entries, eta/mu hidden units {units} by lane, coefficient totals "
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


def make_model(Z: float, device):
    from fermiflow_tpu_torch.cli import common
    from fermiflow_tpu_torch.config import Config

    cfg = Config(nup=N, ndown=0, Z=Z, d_eta=D_ETA, d_mu=D_MU, batch=BATCH,
                 ode_steps=ODE_STEPS, ode_method="dopri5", dtype="float32",
                 device=str(device))
    return common.build_gs(cfg)


def gaussian_params(gen, device, dtype):
    from fermiflow_tpu_torch.nn.backflow import backflow_init_gaussian

    return backflow_init_gaussian(gen, D_ETA, D_MU, std=PARAM_STD,
                                  dtype=dtype, device=device)


def to_f64(params):
    return {k: None if v is None else {kk: t.double() for kk, t in v.items()}
            for k, v in params.items()}


def phase_kernels(device, rows):
    """Each kernel against its plain version; returns equilibrated walkers
    and Gaussian parameters for the later phases."""
    import torch

    from fermiflow_tpu_torch.ops import _build
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
    from fermiflow_tpu_torch.utils import roofline

    model, _ = make_model(0.5, device)
    nx_up, ny_up, nx_dn, ny_dn, ks = model.occ_qnums()
    d = 2 * N
    gen = torch.Generator(device=device).manual_seed(SEED)
    f32 = dict(device=device, dtype=torch.float32)
    occ = dict(nx_occ=nx_up, ny_occ=ny_up, nx_dn=nx_dn, ny_dn=ny_dn,
               num_shells=ks)

    # ---- 1. Metropolis sampler ----
    x0 = torch.randn((d, BATCH), generator=gen, **f32)
    tau0 = torch.full((BATCH,), 0.1, **f32)
    chain = dict(steps=MCMC_STEPS, segments=SEGMENTS, target=0.5, gain=0.1,
                 **occ)
    # Equilibrate: 10 x 30 steps from Gaussians, then 10 x 30 more.
    xs, _, _, tau_eq = metropolis_chains(x0, tau0, 11, **chain)
    xs, _, _, tau_eq = metropolis_chains(xs[-1].contiguous(), tau_eq, 12,
                                         **chain)
    z_eq = xs[-1].contiguous()

    # (a) one shared random stream: exact agreement but for the rare walker
    # whose accept/reject flips on the last bit of exp(dlogp).
    normals = torch.randn((SEGMENTS, MCMC_STEPS + 1, d, BATCH), generator=gen,
                          **f32)
    uniforms = torch.rand((SEGMENTS, MCMC_STEPS, BATCH), generator=gen,
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
    print(f"metropolis shared stream: diverged walkers {frac_flip:.2e}, "
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
    x_w = xs_f[-1].T.reshape(BATCH, N, 2).double()
    lp_ref = model.basedist.log_prob(model.occ_up, model.occ_down, x_w)
    lp_bad = logp_violations(lp_f[-1], lp_ref)
    print(f"metropolis distribution: accept {acc:.4f} at tau=0.1; logp vs "
          f"log_prob max|d| {maxabs(lp_f[-1], lp_ref):.3e}, "
          f"violations {lp_bad:.2e}")
    check(abs(acc - ACCEPT_TAU01) < 0.03, f"sampler: acceptance "
          f"{ACCEPT_TAU01} +- 0.03 at tau=0.1 (the JAX sampler's figure)")
    check(lp_bad <= 1e-3, "sampler: logp = log_prob (f64) within 1e-3 "
          "relative on >= 99.9% of walkers")

    k_ms = cuda_ms(lambda: metropolis_chains(z_eq, tau_eq, 5, **chain), 20)
    p_ms = cuda_ms(lambda: metropolis_chains_plain(z_eq, tau_eq, 5, **chain), 1)
    flops, nbytes = roofline.metropolis_work(BATCH, N, ks, MCMC_STEPS, SEGMENTS)
    rows["metropolis_chains"] = dict(
        max_abs_err=max(err_x, err_lp, err_rate, err_tau), ms=k_ms,
        plain_ms=p_ms, work=(flops, nbytes),
        tolerance="x exact; rate, tau 1e-6; logp 1e-3; <=0.1% walkers "
                  "diverged by accept flips",
        diverged_frac=frac_flip)

    # ---- 2. Slater value / gradient / packed Hessian ----
    y_k, g_k, H_k = out_vgh = slater_vgh_cm(z_eq, **occ)
    out_p = slater_vgh_cm_plain(z_eq, **occ)
    out_r = slater_vgh_cm_plain(z_eq.double(), **occ)
    torch.cuda.synchronize()
    err_vgh64, err_vgh = vgh_against_plain("slater_vgh", out_vgh, out_p, out_r)
    rows["slater_vgh"] = dict(
        max_abs_err=err_vgh64, max_abs_err_vs_plain_f32=err_vgh,
        **vgh_times("slater_vgh", lambda: slater_vgh_cm(z_eq, **occ)),
        plain_ms=cuda_ms(lambda: slater_vgh_cm_plain(z_eq, **occ), 3),
        work=roofline.vgh_work(BATCH, N, ks), tolerance=VGH_TOLERANCE)

    # ---- 3. Hessian flow ----
    params = gaussian_params(gen, device, torch.float32)
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
        print(f"hessian_flow {name}: |kernel - f64| {e_k:.3e}, "
              f"|plain f32 - f64| {e_p:.3e}, scale {scale:.3e}")
        check(math.isfinite(e_k) and e_k <= max(3.0 * e_p, 1e-5 * scale + 1e-6),
              f"hessian_flow {name}: kernel error <= 3x the plain f32 error")
    rows["hessian_flow"] = dict(
        max_abs_err=err_hf, plain_f32_max_abs_err=err_hf32,
        ms=cuda_ms(lambda: hessian_flow_cm(params, z_eq, y_k, g_k, H_k, *ts),
                   20),
        plain_ms=cuda_ms(lambda: hessian_flow_cm_plain(
            params, z_eq, y_k, g_k, H_k, *ts), 1),
        work=roofline.hflow_work(BATCH, N, D_ETA, D_MU, ODE_STEPS, 6),
        tolerance="per output, error vs f64 plain <= max(3 x plain f32 "
                  "error, 1e-5 max|ref| + 1e-6)")

    # ---- 4. REINFORCE adjoint and its block reduction ----
    x1, logp1, g1, H1 = out_k
    d_ = d
    diag = [p * d_ - p * (p - 1) // 2 for p in range(d_)]
    eloc = (-0.25 * H1[diag].sum(0) - 0.125 * (g1 * g1).sum(0)
            + model.potential_rows(x1))
    w = ((eloc - eloc.mean()) / BATCH).contiguous()
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
    print(f"reinforce grads: |kernel - f64| {e_k:.3e}, |plain f32 - f64| "
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
    nblocks, nq = partials.shape
    rows["reinforce_adjoint"] = dict(
        max_abs_err=e_k, plain_f32_max_abs_err=e_p,
        ms=cuda_ms(lambda: reinforce_partials(params, x1, g1, w, *ts), 20),
        plain_ms=cuda_ms(lambda: reinforce_cm_plain(params, x1, g1, w, *ts),
                         1),
        work=roofline.reinforce_work(BATCH, N, D_ETA, D_MU, ODE_STEPS, 6,
                                     nblocks),
        tolerance="gradient error vs f64 plain <= max(3 x plain f32 error, "
                  "1e-5 max|ref| + 1e-7)")
    # The plain version is itself one PyTorch call, so it is also the
    # library yardstick; no single call computes the other kernels.  Both
    # are timed on the device alone (graph replay); the dispatch-inclusive
    # times (back-to-back calls from Python) are printed beside them.
    red_ms, _ = graph_ms(lambda: block_sum(partials))
    sum_ms, _ = graph_ms(lambda: partials.sum(0))
    red_disp = cuda_ms(lambda: block_sum(partials), 50)
    sum_disp = cuda_ms(lambda: partials.sum(0), 50)
    print(f"reinforce_reduce timing: graph replay (device only) kernel "
          f"{red_ms:.6f} ms, Tensor.sum {sum_ms:.6f} ms; dispatch-inclusive "
          f"kernel {red_disp:.6f} ms, Tensor.sum {sum_disp:.6f} ms")
    rows["reinforce_reduce"] = dict(
        max_abs_err=float(red_err.max()),
        ms=red_ms, plain_ms=sum_ms, library_ms=sum_ms,
        ms_dispatch=red_disp, library_ms_dispatch=sum_disp,
        work=roofline.reduce_work(nblocks, nq),
        tolerance="nblocks * 2^-24 * sum_b |partials[b]| per row")
    return z_eq, params


def make_beta_model(Z: float, device):
    """The finite-T model (beta=2, deltaE=2) with identity-flow parameters
    and Boltzmann logits."""
    from fermiflow_tpu_torch.cli import common
    from fermiflow_tpu_torch.config import Config

    cfg = Config(nup=N, ndown=0, Z=Z, beta=BETA, deltaE=DELTA_E,
                 boltzmann=True, d_eta=D_ETA, d_mu=D_MU, batch=BATCH,
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


def phase_kernels_ms(device, rows, z_eq):
    """The per-iteration sampler (kernel 5) and the finite-T kernels
    (mixed-state sampler 7 and VGH 6) against their plain versions.
    Returns walkers equilibrated in Boltzmann-drawn states and the states."""
    import torch

    from fermiflow_tpu_torch.ops.metropolis import (
        metropolis_multistate_cm,
        metropolis_multistate_cm_plain,
        metropolis_single_cm,
        metropolis_single_cm_plain,
    )
    from fermiflow_tpu_torch.ops.slater_vgh import (
        slater_vgh_ms_cm,
        slater_vgh_ms_cm_plain,
    )
    from fermiflow_tpu_torch.utils import roofline

    d = 2 * N
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    f32 = dict(device=device, dtype=torch.float32)
    tau01 = torch.full((BATCH,), 0.1, **f32)
    tau02 = torch.full((BATCH,), 0.2, **f32)

    def shared_noise():
        return (torch.randn((MCMC_STEPS, d, BATCH), generator=gen, **f32),
                torch.rand((MCMC_STEPS, BATCH), generator=gen,
                           **f32).clamp_min(1e-12))

    # ---- 5. single fixed-tau chain (ground state) ----
    gs_model, _ = make_model(0.5, device)
    nx_up, ny_up, nx_dn, ny_dn, ks = gs_model.occ_qnums()
    occ = dict(nx_occ=nx_up, ny_occ=ny_up, nx_dn=nx_dn, ny_dn=ny_dn,
               num_shells=ks)
    noise = shared_noise()
    k_out = metropolis_single_cm(z_eq, tau01, 0, steps=MCMC_STEPS,
                                 noise=noise, **occ)
    p_out = metropolis_single_cm_plain(z_eq, tau01, 0, steps=MCMC_STEPS,
                                       noise=noise, **occ)
    torch.cuda.synchronize()
    frac, err = shared_stream_agreement(k_out, p_out, "metropolis_single")
    x1, lp1, acc1 = metropolis_single_cm(z_eq, tau01, 41, steps=MCMC_STEPS,
                                         **occ)
    lp_bad = logp_violations(lp1, gs_model.basedist.log_prob(
        gs_model.occ_up, gs_model.occ_down, x1.T.reshape(BATCH, N, 2).double()))
    print(f"metropolis_single distribution: accept {float(acc1.mean()):.4f} "
          f"at tau=0.1; logp vs log_prob violations {lp_bad:.2e}")
    check(abs(float(acc1.mean()) - ACCEPT_TAU01) < 0.03 and lp_bad <= 1e-3,
          f"metropolis_single: acceptance {ACCEPT_TAU01} +- 0.03 at tau=0.1; "
          "logp = log_prob (f64) within 1e-3 relative on >= 99.9% of walkers")
    rows["metropolis_single"] = dict(
        max_abs_err=err, diverged_frac=frac,
        ms=cuda_ms(lambda: metropolis_single_cm(z_eq, tau01, 5,
                                                steps=MCMC_STEPS, **occ), 20),
        plain_ms=cuda_ms(lambda: metropolis_single_cm_plain(
            z_eq, tau01, 5, steps=MCMC_STEPS, **occ), 1),
        work=roofline.metropolis_single_work(BATCH, N, ks, MCMC_STEPS),
        tolerance=SINGLE_CHAIN_TOLERANCE)

    # ---- 7. mixed-state sampler, Boltzmann-drawn states ----
    model, params = make_beta_model(0.0, device)
    _, _, kms = model._qnum_tables()
    probs = torch.softmax(params["log_state_weights"], dim=-1)
    idx = torch.multinomial(probs, BATCH, replacement=True,
                            generator=gen).to(torch.int32)
    ms = dict(zip(("nx_cm", "ny_cm"), model.qnums_cm(idx)), num_shells=kms)
    z = torch.randn((d, BATCH), generator=gen, **f32)
    for seed in (31, 32):
        z, _, _ = metropolis_multistate_cm(z, tau02, seed, steps=150, **ms)
    z_ms = z.contiguous()
    noise = shared_noise()
    k_out = metropolis_multistate_cm(z_ms, tau01, 0, steps=MCMC_STEPS,
                                     noise=noise, **ms)
    p_out = metropolis_multistate_cm_plain(z_ms, tau01, 0, steps=MCMC_STEPS,
                                           noise=noise, **ms)
    torch.cuda.synchronize()
    frac, err = shared_stream_agreement(k_out, p_out, "metropolis_multistate")
    # Distribution on the kernel's own stream: uniformly drawn states.
    idx_u = torch.randint(0, model.Nstates, (BATCH,), generator=gen,
                          device=device, dtype=torch.int32)
    ms_u = dict(zip(("nx_cm", "ny_cm"), model.qnums_cm(idx_u)), num_shells=kms)
    zu = torch.randn((d, BATCH), generator=gen, **f32)
    zu, _, _ = metropolis_multistate_cm(zu, tau02, 33, steps=300, **ms_u)
    xu, lpu, accu = metropolis_multistate_cm(zu, tau01, 34, steps=MCMC_STEPS,
                                             **ms_u)
    lp_bad = logp_violations(lpu, model.basedist.log_prob_multstates(
        model.occ_table, idx_u, xu.T.reshape(BATCH, N, 2).double()))
    acc = float(accu.mean())
    print(f"metropolis_multistate distribution: accept {acc:.4f} at tau=0.1 "
          f"on uniformly drawn states; logp vs log_prob_multstates "
          f"violations {lp_bad:.2e}")
    check(abs(acc - ACCEPT_MS_TAU01) < 0.03, f"metropolis_multistate: "
          f"acceptance {ACCEPT_MS_TAU01} +- 0.03 at tau=0.1 (the JAX "
          "mixed-state sampler's figure)")
    check(lp_bad <= 1e-3, "metropolis_multistate: logp = log_prob_multstates "
          "(f64) within 1e-3 relative on >= 99.9% of walkers")
    rows["metropolis_multistate"] = dict(
        max_abs_err=err, diverged_frac=frac,
        ms=cuda_ms(lambda: metropolis_multistate_cm(
            z_ms, tau01, 5, steps=MCMC_STEPS, **ms), 20),
        plain_ms=cuda_ms(lambda: metropolis_multistate_cm_plain(
            z_ms, tau01, 5, steps=MCMC_STEPS, **ms), 1),
        work=roofline.metropolis_ms_work(BATCH, N, kms, MCMC_STEPS),
        tolerance=SINGLE_CHAIN_TOLERANCE)

    # ---- 6. mixed-state Slater value / gradient / packed Hessian ----
    vgh = (ms["nx_cm"], ms["ny_cm"], kms)
    out_k = slater_vgh_ms_cm(z_ms, *vgh)
    out_p = slater_vgh_ms_cm_plain(z_ms, *vgh)
    out_r = slater_vgh_ms_cm_plain(z_ms.double(), *vgh)
    torch.cuda.synchronize()
    err_r, err_p = vgh_against_plain("slater_vgh_ms", out_k, out_p, out_r)
    rows["slater_vgh_ms"] = dict(
        max_abs_err=err_r, max_abs_err_vs_plain_f32=err_p,
        **vgh_times("slater_vgh_ms", lambda: slater_vgh_ms_cm(z_ms, *vgh)),
        plain_ms=cuda_ms(lambda: slater_vgh_ms_cm_plain(z_ms, *vgh), 3),
        work=roofline.vgh_ms_work(BATCH, N, kms), tolerance=VGH_TOLERANCE)
    return z_ms, idx


def phase_beta_oracle(device, z_ms, idx):
    """Z=0, identity flow, Boltzmann logits: every walker's Floc is the
    exact free energy, through the mixed-state VGH, Hessian flow and
    REINFORCE kernels on walkers the mixed-state kernel equilibrated."""
    import numpy as np
    import torch

    model, params = make_beta_model(0.0, device)
    Es = model.Es_original
    f_exact = Es[0] - np.log(np.sum(np.exp(-BETA * (Es - Es[0])))) / BETA
    _, m, _ = model.loss_metrics_grads_cm(params, idx, z_ms)
    torch.cuda.synchronize()
    lps = torch.log_softmax(params["log_state_weights"].double(), -1)[idx.long()]
    se = float(lps.std()) / math.sqrt(BATCH)
    F, F_std = float(m["F"]), float(m["F_std"])
    S, S_an = float(m["S"]), float(m["S_analytical"])
    print(f"finite-T oracle N={N} Z=0 beta={BETA:g}: {model.Nstates} states, "
          f"F {F:.6f} (exact {f_exact:.6f}), F_std {F_std:.3e}, S {S:.4f} "
          f"+- {se:.4f}, S_analytical {S_an:.4f}")
    check(abs(f_exact - F_EXACT_N6) < 1e-6 and abs(F - f_exact) <= 1e-3
          and F_std < 1e-3,
          f"finite-T oracle: F = {F_EXACT_N6} within 1e-3, F_std < 1e-3")
    check(abs(S - S_an) <= 3.0 * se,
          "finite-T oracle: S within 3 standard errors of S_analytical")


def phase_identity_oracle(device, z_eq):
    import torch

    model, params0 = make_model(0.0, device)
    # Non-interacting ground state: the N lowest orbital energies (14 at N=6).
    e0 = float(model.basedist.orbitals.Es[:N].sum())
    _, eloc, _, _ = model.local_energy_cm(params0, z_eq)
    torch.cuda.synchronize()
    err = (eloc.double() - e0).abs()
    frac = float((err > 1e-3).double().mean())
    print(f"identity oracle N={N} Z=0: Eloc median {float(eloc.median()):.6f}, "
          f"max|Eloc - {e0:g}| {float(err.max()):.3e}, outside 1e-3: "
          f"{frac:.2e}")
    check(bool(torch.isfinite(eloc).all()) and frac <= 1e-3,
          f"identity flow: Eloc = {e0:g} within 1e-3 on >= 99.9% of walkers")


def drive_path(main, argv):
    """Run a CLI ``main`` with every launch count set to 0 just before and
    read just after: (state, per-iteration records, counts, wall seconds)."""
    import tempfile

    import torch

    from fermiflow_tpu_torch.ops import _build

    with tempfile.TemporaryDirectory() as tmp:
        metrics = f"{tmp}/metrics.jsonl"
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        state = main(argv + ["--metrics", metrics])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(_build.LAUNCHES)
        with open(metrics) as fh:
            recs = [json.loads(line) for line in fh]
    return state, recs, counts, wall


def path_argv(device, iters, steps_per_call):
    return ["--nup", str(N), "--Z", "0.5", "--batch", str(BATCH), "--dtype",
            "float32", "--persistent", "--steps-per-call", str(steps_per_call),
            "--iternum", str(iters), "--lr", "1e-3", "--Deta", str(D_ETA),
            "--Dmu", str(D_MU), "--ode-steps", str(ODE_STEPS), "--mcmc-steps",
            str(MCMC_STEPS), "--device", device.type]


def phase_main_path(device):
    from fermiflow_tpu_torch.cli import ground_state

    state, recs, counts, wall = drive_path(
        ground_state.main, path_argv(device, MAIN_ITERS, SEGMENTS))
    # Each chunk's wall time (one sampler launch + K updates, ended by the
    # metrics fetch) over K; the first chunk also pays the first-call costs.
    chunk_ms = [1e3 * r["iter_seconds"] for r in recs[::SEGMENTS]]
    energies = [r["E"] for r in recs]
    print(f"main path: {MAIN_ITERS} iterations in {wall:.3f} s wall (setup "
          f"included); ms per iteration by chunk {chunk_ms}; launches "
          f"{json.dumps(counts)}")
    check(state.step == MAIN_ITERS and len(recs) == MAIN_ITERS,
          "main path: all iterations ran")
    # Variational: above the true ground state (~18.16 at N=6, Z=0.5) and
    # near the identity flow's 14 + <V> (~19) this early in training.
    check(all(math.isfinite(e) and 17.0 < e < 21.0 for e in energies),
          "main path: every energy is finite and in (17, 21)")
    gs_kernels = ("metropolis_chains", "slater_vgh", "hessian_flow",
                  "reinforce_adjoint", "reinforce_reduce")
    check(all(counts[k] > 0 for k in gs_kernels),
          "main path: every kernel of the path was launched")
    return counts


def phase_beta_path(device):
    """The finite-T training path through the port's CLI."""
    from fermiflow_tpu_torch.cli import finite_t

    argv = ["--beta", str(BETA), "--nup", str(N), "--Z", "0.5", "--deltaE",
            str(DELTA_E), "--boltzmann", "--batch", str(BATCH), "--dtype",
            "float32", "--persistent", "--steps-per-call", str(SEGMENTS),
            "--iternum", str(MAIN_ITERS), "--lr", "1e-3", "--mcmc-steps",
            str(MCMC_STEPS), "--device", device.type]
    state, recs, counts, wall = drive_path(finite_t.main, argv)
    chunk_ms = [1e3 * r["iter_seconds"] for r in recs[::SEGMENTS]]
    frees = [r["F"] for r in recs]
    print(f"finite-T path: {MAIN_ITERS} iterations in {wall:.3f} s wall "
          f"(setup included); ms per iteration by chunk {chunk_ms} (steady: "
          f"{chunk_ms[1]:.3f}); F first/last {frees[0]:.5f}/{frees[-1]:.5f}; "
          f"S {recs[-1]['S']:.4f}, accept {recs[-1]['accept_rate']:.4f}; "
          f"launches {json.dumps(counts)}")
    check(state.step == MAIN_ITERS and len(recs) == MAIN_ITERS,
          "finite-T path: all iterations ran")
    check(all(math.isfinite(f) and 16.0 < f < 21.0 for f in frees),
          "finite-T path: every F is finite and in (16, 21)")
    check(all(counts[k] == MAIN_ITERS for k in (
        "metropolis_multistate", "slater_vgh_ms", "hessian_flow",
        "reinforce_adjoint", "reinforce_reduce")),
        f"finite-T path: {MAIN_ITERS} launches each of the mixed-state "
        "sampler, mixed-state VGH, Hessian flow and REINFORCE adjoint")
    check(all(counts[k] == 0 for k in ("metropolis_chains", "slater_vgh",
                                       "metropolis_single")),
          "finite-T path: no launch of the ground-state sampler or VGH")
    return counts


def phase_gs_single_path(device):
    """The ground-state per-iteration path (--steps-per-call 1)."""
    from fermiflow_tpu_torch.cli import ground_state

    state, recs, counts, wall = drive_path(
        ground_state.main, path_argv(device, SINGLE_ITERS, 1))
    energies = [r["E"] for r in recs]
    print(f"per-iteration path: {SINGLE_ITERS} iterations in {wall:.3f} s "
          f"wall; ms per iteration {[1e3 * r['iter_seconds'] for r in recs]}; "
          f"E {energies}; launches {json.dumps(counts)}")
    check(all(math.isfinite(e) and 17.0 < e < 21.0 for e in energies),
          "per-iteration path: every energy is finite and in (17, 21)")
    check(counts["metropolis_single"] == SINGLE_ITERS
          and counts["metropolis_chains"] == 0
          and all(counts[k] == SINGLE_ITERS for k in (
              "slater_vgh", "hessian_flow", "reinforce_adjoint")),
          f"per-iteration path: {SINGLE_ITERS} launches of the single-chain "
          "sampler and of each update kernel, none of the multi-segment one")
    return counts


def phase_update_vs_plain(device, z_eq, params):
    import copy

    import torch

    from fermiflow_tpu_torch.vmc.gs import PLAIN_OPS

    model, _ = make_model(0.5, device)
    plain = copy.copy(model)
    plain.ops = PLAIN_OPS
    loss_k, m_k, g_k = model.loss_metrics_grads_cm(params, z_eq)
    loss_p, m_p, g_p = plain.loss_metrics_grads_cm(params, z_eq)
    torch.cuda.synchronize()
    worst, ok_g = flow_grads_close(g_k, g_p)
    print(f"fused update vs plain: E {float(m_k['E']):.7f} / "
          f"{float(m_p['E']):.7f}, E_std {float(m_k['E_std']):.6f} / "
          f"{float(m_p['E_std']):.6f}, loss {float(loss_k):.4e} / "
          f"{float(loss_p):.4e}, grads max|d| {worst:.3e}")
    check(allclose64(m_k["E"], m_p["E"], 1e-5, 0.0)
          and allclose64(m_k["E_std"], m_p["E_std"], 1e-5, 0.0),
          "update: E and E_std within rtol 1e-5 of the plain update")
    check(allclose64(loss_k, loss_p, 1e-4, 1e-6) and ok_g,
          "update: loss and every gradient leaf within rtol 1e-4, atol 1e-6")


def phase_beta_update_vs_plain(device, z_ms, idx, flow_params):
    """The finite-T kernel-chain update against its plain-PyTorch chain."""
    import copy

    import torch

    from fermiflow_tpu_torch.vmc.gs import PLAIN_OPS

    model, params = make_beta_model(0.5, device)
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
    print(f"finite-T update vs plain: F {float(m_k['F']):.7f} / "
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
    try:
        print("== phase 1: build", flush=True)
        phase_build()
        warps, placed, lanes = phase_occupancy(device)
        print("== phase 2: kernels against their plain versions", flush=True)
        z_eq, params = phase_kernels(device, rows)
        z_ms, idx = phase_kernels_ms(device, rows, z_eq)
        print("== phase 3: oracles", flush=True)
        phase_identity_oracle(device, z_eq)
        phase_beta_oracle(device, z_ms, idx)
        print("== phase 4: paths", flush=True)
        counts = {"gs": phase_main_path(device),
                  "beta": phase_beta_path(device),
                  "gs_single": phase_gs_single_path(device)}
        print("== phase 5: updates against the plain updates", flush=True)
        phase_update_vs_plain(device, z_eq, params)
        phase_beta_update_vs_plain(device, z_ms, idx, params)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    from fermiflow_tpu_torch.utils import roofline

    kernels = []
    for name in ("metropolis_chains", "slater_vgh", "hessian_flow",
                 "reinforce_adjoint", "reinforce_reduce", "metropolis_single",
                 "slater_vgh_ms", "metropolis_multistate"):
        r = rows[name]
        b_ms, b_by = roofline.bound_ms(*r.pop("work"))
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=counts[PATH_OF[name]][name],
            launches_path=PATH_OF[name],
            max_abs_err=r.pop("max_abs_err"), ms=r.pop("ms"),
            plain_ms=r.pop("plain_ms"), bound_ms=b_ms, bound_by=b_by,
            library_ms=r.pop("library_ms", None), **r))
        if name in warps:
            kernels[-1]["warps_per_sm"] = warps[name]
        if name in placed:
            per = "walker" if name.startswith("slater_vgh") else "chain"
            kernels[-1].update({"warps_placed_per_sm": placed[name],
                                f"lanes_per_{per}": lanes[name]})
    print(f"total: {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
