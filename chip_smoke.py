#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``fermiflow_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases; any failure ends the run with a non-zero exit code and no result:

  1. the card's name and power limit; every CUDA kernel of the ground-state
     path built from ``fermiflow_tpu_torch/csrc`` (one nvcc per source, in
     parallel), with the build seconds and ptxas' register/spill report;
  2. each kernel against its plain PyTorch version on the card, at the main
     path's shapes (N=6, batch 8192, d_eta=d_mu=50, dopri5 with 4 steps,
     10 sampler segments of 30 steps) on equilibrated walkers and Gaussian
     flow parameters; the sampler also on one shared random stream and by
     its distribution (acceptance at tau=0.1, logp against log_prob);
  3. the identity-flow oracle at N=6, Z=0 through the kernels: Eloc = 14;
  4. the main path, ``fermiflow_tpu_torch.cli.ground_state.main`` for 20
     iterations (--nup 6 --Z 0.5 --batch 8192 --dtype float32 --persistent
     --steps-per-call 10), with every kernel's launch count set to 0 just
     before and read just after;
  5. one fused update against the plain-PyTorch update on the card.

The last lines of standard output are the kernels JSON line, the card line
and ``{"ok": true, "device": {...}}``.  With no CUDA device, or without the
repository beside it, the script exits non-zero before printing any of them.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

SEED = 1234
N, BATCH, D_ETA, D_MU = 6, 8192, 50, 50
ODE_STEPS, SEGMENTS, MCMC_STEPS = 4, 10, 30
PARAM_STD = 0.1  # Gaussian flow weights: a field well away from the identity
MAIN_ITERS = 20
ACCEPT_TAU01 = 0.72  # the JAX sampler's acceptance at tau=0.1, N=6

REPLACES = {
    "metropolis_chains": "fermiflow_tpu/ops/pallas_metropolis.py:461",
    "slater_vgh": "fermiflow_tpu/ops/pallas_slater_vgh.py:352",
    "hessian_flow": "fermiflow_tpu/ops/pallas_hessian_flow.py:387",
    "reinforce_adjoint": "fermiflow_tpu/ops/pallas_reinforce.py:341",
    # The TPU kernel summed the theta rows across walker blocks in one
    # revisited output block (sequential grid); here a second kernel does.
    "reinforce_reduce": "fermiflow_tpu/ops/pallas_reinforce.py:319",
}
SOURCES = {
    "metropolis_chains": "fermiflow_tpu_torch/csrc/metropolis.cu",
    "slater_vgh": "fermiflow_tpu_torch/csrc/slater_vgh.cu",
    "hessian_flow": "fermiflow_tpu_torch/csrc/hessian_flow.cu",
    "reinforce_adjoint": "fermiflow_tpu_torch/csrc/reinforce.cu",
    "reinforce_reduce": "fermiflow_tpu_torch/csrc/reinforce.cu",
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


def maxabs(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def phase_build():
    from fermiflow_tpu_torch.ops import _build

    t0 = time.perf_counter()
    per_source = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s wall, per source "
          + json.dumps({k: round(v, 1) for k, v in per_source.items()}),
          flush=True)
    for name in _build.SOURCES:
        _build.library(name)
        report = _build.BUILD_DIR / f"{name}.ptxas.txt"
        if report.exists():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"ptxas {name}: {line.strip()}")


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
    lp_err = (lp_f[-1].double() - lp_ref).abs()
    lp_bad = float((lp_err > 1e-3 * lp_ref.abs().clamp_min(1.0)).double().mean())
    print(f"metropolis distribution: accept {acc:.4f} at tau=0.1; logp vs "
          f"log_prob max|d| {float(lp_err.max()):.3e}, "
          f"violations {lp_bad:.2e}")
    check(abs(acc - ACCEPT_TAU01) < 0.03, f"sampler: acceptance "
          f"{ACCEPT_TAU01} +- 0.03 at tau=0.1 (the JAX sampler's figure)")
    check(lp_bad <= 1e-3, "sampler: logp = log_prob (f64) within 1e-3 "
          "relative on >= 99.9% of walkers")

    k_ms = cuda_ms(lambda: metropolis_chains(z_eq, tau_eq, 5, **chain), 5)
    p_ms = cuda_ms(lambda: metropolis_chains_plain(z_eq, tau_eq, 5, **chain), 1)
    flops, nbytes = roofline.metropolis_work(BATCH, N, ks, MCMC_STEPS, SEGMENTS)
    rows["metropolis_chains"] = dict(
        max_abs_err=max(err_x, err_lp, err_rate, err_tau), ms=k_ms,
        plain_ms=p_ms, work=(flops, nbytes),
        tolerance="x exact; rate, tau 1e-6; logp 1e-3; <=0.1% walkers "
                  "diverged by accept flips",
        diverged_frac=frac_flip)

    # ---- 2. Slater value / gradient / packed Hessian ----
    y_k, g_k, H_k = slater_vgh_cm(z_eq, **occ)
    y_p, g_p, H_p = slater_vgh_cm_plain(z_eq, **occ)
    y_r, g_r, H_r = slater_vgh_cm_plain(z_eq.double(), **occ)
    torch.cuda.synchronize()
    viol = {}
    for name, k, r, tol in (("y", y_k, y_r, 2e-4), ("g", g_k, g_r, 3e-3),
                            ("H", H_k, H_r, 5e-3)):
        bad = ~torch.isclose(k.double(), r, rtol=tol, atol=tol)
        viol[name] = float(bad.double().mean())
    err_vgh = max(maxabs(y_k, y_p), maxabs(g_k, g_p), maxabs(H_k, H_p))
    err_vgh64 = max(maxabs(y_k, y_r), maxabs(g_k, g_r), maxabs(H_k, H_r))
    print(f"slater_vgh: max|kernel - plain f32| {err_vgh:.3e}, "
          f"max|kernel - plain f64| {err_vgh64:.3e}, violations {viol}")
    check(max(viol.values()) <= 1e-3, "slater_vgh: y/g/H within 2e-4/3e-3/"
          "5e-3 of the f64 plain version on >= 99.9% of entries")
    rows["slater_vgh"] = dict(
        max_abs_err=err_vgh64, max_abs_err_vs_plain_f32=err_vgh,
        ms=cuda_ms(lambda: slater_vgh_cm(z_eq, **occ), 20),
        plain_ms=cuda_ms(lambda: slater_vgh_cm_plain(z_eq, **occ), 3),
        work=roofline.vgh_work(BATCH, N, ks),
        tolerance="vs f64 plain: y 2e-4, g 3e-3, H 5e-3 (rtol=atol), "
                  "<=0.1% of entries outside")

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
                   5),
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
    nblocks, nq = partials.shape
    rows["reinforce_adjoint"] = dict(
        max_abs_err=e_k, plain_f32_max_abs_err=e_p,
        ms=cuda_ms(lambda: reinforce_partials(params, x1, g1, w, *ts), 5),
        plain_ms=cuda_ms(lambda: reinforce_cm_plain(params, x1, g1, w, *ts),
                         1),
        work=roofline.reinforce_work(BATCH, N, D_ETA, D_MU, ODE_STEPS, 6,
                                     nblocks),
        tolerance="gradient error vs f64 plain <= max(3 x plain f32 error, "
                  "1e-5 max|ref| + 1e-7)")
    # The plain version is itself one PyTorch call, so it is also the
    # library yardstick; no single call computes the other kernels.
    sum_ms = cuda_ms(lambda: partials.sum(0), 50)
    rows["reinforce_reduce"] = dict(
        max_abs_err=float(red_err.max()),
        ms=cuda_ms(lambda: block_sum(partials), 50),
        plain_ms=sum_ms, library_ms=sum_ms,
        work=roofline.reduce_work(nblocks, nq),
        tolerance="nblocks * 2^-24 * sum_b |partials[b]| per row")
    return z_eq, params


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


def phase_main_path(device):
    import tempfile

    import torch

    from fermiflow_tpu_torch.cli import ground_state
    from fermiflow_tpu_torch.ops import _build

    argv = ["--nup", str(N), "--Z", "0.5", "--batch", str(BATCH), "--dtype",
            "float32", "--persistent", "--steps-per-call", str(SEGMENTS),
            "--iternum", str(MAIN_ITERS), "--lr", "1e-3", "--Deta",
            str(D_ETA), "--Dmu", str(D_MU), "--ode-steps", str(ODE_STEPS),
            "--mcmc-steps", str(MCMC_STEPS), "--device", device.type]
    with tempfile.TemporaryDirectory() as tmp:
        metrics = f"{tmp}/metrics.jsonl"
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        state = ground_state.main(argv + ["--metrics", metrics])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(_build.LAUNCHES)
        with open(metrics) as fh:
            recs = [json.loads(line) for line in fh]
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
    check(all(v > 0 for v in counts.values()),
          "main path: every kernel was launched")
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

    def rel(a, b, rtol, atol):
        return bool(torch.allclose(a.double(), b.double(), rtol=rtol,
                                   atol=atol))

    worst = 0.0
    ok_g = True
    for m in ("eta", "mu"):
        for k in ("w2", "w1", "b1"):
            a, b = g_k[m][k], g_p[m][k]
            worst = max(worst, maxabs(a, b))
            ok_g &= rel(a, b, 1e-4, 1e-6)
    print(f"fused update vs plain: E {float(m_k['E']):.7f} / "
          f"{float(m_p['E']):.7f}, E_std {float(m_k['E_std']):.6f} / "
          f"{float(m_p['E_std']):.6f}, loss {float(loss_k):.4e} / "
          f"{float(loss_p):.4e}, grads max|d| {worst:.3e}")
    check(rel(m_k["E"], m_p["E"], 1e-5, 0.0)
          and rel(m_k["E_std"], m_p["E_std"], 1e-5, 0.0),
          "update: E and E_std within rtol 1e-5 of the plain update")
    check(rel(loss_k, loss_p, 1e-4, 1e-6) and ok_g,
          "update: loss and every gradient leaf within rtol 1e-4, atol 1e-6")


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
        print("== phase 2: kernels against their plain versions", flush=True)
        z_eq, params = phase_kernels(device, rows)
        print("== phase 3: identity-flow oracle", flush=True)
        phase_identity_oracle(device, z_eq)
        print("== phase 4: main path", flush=True)
        counts = phase_main_path(device)
        print("== phase 5: fused update against the plain update", flush=True)
        phase_update_vs_plain(device, z_eq, params)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    from fermiflow_tpu_torch.utils import roofline

    kernels = []
    for name in ("metropolis_chains", "slater_vgh", "hessian_flow",
                 "reinforce_adjoint", "reinforce_reduce"):
        r = rows[name]
        b_ms, b_by = roofline.bound_ms(*r.pop("work"))
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=counts[name],
            max_abs_err=r.pop("max_abs_err"), ms=r.pop("ms"),
            plain_ms=r.pop("plain_ms"), bound_ms=b_ms, bound_by=b_by,
            library_ms=r.pop("library_ms", None), **r))
    print(f"total: {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
