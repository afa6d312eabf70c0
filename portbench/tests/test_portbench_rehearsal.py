"""A whole run of each cell at a tiny size on the CPU, through the same
harness, with the measured package's plain versions in float64: sound, it
comes out correct; with the timed path broken underneath, not.  And the
reference against the package's plain chain at random weights."""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

import calibrate
import check
import harness
import reference

ROOT = Path(harness.__file__).resolve().parent.parent
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
TINY = dict(nup=3, batch=256, d_eta=8, d_mu=8, ode_steps=2, dtype="float64")
SEED = 3_000_000_123


# The cells that wait for the program (PERF.md, Open questions) keep their
# files, and are rehearsed here with the persistent cell's limits (the
# finite-T cell's F and S held to the energy's) and its metrics' names.
PERSISTENT, FINITE = "gs_n6.persistent_k10", "ft_n6.persistent_k10"
CELLS += [PERSISTENT, FINITE]


def tiny_spec(cell):
    if cell in (PERSISTENT, FINITE):
        spec = harness.kept_out_spec(cell)
        fresh = harness.cell_spec(ROOT, "gs_n6.fresh_k1")
        spec["per_layer"] = [dict(m, name=m["name"].removesuffix(".k1"))
                             for m in fresh["per_layer"]]
        if cell == FINITE:
            lim = harness.kept_out_spec(PERSISTENT)["limits"]
            spec["limits"] = dict(lim, trained_F_rel=lim["trained_E_rel"],
                                  trained_S_rel=lim["trained_E_rel"])
    else:
        spec = harness.cell_spec(ROOT, cell)
    spec["conf"] = dict(spec["conf"], **TINY)
    return spec


def run(cell, tmp_path, hooks=None, trace=False, **sizes):
    spec = tiny_spec(cell)
    spec["conf"].update(sizes)
    res = harness.run_cell(spec, SEED, 1.0, trace, "cpu", time.perf_counter(),
                           tmp_path, hooks=hooks)
    return spec, res


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, tmp_path):
    spec, res = run(cell, tmp_path, trace=True)
    assert res["failure"] is None and res["attempted"] > 0
    assert check.verdict(res["compared"], spec["limits"]), res["compared"]
    # On the CPU no kernel of the card runs: the host's metrics read.
    suffix = ".k1" if spec["traffic"]["steps_per_call"] == 1 else ""
    assert set(res["per_layer"]) >= {"chunk_call_ms" + suffix,
                                     "device_idle_share" + suffix}
    assert res["setup_s"] > 0 and res["iter_ms"] > 0


def _unchanged_state(model, state):
    state.optimizer.step = lambda *a, **k: None


def _half_batch(model, state):
    full = model.loss_metrics_grads_cm

    def half(params, *args):
        *lead, z_cm, mesh = args
        B = z_cm.shape[1] // 2
        lead = [t[:B].contiguous() for t in lead]
        return full(params, *lead, z_cm[:, :B].contiguous(), mesh)

    model.loss_metrics_grads_cm = half


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch",
                                   "scaled_walkers"])
def test_broken_run_is_not_correct(cell, fault, tmp_path):
    if fault in calibrate.FAULTS:
        from fermiflow_tpu_torch import train

        # The walkers' statistics need more of them, and of particles,
        # than the rest.
        with calibrate.sampler_fault(train, **calibrate.FAULTS[fault]):
            spec, res = run(cell, tmp_path, nup=6, batch=1024)
    else:
        hooks = {"unchanged_state": _unchanged_state,
                 "half_batch": _half_batch}[fault]
        spec, res = run(cell, tmp_path, hooks=hooks)
    assert res["failure"] is None
    assert not check.verdict(res["compared"], spec["limits"]), res["compared"]


def _trained_weights(model, state):
    """Weights of the size that training reaches, in place of the identity
    flow's zeros, so that every term of the flow's derivatives counts."""
    g = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for mod in (state.flow.eta, state.flow.mu):
            for p in mod.values():
                p.copy_(0.5 * torch.randn(p.shape, generator=g,
                                          dtype=p.dtype))


@pytest.mark.parametrize("fault", [None, 0.9])
def test_flow_second_derivatives_fault(fault, tmp_path, monkeypatch):
    """The Hessian flow's terms in the MLPs' second and third derivatives
    (S and T) scaled by ``fault``: the iteration that closed the window is
    judged at the weights the run reached, where those terms count (at the
    identity flow they vanish)."""
    from fermiflow_tpu_torch.nn import backflow_derivs

    if fault:
        full = backflow_derivs.mlp_derivs3

        def scaled(params, r):
            e0, e1, e2, e3 = full(params, r)
            return e0, e1, fault * e2, fault * e3

        monkeypatch.setattr(backflow_derivs, "mlp_derivs3", scaled)
    spec, res = run("gs_n6.persistent_k10", tmp_path, hooks=_trained_weights)
    assert res["failure"] is None
    assert check.verdict(res["compared"], spec["limits"]) == (fault is None), \
        res["compared"]


def test_undo_step_recovers_the_state_before_adams_step():
    g = torch.Generator().manual_seed(3)
    p = torch.nn.Parameter(torch.randn(4, 3, generator=g,
                                       dtype=torch.float64))
    opt = torch.optim.Adam([p], 1e-3)
    for _ in range(5):
        before = [p.detach().clone()] + [
            opt.state[p][k].clone() if opt.state else torch.zeros_like(p)
            for k in ("exp_avg", "exp_avg_sq")]
        p.grad = torch.randn(p.shape, generator=g, dtype=p.dtype)
        opt.step()
    st = opt.state[p]
    snap = dict(theta={"w": p.detach()}, grad={"w": p.grad},
                m={"w": st["exp_avg"]}, v={"w": st["exp_avg_sq"]},
                steps={"w": float(st["step"])})
    theta, adam = check.undo_step(snap, 1e-3, torch.device("cpu"))
    assert adam["t"] == 4
    for mine, want in zip((theta["w"], adam[("m", "w")], adam[("v", "w")]),
                          before):
        torch.testing.assert_close(mine, want, rtol=0, atol=1e-15)


def test_trained_gradient_is_held_to_what_float32_resolves():
    """The program's gradient gap counts as a multiple of the float32
    reference's own on the same batch: a float32 answer reads at most 1,
    a gradient 10 % off reads far above the cell's limit."""
    g = torch.Generator().manual_seed(7)
    spec = tiny_spec("gs_n6.fresh_k1")
    c = harness.shapes(spec)
    p = reference.Model(c).init_params(c["d_eta"], c["d_mu"], torch.float64,
                                       "cpu")
    p = {k: 0.5 * torch.randn(v.shape, generator=g, dtype=v.dtype)
         for k, v in p.items()}
    z = torch.randn(64, c["nup"], 2, generator=g, dtype=torch.float64)
    zeros = {k: torch.zeros_like(v) for k, v in p.items()}
    snap = dict(theta=p, grad=zeros, m=zeros, v=zeros,
                steps={k: 0.0 for k in p}, states=None,
                z_cm=z.reshape(64, -1).T.contiguous())
    cpu = torch.device("cpu")
    row, ref = check.rerun(c, snap, torch.float64, cpu)
    f32 = check.rerun_f32(c, snap, cpu)
    number = lambda grad: check.trained_numbers(c, row, grad, row, ref, f32)[
        "trained_grad_f32x"]
    assert number(f32) <= 1.0
    assert number({k: 1.1 * v for k, v in ref.items()}) > 10 * spec[
        "limits"]["trained_grad_f32x"]


def test_spikes_tool_reruns_the_iteration_that_tripped_the_watchdog():
    import spikes

    out = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "spikes.py"), "--tiny",
         "--device", "cpu", "--iterations", "100", "--seeds", "5"],
        capture_output=True, text=True, check=True).stdout
    res = json.loads(out.strip().splitlines()[-1])
    assert res["tripped"] and res["row"]["F"] == res["spike"]["F"]
    assert res["F_rel"] < 1e-12 and spikes.TINY["dtype"] == "float64"


def test_rehearsal_loads_no_jax(tmp_path):
    code = f"""
import sys, time
from pathlib import Path
sys.path[:0] = [{str(ROOT / 'portbench')!r}, {str(ROOT)!r}]
import harness
spec = harness.cell_spec(Path({str(ROOT)!r}), "gs_n6.fresh_k1")
spec["conf"] = dict(spec["conf"], **{TINY!r})
harness.run_cell(spec, 5, 0.2, False, "cpu", time.perf_counter(),
                 Path({str(tmp_path)!r}))
print(harness.forbidden_modules(sys.modules))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("finite", [False, True])
def test_reference_step_matches_the_plain_chain(finite):
    """One iteration at random weights, N = 3, B = 64, float64, 8 dopri5
    steps (the adjoint and the reverse ODE then differ by ~1e-7)."""
    from fermiflow_tpu_torch.cli import common
    from fermiflow_tpu_torch.config import Config
    from fermiflow_tpu_torch.nn.backflow import backflow_init_gaussian

    cfg = Config(nup=3, Z=0.5, batch=64, d_eta=6, d_mu=5, ode_steps=8,
                 dtype="float64", device="cpu", beta=2.0, deltaE=2.0,
                 boltzmann=True)
    g = torch.Generator().manual_seed(1)
    flow = backflow_init_gaussian(g, 6, 5, std=0.3)
    z = torch.randn(64, 3, 2, generator=g, dtype=torch.float64)
    z_cm = z.reshape(64, 6).T.contiguous()
    rc = {"nup": 3, "Z": 0.5, "ode_steps": 8, "lr": 1e-3}
    p = {f"{m}.{k}": flow[m][k] for m in ("eta", "mu")
         for k in ("w1", "b1", "w2")}
    if finite:
        model, params = common.build_beta(cfg)
        rc.update(beta=2.0, deltaE=2.0)
        states = torch.randint(0, model.Nstates, (64,), generator=g)
        p["logits"] = params["log_state_weights"] + 0.1 * torch.randn(
            model.Nstates, generator=g, dtype=torch.float64)
        loss, met, grads = model.loss_metrics_grads_cm(
            {"flow": flow, "log_state_weights": p["logits"]},
            states.to(torch.int32), z_cm)
        grads = dict(grads["flow"], logits=grads["log_state_weights"])
    else:
        model, _ = common.build_gs(cfg)
        states = torch.zeros(64, dtype=torch.long)
        loss, met, grads = model.loss_metrics_grads_cm(flow, z_cm)
    m, ref, _, _ = reference.step(reference.Model(rc), p, {}, z, states,
                                  block=16)
    for k in met:
        if k in m:
            assert float(met[k]) == pytest.approx(m[k], rel=1e-12), k
    assert float(loss) == pytest.approx(m["loss"], rel=1e-9)
    for k, r in ref.items():
        mine = grads[k] if k == "logits" else grads[k.split(".")[0]][
            k.split(".")[1]]
        assert float((mine - r).abs().max()) <= 1e-5 * float(r.abs().max()), k
