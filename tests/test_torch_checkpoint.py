"""Checkpoints, resume and the restart watchdog of ``fermiflow_tpu_torch``.

A run that saves at step 2 and resumes in a fresh ``main`` call must equal
the run that never stopped, bitwise: the metrics rows after the resume, the
flow's parameters, Adam's state, the chains and both generators, with
persistent walkers and with fresh ones (drawn from the device generator).
The
restart cases are those of ``tests/test_watchdog.py``, through both
packages' ``run_training_loop`` with the JAX tests' own fake steps and a
port fake step poisoned the same way (at step 2 of the original stream):
both must restore the same step, as often, and print and raise the same
messages.
"""

import contextlib
import io
import json
import os

import pytest
import torch

from fermiflow_tpu.cli import common as jcommon
from fermiflow_tpu.utils import MetricsLogger as JLogger
from test_watchdog import _setup, _setup_divergence

from fermiflow_tpu_torch.cli import common, finite_t, ground_state
from fermiflow_tpu_torch.config import Config
from fermiflow_tpu_torch.train import init_beta_state, init_gs_state
from fermiflow_tpu_torch.utils import (
    MetricsLogger,
    restore_checkpoint,
    save_checkpoint,
)

SMALL = ["--nup", "2", "--batch", "16", "--Deta", "8", "--Dmu", "8",
         "--ode-steps", "1", "--mcmc-steps", "3", "--equilibrium-steps", "3",
         "--lr", "1e-2", "--device", "cpu", "--persistent",
         "--checkpoint-every", "2"]
BETA = ["--beta", "2.0", "--deltaE", "1.0", "--boltzmann"]
TIMING = ("iter_seconds", "hours_per_100_iters")


def run(main, tmp, name, iters, extra, small=SMALL):
    """``main`` for ``iters`` iterations with checkpoints in tmp/name;
    returns (final state, metrics rows without their timings)."""
    path = tmp / f"{name}.jsonl"
    state = main(small + extra + [
        "--iternum", str(iters), "--checkpoint-dir", str(tmp / name),
        "--metrics", str(path)])
    rows = [{k: v for k, v in json.loads(line).items() if k not in TIMING}
            for line in path.read_text().splitlines()]
    return state, rows


def state_tensors(state) -> dict:
    out = {k: v.detach().clone() for k, v in state.flow.state_dict().items()}
    for k in ("walkers_cm", "tau", "log_state_weights", "state_idx",
              "sample_probs"):
        if getattr(state, k) is not None:
            out[k] = getattr(state, k).detach().clone()
    for gi, group in enumerate(state.optimizer.param_groups):
        for pi, p in enumerate(group["params"]):
            for k, v in state.optimizer.state[p].items():
                out[f"adam.{gi}.{pi}.{k}"] = v.clone()
    out["generator"] = state.generator.get_state()
    if state.device_generator is not None:
        out["device_generator"] = state.device_generator.get_state()
    return out


def assert_bitwise(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("path,K", [("gs", 1), ("gs", 2), ("beta", 2),
                                    ("gs_fresh", 1), ("gs_fresh", 2)])
def test_resume_equals_uninterrupted_run(tmp_path, path, K, dtype):
    main = finite_t.main if path == "beta" else ground_state.main
    extra = (BETA if path == "beta" else []) + [
        "--steps-per-call", str(K), "--dtype", dtype]
    small = [a for a in SMALL if path != "gs_fresh" or a != "--persistent"]
    whole, rows = run(main, tmp_path, "whole", 4, extra, small)
    run(main, tmp_path, "cut", 2, extra, small)
    resumed, rows_cut = run(main, tmp_path, "cut", 4, extra, small)
    assert resumed.step == whole.step == 4
    assert sorted(os.listdir(tmp_path / "cut")) == [
        "ckpt_00000002.pt", "ckpt_00000004.pt"]
    assert [r["step"] for r in rows_cut] == [1, 2, 3, 4]
    assert rows_cut[2:] == rows[2:]
    assert_bitwise(state_tensors(resumed), state_tensors(whole))


def test_restore_is_bitwise_and_in_place(tmp_path):
    cfg = Config(nup=2, batch=16, d_eta=8, d_mu=8, ode_steps=1, mcmc_steps=3,
                 persistent_walkers=True, steps_per_call=2, iternum=2,
                 dtype="float64", device="cpu", checkpoint_dir=str(tmp_path))
    state, _ = run(ground_state.main, tmp_path, "a", 2, ["--dtype", "float64"])
    model, params = common.build_gs(cfg)
    fresh = init_gs_state(model, params, cfg, torch.device("cpu"))
    live_params = list(fresh.flow.parameters())
    restored, step = restore_checkpoint(str(tmp_path / "a"), fresh)
    assert step == restored.step == 2
    assert_bitwise(state_tensors(restored), state_tensors(state))
    # The optimizer still updates the live parameters.
    assert [id(p) for p in restored.flow.parameters()] == [
        id(p) for p in live_params]
    assert all(id(p) in {id(q) for q in live_params}
               for g in restored.optimizer.param_groups for p in g["params"])


def _gs(nup=2, batch=8):
    cfg = Config(nup=nup, batch=batch, d_eta=8, d_mu=8, dtype="float64",
                 device="cpu")
    model, params = common.build_gs(cfg)
    return init_gs_state(model, params, cfg, torch.device("cpu"))


def _beta(nup=2, batch=8):
    cfg = Config(nup=nup, batch=batch, d_eta=8, d_mu=8, dtype="float64",
                 device="cpu", deltaE=1.0, boltzmann=True)
    model, params = common.build_beta(cfg)
    return init_beta_state(model, params, cfg, torch.device("cpu"))


@pytest.mark.parametrize("saved,live", [
    (lambda: _gs(batch=8), lambda: _gs(batch=16)),
    (lambda: _gs(nup=2), lambda: _gs(nup=3)),
    (lambda: _gs(), lambda: _beta()),
    (lambda: _beta(nup=2), lambda: _beta(nup=3)),
], ids=["batch", "N", "gs-into-beta", "state-count"])
def test_restore_refuses_another_structure(tmp_path, saved, live):
    save_checkpoint(str(tmp_path), 3, saved())
    with pytest.raises(ValueError, match="structure mismatch"):
        restore_checkpoint(str(tmp_path), live())


def test_restore_of_a_gs_file_saved_without_a_device_generator(tmp_path):
    """A ground-state checkpoint written before the ground state had a
    device generator (no ``device_generator`` entry, none in its
    fingerprint) restores: every tensor and the host generator bitwise,
    the live device generator as it was; a finite-T state still refuses
    it."""
    from fermiflow_tpu_torch.utils import checkpointing as ck

    saved = _gs()
    torch.rand(3, generator=saved.generator)
    path = save_checkpoint(str(tmp_path), 3, saved)
    payload = torch.load(path, weights_only=True)
    del payload["device_generator"]
    payload["fingerprint"] = ck._fingerprint(saved, ("generator",))
    torch.save(payload, path)
    live = _gs()
    dev = live.device_generator.get_state()
    restored, step = restore_checkpoint(str(tmp_path), live)
    assert step == 3
    for k, t in ck.named_tensors(saved).items():
        assert torch.equal(ck.named_tensors(restored)[k], t), k
    assert torch.equal(restored.generator.get_state(),
                       saved.generator.get_state())
    assert torch.equal(restored.device_generator.get_state(), dev)
    with pytest.raises(ValueError, match="structure mismatch"):
        restore_checkpoint(str(tmp_path), _beta())


def test_restore_without_checkpoint_and_with_process_shards(tmp_path):
    """No directory, and an empty per-process ``proc00000`` directory, both
    restore as "no checkpoint" (step 0, the state unchanged), as the JAX
    ``_restore_resharded`` does."""
    state = _gs()
    assert restore_checkpoint(str(tmp_path / "none"), state) == (state, 0)
    os.makedirs(tmp_path / "proc00000")
    assert restore_checkpoint(str(tmp_path), state) == (state, 0)


# ---- the restart watchdog against the JAX loop ----


def _port_setup(tmp_path, max_restarts, K, divergence):
    """The port's counterpart of tests/test_watchdog.py's harness: a real
    TrainState and a fake chunk whose iteration 3 (state.step == 2) is NaN,
    or 1e6 with ``divergence``, on the original host stream only."""
    extra = dict(iternum=8, divergence_window=2, divergence_nsigma=5.0) \
        if divergence else dict(iternum=6)
    cfg = Config(nup=2, batch=8, checkpoint_dir=str(tmp_path / "ck"),
                 checkpoint_every=2, max_restarts=max_restarts,
                 steps_per_call=K, dtype="float64", device="cpu", **extra)
    model, params = common.build_gs(cfg)
    state = init_gs_state(model, params, cfg, torch.device("cpu"))
    gen0 = state.generator.get_state().clone()
    bad = 1e6 if divergence else float("nan")

    def make_chunk(chunk):
        def fn(state):
            Es = []
            for _ in range(chunk):
                poisoned = (state.step == 2 and torch.equal(
                    state.generator.get_state(), gen0))
                Es.append(bad if poisoned else 1.0 + state.step)
                state.step += 1
            E = torch.tensor(Es, dtype=torch.float64)
            return state, {"E": E, "E_std": 0 * E, "accept_rate": 0 * E,
                           "loss": 0 * E}
        return fn

    return cfg, state, make_chunk


def _outcome(go):
    """("raised", message) or ("ran", printed lines, printed steps, final
    step) of one loop run."""
    seen, out = [], io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            final = go(seen.append)
    except FloatingPointError as e:
        return "raised", str(e)
    return "ran", out.getvalue().splitlines(), seen, int(final.step)


def _both(tmp_path, max_restarts, K, divergence, nsigma=None):
    setup = _setup_divergence if divergence else _setup
    jcfg, jstate, fake_step, args, _ = setup(tmp_path / "jax", max_restarts,
                                             steps_per_call=K)
    cfg, state, make_chunk = _port_setup(tmp_path / "port", max_restarts, K,
                                         divergence)
    if nsigma is not None:
        jcfg.divergence_nsigma = cfg.divergence_nsigma = nsigma
    j = _outcome(lambda row: jcommon.run_training_loop(
        jstate, 0, jcfg, args, lambda jit: fake_step, JLogger(None),
        primary=True, print_row=lambda rec: row(rec["step"])))
    p = _outcome(lambda row: common.run_training_loop(
        state, cfg, make_chunk, MetricsLogger(None),
        lambda rec: row(rec["step"])))
    return j, p


@pytest.mark.parametrize("K", [1, 2])
def test_watchdog_restores_and_completes(tmp_path, K):
    j, p = _both(tmp_path, 2, K, divergence=False)
    assert p == j
    status, lines, steps, final = p
    assert lines == [f"WATCHDOG: non-finite energy (E=nan) at iteration "
                     f"{3 if K == 1 else 4}; restored checkpoint step 2 with "
                     f"reseeded chains (restart 1/2)"]
    assert final == 6 and steps == [1, 2, 3, 4, 5, 6]


def test_watchdog_exhausted_raises(tmp_path):
    j, p = _both(tmp_path, 0, 1, divergence=False)
    assert p == j == ("raised", "non-finite energy (E=nan) at iteration 3; "
                                "0/0 restarts used")


@pytest.mark.parametrize("K", [1, 2])
def test_divergence_watchdog_restores(tmp_path, K):
    j, p = _both(tmp_path, 2, K, divergence=True)
    assert p == j
    status, lines, steps, final = p
    assert len(lines) == 1 and lines[0].startswith("WATCHDOG: divergence (E=")
    assert "restored checkpoint step 2 with reseeded chains (restart 1/2)" \
        in lines[0]
    assert final == 8 and steps == list(range(1, 9))


def test_divergence_watchdog_raises_without_restarts(tmp_path):
    j, p = _both(tmp_path, 0, 1, divergence=True)
    assert p == j and p[0] == "raised"
    assert p[1].startswith("divergence (E=1e+06 > window mean ")
    assert p[1].endswith("at iteration 3; 0/0 restarts used")


def test_divergence_watchdog_disabled(tmp_path):
    j, p = _both(tmp_path, 0, 1, divergence=True, nsigma=0.0)
    assert p == j and p[0] == "ran" and p[1] == [] and p[3] == 8


def test_restart_refused_before_the_first_checkpoint(tmp_path):
    cfg, state, make_chunk = _port_setup(tmp_path, 1, 1, divergence=False)
    cfg.checkpoint_every = 4  # iteration 3 fails before step 4 is saved
    with pytest.raises(FloatingPointError, match="before the first "
                       "checkpoint was written"):
        common.run_training_loop(state, cfg, make_chunk, MetricsLogger(None),
                                 lambda rec: None)


def test_reseed_is_deterministic_and_differs_per_restart():
    a, b = _beta(), _beta()
    common._reseed(a, 7920)
    common._reseed(b, 7920)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert torch.equal(a.device_generator.get_state(),
                       b.device_generator.get_state())
    c = _beta()
    common._reseed(c, 7921)
    assert not torch.equal(a.generator.get_state(), c.generator.get_state())
    assert not torch.equal(a.device_generator.get_state(),
                           c.device_generator.get_state())
