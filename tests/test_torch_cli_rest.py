"""The rest of the single-process CLI of ``fermiflow_tpu_torch``: the flags
this port used to refuse (checkpoints, restarts, the solvers, the nested-jvp
engine, the movie), ``--debug-nans`` and the ``--no-pallas-*`` switches, on
``--device cpu`` at N = 2-3, widths 8, a few iterations.
"""

import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fermiflow_tpu.cli import common as jcommon
from fermiflow_tpu.config import Config as JConfig

from fermiflow_tpu_torch.cli import common, finite_t, ground_state
from fermiflow_tpu_torch.config import Config
from fermiflow_tpu_torch.train import init_gs_state
from fermiflow_tpu_torch.utils import MetricsLogger

GS = ["--nup", "3", "--batch", "16", "--Deta", "8", "--Dmu", "8",
      "--ode-steps", "2", "--mcmc-steps", "5", "--equilibrium-steps", "5",
      "--lr", "1e-3", "--device", "cpu", "--persistent"]
BETA = ["--beta", "2.0", "--deltaE", "2.0", "--boltzmann"]


def rows_of(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


@pytest.mark.parametrize("flags", [
    ["--checkpoint-dir", "{tmp}/ck", "--checkpoint-every", "2"],
    ["--max-restarts", "1", "--checkpoint-dir", "{tmp}/ck"],
    ["--ode-solver", "adaptive", "--local-energy", "nested_jvp"],
    ["--ode-solver", "adjoint", "--local-energy", "nested_jvp"],
    ["--local-energy", "nested_jvp"],
    ["--movie", "{tmp}/m.npy", "--movie-frames", "3", "--movie-walkers", "8"],
])
@pytest.mark.parametrize("finite", [False, True], ids=["gs", "beta"])
def test_cli_runs_the_flags_it_used_to_refuse(tmp_path, flags, finite):
    """Two iterations (one K=2 chunk) with each flag: variational energies
    near the identity flow's, a metrics row per iteration."""
    path = tmp_path / "m.jsonl"
    main = finite_t.main if finite else ground_state.main
    argv = (BETA if finite else []) + GS + [
        "--dtype", "float64", "--iternum", "2", "--steps-per-call", "2",
        "--metrics", str(path)] + [f.format(tmp=tmp_path) for f in flags]
    state = main(argv)
    rows = rows_of(path)
    assert state.step == 2 and [r["step"] for r in rows] == [1, 2]
    key = "F" if finite else "E"
    assert all(np.isfinite(r[key]) and 4.0 < r[key] < 7.5 for r in rows)
    if "--checkpoint-every" in flags:
        assert (tmp_path / "ck" / "ckpt_00000002.pt").exists()


def test_config_from_args_maps_the_flags_as_jax(tmp_path):
    parser = argparse.ArgumentParser()
    common.add_flags(parser)
    argv = ["--checkpoint-dir", str(tmp_path), "--checkpoint-every", "7",
            "--max-restarts", "3", "--ode-solver", "adaptive", "--rtol",
            "1e-5", "--atol", "1e-7", "--local-energy", "nested_jvp"]
    cfg = common.config_from_args(parser.parse_args(argv))
    jparser = argparse.ArgumentParser()
    jcommon.add_flags(jparser, finite_t=False)
    jcfg = jcommon.config_from_args(jparser.parse_args(argv), finite_t=False)
    for f in ("checkpoint_dir", "checkpoint_every", "max_restarts",
              "ode_solver", "rtol", "atol", "local_energy"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    cnf = common.make_cnf(cfg)
    assert (cnf.solver, cnf.rtol, cnf.atol) == ("adaptive", 1e-5, 1e-7)
    assert (cfg.pallas_sampler, cfg.pallas_local_energy,
            cfg.pallas_reinforce) == (True, True, True)
    off = common.config_from_args(parser.parse_args(
        ["--no-pallas-sampler", "--no-pallas-local-energy",
         "--no-pallas-reinforce"]))
    assert (off.pallas_sampler, off.pallas_local_energy,
            off.pallas_reinforce) == (False, False, False)
    assert parser.parse_args([]).movie_frames == 50
    assert parser.parse_args([]).movie_walkers == 2000


@pytest.mark.parametrize("finite", [False, True], ids=["gs", "beta"])
def test_movie_has_jax_shape_and_ends_at_generate(tmp_path, finite):
    movie = tmp_path / "m.npy"
    main = finite_t.main if finite else ground_state.main
    state = main((BETA if finite else []) + GS + [
        "--dtype", "float64", "--iternum", "1", "--movie", str(movie),
        "--movie-frames", "4", "--movie-walkers", "8"])
    frames = np.load(movie)
    # The JAX driver's frames for the same flags, by shape.
    jcfg = JConfig(nup=3, d_eta=8, d_mu=8, ode_steps=2)
    jmodel, jparams = (jcommon.build_beta if finite else jcommon.build_gs)(jcfg)
    jflow = jparams["flow"] if finite else jparams
    want = jax.eval_shape(lambda p, z: jmodel.cnf.generate_trajectory(p, z, 4),
                          jflow, jnp.zeros((8, 3, 2)))
    assert frames.shape == want.shape == (4, 8, 3, 2)
    # The last frame is generate of the first on the trajectory's grid
    # (3 intervals x 4 sub-steps).
    cfg = Config(nup=3, d_eta=8, d_mu=8, ode_steps=2, dtype="float64",
                 device="cpu")
    model, _ = common.build_gs(cfg)
    fine = dataclasses.replace(model.cnf, steps=12)
    flow = state.params["flow"] if finite else state.params
    with torch.no_grad():
        x = fine.generate(flow, torch.as_tensor(frames[0]))
    np.testing.assert_allclose(frames[-1], x.numpy(), rtol=1e-12, atol=1e-12)
    assert not np.allclose(frames[-1], frames[0])


def _one_iteration(tmp_path, name, flags, finite=False):
    path = tmp_path / f"{name}.jsonl"
    main = finite_t.main if finite else ground_state.main
    state = main((BETA if finite else []) + GS + [
        "--dtype", "float64", "--iternum", "1", "--metrics", str(path)]
        + flags)
    return state, rows_of(path)[0]


@pytest.mark.parametrize("finite", [False, True], ids=["gs", "beta"])
@pytest.mark.parametrize("flags", [
    ["--no-pallas-sampler"], ["--no-pallas-reinforce"],
    ["--no-pallas-local-energy"],
    ["--no-pallas-sampler", "--no-pallas-local-energy",
     "--no-pallas-reinforce"],
])
def test_no_pallas_switches_take_the_plain_paths(tmp_path, monkeypatch,
                                                 flags, finite):
    """On the CPU every wrapper already runs its plain version, so the
    sampler switch changes nothing but the stream the plain samplers draw
    from, the state's device generator (the base run's wrappers are handed
    the same generator here, which a wrapper accepts on the CPU); the other
    two trade the closed-form adjoint for autograd of the reverse-ODE logp,
    which agrees with it up to the fixed grid's reversal error."""
    from fermiflow_tpu_torch import train

    with monkeypatch.context() as m:
        if "--no-pallas-sampler" in flags:
            m.setattr(train, "_plain_draws", lambda cfg, state: {
                "generator": state.device_generator})
        base, rec = _one_iteration(tmp_path, "base", [], finite)
    off, rec_off = _one_iteration(tmp_path, "off", flags, finite)
    for k in ("E", "E_std", "accept_rate") + (("F", "S") if finite else ()):
        np.testing.assert_allclose(rec_off[k], rec[k], rtol=1e-12)
    assert torch.equal(off.walkers_cm, base.walkers_cm)
    for a, b in zip(off.flow.parameters(), base.flow.parameters()):
        if flags == ["--no-pallas-sampler"]:
            assert torch.equal(a, b)
        else:
            np.testing.assert_allclose(a.detach().numpy(),
                                       b.detach().numpy(), rtol=1e-6,
                                       atol=1e-9)


def test_debug_nans_names_the_first_nonfinite_state_tensor():
    cfg = Config(nup=2, batch=8, iternum=4, steps_per_call=2, dtype="float64",
                 device="cpu", d_eta=8, d_mu=8)
    model, params = common.build_gs(cfg)
    state = init_gs_state(model, params, cfg, torch.device("cpu"))

    def make_chunk(chunk):
        def fn(state):
            anomaly.append(torch.is_anomaly_enabled())
            state.step += chunk
            if state.step == 4:
                state.tau[3] = float("nan")
            E = torch.ones(chunk, dtype=torch.float64)
            return state, {"E": E, "E_std": 0 * E}
        return fn

    anomaly = []
    with pytest.raises(FloatingPointError,
                       match=r"--debug-nans: non-finite tau after iteration 4"):
        common.run_training_loop(state, cfg, make_chunk, MetricsLogger(None),
                                 lambda rec: None, debug_nans=True)
    assert anomaly == [True, True] and not torch.is_anomaly_enabled()
    # Off, the same chunks run through (the metrics stay finite).
    state.step, state.tau = 0, torch.full((8,), 0.1, dtype=torch.float64)
    anomaly.clear()
    common.run_training_loop(state, cfg, make_chunk, MetricsLogger(None),
                             lambda rec: None)
    assert anomaly == [False, False]


def test_cli_debug_nans_runs_a_healthy_run(tmp_path):
    state, rec = _one_iteration(tmp_path, "dbg", ["--debug-nans"])
    assert state.step == 1 and np.isfinite(rec["E"])
    assert not torch.is_anomaly_enabled()
