"""The port's checkpoint evaluator (``fermiflow_tpu_torch/cli/
eval_at_checkpoint.py``, the counterpart of ``validation/
eval_at_checkpoint.py``) on the CPU in float64: the identity-flow oracle
E = 5 exactly at Z = 0, N = 3 with both engines; both engines on the same
fresh walkers at a trained checkpoint; and the JAX script's output keys.
Also the JAX sampler's acceptance at nup = ndown = 1 that ``chip_smoke.py``
phase 10 holds kernels #1 and #5 to."""

import ast
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fermiflow_tpu import mcmc as jmcmc
from fermiflow_tpu.physics import HO2D as JHO2D
from fermiflow_tpu.physics import FreeFermion as JFreeFermion

from fermiflow_tpu_torch.cli import common, eval_at_checkpoint, ground_state
from fermiflow_tpu_torch.config import Config
from fermiflow_tpu_torch.train import init_gs_state
from fermiflow_tpu_torch.utils.checkpointing import save_checkpoint

import _torch_port as tp

torch.set_num_threads(1)

ENGINES = ("hessian_flow", "nested_jvp")
SMALL = ["--nup", "3", "--Deta", "8", "--Dmu", "8", "--ode-steps", "2",
         "--dtype", "float64", "--device", "cpu"]


def jax_script_keys() -> set:
    """The keys of the result dict that ``validation/eval_at_checkpoint.py``
    writes, read from its source."""
    path = os.path.join(tp.REPO, "validation", "eval_at_checkpoint.py")
    for node in ast.walk(ast.parse(open(path).read())):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and [t.id for t in node.targets
                     if isinstance(t, ast.Name)] == ["res"]):
            return {k.value for k in node.value.keys}
    raise AssertionError("no result dict in the JAX script")


def evaluate(ckpt, out, engine, extra):
    return eval_at_checkpoint.main(
        SMALL + ["--ckpt", str(ckpt), "--engine", engine, "--out", str(out)]
        + extra)


@pytest.mark.parametrize("engine", ENGINES)
def test_identity_flow_oracle_both_engines(tmp_path, engine):
    """Z = 0 at the identity flow: the base Slater state is an eigenstate,
    Eloc = 5 on every fresh walker."""
    cfg = Config(nup=3, Z=0.0, batch=32, d_eta=8, d_mu=8, ode_steps=2,
                 dtype="float64", device="cpu")
    model, params = common.build_gs(cfg)
    save_checkpoint(str(tmp_path / "ck"), 1,
                    init_gs_state(model, params, cfg, torch.device("cpu")))
    out = tmp_path / "e.json"
    res = evaluate(tmp_path / "ck", out, engine,
                   ["--Z", "0.0", "--batch", "64", "--train-batch", "32",
                    "--equil", "20", "--reps", "2"])
    assert res["step"] == 1 and res["n_total"] == 128
    assert abs(res["E"] - 5.0) < 1e-9 and res["E_std"] < 1e-9
    assert json.loads(out.read_text()) == res
    assert set(res) == jax_script_keys()


def test_engines_agree_at_a_trained_checkpoint(tmp_path):
    """After 3 CPU iterations of the ground-state CLI (Z = 0.5), the two
    engines on the same fresh walkers (same seed) agree to 1e-8."""
    ground_state.main(SMALL + [
        "--Z", "0.5", "--batch", "32", "--iternum", "3", "--lr", "1e-2",
        "--mcmc-steps", "3", "--equilibrium-steps", "3", "--persistent",
        "--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every", "3"])
    argv = ["--Z", "0.5", "--batch", "48", "--train-batch", "32", "--equil",
            "10", "--reps", "2", "--seed", "3"]
    res = {e: evaluate(tmp_path / "ck", tmp_path / f"{e}.json", e, argv)
           for e in ENGINES}
    assert res["hessian_flow"]["step"] == 3
    assert abs(res["hessian_flow"]["E"] - res["nested_jvp"]["E"]) < 1e-8
    assert abs(res["hessian_flow"]["E_std"]
               - res["nested_jvp"]["E_std"]) < 1e-8
    # And walker by walker.
    model, params, _ = eval_at_checkpoint.restore_model(
        str(tmp_path / "ck"), 3, 0, 0.5, 32, "float64", 2, "cpu", 8, 8)
    z, acc = eval_at_checkpoint.fresh_walkers(
        model, torch.Generator().manual_seed(5), 16, 10, torch.float64)
    assert 0.0 < acc <= 1.0
    e_hf, e_jvp = (eval_at_checkpoint.local_energies(model, params, z, e)
                   for e in ENGINES)
    np.testing.assert_allclose(e_hf.numpy(), e_jvp.numpy(), rtol=0,
                               atol=1e-8)
    # The flow moved off the identity: the energies are not the Z = 0 ones.
    assert float(e_hf.std()) > 1e-3


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        evaluate(tmp_path / "none", tmp_path / "e.json", "hessian_flow",
                 ["--Z", "0.5", "--batch", "8", "--train-batch", "8",
                  "--reps", "1", "--equil", "1"])


def test_jax_sampler_singlet_acceptance_is_chip_smokes_figure():
    """chip_smoke.py phase 10 holds kernels #1 and #5 at nup = ndown = 1 to
    the JAX sampler's acceptance at tau = 0.1 after 300 steps at tau = 0.2
    from Gaussians (0.894, over 8192 walkers): the JAX package's plain
    sampler gives it again over 1024 walkers (standard error ~0.002)."""
    import chip_smoke

    jbd = JFreeFermion(JHO2D())
    up = dn = np.arange(1)
    run = jax.jit(lambda k, x, steps, tau: jmcmc.metropolis(
        lambda y: jbd.log_prob(up, dn, y), k, x, steps, tau),
        static_argnums=2)
    k1, k2 = jax.random.split(jax.random.PRNGKey(2))
    x0 = jnp.asarray(np.random.default_rng(2).standard_normal((1024, 2, 2)),
                     jnp.float32)
    st = run(k2, run(k1, x0, 300, 0.2).x, 300, 0.1)
    acc = float(jnp.mean(st.accept_rate))
    assert abs(acc - chip_smoke.ACCEPT_TAU01_11) < 0.01, acc
