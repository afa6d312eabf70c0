"""The walker mesh (``fermiflow_tpu_torch/parallel/mesh.py``) on the CPU:
two ranks of a gloo process group, each its own process, against one
process, and against the JAX package's estimators on a 2-device mesh.

The ranks run the jobs of ``tests/_torch_port.py`` once (the module
fixture); the parent runs the same jobs with no mesh, and the JAX side.
N = 3, batch 64 (32 rows a rank), d_eta = d_mu = 8, 2 dopri5 steps, f64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fermiflow_tpu.cli import common as jcommon
from fermiflow_tpu.config import Config as JConfig
from fermiflow_tpu.parallel import make_walker_mesh as j_make_walker_mesh
from fermiflow_tpu.parallel import shard_walkers as j_shard_walkers

from fermiflow_tpu_torch.parallel.mesh import (
    WalkerMesh,
    all_sum,
    all_sum_tree,
    global_batch,
    make_walker_mesh,
    sampler_rows,
    shard_walkers,
    walker_mean,
    walker_std,
)

import _torch_port as tp
from _torch_port import flat_np, jax_params, np_params

WORLD, B = 2, tp.MESH_CFG["batch"]
ROWS = B // WORLD
STEP_KINDS = [(False, "fused"), (False, "persistent"), (False, "fresh"),
              (False, "autograd"), (True, "persistent"), (True, "fresh"),
              (True, "autograd")]


def _inputs():
    """Walkers equilibrated on the N=3 ground state's density, Gaussian
    flow parameters (std 0.3), states and logits: the estimator inputs."""
    from fermiflow_tpu_torch.ops.metropolis import metropolis_chains_plain
    from fermiflow_tpu_torch.physics import HO2D

    orb = HO2D()
    rng = np.random.default_rng(61)
    x0 = torch.as_tensor(rng.standard_normal((6, B)))
    q = dict(nx_occ=tuple(int(v) for v in orb.nx[:3]),
             ny_occ=tuple(int(v) for v in orb.ny[:3]), num_shells=2)
    xs, _, _, _ = metropolis_chains_plain(
        x0, torch.full((B,), 0.3, dtype=torch.float64), 62, steps=60,
        segments=1, **q)
    table, _ = orb.fermion_states(3, 0, 2.0)
    return dict(z_cm=xs[-1].numpy().copy(), params=np_params(63),
                state_idx=rng.integers(0, len(table), B).astype(np.int32),
                logits=0.3 * rng.standard_normal(len(table)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(inputs, per-rank results) of every job on 2 ranks."""
    inp = _inputs()
    jobs = {f"train_{finite}_{kind}": ("job_train",
                                        dict(finite=finite, kind=kind))
            for finite, kind in STEP_KINDS}
    jobs["est_gs"] = ("job_estimators", dict(z_cm=inp["z_cm"],
                                             params=inp["params"]))
    jobs["est_beta"] = ("job_estimators", inp)
    jobs["ops"] = ("job_ops", dict(x_cm=inp["z_cm"], params=inp["params"],
                                   state_idx=inp["state_idx"]))
    jobs["collectives"] = ("job_collectives", {})
    return inp, tp.run_ranks(WORLD, jobs, tmp_path_factory.mktemp("ranks"))


def _rows(a, dim):
    """The 1-process array cut into the ranks' rows along ``dim``."""
    return np.split(np.asarray(a), WORLD, axis=dim)


def _flat(tree):
    """Every array of a nested dict/list, flattened, in a fixed order."""
    if tree is None:
        return np.zeros(0)
    if isinstance(tree, dict):
        return np.concatenate([_flat(tree[k]) for k in sorted(tree)])
    if isinstance(tree, list):
        return np.concatenate([_flat(v) for v in tree])
    return np.asarray(tree, np.float64).ravel()


@pytest.mark.parametrize("finite,kind", STEP_KINDS)
def test_two_rank_train_steps_equal_one_process(ranks, finite, kind):
    """Two iterations of every training path, as 2 ranks and as one
    process (tests/test_sharding.py:36 for the port): E rtol 1e-10, E_std
    rtol 1e-9 (at finite T also F, F_std, S), the replicated parameters
    (and logits) to atol 1e-12 and equal on both ranks, and each rank's
    walkers, tau and states bitwise the one-process rows.  The chains draw
    global streams keyed by the global walker, and at the GS the walkers
    never depend on the parameters."""
    _, outs = ranks
    one = tp.job_train(None, finite, kind)
    two = [o[f"train_{finite}_{kind}"] for o in outs]
    means = ("E", "F", "S", "S_analytical") if finite else ("E",)
    for r in two:
        for k in means:
            np.testing.assert_allclose(r["metrics"][k], one["metrics"][k],
                                       rtol=1e-10)
        for k in means[:2]:
            np.testing.assert_allclose(r["metrics"][k + "_std"],
                                       one["metrics"][k + "_std"], rtol=1e-9)
        np.testing.assert_allclose(r["metrics"]["accept_rate"],
                                   one["metrics"]["accept_rate"], rtol=1e-12)
        np.testing.assert_allclose(_flat(r["flow"]), _flat(one["flow"]),
                                   rtol=0, atol=1e-12)
        if finite:
            np.testing.assert_allclose(r["logits"], one["logits"], rtol=0,
                                       atol=1e-12)
    np.testing.assert_array_equal(_flat(two[0]["flow"]), _flat(two[1]["flow"]))
    for k, dim in (("walkers_cm", 1), ("tau", 0), ("state_idx", 0)):
        if one[k] is None:
            continue
        for r, rows in zip(two, _rows(one[k], dim)):
            np.testing.assert_array_equal(r[k], rows)


def _jax_estimator(inp, finite):
    """The JAX package's ``loss_and_metrics_from_base`` and its gradient,
    jitted with the walkers (and states) sharded over a 2-device mesh."""
    jcfg = JConfig(**{k: v for k, v in tp.MESH_CFG.items() if k != "device"})
    jmesh = j_make_walker_mesh(jax.devices("cpu")[:WORLD])
    z = j_shard_walkers(jmesh, jnp.asarray(
        inp["z_cm"].T.reshape(B, 3, 2)))
    if finite:
        jcfg.beta, jcfg.deltaE = 2.0, 2.0
        jmodel, _ = jcommon.build_beta(jcfg)
        params = {"flow": jax_params(inp["params"]),
                  "log_state_weights": jnp.asarray(inp["logits"])}
        args = (params, j_shard_walkers(jmesh, jnp.asarray(inp["state_idx"])),
                z)
    else:
        jmodel, _ = jcommon.build_gs(jcfg)
        args = (jax_params(inp["params"]), z)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        jmodel.loss_and_metrics_from_base, has_aux=True))(*args)
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads


@pytest.mark.parametrize("finite", [False, True])
def test_two_rank_estimators_equal_jax_on_a_two_device_mesh(ranks, finite):
    """The 2-rank estimators against the JAX package's on a 2-device mesh
    (GSPMD inserts its means and gradient sums), f64, rtol 1e-10: the
    autograd estimator's loss, metrics and gradient (the flow's and the
    logits'); the kernel chain's metrics and closed-form logits gradient.
    The chain's flow gradient is the continuous adjoint, which differs from
    autodiff through the discrete solve at the ODE's error: it and its loss
    are held to the one-process chain's, rtol 1e-10."""
    inp, outs = ranks
    name = "est_beta" if finite else "est_gs"
    jloss, jm, jgrads = _jax_estimator(inp, finite)
    jflow = flat_np(jgrads["flow"] if finite else jgrads)
    one = tp.job_estimators(None, **(inp if finite else dict(
        z_cm=inp["z_cm"], params=inp["params"])))
    for r in (o[name] for o in outs):
        auto, chain = r["autograd"], r["chain"]
        np.testing.assert_allclose(auto["loss"], jloss, rtol=1e-10)
        for k, v in jm.items():
            np.testing.assert_allclose(auto["metrics"][k], v, rtol=1e-10)
            np.testing.assert_allclose(chain["metrics"][k], v, rtol=1e-10)
        g = np.concatenate([np.ravel(t) for t in auto["grads"]])
        n = len(jflow)
        np.testing.assert_allclose(g[:n], jflow, rtol=1e-10,
                                   atol=1e-10 * np.abs(jflow).max())
        if finite:
            jl = np.asarray(jgrads["log_state_weights"])
            for got in (g[n:], chain["grads"]["log_state_weights"]):
                np.testing.assert_allclose(got, jl, rtol=1e-10,
                                           atol=1e-10 * np.abs(jl).max())
        cf = _flat(chain["grads"]["flow"] if finite else chain["grads"])
        of = _flat(one["chain"]["grads"]["flow"] if finite
                   else one["chain"]["grads"])
        np.testing.assert_allclose(cf, of, rtol=1e-10,
                                   atol=1e-10 * np.abs(of).max())
        np.testing.assert_allclose(chain["loss"], one["chain"]["loss"],
                                   rtol=1e-10)


@pytest.mark.parametrize("entry", ["chains", "single", "multistate", "vgh",
                                   "vgh_ms", "hessian_flow", "reinforce"])
def test_sharded_entry_points_give_the_one_process_rows(ranks, entry):
    """Each ``*_sharded`` entry point on a rank's rows gives those rows of
    the one-process call: bitwise for the samplers (each rank's plain
    sampler draws the global stream and keeps its rows), within 1e-12 for
    the per-walker kernels' plain versions; the REINFORCE gradient is the
    sum over ranks, replicated, within 1e-10 of the one-process one."""
    inp, outs = ranks
    one = tp.job_ops(None, inp["z_cm"], inp["params"], inp["state_idx"])
    two = [o["ops"][entry] for o in outs]
    if entry == "reinforce":
        ref = _flat(one[entry][0])
        for r in two:
            np.testing.assert_allclose(_flat(r[0]), ref, rtol=1e-10,
                                       atol=1e-10 * np.abs(ref).max())
        outputs = [(one[entry][1], [r[1] for r in two])]
    else:
        outputs = [(a, [r[i] for r in two]) for i, a in enumerate(one[entry])]
    for full, parts in outputs:
        # The walker axis: after the segment axis of the chains' outputs.
        dim = 1 if entry == "chains" and full.ndim > 1 else 0
        for got, rows in zip(parts, _rows(full, dim)):
            if entry in ("chains", "single", "multistate"):
                np.testing.assert_array_equal(got, rows)
            else:
                np.testing.assert_allclose(got, rows, rtol=1e-12, atol=1e-12)


def test_two_rank_reductions(ranks):
    """all_sum, all_mean, the one-collective sums of several tensors and of
    a gradient dict (None kept, dtypes kept), and the walker-axis mean,
    two-pass std and per-rank share, against numpy on the global values;
    replicated on both ranks, and counted: one collective each (seven,
    the mean handed to the std included; the per-rank share runs none)."""
    _, outs = ranks
    x = np.arange(8.0)
    for r in (o["collectives"] for o in outs):
        np.testing.assert_array_equal(r["sum"], [3.0, 30.0])
        np.testing.assert_array_equal(r["mean"], [1.5, 15.0])
        assert r["tensors"][1] is None
        np.testing.assert_array_equal(r["tensors"][0], [3.0, 30.0])
        assert r["tensors"][2].dtype == np.int32 and r["tensors"][2] == [3]
        assert r["tree"]["a"]["c"] is None and r["tree"]["d"] == [3]
        np.testing.assert_array_equal(r["tree"]["a"]["b"], [3.0, 30.0])
        assert r["walker_mean"] == x.mean()
        np.testing.assert_allclose(r["walker_std"], x.std(), rtol=1e-15)
        assert r["count"] == 7
    np.testing.assert_allclose(sum(o["collectives"]["local_mean"]
                                   for o in outs), x.mean(), rtol=1e-15)


def test_mesh_helpers_at_one_process():
    """Without a process group the mesh is one rank and every reduction is
    the one-process one (``--shard`` alone); the rows of a global tensor."""
    mesh = make_walker_mesh("cpu")
    assert mesh == WalkerMesh(0, 1, torch.device("cpu"))
    assert mesh.rows(64) == (0, 64) and global_batch(mesh, 64) == 64
    assert sampler_rows(mesh, 64) == dict(walker0=0, global_batch=64)
    assert sampler_rows(None, 64) == {}
    x = torch.randn(3, 64, dtype=torch.float64)
    assert torch.equal(shard_walkers(mesh, x, 1), x)
    two = WalkerMesh(1, 2, torch.device("cpu"))
    assert torch.equal(shard_walkers(two, x, 1), x[:, 32:])
    assert two.rows(64) == (32, 32) and sampler_rows(two, 32) == dict(
        walker0=32, global_batch=64)
    with pytest.raises(ValueError, match="does not split"):
        two.rows(63)
    e = x[0]
    assert torch.equal(walker_mean(mesh, e), torch.mean(e))
    assert torch.equal(walker_std(mesh, (e, torch.mean(e))),
                       torch.std(e, correction=0))
    assert all_sum(mesh, e) is e
    tree = {"eta": {"w": e}, "mu": None}
    assert all_sum_tree(mesh, tree) is tree
