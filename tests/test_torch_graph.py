"""The compiled chunk on the CPU: what the card captures as one CUDA graph
per chunk (``fermiflow_tpu_torch/train.py``), held here without a card.

* ``CoulombPairPotential.V_rows``, now one expression of six operations,
  against the JAX ``V_rows`` and ``V`` in float64;
* the plain samplers give the same bits for an ``int`` seed and for the
  one-element int32 tensor a captured chunk hands the kernels;
* the captured chunk's host side (seeds through the static buffer, the
  eager warm-up, the metrics out of the graph's output) with a stand-in for
  the capture that replays by running the body again: bitwise the eager
  chunk, for the GS fused chunk, the GS step and the finite-T multi-step,
  with persistent and with fresh walkers;
* ``graph=True`` refuses every path that stays eager, and accepts a mesh
  without a process group and an NCCL mesh; a replay counts the mesh's
  collectives as the capture recorded them;
* fresh walkers: drawn from the device generator, a rank's rows of the
  one-process draw; the identity-flow oracles through all three builders
  against the JAX package's values;
* ``run_training_loop`` makes its chunks anew after a restore;
* the trace summary's counts of graph launches, launches and waits.

``tests/test_torch_cuda.py`` holds real replays against eager chunks on the
card, and ``chip_smoke.py`` phase 12 at the paths' widths.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from fermiflow_tpu.physics.potentials import CoulombPairPotential as JCoulomb

from fermiflow_tpu_torch import train
from fermiflow_tpu_torch.cli import common
from fermiflow_tpu_torch.config import Config
from fermiflow_tpu_torch.ops.metropolis import (
    metropolis_chains,
    metropolis_multistate_cm,
    metropolis_single_cm,
)
from fermiflow_tpu_torch.parallel import mesh as mesh_mod
from fermiflow_tpu_torch.parallel.mesh import WalkerMesh, make_walker_mesh
from fermiflow_tpu_torch.physics import HO2D
from fermiflow_tpu_torch.physics.potentials import CoulombPairPotential
from fermiflow_tpu_torch.utils import MetricsLogger
from fermiflow_tpu_torch.utils.profiling import summarize

from _torch_port import walkers

ORB = HO2D()


# ---- the pair potential as one expression ----


class OpCounter(TorchDispatchMode):
    """The operations (views aside) that reach the kernels' dispatch."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("n", [2, 3, 6, 10])
def test_v_rows_matches_jax_in_six_operations(n):
    """V_rows against the JAX ``V_rows`` and ``V`` in float64 to 1e-12
    relative, walker 0's first two particles 1e-7 apart in each coordinate
    (Z/r ~ 5e6 of a sum of order 1); and one call is at most six operations, where the
    unrolled pair loop took ~8 a pair."""
    B, Z = 64, 0.7
    x = walkers(60 + n, B, n)
    x[0, 1] = x[0, 0] + 1e-7
    xd = torch.as_tensor(x.reshape(B, 2 * n).T.copy())
    pot, jpot = CoulombPairPotential(Z), JCoulomb(Z)
    v = pot.V_rows(xd, n, 2)
    np.testing.assert_allclose(v.numpy(),
                               np.asarray(jpot.V_rows(jnp.asarray(xd.numpy()),
                                                      n, 2)), rtol=1e-12)
    np.testing.assert_allclose(v.numpy(), np.asarray(jpot.V(jnp.asarray(x))),
                               rtol=1e-12)
    assert float(v[0]) > 0.99 * Z / (2**0.5 * 1e-7)
    with OpCounter() as counter:
        pot.V_rows(xd, n, 2)
    assert len(counter.ops) <= 6, counter.ops


# ---- the samplers' seed: an int or a device word ----


@pytest.mark.parametrize("entry", ["chains", "single", "multistate"])
def test_plain_samplers_take_an_int_or_a_tensor_seed(entry):
    """Each sampler wrapper on the CPU (its plain version) gives the same
    bits for ``seed=s`` and ``seed=torch.tensor([s], dtype=torch.int32)``,
    and another stream for another seed."""
    n, B = 3, 24
    x0 = torch.as_tensor(walkers(61, B, n, dtype=np.float32)
                         .reshape(B, 2 * n).T.copy())
    tau = torch.full((B,), 0.3)
    q = dict(nx_occ=(0, 1, 0), ny_occ=(0, 0, 1), num_shells=2)
    table, _ = ORB.fermion_states(n, 0, 2.0)
    occ = torch.as_tensor(table).long()[torch.arange(B) % table.shape[0]]
    nx, ny = (torch.as_tensor(a)[occ].T.to(torch.int32).contiguous()
              for a in (ORB.nx, ORB.ny))

    def run(seed):
        if entry == "chains":
            return metropolis_chains(x0, tau, seed, steps=4, segments=2, **q)
        if entry == "single":
            return metropolis_single_cm(x0, tau, seed, steps=4, **q)
        return metropolis_multistate_cm(x0, tau, seed, steps=4, nx_cm=nx,
                                        ny_cm=ny, num_shells=4)

    s = 1234567
    a, b, c = run(s), run(torch.tensor([s], dtype=torch.int32)), run(s + 1)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    assert not torch.equal(a[0], c[0])


# ---- the captured chunk's host side, with a stand-in capture ----


# The autograd A/B paths: the CLI's --no-pallas-* flags, the nested-jvp
# engine, and --no-pallas-reinforce alone (kernels #1-#3, then autograd).
AB_FLAGS = {"no_pallas": dict(pallas_sampler=False, pallas_local_energy=False,
                              pallas_reinforce=False),
            "nested_jvp": dict(local_energy="nested_jvp"),
            "no_pallas_reinforce": dict(pallas_reinforce=False)}


def small_cfg(finite, K, **kw):
    cfg = Config(**{**dict(nup=3, batch=32, d_eta=8, d_mu=8, ode_steps=2,
                           mcmc_steps=5, dtype="float64",
                           persistent_walkers=True, steps_per_call=K, lr=1e-3,
                           device="cpu"), **kw})
    if finite:
        cfg.beta, cfg.deltaE = 2.0, 2.0
    return cfg


def small_run(kind, graphed, chunks=4, persistent=True, mesh=None,
              path=None):
    """``chunks`` chunks of the GS fused chunk (K = 3), the GS step
    (K = 1) or the finite-T multi-step (K = 3) from a fresh float64 state
    at N = 3, with persistent or fresh walkers, on ``mesh``, on the kernel
    chain or an A/B ``path`` (``AB_FLAGS``); ``graphed``: through the
    captured chunk's host side, the capture replaced by a stand-in that
    runs nothing and replays by running the body again."""
    finite, K = kind == "beta", 1 if kind == "single" else 3
    cfg = small_cfg(finite, K, persistent_walkers=persistent,
                    equilibrium_steps=6, **AB_FLAGS.get(path, {}))
    cpu = torch.device("cpu")
    if finite:
        model, params = common.build_beta(cfg)
        state = train.init_beta_state(model, params, cfg, cpu, mesh)
        chunk = train.make_multi_step(
            train.make_beta_train_step(model, cfg, mesh), K)
    else:
        model, params = common.build_gs(cfg)
        state = train.init_gs_state(model, params, cfg, cpu, mesh)
        chunk = (train.make_multi_step(
            train.make_gs_train_step(model, cfg, mesh), 1)
                 if kind == "single" else
                 train.make_gs_fused_multi_step(model, cfg, K, mesh))
    if graphed:
        chunk._captured = lambda state: True
    rows = []
    for _ in range(chunks):
        state, metrics = chunk(state)
        rows.append(metrics)
    return state, rows, chunk


def state_tensors(state):
    from fermiflow_tpu_torch.utils.checkpointing import named_tensors

    out = dict(named_tensors(state))
    for i, st in enumerate(state.optimizer.state.values()):
        out.update({f"adam{i}.{k}": v for k, v in st.items()})
    out["generator"] = state.generator.get_state()
    if state.device_generator is not None:
        out["device_generator"] = state.device_generator.get_state()
    return out


@pytest.mark.parametrize("persistent", [True, False],
                         ids=["persistent", "fresh"])
@pytest.mark.parametrize("kind", ["fused", "single", "beta"])
def test_captured_chunk_host_side_is_the_eager_chunk_bitwise(monkeypatch,
                                                             kind,
                                                             persistent):
    """The captured chunk run on the CPU in float64 (its seeds drawn up
    front and read from the static buffer, the first chunk warming up, the
    metrics cloned out of one packed output) against the eager chunk, 4
    chunks each, with persistent and with fresh walkers: walkers, tau,
    every parameter, Adam's moments and step, the states and their
    probabilities, both generators and every metric, bitwise.  The eager
    chunks are the ones that ``tests/test_torch_train.py`` and
    ``tests/test_torch_beta.py`` hold against the JAX package.  A fresh
    chunk registers the device generator it draws from."""
    monkeypatch.setattr(train, "_on_side_stream", lambda fn, device: fn())
    registered = []
    monkeypatch.setattr(train, "_capture", lambda fn, device, generators=(): (
        registered.append(tuple(generators)), (fn, 0.0, 0))[1])
    s_g, rows_g, chunk = small_run(kind, True, persistent=persistent)
    s_e, rows_e, _ = small_run(kind, False, persistent=persistent)
    draws = kind == "beta" or not persistent
    assert registered == [(s_g.device_generator,) if draws else ()]
    assert chunk._replay is not None
    assert s_g.step == s_e.step == 4 * chunk.iters
    a, b = state_tensors(s_g), state_tensors(s_e)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for r_g, r_e in zip(rows_g, rows_e):
        assert r_g.keys() == r_e.keys()
        for k in r_g:
            assert torch.equal(r_g[k], r_e[k]), k


@pytest.mark.parametrize("path,kind,persistent", [
    ("no_pallas", "fused", True), ("no_pallas", "beta", False),
    ("nested_jvp", "single", True), ("nested_jvp", "single", False),
    ("no_pallas_reinforce", "beta", True),
    ("no_pallas_reinforce", "fused", False)])
def test_captured_ab_chunk_host_side_is_the_eager_chunk_bitwise(
        monkeypatch, path, kind, persistent):
    """The autograd A/B paths through the captured chunk's host side (the
    stand-in capture as above) against the eager chunk, 3 chunks each (2,
    the warm-up and one replay, on the slow nested-jvp engine): every
    state tensor, Adam, both generators and every metric bitwise.  Each
    path runs persistent and fresh, and each chunk kind twice.  The graph
    registers the device generator wherever the body draws from it: fresh
    walkers, finite-T states, the plain samplers."""
    monkeypatch.setattr(train, "_on_side_stream", lambda fn, device: fn())
    registered = []
    monkeypatch.setattr(train, "_capture", lambda fn, device, generators=(): (
        registered.append(tuple(generators)), (fn, 0.0, 0))[1])
    chunks = 2 if path == "nested_jvp" else 3
    s_g, rows_g, chunk = small_run(kind, True, chunks, persistent, path=path)
    s_e, rows_e, _ = small_run(kind, False, chunks, persistent, path=path)
    draws = kind == "beta" or not persistent or path == "no_pallas"
    assert registered == [(s_g.device_generator,) if draws else ()]
    assert chunk._replay is not None and s_g.step == s_e.step
    a, b = state_tensors(s_g), state_tensors(s_e)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for r_g, r_e in zip(rows_g, rows_e):
        assert r_g.keys() == r_e.keys()
        for k in r_g:
            assert torch.equal(r_g[k], r_e[k]), k


@pytest.mark.parametrize("kind", ["fused", "single", "beta"])
def test_plain_samplers_draw_from_the_device_generator(monkeypatch, kind):
    """``--no-pallas-sampler``: the plain samplers draw from the state's
    device generator, not from a generator seeded with the chunk's seed
    word (which they would read on the host), so the walkers do not
    depend on the host's seeds, and the host generator still draws one
    seed an iteration, as on the kernel path."""
    runs = []
    for seed in (lambda state: 11, lambda state: 12):
        monkeypatch.setattr(train, "_new_seed", seed)
        s, _, _ = small_run(kind, False, 1, path="no_pallas")
        runs.append(s)
    assert torch.equal(runs[0].walkers_cm, runs[1].walkers_cm)
    assert torch.equal(runs[0].device_generator.get_state(),
                       runs[1].device_generator.get_state())
    monkeypatch.undo()
    s, _, _ = small_run(kind, False, 1, path="no_pallas")
    k, _, _ = small_run(kind, False, 1)
    assert not torch.equal(s.device_generator.get_state(),
                           k.device_generator.get_state())
    assert torch.equal(s.generator.get_state(), k.generator.get_state())


def test_captured_chunk_refuses_a_replaced_state_tensor(monkeypatch):
    """A replay reads the tensors it captured: after one of them is
    replaced (as Adam's state is by a restore) the chunk raises instead of
    replaying over memory the state no longer uses."""
    monkeypatch.setattr(train, "_on_side_stream", lambda fn, device: fn())
    monkeypatch.setattr(train, "_capture",
                        lambda fn, device, generators=(): (fn, 0.0, 0))
    state, _, chunk = small_run("fused", True, chunks=1)
    state.tau = state.tau.clone()
    with pytest.raises(RuntimeError, match="make the chunk anew"):
        chunk(state)


def gloo_mesh():
    """A 2-rank gloo mesh as the builders see it; its group a stand-in
    (the builders refuse it before any collective)."""
    return WalkerMesh(0, 2, torch.device("cuda", 0), object(), "gloo")


@pytest.mark.parametrize("case", ["cpu", "cpu_state", "gloo_mesh",
                                  "adaptive", "adjoint"])
def test_graph_true_refuses_the_paths_that_stay_eager(case):
    """``graph=True`` raises ``ValueError`` saying why on every path that
    cannot be captured (the default leaves them eager): the CPU, a gloo
    walker mesh and the adaptive and adjoint solvers; for each chunk."""
    kw = {"adaptive": dict(ode_solver="adaptive"),
          "adjoint": dict(ode_solver="adjoint")}.get(case, {})
    match = {"cpu": "--device cpu", "cpu_state": "the state lies on the CPU",
             "gloo_mesh": "gloo walker mesh",
             "adaptive": "adaptive solver",
             "adjoint": "adjoint solver"}[case]
    gs_model, gs_params = common.build_gs(small_cfg(False, 2))
    beta_model, beta_params = common.build_beta(small_cfg(True, 2))
    cfg = small_cfg(False, 2, **kw)
    if case != "cpu":
        cfg.device = "cuda"  # the builders read the device, never use it
    mesh = gloo_mesh() if case == "gloo_mesh" else None
    builders = [
        lambda: train.make_gs_fused_multi_step(gs_model, cfg, 2, mesh, True),
        lambda: train.make_multi_step(
            train.make_gs_train_step(gs_model, cfg, mesh), 2, True),
        lambda: train.make_gs_train_step(gs_model, cfg, mesh, True),
        lambda: train.make_multi_step(
            train.make_beta_train_step(beta_model, cfg, mesh), 2, True),
    ]
    for build in builders:
        if case != "cpu_state":
            with pytest.raises(ValueError, match=match):
                build()
            continue
        state = train.init_gs_state(gs_model, gs_params, small_cfg(False, 2),
                                    torch.device("cpu"))
        chunk = build()  # the device decides at the first call
        with pytest.raises(ValueError, match=match):
            chunk(state)


def nccl_mesh(monkeypatch):
    """A one-rank NCCL mesh as the builders and estimators see it, on the
    CPU: its group a stand-in, its sum over the one rank the identity."""
    monkeypatch.setattr(mesh_mod.dist, "all_reduce",
                        lambda t, group=None: None)
    return WalkerMesh(0, 1, torch.device("cpu"), object(), "nccl")


@pytest.mark.parametrize("case", ["fresh", "mesh", "nccl_mesh",
                                  "no_pallas_reinforce", "nested_jvp"])
def test_graph_true_accepts_fresh_walkers_and_meshes_without_gloo(
        monkeypatch, case):
    """Fresh walkers (drawn on the card), a mesh without a process group,
    an NCCL mesh, ``--no-pallas-reinforce`` and the nested-jvp engine (the
    autograd paths) are captured: ``graph=True`` builds each chunk, and no
    builder gives a reason to stay eager."""
    gs_model, _ = common.build_gs(small_cfg(False, 2))
    beta_model, _ = common.build_beta(small_cfg(True, 2))
    cfg = small_cfg(False, 2, persistent_walkers=case != "fresh",
                    device="cuda", **AB_FLAGS.get(case, {}))
    mesh = {"mesh": make_walker_mesh(torch.device("cpu")),
            "nccl_mesh": nccl_mesh(monkeypatch)}.get(case)
    chunks = [
        train.make_gs_fused_multi_step(gs_model, cfg, 2, mesh, True),
        train.make_multi_step(
            train.make_gs_train_step(gs_model, cfg, mesh), 2, True),
        train.make_gs_train_step(gs_model, cfg, mesh, True),
        train.make_multi_step(
            train.make_beta_train_step(beta_model, cfg, mesh), 2, True),
    ]
    assert all(c.refusal is None and c.graph for c in chunks)


@pytest.mark.parametrize("kind", ["fused", "single", "beta"])
def test_captured_chunk_on_a_one_rank_nccl_mesh_is_the_eager_chunk_bitwise(
        monkeypatch, kind):
    """Fresh walkers on a one-rank NCCL mesh (its collectives through the
    estimators' sums): the captured chunk's host side against the eager
    chunk, 4 chunks each, every state tensor, both generators and every
    metric bitwise, and the same count of collectives."""
    monkeypatch.setattr(train, "_on_side_stream", lambda fn, device: fn())
    monkeypatch.setattr(train, "_capture",
                        lambda fn, device, generators=(): (fn, 0.0, 0))
    mesh_g, mesh_e = nccl_mesh(monkeypatch), nccl_mesh(monkeypatch)
    s_g, rows_g, chunk = small_run(kind, True, persistent=False, mesh=mesh_g)
    s_e, rows_e, _ = small_run(kind, False, persistent=False, mesh=mesh_e)
    assert chunk._replay is not None and chunk.mesh is mesh_g
    a, b = state_tensors(s_g), state_tensors(s_e)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for r_g, r_e in zip(rows_g, rows_e):
        for k in r_g:
            assert torch.equal(r_g[k], r_e[k]), k
    assert mesh_g.stats["count"] == mesh_e.stats["count"] > 0


def test_a_replay_counts_the_collectives_its_capture_recorded(monkeypatch):
    """On an NCCL mesh the warm-up chunk's collectives run and count; the
    capture's are recorded, not counted; each replay, which runs no Python,
    adds them once, as ``replayed``, with its host seconds; the CLI's mesh
    line says so."""
    mesh = nccl_mesh(monkeypatch)
    monkeypatch.setattr(train, "_on_side_stream", lambda fn, device: fn())
    recorded = {}

    def capture(fn, device, generators=()):
        recorded["out"] = fn()  # the capture sees fn's collectives
        return lambda: recorded["out"], 0.0, 0

    monkeypatch.setattr(train, "_capture", capture)

    def body(state, seed):
        seed(0)
        one = torch.ones((), dtype=torch.float64)
        return {"a": mesh_mod.all_sum(mesh, one),
                "b": mesh_mod.all_sum(mesh, 2 * one)}

    cfg = small_cfg(False, 1)
    model, params = common.build_gs(cfg)
    state = train.init_gs_state(model, params, cfg, torch.device("cpu"))
    chunk = train._Chunk(body, 1, 1, None, None, mesh=mesh)
    chunk._captured = lambda state: True
    for _ in range(3):
        state, metrics = chunk(state)
    assert chunk.collectives == 2
    assert float(metrics["b"]) == 2.0
    assert mesh.stats["count"] == 6 and mesh.stats["replayed"] == 4
    assert mesh.stats["seconds"] > 0
    line = common._collectives_line(mesh, 3)
    assert line.startswith("mesh: 1 ranks over nccl, 6 collectives")
    assert "(4 of them in replayed chunks" in line


# ---- fresh walkers: the device draw, a rank's rows, the oracles ----


def test_fresh_walkers_are_the_device_draw_and_a_rank_holds_its_rows():
    """Fresh chain starts come from the state's device generator (the host
    generator, which draws the sampler seeds, is left as it was), at
    cfg.tau for cfg.equilibrium_steps; on a mesh of 2 or 4 ranks each
    rank's start is its rows of the one-process draw, bitwise."""
    cfg = small_cfg(False, 1, persistent_walkers=False, tau=0.1)
    model, params = common.build_gs(cfg)
    cpu = torch.device("cpu")
    one = train.init_gs_state(model, params, cfg, cpu)
    host, dev = one.generator.get_state(), one.device_generator.get_state()
    z0, steps, tau = train._chain_start(one, cfg)
    assert torch.equal(one.generator.get_state(), host)
    assert not torch.equal(one.device_generator.get_state(), dev)
    assert steps == cfg.equilibrium_steps and bool((tau == 0.1).all())
    assert z0.shape == (6, cfg.batch)
    for world in (2, 4):
        n = cfg.batch // world
        for rank in range(world):
            mesh = WalkerMesh(rank, world, cpu)
            st = train.init_gs_state(model, params, cfg, cpu, mesh)
            zr, _, tr = train._chain_start(st, cfg, mesh)
            assert torch.equal(zr, z0[:, rank * n:(rank + 1) * n])
            assert tr.shape == (n,)
            assert torch.equal(st.device_generator.get_state(),
                               one.device_generator.get_state())


ORACLE = dict(nup=3, Z=0.0, batch=64, d_eta=8, d_mu=8, ode_steps=2,
              equilibrium_steps=10, seed=0)


@pytest.fixture(scope="module")
def jax_oracles():
    """E of the JAX package's GS step and F of its finite-T step at the
    identity flow, N = 3, Z = 0, fresh walkers, float64 on the CPU (its
    own oracle tests' configuration: E = 5, F = 4.636605)."""
    import optax

    from fermiflow_tpu.cli import common as jcommon
    from fermiflow_tpu.config import Config as JConfig
    from fermiflow_tpu.train import (
        init_beta_state,
        init_gs_state,
        make_beta_train_step,
        make_gs_train_step,
    )

    cfg = JConfig(**ORACLE)
    model, params = jcommon.build_gs(cfg)
    opt = optax.sgd(cfg.lr)
    _, m = make_gs_train_step(model, opt, cfg)(
        init_gs_state(model, params, cfg, opt))
    cfg.beta, cfg.deltaE, cfg.boltzmann = 2.0, 2.0, True
    model, params = jcommon.build_beta(cfg)
    _, mb = make_beta_train_step(model, opt, cfg)(
        init_beta_state(model, params, cfg, opt))
    return {"E": float(m["E"]), "F": float(mb["F"])}


@pytest.mark.parametrize("kind", ["fused", "single", "beta"])
def test_identity_flow_oracle_with_fresh_walkers_matches_jax(jax_oracles,
                                                             kind):
    """The identity flow at N = 3, Z = 0 with fresh walkers through each
    builder (2 iterations, lr 0 so the flow stays the identity): every
    iteration's E (or at beta = 2, deltaE = 2, Boltzmann logits, F) is the
    JAX package's within the JAX oracle tests' tolerances (value 1e-8,
    spread 1e-7)."""
    finite = kind == "beta"
    cfg = Config(**ORACLE, dtype="float64", device="cpu", lr=0.0,
                 persistent_walkers=False, steps_per_call=2)
    cpu = torch.device("cpu")
    if finite:
        cfg.beta, cfg.deltaE, cfg.boltzmann = 2.0, 2.0, True
        model, params = common.build_beta(cfg)
        state = train.init_beta_state(model, params, cfg, cpu)
        chunk = train.make_multi_step(train.make_beta_train_step(model, cfg),
                                      2)
    else:
        model, params = common.build_gs(cfg)
        state = train.init_gs_state(model, params, cfg, cpu)
        chunk = (train.make_gs_fused_multi_step(model, cfg, 2)
                 if kind == "fused" else
                 train.make_multi_step(train.make_gs_train_step(model, cfg),
                                       2))
    key = "F" if finite else "E"
    np.testing.assert_allclose(jax_oracles[key],
                               4.636605 if finite else 5.0, atol=1e-6)
    _, m = chunk(state)
    np.testing.assert_allclose(m[key].numpy(), jax_oracles[key], rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(m[key + "_std"].numpy(), 0.0, atol=1e-7)


# ---- the training loop makes its chunks anew after a restore ----


@pytest.mark.parametrize("spike", ["non-finite", "divergence"])
def test_training_loop_makes_its_chunks_anew_after_a_restore(monkeypatch,
                                                              spike):
    """A chunk that trips the watchdog (a NaN energy, or a finite spike
    past the window) restores the latest checkpoint and restarts; the
    restore replaced Adam's state tensors, so the loop makes its chunk of
    that length anew, after the restore, and not before."""
    events = []
    cfg = Config(nup=2, batch=8, iternum=12, steps_per_call=2,
                 dtype="float64", device="cpu", checkpoint_dir="ck",
                 checkpoint_every=4, max_restarts=1, divergence_window=4)
    energy = 20.0 + 0.01 * torch.sin(torch.arange(12.0))
    bad = float("nan") if spike == "non-finite" else 30.0
    monkeypatch.setattr(common, "restore_checkpoint",
                        lambda d, state: (events.append("restore"), (4, 4))[1])
    monkeypatch.setattr(common, "save_checkpoint",
                        lambda d, step, state: events.append(f"save {step}"))
    monkeypatch.setattr(common, "_reseed", lambda state, salt: None)

    def make_chunk(k):
        events.append(f"make {k}")

        def chunk(i):
            e = energy[i:i + k].clone()
            if i == 4 and "restore" not in events:
                e[0] = bad
            return i + k, {"E": e, "E_std": torch.ones(k)}

        return chunk

    out = common.run_training_loop(0, cfg, make_chunk, MetricsLogger(None),
                                   lambda rec: None)
    assert out == 12
    assert events == ["make 2", "save 4", "restore", "make 2", "save 8",
                      "save 12"]


# ---- the trace summary's counts ----


def test_profile_summary_counts_graph_launches_and_waits():
    """A replayed chunk's trace: one ``cudaGraphLaunch``, the kernels it ran
    (no launch call of their own), the clone's launch and the fetch's
    wait."""
    x = lambda cat, name, ts, dur, tid=1: dict(ph="X", cat=cat, name=name,
                                              ts=ts, dur=dur, pid=1, tid=tid)
    trace = {"traceEvents": [
        x("cuda_runtime", "cudaGraphLaunch", 0, 5),
        x("kernel", "k1", 6, 10, tid=7), x("kernel", "k2", 17, 10, tid=7),
        x("kernel", "k3", 28, 10, tid=7),
        x("cuda_runtime", "cudaLaunchKernel", 8, 2),
        x("kernel", "copy", 40, 1, tid=7),
        x("cuda_runtime", "cudaMemcpyAsync", 12, 2),
        x("cuda_runtime", "cudaStreamSynchronize", 14, 30)]}
    s = summarize(trace)
    assert s["kernels"] == 4
    assert s["runtime_calls"] == {
        "cudaGraphLaunch": 1, "cudaLaunchKernel": 1, "cudaLaunchKernelExC": 0,
        "cudaStreamSynchronize": 1}
