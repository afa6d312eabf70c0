"""The compiled chunk on the CPU: what the card captures as one CUDA graph
per chunk (``fermiflow_tpu_torch/train.py``), held here without a card.

* ``CoulombPairPotential.V_rows``, now one expression of six operations,
  against the JAX ``V_rows`` and ``V`` in float64;
* the plain samplers give the same bits for an ``int`` seed and for the
  one-element int32 tensor a captured chunk hands the kernels;
* the captured chunk's host side (seeds through the static buffer, the
  eager warm-up, the metrics out of the graph's output) with a stand-in for
  the capture that replays by running the body again: bitwise the eager
  chunk, for the GS fused chunk, the GS step and the finite-T multi-step;
* ``graph=True`` refuses every path that stays eager;
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
from fermiflow_tpu_torch.parallel.mesh import make_walker_mesh
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


def small_cfg(finite, K, **kw):
    cfg = Config(**{**dict(nup=3, batch=32, d_eta=8, d_mu=8, ode_steps=2,
                           mcmc_steps=5, dtype="float64",
                           persistent_walkers=True, steps_per_call=K, lr=1e-3,
                           device="cpu"), **kw})
    if finite:
        cfg.beta, cfg.deltaE = 2.0, 2.0
    return cfg


def small_run(kind, graphed, chunks=4):
    """``chunks`` chunks of the GS fused chunk (K = 3), the GS step
    (K = 1) or the finite-T multi-step (K = 3) from a fresh float64 state
    at N = 3; ``graphed``: through the captured chunk's host side, the
    capture replaced by a stand-in that runs nothing and replays by running
    the body again."""
    finite, K = kind == "beta", 1 if kind == "single" else 3
    cfg = small_cfg(finite, K)
    cpu = torch.device("cpu")
    if finite:
        model, params = common.build_beta(cfg)
        state = train.init_beta_state(model, params, cfg, cpu)
        chunk = train.make_multi_step(train.make_beta_train_step(model, cfg),
                                      K)
    else:
        model, params = common.build_gs(cfg)
        state = train.init_gs_state(model, params, cfg, cpu)
        chunk = (train.make_multi_step(train.make_gs_train_step(model, cfg), 1)
                 if kind == "single" else
                 train.make_gs_fused_multi_step(model, cfg, K))
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


@pytest.mark.parametrize("kind", ["fused", "single", "beta"])
def test_captured_chunk_host_side_is_the_eager_chunk_bitwise(monkeypatch,
                                                             kind):
    """The captured chunk run on the CPU in float64 (its seeds drawn up
    front and read from the static buffer, the first chunk warming up, the
    metrics cloned out of one packed output) against the eager chunk, 4
    chunks each: walkers, tau, every parameter, Adam's moments and step,
    the states and their probabilities, both generators and every metric,
    bitwise.  The eager chunks are the ones that ``tests/test_torch_train.py``
    and ``tests/test_torch_beta.py`` hold against the JAX package."""
    monkeypatch.setattr(train, "_on_side_stream", lambda fn, device: fn())
    monkeypatch.setattr(train, "_capture",
                        lambda fn, device, generators=(): (fn, 0.0, 0))
    s_g, rows_g, chunk = small_run(kind, True)
    s_e, rows_e, _ = small_run(kind, False)
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


@pytest.mark.parametrize("case", ["cpu", "cpu_state", "mesh", "fresh",
                                  "no_pallas_reinforce", "nested_jvp",
                                  "adaptive"])
def test_graph_true_refuses_the_paths_that_stay_eager(case):
    """``graph=True`` raises ``ValueError`` saying why on every path that
    cannot be captured (the default leaves them eager): the CPU, a walker
    mesh, fresh walkers, ``--no-pallas-reinforce``, the nested-jvp engine
    and the adaptive solver; for each builder."""
    kw = {"fresh": dict(persistent_walkers=False),
          "no_pallas_reinforce": dict(pallas_reinforce=False),
          "nested_jvp": dict(local_energy="nested_jvp"),
          "adaptive": dict(ode_solver="adaptive")}.get(case, {})
    match = {"cpu": "--device cpu", "cpu_state": "the state lies on the CPU",
             "mesh": "walker mesh", "fresh": "fresh walkers",
             "no_pallas_reinforce": "no-pallas", "nested_jvp": "nested-jvp",
             "adaptive": "adaptive solver"}[case]
    gs_model, gs_params = common.build_gs(small_cfg(False, 2))
    beta_model, beta_params = common.build_beta(small_cfg(True, 2))
    cfg = small_cfg(False, 2, **kw)
    if case != "cpu":
        cfg.device = "cuda"  # the builders read the device, never use it
    mesh = make_walker_mesh(torch.device("cpu")) if case == "mesh" else None
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
