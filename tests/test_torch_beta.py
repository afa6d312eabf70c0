"""The port's finite-temperature slice against the JAX package on the CPU:
the mixed-state Slater and base-distribution modules in float64, ``BetaVMC``
by autograd and by its kernel chain, one training step with Adam, the
Boltzmann fixed point, the coupled state refresh, and the finite-T CLI.

Sizes are small (N=3, deltaE=2: 21 states; B <= 64, except the chi-square
check; d_eta=d_mu=8).  The comparisons with the JAX Pallas kernels in
interpret mode are in tests/test_torch_kernels.py, whose other tests compile
the same interpret programs.
"""

import json
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from fermiflow_tpu import mcmc as jmcmc
from fermiflow_tpu import train as jtrain
from fermiflow_tpu.cli import common as jcommon
from fermiflow_tpu.config import Config as JConfig
from fermiflow_tpu.physics import HO2D as JHO2D
from fermiflow_tpu.physics import FreeFermion as JFreeFermion
from fermiflow_tpu.physics import slater as jslater

from fermiflow_tpu_torch import mcmc
from fermiflow_tpu_torch.cli import common, finite_t, ground_state
from fermiflow_tpu_torch.config import Config
from fermiflow_tpu_torch.nn.backflow import Backflow, backflow_init_zeros
from fermiflow_tpu_torch.ops.metropolis import metropolis_multistate_cm
from fermiflow_tpu_torch.physics import HO2D, FreeFermion
from fermiflow_tpu_torch.physics import slater
from fermiflow_tpu_torch.train import (
    _coupled_state_refresh,
    init_beta_state,
    make_beta_train_step,
)
from fermiflow_tpu_torch.vmc.gs import PLAIN_OPS

from _torch_port import flat_np, flat_torch, jax_params, np_params, walkers

torch.set_num_threads(1)

B, STEPS, LR = 32, 2, 1e-3
ORB, JORB = HO2D(), JHO2D()
OCC, ES = ORB.fermion_states(3, 0, 2.0)  # 21 states, quantum numbers < 4
RTOL, ATOL = 1e-9, 1e-10


def close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(
        t.detach().numpy() if isinstance(t, torch.Tensor) else t,
        np.asarray(j), rtol=rtol, atol=atol)


def states(seed, batch):
    return np.random.default_rng(seed).integers(0, len(OCC), batch)


def cfg_beta(**kw):
    """The finite-T configuration of these tests, for both packages."""
    base = dict(nup=3, Z=0.5, beta=2.0, deltaE=2.0, batch=B, d_eta=8, d_mu=8,
                ode_steps=STEPS, dtype="float64", lr=LR, seed=0)
    base.update(kw)
    return Config(device="cpu", **base), JConfig(**base)


def equilibrated_ms(idx, seed, steps=100):
    """(d, batch) f64 walkers equilibrated in their own states by the port's
    plain mixed-state sampler, from seeded Gaussians."""
    model, _ = common.build_beta(cfg_beta()[0])
    nx, ny = model.qnums_cm(torch.as_tensor(idx))
    z0 = torch.as_tensor(walkers(seed, len(idx), 3).reshape(len(idx), 6).T.copy())
    x, _, _ = metropolis_multistate_cm(
        z0, torch.full((len(idx),), 0.3, dtype=torch.float64), seed,
        steps=steps, nx_cm=nx, ny_cm=ny, num_shells=4)
    return x


# ---- physics/slater.py and physics/base_dist.py, mixed states ----


def test_multstates_slater_and_base_dist_match_jax():
    x = walkers(40, B, 3)
    idx = states(41, B)
    tx, tidx = torch.as_tensor(x), torch.as_tensor(idx)
    jx, jidx, jocc = jnp.asarray(x), jnp.asarray(idx), jnp.asarray(OCC)
    close(slater.slater_matrix_multstates(ORB, OCC, tidx, tx),
          jax.jit(lambda a, i: jslater.slater_matrix_multstates(JORB, jocc, i, a))(jx, jidx))
    close(slater.log_abs_slater_det_multstates(ORB, OCC, tidx, tx),
          jax.jit(lambda a, i: jslater.log_abs_slater_det_multstates(JORB, jocc, i, a))(jx, jidx))
    derivs = slater.slater_derivs_multstates(ORB, OCC, tidx, tx)
    jderivs = jax.jit(lambda a, i: jslater.slater_derivs_multstates(JORB, jocc, i, a))(jx, jidx)
    for a, b in zip(derivs, jderivs):
        close(a, b)
    bd, jbd = FreeFermion(ORB), JFreeFermion(JORB)
    close(bd.log_prob_multstates(OCC, tidx, tx),
          jax.jit(lambda a, i: jbd.log_prob_multstates(jocc, i, a))(jx, jidx))
    jvgh = jax.jit(lambda a, i: jbd.log_prob_vgh_multstates(jocc, i, a))(jx, jidx)
    for a, b in zip(bd.log_prob_vgh_multstates(OCC, tidx, tx), jvgh):
        close(a, b, atol=1e-9 * float(np.abs(np.asarray(b)).max()))


def test_sample_multstates_equilibrates_each_walker_in_its_state():
    """Fresh-Gaussian Metropolis on the mixed-state densities: at Z=0 with
    the identity flow every sampled walker's local energy is its own
    state's energy."""
    cfg, _ = cfg_beta(Z=0.0)
    model, params = common.build_beta(cfg)
    idx = torch.as_tensor(states(42, B))
    z = model.basedist.sample_multstates(
        OCC, idx, torch.Generator().manual_seed(0), equilibrium_steps=20)
    assert z.shape == (B, 3, 2) and torch.isfinite(z).all()
    _, eloc, _ = model.local_energy_from_base(params["flow"], idx, z)
    close(eloc, ES[states(42, B)], atol=1e-9)


# ---- vmc/beta.py: BetaVMC ----


def _jax_beta(cfg):
    jmodel, _ = jcommon.build_beta(cfg)
    return jmodel


@pytest.mark.parametrize("Z", [0.5, 8.0])
def test_beta_loss_and_grads_match_jax_autodiff_f64(Z):
    """``loss_and_metrics_from_base`` + autograd against the JAX package's
    + ``jax.value_and_grad`` on the same walkers, states and parameters:
    the same math in f64, so every metric, the loss and every gradient leaf
    (flow and logits) to 1e-9 relative.  The no-autograd kernel chain
    (plain versions, f64) gives the same metrics and the same logits
    gradient; its flow gradient is the continuous adjoint, which differs
    from autodiff through the discrete solve at the ODE's error, and is
    held to the JAX Pallas path in tests/test_torch_kernels.py.  At
    Z = 0.5 and at the sweep's strongest coupling, Z = 8."""
    cfg, jcfg = cfg_beta(Z=Z)
    model, _ = common.build_beta(cfg)
    jmodel = _jax_beta(jcfg)
    idx = states(43, B)
    z_cm = equilibrated_ms(idx, 44)
    z = z_cm.T.reshape(B, 3, 2)
    p = np_params(45)
    logits = 0.3 * np.random.default_rng(46).standard_normal(len(OCC))
    jparams = {"flow": jax_params(p), "log_state_weights": jnp.asarray(logits)}
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss_and_metrics_from_base, has_aux=True))(
            jparams, jnp.asarray(idx), jnp.asarray(z.numpy()))

    flow = Backflow({m: None if v is None else
                     {k: torch.as_tensor(a) for k, a in v.items()}
                     for m, v in p.items()})
    lg = torch.nn.Parameter(torch.tensor(logits))
    params = {"flow": flow.params(), "log_state_weights": lg}
    tidx = torch.as_tensor(idx)
    loss, m = model.loss_and_metrics_from_base(params, tidx, z)
    loss.backward()
    for key in ("E", "E_std", "F", "F_std", "S", "S_analytical"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-9)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-9,
                               atol=1e-12)
    grads = {name: {k: v.grad for k, v in mod.items()}
             for name, mod in (("eta", flow.eta), ("mu", flow.mu))}
    jg = flat_np(jgrads["flow"])
    np.testing.assert_allclose(flat_torch(grads), jg, rtol=1e-9,
                               atol=1e-9 * np.abs(jg).max())
    jgl = np.asarray(jgrads["log_state_weights"])
    close(lg.grad, jgl, atol=1e-9 * np.abs(jgl).max())

    model.ops = PLAIN_OPS
    _, mc, gc = model.loss_metrics_grads_cm(params, tidx, z_cm)
    for key in ("E", "E_std", "F", "F_std", "S", "S_analytical"):
        np.testing.assert_allclose(float(mc[key]), float(jm[key]), rtol=1e-9)
    close(gc["log_state_weights"], jgl, atol=1e-9 * np.abs(jgl).max())


def test_beta_train_step_with_adam_matches_jax_f64():
    """One ``make_beta_train_step`` iteration with Adam against the JAX
    package's ``make_beta_train_step`` + ``optax.adam``, the sampler held
    fixed (persistent walkers, one Metropolis step at tau = 0, which
    accepts the walker's own position; the logits have not moved, so the
    coupled refresh keeps every state).

    Metrics are computed before the update: 1e-9 relative.  The JAX step
    differentiates through the discrete reverse solve, the port uses the
    continuous adjoint on the same grid; Adam's first step is
    lr * g / (|g| + eps), so the parameters still agree to 1e-9 relative
    (the gradients differ far less than |g|).  The surrogate losses are not
    compared here: the port's takes logp from the forward Hessian flow, the
    JAX step's from the reverse solve (tests/test_torch_kernels.py holds the
    port's loss to the JAX Pallas path's, which also takes the forward one).
    """
    cfg, jcfg = cfg_beta(persistent_walkers=True, mcmc_steps=1, tau=0.0)
    model, params = common.build_beta(cfg)
    jmodel = _jax_beta(jcfg)
    p = np_params(47)
    logits = 0.3 * np.random.default_rng(48).standard_normal(len(OCC))
    params = {"flow": {m: None if v is None else
                       {k: torch.as_tensor(a) for k, a in v.items()}
                       for m, v in p.items()},
              "log_state_weights": torch.as_tensor(logits)}
    state = init_beta_state(model, params, cfg, torch.device("cpu"))
    state.walkers_cm = equilibrated_ms(state.state_idx.numpy(), 49)

    jopt = optax.adam(LR)
    jparams = {"flow": jax_params(p), "log_state_weights": jnp.asarray(logits)}
    jstate = jtrain.TrainState(
        params=jparams, opt_state=jopt.init(jparams), key=jax.random.PRNGKey(0),
        step=jnp.zeros((), jnp.int32),
        walkers=jnp.asarray(state.walkers.numpy()),
        tau=jnp.full((B,), cfg.tau), state_idx=jnp.asarray(state.state_idx.numpy()),
        sample_probs=jax.nn.softmax(jnp.asarray(logits)))
    jstate2, jm = jtrain.make_beta_train_step(jmodel, jopt, jcfg)(jstate)
    state, m = make_beta_train_step(model, cfg)(state)

    for key in ("E", "E_std", "F", "F_std", "S", "S_analytical",
                "accept_rate", "state_switch_frac"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-9,
                                   atol=1e-12)
    np.testing.assert_array_equal(state.state_idx.numpy(),
                                  np.asarray(jstate2.state_idx))
    close(state.tau, jstate2.tau)
    close(state.walkers, jstate2.walkers)
    close(state.log_state_weights, jstate2.params["log_state_weights"])
    np.testing.assert_allclose(flat_torch(state.flow.params()),
                               flat_np(jstate2.params["flow"]), rtol=1e-9,
                               atol=1e-13)


def test_beta_boltzmann_fixed_point_f64():
    """Z=0, identity flow, Boltzmann logits (N=3, beta=2, deltaE=2): every
    walker's Floc is the exact free energy F = E0 - log sum_s
    exp(-beta (E_s - E0)) / beta = 4.636605, so F_std = 0, through a
    training step (fresh walkers, the mixed-state sampler, the kernel
    chain's plain versions), and the gradient vanishes."""
    cfg, _ = cfg_beta(Z=0.0, boltzmann=True, batch=64, equilibrium_steps=10)
    model, params = common.build_beta(cfg)
    F_exact = ES[0] - np.log(np.sum(np.exp(-2.0 * (ES - ES[0])))) / 2.0
    np.testing.assert_allclose(F_exact, 4.636605, atol=1e-6)
    state = init_beta_state(model, params, cfg, torch.device("cpu"))
    state, m = make_beta_train_step(model, cfg)(state)
    np.testing.assert_allclose(float(m["F"]), F_exact, rtol=0, atol=1e-7)
    np.testing.assert_allclose(float(m["F_std"]), 0.0, atol=1e-7)
    z_cm = state.walkers_cm
    _, m2, grads = model.loss_metrics_grads_cm(
        {"flow": backflow_init_zeros(8, 8), "log_state_weights":
         params["log_state_weights"]}, state.state_idx, z_cm)
    np.testing.assert_allclose(float(m2["F"]), F_exact, rtol=0, atol=1e-7)
    assert float(grads["log_state_weights"].abs().max()) < 1e-10
    assert float(np.abs(flat_torch(grads["flow"])).max()) < 1e-10


def test_zero_step_chain_reports_zero_acceptance():
    """A chain of 0 steps reports an acceptance of 0 in the port, as the
    TPU kernels do (they divide by max(steps, 1)).  The JAX package's XLA
    sampler divides by steps and reports NaN, so ``adapt_tau`` makes a
    persistent walker's tau NaN (ROADMAP.md section 3)."""
    x = walkers(52, 8, 3)
    up = np.arange(3)
    st = mcmc.metropolis(lambda z: FreeFermion(ORB).log_prob(up, (), z),
                         torch.Generator().manual_seed(0), torch.as_tensor(x),
                         0, torch.full((8,), 0.1, dtype=torch.float64))
    assert torch.equal(st.accept_rate, torch.zeros(8, dtype=torch.float64))
    assert torch.isfinite(mcmc.adapt_tau(st)).all()
    jst = jmcmc.metropolis(lambda z: JFreeFermion(JORB).log_prob(up, (), z),
                           jax.random.PRNGKey(0), jnp.asarray(x), 0,
                           jnp.full((8,), 0.1))
    assert np.isnan(np.asarray(jst.accept_rate)).all()
    assert np.isnan(np.asarray(jmcmc.adapt_tau(jst))).all()


# ---- train.py: the coupled state refresh ----


def test_coupled_state_refresh_matches_jax_on_its_draws():
    """Fed the uniforms and residual draws the JAX function takes from its
    key, the port gives the same states, probabilities and switch fraction."""
    rng = np.random.default_rng(50)
    logits_old = rng.standard_normal(len(OCC))
    logits_new = logits_old + 0.5 * rng.standard_normal(len(OCC))
    p_old = np.exp(logits_old) / np.exp(logits_old).sum()
    idx_old = rng.integers(0, len(OCC), 256).astype(np.int32)
    key = jax.random.PRNGKey(3)
    jidx, jp, jfrac = jtrain._coupled_state_refresh(
        key, jnp.asarray(logits_new), jnp.asarray(p_old), jnp.asarray(idx_old))
    # The draws inside the JAX function, reproduced from the same key.
    jpn = jax.nn.softmax(jnp.asarray(logits_new))
    resid = jnp.maximum(jpn - jnp.minimum(jpn, jnp.asarray(p_old)), 0.0)
    k_u, k_r = jax.random.split(key)
    u = jax.random.uniform(k_u, (256,), dtype=jpn.dtype)
    redraw = jax.random.categorical(k_r, jnp.log(resid + 1e-30), shape=(256,))
    idx, p, frac = _coupled_state_refresh(
        None, torch.as_tensor(logits_new), torch.as_tensor(p_old),
        torch.as_tensor(idx_old), u=torch.tensor(np.asarray(u)),
        redraw=torch.tensor(np.asarray(redraw)))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    close(p, jp, rtol=1e-15)
    close(frac, jfrac, rtol=1e-15)
    assert 0.0 < float(frac) < 0.5


def test_coupled_state_refresh_marginal_is_p_new():
    """On the port's own stream, walkers drawn from p_old and refreshed
    toward p_new are distributed as p_new (chi-square over 21 states at
    B = 4000), and the switch fraction is the total-variation distance."""
    from scipy import stats

    Bc = 4000
    gen = torch.Generator().manual_seed(51)
    logits_old = torch.randn(len(OCC), generator=gen, dtype=torch.float64)
    logits_new = logits_old + 0.7 * torch.randn(len(OCC), generator=gen,
                                                dtype=torch.float64)
    p_old = torch.softmax(logits_old, -1)
    idx_old = torch.multinomial(p_old, Bc, replacement=True,
                                generator=gen).to(torch.int32)
    idx, p_new, frac = _coupled_state_refresh(gen, logits_new, p_old, idx_old)
    counts = torch.bincount(idx.long(), minlength=len(OCC)).double()
    expected = Bc * p_new
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert stats.chi2.sf(chi2, len(OCC) - 1) > 1e-3, chi2
    tv = 0.5 * float((p_new - p_old).abs().sum())
    assert abs(float(frac) - tv) < 4 * np.sqrt(tv * (1 - tv) / Bc)
    kept = idx == idx_old
    assert float(kept.double().mean()) >= 1 - float(frac) - 1e-12


# ---- cli/finite_t.py ----


CLI_BETA = ["--beta", "2.0", "--nup", "3", "--Z", "0.5", "--deltaE", "2.0",
            "--boltzmann", "--batch", "32", "--iternum", "2", "--Deta", "8",
            "--Dmu", "8", "--ode-steps", "2", "--mcmc-steps", "5",
            "--equilibrium-steps", "5", "--dtype", "float32", "--lr", "1e-3"]


@pytest.mark.parametrize("persistent", [True, False])
def test_finite_t_cli_runs_two_iterations_on_cpu(tmp_path, capsys, persistent):
    """``python -m fermiflow_tpu_torch.cli.finite_t --device cpu`` for two
    iterations at N=3, one chunk (K=2): the JAX driver's lines, finite F in
    the range of the identity flow (F about 5.7 at Z=0.5), one metrics row
    per iteration."""
    path = tmp_path / "m.jsonl"
    argv = CLI_BETA + ["--device", "cpu", "--steps-per-call", "2",
                       "--metrics", str(path)]
    state = finite_t.main(argv + (["--persistent"] if persistent else []))
    assert state.step == 2 and state.state_idx.shape == (32,)
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2]
    for r in rows:
        assert np.isfinite(r["F"]) and 4.6 < r["F"] < 7.5
        assert 0.0 < r["accept_rate"] <= 1.0
    out = capsys.readouterr().out
    assert "total number of states = 21" in out
    assert "Boltzmann distribution." in out and "iter: 002 F:" in out


def test_gs_cli_steps_per_call_1_runs_per_iteration_sampler(tmp_path):
    """With --steps-per-call 1 the ground-state driver runs one single-chain
    sampler per iteration (``make_gs_train_step``), as the JAX driver does."""
    path = tmp_path / "m.jsonl"
    argv = ["--nup", "3", "--batch", "32", "--iternum", "2", "--Deta", "8",
            "--Dmu", "8", "--ode-steps", "2", "--mcmc-steps", "5", "--dtype",
            "float32", "--persistent", "--device", "cpu", "--steps-per-call",
            "1", "--metrics", str(path)]
    state = ground_state.main(argv)
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert state.step == 2 and [r["step"] for r in rows] == [1, 2]
    assert all(5.0 < r["E"] < 7.5 for r in rows)
    assert not torch.equal(state.tau, torch.full((32,), 0.1))


@pytest.mark.parametrize("flags", [
    ["--shard"],
    ["--shard", "--checkpoint-dir", "ck", "--checkpoint-every", "2"],
    ["--coordinator", "localhost:1"], ["--num-processes", "2"],
    ["--process-id", "1"],
])
def test_finite_t_cli_refuses_unported_flags(tmp_path, monkeypatch, flags):
    """The mesh's flags at one process in the finite-T driver: ``--shard``
    is a 1-rank mesh whose rows equal the run's without it (its checkpoint
    a plain file); ``--process-id`` alone is a no-op; a coordinator without
    ``--num-processes`` and ``--num-processes 2`` without a coordinator
    raise before any work."""
    monkeypatch.chdir(tmp_path)
    argv = CLI_BETA + ["--device", "cpu"]
    if "--coordinator" in flags or "--num-processes" in flags:
        with pytest.raises(ValueError, match="multi-process run needs"):
            finite_t.main(argv + flags)
        assert not os.path.exists(tmp_path / "ck")
        return

    def rows(extra, name):
        finite_t.main(argv + extra + ["--metrics", name])
        return [{k: v for k, v in json.loads(line).items()
                 if k not in ("iter_seconds", "hours_per_100_iters")}
                for line in (tmp_path / name).read_text().splitlines()]

    assert rows(flags, "m.jsonl") == rows([], "ref.jsonl")
    if "--checkpoint-dir" in flags:
        assert sorted(os.listdir(tmp_path / "ck")) == ["ckpt_00000002.pt"]


def test_finite_t_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        common.build_beta(Config(nup=3, dtype="float32"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        finite_t.main(CLI_BETA)
    model, params = common.build_beta(cfg_beta(dtype="float32")[0])
    assert params["log_state_weights"].device.type == "cpu"
    with pytest.raises(ValueError, match="random init"):
        model.init_log_state_weights(False)
