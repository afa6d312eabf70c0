"""The port's ground-state slice as a whole, on the CPU: the update with
Adam against the JAX package in float64, the CLI, the physics oracles, the
sampler's distribution, and the rule that no entry point drops quietly to
the CPU."""

import json

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from fermiflow_tpu import mcmc as jmcmc
from fermiflow_tpu import train as jtrain
from fermiflow_tpu.config import Config as JConfig
from fermiflow_tpu.flow import CNF as JCNF
from fermiflow_tpu.nn.backflow import backflow_apply as j_apply
from fermiflow_tpu.nn.backflow import backflow_divergence as j_div
from fermiflow_tpu.nn.backflow_derivs import backflow_field_tensors as j_ft
from fermiflow_tpu.physics import HO2D as JHO2D
from fermiflow_tpu.physics import CoulombPairPotential as JCoulomb
from fermiflow_tpu.physics import FreeFermion as JFreeFermion
from fermiflow_tpu.physics import HOPotential as JHO
from fermiflow_tpu.vmc import GSVMC as JGSVMC

import fermiflow_tpu_torch
from fermiflow_tpu_torch import mcmc
from fermiflow_tpu_torch.cli import common, ground_state
from fermiflow_tpu_torch.config import Config
from fermiflow_tpu_torch.flow import CNF
from fermiflow_tpu_torch.nn.backflow import (
    Backflow,
    backflow_apply,
    backflow_divergence,
    backflow_init_zeros,
)
from fermiflow_tpu_torch.nn.backflow_derivs import backflow_field_tensors
from fermiflow_tpu_torch.ops.metropolis import metropolis_chains
from fermiflow_tpu_torch.physics import (
    HO2D,
    CoulombPairPotential,
    FreeFermion,
    HOPotential,
)
from fermiflow_tpu_torch.train import make_adam
from fermiflow_tpu_torch.vmc import GSVMC

from _torch_port import flat_np, flat_torch, jax_params, np_params, walkers

torch.set_num_threads(1)

B, STEPS, METHOD, LR = 32, 2, "dopri5", 1e-3
# The JAX sampler's acceptance at tau = 0.1 for N=3 (0.847 on the walkers
# of the mcmc test below; the verify notes round it to 0.8).
ACCEPT_N3 = 0.84


def equilibrated(nup, ndown, batch, seed, steps=100, dtype=torch.float64):
    """(d, batch) walkers from the port's plain sampler, from seeded
    Gaussians; f64 throughout, so no nodal f32 trouble downstream."""
    model = make_model(nup, ndown, 0.5)
    nx_up, ny_up, nx_dn, ny_dn, ks = model.occ_qnums()
    n = nup + ndown
    z0 = torch.as_tensor(walkers(seed, batch, n).reshape(batch, 2 * n).T.copy())
    xs, _, _, _ = metropolis_chains(
        z0, torch.full((batch,), 0.3, dtype=torch.float64), seed, steps=steps,
        segments=1, nx_occ=nx_up, ny_occ=ny_up, nx_dn=nx_dn, ny_dn=ny_dn,
        num_shells=ks)
    return xs[-1].to(dtype)


def make_model(nup, ndown, Z):
    cnf = CNF(backflow_apply, backflow_divergence, backflow_field_tensors,
              steps=STEPS, method=METHOD)
    return GSVMC(nup, ndown, FreeFermion(HO2D()), cnf, CoulombPairPotential(Z),
                 HOPotential())


# ---- the update with Adam, float64, against the JAX autodiff path ----


def test_update_and_adam_match_jax_autodiff_f64():
    """Two iterations of the reference update (``loss_and_metrics_from_base``
    + ``jax.grad`` + ``optax.adam``) against the port's
    (``loss_and_metrics_from_base`` + autograd + ``torch.optim.Adam``) on the
    same walkers and Gaussian parameters.  Same math in f64: E, E_std, loss
    and every gradient leaf to 1e-9 relative (of the largest entry), the
    parameters after each Adam step to 1e-9 relative.  The port's
    no-autograd kernel chain gives the same E and E_std."""
    z_cm = equilibrated(3, 0, B, 30)
    z = z_cm.T.reshape(B, 3, 2)
    p = np_params(31)
    model = make_model(3, 0, 0.5)
    jcnf = JCNF(j_apply, j_div, j_ft, steps=STEPS, method=METHOD)
    jmodel = JGSVMC(3, 0, JFreeFermion(JHO2D()), jcnf, JCoulomb(0.5), JHO())
    jcfg = JConfig(nup=3, batch=B, dtype="float64", ode_steps=STEPS, lr=LR)
    jopt = optax.adam(LR)
    jparams = jax_params(p)
    jstate = jtrain.TrainState(
        params=jparams, opt_state=jopt.init(jparams), key=jax.random.PRNGKey(0),
        step=jnp.zeros((), jnp.int32), walkers=jnp.asarray(z.numpy()),
        tau=jnp.full((B,), 0.1))
    jupdate = jax.jit(jtrain._make_gs_update(jmodel, jopt, jcfg, None))
    jgrad = jax.jit(jax.value_and_grad(jmodel.loss_and_metrics_from_base,
                                       has_aux=True))

    flow = Backflow({m: None if v is None else
                     {k: torch.as_tensor(a) for k, a in v.items()}
                     for m, v in p.items()})
    opt = make_adam(flow, LR)
    jz = jnp.asarray(z.numpy())
    for _ in range(2):
        (jloss, jm), jgrads = jgrad(jstate.params, jz)
        loss, m = model.loss_and_metrics_from_base(flow.params(), z)
        opt.zero_grad()
        loss.backward()
        grads = {name: None if mod is None else
                 {k: v.grad for k, v in mod.items()}
                 for name, mod in (("eta", flow.eta), ("mu", flow.mu))}
        for key in ("E", "E_std"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-9)
        np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-9,
                                   atol=1e-12)
        jg = flat_np(jgrads)
        np.testing.assert_allclose(flat_torch(grads), jg, rtol=1e-9,
                                   atol=1e-9 * np.abs(jg).max())
        _, mc, _ = model.loss_metrics_grads_cm(flow.params(), z_cm)
        for key in ("E", "E_std"):
            np.testing.assert_allclose(float(mc[key]), float(jm[key]), rtol=1e-9)

        jp_new, jopt_state, _, _ = jupdate(jstate, jz)
        jstate = jstate._replace(params=jp_new, opt_state=jopt_state)
        opt.step()
        np.testing.assert_allclose(flat_torch(flow.params()), flat_np(jp_new),
                                   rtol=1e-9, atol=1e-13)


# ---- physics oracles ----


@pytest.mark.parametrize("nup,ndown,E0", [(3, 0, 5.0), (2, 1, 4.0)])
def test_identity_flow_local_energy_is_exact_at_Z0(nup, ndown, E0):
    """Identity flow, no interaction: every walker's Eloc is the sum of the
    occupied orbital energies (5 for three polarized fermions), through the
    kernel chain's plain versions and through the plain Hessian flow."""
    model = make_model(nup, ndown, 0.0)
    params = backflow_init_zeros(8, 8)
    z_cm = equilibrated(nup, ndown, 64, 32)
    _, eloc, _, _ = model.local_energy_cm(params, z_cm)
    np.testing.assert_allclose(eloc.numpy(), E0, rtol=0, atol=1e-9)
    _, eloc2, _ = model.local_energy_from_base(
        params, z_cm.T.reshape(64, nup + ndown, 2))
    np.testing.assert_allclose(eloc2.numpy(), E0, rtol=0, atol=1e-9)


# ---- samplers: distribution ----


def test_plain_sampler_acceptance_and_logp():
    """The multi-segment sampler's plain version on its own torch stream:
    acceptance at tau = 0.1 for N=3 as the JAX sampler's, and the logp it returns is ``FreeFermion.log_prob`` of the walkers."""
    model = make_model(3, 0, 0.5)
    nx_up, ny_up, _, _, ks = model.occ_qnums()
    z_cm = equilibrated(3, 0, 512, 33, dtype=torch.float32)
    tau = torch.full((512,), 0.1)
    xs, lp, rate, tau_out = metropolis_chains(
        z_cm, tau, 34, steps=30, segments=4, nx_occ=nx_up, ny_occ=ny_up,
        num_shells=ks, gain=0.0)
    assert abs(float(rate.mean()) - ACCEPT_N3) < 0.03
    torch.testing.assert_close(tau_out, tau, rtol=0, atol=0)
    for s in range(4):
        x = xs[s].T.reshape(512, 3, 2).double()
        ref = model.basedist.log_prob(model.occ_up, model.occ_down, x)
        # f32 log-density of f32 positions: ~1e-6 relative roundoff.
        np.testing.assert_allclose(lp[s].double().numpy(), ref.numpy(),
                                   rtol=1e-4, atol=1e-4)


def test_mcmc_matches_jax_by_distribution_and_adapt_tau_exactly():
    """``mcmc.metropolis`` against the JAX sampler (different random streams:
    acceptance within 0.03 of each other and of 0.84 at tau = 0.1, N=3), and ``adapt_tau`` bit for bit
    on the same rates, for a global and a per-walker tau."""
    bd, jbd = FreeFermion(HO2D()), JFreeFermion(JHO2D())
    up = np.arange(3)
    x0 = equilibrated(3, 0, 256, 35).T.reshape(256, 3, 2)
    st = mcmc.metropolis(lambda x: bd.log_prob(up, (), x),
                         torch.Generator().manual_seed(0), x0, 40, 0.1)
    jst = jmcmc.metropolis(lambda x: jbd.log_prob(up, (), x),
                           jax.random.PRNGKey(0), jnp.asarray(x0.numpy()), 40,
                           0.1)
    acc, jacc = float(st.accept_rate.mean()), float(jnp.mean(jst.accept_rate))
    assert abs(acc - jacc) < 0.03 and abs(acc - ACCEPT_N3) < 0.03
    np.testing.assert_allclose(st.logp.numpy(),
                               bd.log_prob(up, (), st.x).numpy(), rtol=1e-12)

    rates = np.random.default_rng(36).uniform(0, 1, 16)
    for tau in (np.asarray(0.1), np.linspace(0.05, 0.3, 16)):
        s = mcmc.MCMCState(None, None, torch.as_tensor(tau),
                           torch.as_tensor(rates))
        js = jmcmc.MCMCState(None, None, jnp.asarray(tau), jnp.asarray(rates))
        np.testing.assert_allclose(mcmc.adapt_tau(s, 0.5, 0.1).numpy(),
                                   np.asarray(jmcmc.adapt_tau(js, 0.5, 0.1)),
                                   rtol=1e-15)


# ---- the CLI ----


CLI_SMALL = ["--nup", "3", "--batch", "32", "--iternum", "2", "--Deta", "8",
             "--Dmu", "8", "--ode-steps", "2", "--mcmc-steps", "5",
             "--equilibrium-steps", "5", "--dtype", "float32", "--lr", "1e-3"]


@pytest.mark.parametrize("persistent", [True, False])
def test_cli_runs_two_iterations_on_cpu(tmp_path, capsys, persistent):
    """``python -m fermiflow_tpu_torch.cli.ground_state --device cpu`` for two
    iterations at N=3: one fused chunk (K=2), finite energies, a metrics
    row per iteration.  At the identity init E is about 5.93 (5 + <V>)."""
    path = tmp_path / "m.jsonl"
    argv = CLI_SMALL + ["--device", "cpu", "--steps-per-call", "2",
                        "--metrics", str(path)]
    state = ground_state.main(argv + (["--persistent"] if persistent else []))
    assert state.step == 2
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2]
    for r in rows:
        assert np.isfinite(r["E"]) and 5.0 < r["E"] < 7.5
        assert 0.0 < r["accept_rate"] <= 1.0
    assert state.walkers.shape == (32, 3, 2)
    assert "iter: 002 E:" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [
    ["--shard"], ["--checkpoint-dir", "ck"], ["--max-restarts", "1"],
    ["--ode-solver", "adaptive"], ["--ode-solver", "adjoint"],
    ["--local-energy", "nested_jvp"], ["--movie", "m.npz"],
    ["--shard", "--movie", "m.npz"],
])
def test_cli_refuses_unported_flags(flags):
    with pytest.raises(NotImplementedError, match="not ported"):
        ground_state.main(CLI_SMALL + ["--device", "cpu"] + flags)


@pytest.mark.parametrize("steps_per_call", [1, 2])
def test_cli_profile_dir_writes_a_trace(tmp_path, steps_per_call):
    prof = tmp_path / "prof"
    argv = CLI_SMALL[:]
    argv[argv.index("--iternum") + 1] = "4"
    state = ground_state.main(argv + [
        "--device", "cpu", "--steps-per-call", str(steps_per_call),
        "--profile-dir", str(prof)])
    assert state.step == 4
    events = json.loads((prof / "trace.json").read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    summary = json.loads((prof / "summary.json").read_text())
    assert summary["window_ms"] > 0 and summary["host_self"]
    assert "device_busy_ms" not in summary  # no device on --device cpu


def test_profile_summary_splits_device_idle():
    from fermiflow_tpu_torch.utils.profiling import summarize

    x = lambda cat, name, ts, dur, tid=1: dict(ph="X", cat=cat, name=name,
                                              ts=ts, dur=dur, pid=1, tid=tid)
    trace = {"traceEvents": [
        x("cpu_op", "step", 0, 100), x("cpu_op", "aten::add", 10, 20),
        x("cuda_runtime", "cudaLaunchKernel", 12, 5),
        x("kernel", "k1", 20, 30, tid=7), x("kernel", "k2", 55, 10, tid=7),
        x("kernel", "k1", 90, 5, tid=7)]}
    s = summarize(trace)
    assert s["window_ms"] == pytest.approx(0.1)
    assert s["device_busy_ms"] == pytest.approx(0.045)
    assert s["device_idle_ms"] == pytest.approx(0.055)
    assert s["launch_gaps"] == {"count": 1, "ms": pytest.approx(0.005)}
    assert s["long_gaps"]["count"] == 1
    assert s["long_gaps"]["ms"] == pytest.approx(0.025)
    assert s["device_lead_tail_idle_ms"] == pytest.approx(0.025)
    self_ms = {r["name"]: r["ms"] for r in s["host_self"]}
    assert self_ms == pytest.approx({"step": 0.08, "aten::add": 0.015,
                                     "cudaLaunchKernel": 0.005})
    assert {r["name"]: r["count"] for r in s["device_work"]} == {"k1": 2,
                                                                 "k2": 1}


# ---- no silent CPU ----


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fermiflow_tpu_torch.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        common.build_gs(Config(nup=3, dtype="float32"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ground_state.main(CLI_SMALL)
    assert fermiflow_tpu_torch.resolve_device("cpu").type == "cpu"
