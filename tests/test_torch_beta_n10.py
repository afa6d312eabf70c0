"""The port's finite-temperature slice at N = 10 (deltaE = 4: 1781 states,
quantum numbers to 7, Hermite depth 8; beta = 1) against the JAX package,
float64, CPU.

Both packages get the same seeded numpy inputs at a small size: B = 12
walkers, d_eta = d_mu = 8 hidden units, dopri5 with 2 steps.  The JAX side
is its plain (XLA) reference of each function, never a Pallas kernel in
interpret mode: ``FreeFermion.log_prob_multstates`` /
``log_prob_vgh_multstates``, ``BetaVMC.loss_and_metrics_from_base`` under
``jax.value_and_grad``, ``BetaVMC.local_energy_from_base`` and the
continuous adjoint of tests/test_torch_n10.py.  The port's side is what its
mixed-state kernels (#6, #7) are held to on the card: the plain versions
``slater_vgh_ms_cm_plain`` and ``slater_logp_ms``, and the plain kernel
chain of ``BetaVMC.loss_metrics_grads_cm``.  The math is the same closed
form on both sides and only the order of sums differs: every comparison
holds to 1e-9 relative to the largest entry.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fermiflow_tpu import mcmc as jmcmc
from fermiflow_tpu.cli import common as jcommon
from fermiflow_tpu.config import Config as JConfig

from fermiflow_tpu_torch.cli import common, finite_t
from fermiflow_tpu_torch.config import Config
from fermiflow_tpu_torch.nn.backflow import Backflow, backflow_init_zeros
from fermiflow_tpu_torch.ops import metropolis as mp
from fermiflow_tpu_torch.ops.slater_vgh import (
    pack_triu,
    slater_vgh_ms_cm,
    slater_vgh_ms_cm_plain,
)
from fermiflow_tpu_torch.vmc.gs import PLAIN_OPS

from _torch_port import flat_np, flat_torch, jax_params, np_params
from test_torch_n10 import close, jax_adjoint

torch.set_num_threads(1)

N, B, BETA, DELTA_E = 10, 12, 1.0, 4.0


def cfg_beta(**kw):
    """The finite-T configuration of these tests, for both packages."""
    base = dict(nup=N, Z=0.5, beta=BETA, deltaE=DELTA_E, batch=B, d_eta=8,
                d_mu=8, ode_steps=2, dtype="float64", lr=1e-3, seed=0)
    base.update(kw)
    return Config(device="cpu", **base), JConfig(**base)


MODEL, _ = common.build_beta(cfg_beta()[0])
OCC = MODEL.occ_table
# The 8 states (of 1781) that hold quantum number 7: a particle of the
# N = 10 closed shell (nx + ny = 3) moved up by deltaE = 4.
DEEPEST = np.flatnonzero(
    np.maximum(MODEL.basedist.orbitals.nx[OCC],
               MODEL.basedist.orbitals.ny[OCC]).max(axis=1) == 7)


def states(seed, boltzmann=False):
    """(B,) state indices: uniform over the 1781, or from the Boltzmann
    probabilities; walker 0 in the first state holding quantum number 7."""
    rng = np.random.default_rng(seed)
    if boltzmann:
        es = MODEL.Es_original
        p = np.exp(-BETA * (es - es[0]))
        idx = rng.choice(len(OCC), B, p=p / p.sum())
    else:
        idx = rng.integers(0, len(OCC), B)
    idx[0] = DEEPEST[0]
    return idx


def equilibrated(idx, seed):
    """(d, B) f64 walkers equilibrated in their own states by the port's
    plain mixed-state sampler, from seeded Gaussians: away from the nodal
    surface."""
    nx, ny = MODEL.qnums_cm(torch.as_tensor(idx))
    z0 = torch.as_tensor(np.random.default_rng(seed).standard_normal((2 * N, B)))
    x, _, _ = mp.metropolis_multistate_cm(
        z0, torch.full((B,), 0.3, dtype=torch.float64), seed, steps=100,
        nx_cm=nx, ny_cm=ny, num_shells=8)
    return x


# ---- kernels 7 and 6: the mixed-state log density and VGH ----


def test_multistate_density_and_vgh_match_jax():
    """The log density the mixed-state sampler's plain version walks on
    (``slater_logp_ms``) and y, g and the packed Hessian of
    ``slater_vgh_ms_cm_plain`` (kernel 6's plain version) at depth 8,
    against ``log_prob_multstates`` and ``log_prob_vgh_multstates``, on
    walkers in states drawn from the 1781 (one holding quantum number 7):
    1e-9 relative."""
    idx = states(60)
    z_cm = equilibrated(idx, 61)
    x = z_cm.T.reshape(B, N, 2)
    nx, ny = MODEL.qnums_cm(torch.as_tensor(idx))
    assert int(max(nx.max(), ny.max())) == 7
    jbd, jocc = jcommon.build_beta(cfg_beta()[1])[0].basedist, jnp.asarray(OCC)
    jx, jidx = jnp.asarray(x.numpy()), jnp.asarray(idx)
    lp = mp.slater_logp_ms(x, nx.T, ny.T, 8)
    close(lp.numpy(), jbd.log_prob_multstates(jocc, jidx, jx))
    y, g, Hp = slater_vgh_ms_cm_plain(z_cm, nx, ny, 8)
    jy, jg, jH = jbd.log_prob_vgh_multstates(jocc, jidx, jx)
    assert Hp.shape == (2 * N * (2 * N + 1) // 2, B)
    close(y.numpy(), jy)
    close(g.T.numpy(), jg)
    close(Hp.T.numpy(), pack_triu(torch.as_tensor(np.array(jH))).numpy())


# ---- the slice as a whole: one finite-T update ----


def test_beta_update_matches_jax_f64():
    """One finite-T update at N = 10, Z = 0.5 on walkers in states drawn
    from the 1781, as tests/test_torch_beta.py holds N = 3: the port's
    ``loss_and_metrics_from_base`` + autograd against the JAX package's +
    ``jax.value_and_grad`` (every metric, the loss, the flow and logits
    gradients); the plain kernel chain ``loss_metrics_grads_cm`` (Slater
    VGH -> Hessian flow -> REINFORCE adjoint) against the same metrics and
    logits gradient, and its flow gradient against the continuous adjoint
    from JAX vector-Jacobian products (tests/test_torch_n10.py) with the
    per-state-baselined weights.  All 1e-9 relative."""
    cfg, jcfg = cfg_beta()
    model, _ = common.build_beta(cfg)
    jmodel, _ = jcommon.build_beta(jcfg)
    idx = states(62)
    z_cm = equilibrated(idx, 63)
    z = z_cm.T.reshape(B, N, 2)
    p = np_params(64)
    logits = 0.3 * np.random.default_rng(65).standard_normal(len(OCC))
    jparams = {"flow": jax_params(p), "log_state_weights": jnp.asarray(logits)}
    jidx, jz = jnp.asarray(idx), jnp.asarray(z.numpy())
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss_and_metrics_from_base, has_aux=True))(jparams, jidx, jz)

    flow = Backflow({m: None if v is None else
                     {k: torch.as_tensor(a) for k, a in v.items()}
                     for m, v in p.items()})
    lg = torch.nn.Parameter(torch.tensor(logits))
    params = {"flow": flow.params(), "log_state_weights": lg}
    tidx = torch.as_tensor(idx)
    loss, m = model.loss_and_metrics_from_base(params, tidx, z)
    loss.backward()
    keys = ("E", "E_std", "F", "F_std", "S", "S_analytical")
    for key in keys:
        close(float(m[key]), float(jm[key]))
    close(float(loss.detach()), float(jloss))
    grads = {name: {k: v.grad for k, v in mod.items()}
             for name, mod in (("eta", flow.eta), ("mu", flow.mu))}
    close(flat_torch(grads), flat_np(jgrads["flow"]))
    jgl = np.asarray(jgrads["log_state_weights"])
    close(lg.grad.numpy(), jgl)

    model.ops = PLAIN_OPS
    _, mc, gc = model.loss_metrics_grads_cm(params, tidx, z_cm)
    for key in keys:
        close(float(mc[key]), float(jm[key]))
    close(gc["log_state_weights"].numpy(), jgl)
    x, eloc, _, g = jmodel.local_energy_from_base(
        jparams["flow"], jidx, jz, return_grad=True)
    eloc = np.asarray(eloc)
    counts = np.bincount(idx, minlength=len(OCC))
    sums = np.bincount(idx, weights=eloc, minlength=len(OCC))
    w = (eloc - (sums / np.maximum(counts, 1))[idx]) / B
    close(flat_torch(gc["flow"]),
          flat_np(jax_adjoint(jparams["flow"], x, g, jnp.asarray(w))))


# ---- the Boltzmann oracle at 1781 states ----


def test_boltzmann_oracle_at_1781_states():
    """Z = 0, identity flow, Boltzmann logits at beta = 1, deltaE = 4:
    every walker's Floc is the exact free energy F = E0 - log sum_s
    exp(-beta (E_s - E0)) / beta = 25.831155 (E0 = 30), so F_std = 0, and
    the logit and flow gradients vanish, through the plain kernel chain
    (tests/test_vmc.py holds the JAX package's oracle at this
    enumeration, at beta = 2)."""
    cfg, _ = cfg_beta(Z=0.0, boltzmann=True)
    model, params = common.build_beta(cfg)
    model.ops = PLAIN_OPS
    es = model.Es_original
    F_exact = es[0] - np.log(np.sum(np.exp(-BETA * (es - es[0])))) / BETA
    np.testing.assert_allclose(F_exact, 25.831155, atol=1e-6)
    idx = states(66, boltzmann=True)
    z_cm = equilibrated(idx, 67)
    params = {"flow": backflow_init_zeros(8, 8),
              "log_state_weights": params["log_state_weights"]}
    _, m, grads = model.loss_metrics_grads_cm(params, torch.as_tensor(idx),
                                              z_cm)
    np.testing.assert_allclose(float(m["F"]), F_exact, rtol=0, atol=1e-9)
    np.testing.assert_allclose(float(m["F_std"]), 0.0, atol=1e-9)
    np.testing.assert_allclose(float(m["S_analytical"]), 7.045949, atol=1e-6)
    assert float(grads["log_state_weights"].abs().max()) < 1e-10
    assert float(np.abs(flat_torch(grads["flow"])).max()) < 1e-10


# ---- what the mixed-state kernels are built for ----


def test_mixed_state_kernels_take_n_up_to_10_at_depth_8():
    """The finite-T path at N = 10 needs depth 8 of the compiled 4, 5, 6,
    8.  N = 11 or a depth above 8 raises on a non-CPU tensor, and a valid
    one goes to the CUDA path (which refuses a tensor that is not on the
    card), never a quiet fall back to the plain version."""
    assert mp.MS_SUPPORTED_N == tuple(range(2, 11))
    _, _, ks = MODEL._qnum_tables()
    assert ks == 8 and mp.ms_depth(ks) == 8 and len(OCC) == 1781
    mp.check_ms_occupation("sampler", 10, ks)
    meta = dict(device="meta")
    for n, shells, match in ((11, 8, "2 ≤ N ≤ 10"), (10, 9, "up to 8"),
                             (10, 8, "must be a CUDA tensor")):
        x = torch.empty((2 * n, B), **meta)
        q = torch.empty((n, B), dtype=torch.int32, **meta)
        with pytest.raises(ValueError, match=match):
            mp.metropolis_multistate_cm(x, torch.empty((B,), **meta), 0,
                                        steps=1, nx_cm=q, ny_cm=q,
                                        num_shells=shells)
        with pytest.raises(ValueError, match=match):
            slater_vgh_ms_cm(x, q, q, shells)


def test_jax_sampler_acceptance_is_chip_smokes_figure():
    """chip_smoke.py holds kernel 7 at N = 10 to the JAX mixed-state
    sampler's acceptance at tau = 0.1 on uniformly drawn states of the 1781
    after 300 steps at tau = 0.2 from Gaussians (0.616, over 8192 walkers):
    the JAX package's plain sampler gives it again over 1024 walkers, whose
    standard error is ~0.002."""
    import chip_smoke

    rng = np.random.default_rng(68)
    nb = 1024
    idx = jnp.asarray(rng.integers(0, len(OCC), nb))
    jbd, jocc = jcommon.build_beta(cfg_beta()[1])[0].basedist, jnp.asarray(OCC)
    run = jax.jit(lambda k, x, steps, tau: jmcmc.metropolis(
        lambda y: jbd.log_prob_multstates(jocc, idx, y), k, x, steps, tau),
        static_argnums=2)
    k1, k2 = jax.random.split(jax.random.PRNGKey(68))
    x0 = jnp.asarray(rng.standard_normal((nb, N, 2)), jnp.float32)
    st = run(k2, run(k1, x0, 300, 0.2).x, 30, 0.1)
    acc = float(jnp.mean(st.accept_rate))
    assert abs(acc - chip_smoke.ACCEPT_MS_TAU01_N10) < 0.01, acc


# ---- cli/finite_t.py at N = 10 ----


def test_finite_t_cli_n10_runs_two_iterations_on_cpu(tmp_path, capsys):
    """``python -m fermiflow_tpu_torch.cli.finite_t --device cpu`` at
    --nup 10 --deltaE 4.0 --beta 1.0 --boltzmann for two iterations at tiny
    widths, one chunk (K = 2): the JAX CLI's lines, 1781 states, a finite
    F near the JAX CLI's first (41.12 at full width) and one metrics row
    per iteration."""
    path = tmp_path / "m.jsonl"
    argv = ["--beta", "1.0", "--nup", "10", "--Z", "0.5", "--deltaE", "4.0",
            "--boltzmann", "--batch", "16", "--iternum", "2", "--Deta", "8",
            "--Dmu", "8", "--ode-steps", "2", "--mcmc-steps", "5",
            "--dtype", "float32", "--lr", "3e-3", "--persistent",
            "--steps-per-call", "2", "--device", "cpu", "--metrics", str(path)]
    state = finite_t.main(argv)
    assert state.step == 2 and state.state_idx.shape == (16,)
    assert int(state.state_idx.max()) < 1781
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2]
    for r in rows:
        assert np.isfinite(r["F"]) and 30.0 < r["F"] < 80.0
        assert abs(r["S_analytical"] - 7.046) < 1e-2
        assert 0.0 < r["accept_rate"] <= 1.0
    out = capsys.readouterr().out
    assert "total number of states = 1781" in out
    assert "Boltzmann distribution." in out and "iter: 002 F:" in out
