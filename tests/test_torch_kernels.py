"""The port's four kernel modules, through their plain versions, against the
JAX package's Pallas kernels run in interpret mode (float32, CPU).

The CUDA kernels run only on the card (``chip_smoke.py`` holds them against
these plain versions there).  Here a CPU tensor takes each wrapper's plain
path, which must reproduce the TPU kernel's arithmetic.  Tolerances are
those of the JAX package's own interpret tests of the same kernel
(tests/test_pallas_*.py, tests/test_hessian_flow.py), or tighter.

Every Pallas call uses one set of shapes (N=3, B=64, d_eta=d_mu=8, dopri5,
2 steps) and the call signature ``GSVMC.loss_metrics_grads_pallas`` uses, so
the whole-update test at the end reuses the compiled interpret programs.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from fermiflow_tpu import train as jtrain
from fermiflow_tpu.config import Config as JConfig
from fermiflow_tpu.flow import CNF as JCNF
from fermiflow_tpu.nn.backflow import backflow_apply as j_apply
from fermiflow_tpu.nn.backflow import backflow_divergence as j_div
from fermiflow_tpu.nn.backflow_derivs import backflow_field_tensors as j_ft
from fermiflow_tpu.ops.pallas_hessian_flow import hessian_flow_pallas
from fermiflow_tpu.ops.pallas_metropolis import metropolis_free_fermion_chains as j_chains
from fermiflow_tpu.ops.pallas_reinforce import reinforce_flow_grad_pallas
from fermiflow_tpu.ops.pallas_slater_vgh import slater_vgh_pallas
from fermiflow_tpu.physics import HO2D as JHO2D
from fermiflow_tpu.physics import CoulombPairPotential as JCoulomb
from fermiflow_tpu.physics import FreeFermion as JFreeFermion
from fermiflow_tpu.physics import HOPotential as JHO
from fermiflow_tpu.vmc import GSVMC as JGSVMC

from fermiflow_tpu_torch.flow import CNF
from fermiflow_tpu_torch.nn.backflow import (
    Backflow,
    backflow_apply,
    backflow_divergence,
)
from fermiflow_tpu_torch.nn.backflow_derivs import backflow_field_tensors
from fermiflow_tpu_torch.ode import odeint
from fermiflow_tpu_torch.ops.hessian_flow import hessian_flow_packed
from fermiflow_tpu_torch.ops.metropolis import (
    metropolis_chains,
    metropolis_free_fermion_chains,
)
from fermiflow_tpu_torch.ops.reinforce import block_sum, reinforce_flow_grad
from fermiflow_tpu_torch.ops.slater_vgh import pack_triu, slater_vgh
from fermiflow_tpu_torch.physics import (
    HO2D,
    CoulombPairPotential,
    FreeFermion,
    HOPotential,
)
from fermiflow_tpu_torch.train import TrainState, _make_gs_update, make_adam
from fermiflow_tpu_torch.vmc import GSVMC

from _torch_port import (
    flat_np,
    flat_torch,
    jax_params,
    np_params,
    torch_params,
    walkers,
)

B, STEPS, METHOD, T0, T1 = 64, 2, "dopri5", 0.0, 1.0
ORB = HO2D()


def qnums(nup, ndown):
    occ_up, occ_dn = np.arange(nup), np.arange(ndown)
    nx_up = tuple(int(v) for v in ORB.nx[occ_up])
    ny_up = tuple(int(v) for v in ORB.ny[occ_up])
    nx_dn = tuple(int(v) for v in ORB.nx[occ_dn])
    ny_dn = tuple(int(v) for v in ORB.ny[occ_dn])
    ks = int(max(nx_up + ny_up + nx_dn + ny_dn)) + 1
    return nx_up, ny_up, nx_dn, ny_dn, ks


@pytest.fixture(scope="module")
def inputs():
    """Equilibrated walkers (N=3) and Gaussian parameters, float32.

    f32 results are compared only on walkers the sampler has equilibrated:
    raw Gaussian points can sit near the nodal surface, where f32
    elimination depends on pivot order.  The chain runs in f64 through the
    port's plain sampler from seeded Gaussians."""
    nx_up, ny_up, nx_dn, ny_dn, ks = qnums(3, 0)
    z0 = torch.as_tensor(walkers(20, B, 3).reshape(B, 6).T.copy())
    xs, _, _, _ = metropolis_chains(
        z0, torch.full((B,), 0.3, dtype=torch.float64), 20, steps=100,
        segments=1, nx_occ=nx_up, ny_occ=ny_up, num_shells=ks)
    z = xs[-1].T.reshape(B, 3, 2).numpy().astype(np.float32)
    p = np_params(21, dtype=np.float32)
    return z, p


# ---- kernel 2: Slater value / gradient / packed Hessian ----


@pytest.mark.parametrize("nup,ndown", [(3, 0), (2, 1)])
def test_slater_vgh_plain_matches_pallas_interpret(inputs, nup, ndown):
    z, _ = inputs
    nx_up, ny_up, nx_dn, ny_dn, ks = qnums(nup, ndown)
    jy, jg, jH = slater_vgh_pallas(jnp.asarray(z), nx_up, ny_up, ks, nx_dn,
                                   ny_dn, interpret=True)
    y, g, Hp = slater_vgh(torch.as_tensor(z), nx_up, ny_up, ks, nx_dn, ny_dn)
    iu = np.triu_indices(6)
    # tests/test_pallas_slater_vgh.py: y 2e-4, g 3e-3, H 5e-3, no violations.
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=3e-3, atol=3e-3)
    np.testing.assert_allclose(Hp.numpy(), np.asarray(jH)[:, iu[0], iu[1]],
                               rtol=5e-3, atol=5e-3)
    # The packed layout is np.triu_indices order of the symmetric Hessian.
    np.testing.assert_array_equal(
        pack_triu(torch.as_tensor(np.array(jH))).numpy(),
        np.asarray(jH)[:, iu[0], iu[1]])


# ---- kernel 3: Hessian flow ----


def test_hessian_flow_plain_matches_pallas_interpret(inputs):
    z, p = inputs
    nx_up, ny_up, nx_dn, ny_dn, ks = qnums(3, 0)
    jz = jnp.asarray(z)
    jy, jg, jH = slater_vgh_pallas(jz, nx_up, ny_up, ks, nx_dn, ny_dn,
                                   interpret=True)
    ref = hessian_flow_pallas(jax_params(p), jz, jy, jg, jH, T0, T1,
                              steps=STEPS, method=METHOD, interpret=True)
    iu = np.triu_indices(6)
    out = hessian_flow_packed(
        torch_params(p, torch.float32), torch.as_tensor(z),
        torch.as_tensor(np.array(jy)), torch.as_tensor(np.array(jg)),
        torch.as_tensor(np.asarray(jH)[:, iu[0], iu[1]].copy()), T0, T1,
        STEPS, METHOD)
    refs = [np.asarray(r) for r in ref]
    refs[3] = refs[3][:, iu[0], iu[1]]
    for name, o, r in zip(("x", "logp", "g", "H"), out, refs):
        # tests/test_hessian_flow.py: err < 1e-4 * scale + 1e-5.
        err = float(np.max(np.abs(o.numpy().astype(np.float64) - r)))
        scale = float(np.max(np.abs(r)))
        assert err < 1e-4 * scale + 1e-5, (name, err, scale)


# ---- kernel 4: REINFORCE adjoint ----


def adjoint_oracle_torch(params, x1, ghat, w, t0, t1, steps, method):
    """grad_theta sum_i w_i log p_theta(x1_i) by the continuous adjoint on
    the same grid, with every vector-Jacobian product from autograd
    (tests/test_pallas_reinforce.py's oracle, in PyTorch)."""
    mods = [m for m in ("eta", "mu") if params.get(m) is not None]
    keys = [(m, k) for m in mods for k in ("w2", "w1", "b1")]

    def rhs(p, t, state):
        x, a, _ = state
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            pp = {m: {k: v.detach().requires_grad_(True) for k, v in p[m].items()}
                  for m in mods}
            pp.setdefault("mu", None)
            v = backflow_apply(pp, xx)
            div = backflow_divergence(pp, xx)
            grads = torch.autograd.grad(
                (v, div), [xx] + [pp[m][k] for m, k in keys], (a, -w))
        return (v.detach(), -grads[0], tuple(-q for q in grads[1:]))

    a1 = (-w[:, None] * ghat).reshape(x1.shape)
    th0 = tuple(torch.zeros_like(params[m][k]) for m, k in keys)
    _, _, th = odeint(rhs, params, (x1, a1, th0), t1, t0, steps=steps,
                      method=method)
    out = {m: {} for m in mods}
    for (m, k), v in zip(keys, th):
        out[m][k] = v
    out.setdefault("mu", None)
    return out


def _reinforce_inputs(seed):
    rng = np.random.default_rng(seed)
    x1 = rng.standard_normal((B, 3, 2))
    ghat = rng.standard_normal((B, 6))
    w = rng.standard_normal(B) / B
    return x1, ghat, w


@pytest.mark.parametrize("d_mu", [8, None])
def test_reinforce_plain_matches_autograd_oracle_f64(d_mu):
    """Same continuous adjoint, closed forms against autograd vjps: f64
    agreement to 1e-9 relative of the largest gradient entry."""
    p = np_params(22, d_mu=d_mu)
    x1, ghat, w = (torch.as_tensor(a) for a in _reinforce_inputs(23))
    grads, z_back = reinforce_flow_grad(torch_params(p), x1, ghat, w, T0, T1,
                                        STEPS, METHOD)
    oracle = adjoint_oracle_torch(torch_params(p), x1, ghat, w, T0, T1, STEPS,
                                  METHOD)
    a, b = flat_torch(grads), flat_torch(oracle)
    np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9 * np.abs(b).max())
    assert z_back.shape == x1.shape and torch.isfinite(z_back).all()


def test_reinforce_plain_matches_pallas_interpret(inputs):
    _, p = inputs
    x1, ghat, w = (a.astype(np.float32) for a in _reinforce_inputs(24))
    jgrads, jz = reinforce_flow_grad_pallas(
        jax_params(p), jnp.asarray(x1), jnp.asarray(ghat), jnp.asarray(w),
        T0, T1, steps=STEPS, method=METHOD, interpret=True)
    grads, z_back = reinforce_flow_grad(
        torch_params(p, torch.float32), torch.as_tensor(x1),
        torch.as_tensor(ghat), torch.as_tensor(w), T0, T1, STEPS, METHOD)
    a, b = flat_torch(grads), flat_np(jgrads)
    # tests/test_pallas_reinforce.py: atol 3e-6 * max|grad|, rtol 2e-5.
    np.testing.assert_allclose(a, b, rtol=2e-5, atol=3e-6 * np.abs(b).max())
    np.testing.assert_allclose(z_back.numpy(), np.asarray(jz), rtol=1e-5,
                               atol=1e-5)
    # The reduce pass's plain version sums per-block partials.
    parts = torch.as_tensor(np.random.default_rng(0).standard_normal((5, 7)))
    np.testing.assert_allclose(block_sum(parts).numpy(), parts.numpy().sum(0),
                               rtol=1e-12)


# ---- kernel 1: multi-segment Metropolis sampler ----


def _interpret_noise(S, steps, n):
    """The random stream of the TPU kernel in interpret mode, which stubs
    prng_random_bits to zero: every uniform is the 1e-12 floor and every
    Box-Muller pair the same (r cos, r sin).  Computed with jnp in float32
    exactly as pallas_metropolis._normals_tiles computes it."""
    u = jnp.maximum(jnp.zeros((), jnp.float32) * (1.0 / (1 << 24)), 1e-12)
    r = jnp.sqrt(-2.0 * jnp.log(u))
    two_pi_u = (2.0 * np.pi) * u
    c, s = np.float32(r * jnp.cos(two_pi_u)), np.float32(r * jnp.sin(two_pi_u))
    d = 2 * n
    col = np.array([c] * (d // 2) + [s] * (d // 2), np.float32)
    normals = np.broadcast_to(col[None, None, :, None], (S, steps + 1, d, B))
    uniforms = np.full((S, steps, B), np.float32(u), np.float32)
    return (torch.as_tensor(normals.copy()), torch.as_tensor(uniforms))


@pytest.mark.parametrize("reinit", [False, True])
@pytest.mark.parametrize("nup,ndown", [(3, 0), (2, 1)])
def test_metropolis_plain_matches_pallas_interpret(inputs, reinit, nup, ndown):
    """Snapshots, logp, rates and tau_out on the interpreter's random stream.

    With reinit=False, the reference's proposals in segments after the
    first still use the initial tau (the fori_loop body's closure over tau
    is traced once and reused), so the segments are compared at gain=0,
    where the documented and the traced behaviour coincide; the port's tau
    adaptation is held to ``mcmc.adapt_tau`` in the test below.

    With reinit, every segment restarts all walkers at the stream's one
    constant point (|x| ~ 7.4), where a step's log-ratio crosses
    log(1e-12) = -27.6 for tau near 0.1: there the last bits of two f32
    evaluations of logp ~ -200 decide acceptance, so those taus are left out.
    """
    z, _ = inputs
    x0 = 0.5 * z
    S, steps = 3, 4
    gain = 0.1 if reinit else 0.0
    nx_up, ny_up, nx_dn, ny_dn, ks = qnums(nup, ndown)
    if reinit:  # always-accept and always-reject bands
        tau0 = np.concatenate([np.linspace(0.02, 0.05, B // 2),
                               np.linspace(0.15, 0.2, B // 2)])
    else:
        tau0 = np.linspace(0.05, 0.2, B)
    tau0 = tau0.astype(np.float32)
    jxs, jlp, jrate, jtau = j_chains(
        jnp.asarray(x0), 7, jnp.asarray(tau0), steps, S, nx_up, ny_up, ks,
        interpret=True, nx_dn=nx_dn, ny_dn=ny_dn, target=0.5, gain=gain,
        reinit=reinit)
    xs, lp, rate, tau = metropolis_free_fermion_chains(
        torch.as_tensor(x0), 7, torch.as_tensor(tau0), steps, S, nx_up, ny_up,
        ks, nx_dn, ny_dn, target=0.5, gain=gain, reinit=reinit,
        noise=_interpret_noise(S, steps, nup + ndown))
    # tests/test_pallas_metropolis.py holds the kernel's logp to 1e-4.
    np.testing.assert_allclose(xs.numpy(), np.asarray(jxs), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(rate.numpy(), np.asarray(jrate))
    np.testing.assert_allclose(tau.numpy(), np.asarray(jtau), rtol=1e-6)
    assert 0.0 < float(rate.mean()) <= 1.0


@pytest.mark.parametrize("reinit", [False, True])
def test_metropolis_segments_equal_chained_single_segments(inputs, reinit):
    """K segments in one call equal K one-segment calls with
    ``mcmc.adapt_tau`` applied between them (fixed tau with reinit), on one
    shared random stream: the port adapts tau inside the launch."""
    from fermiflow_tpu_torch.mcmc import MCMCState, adapt_tau

    z, _ = inputs
    S, steps = 3, 5
    nx_up, ny_up, nx_dn, ny_dn, ks = qnums(3, 0)
    rng = np.random.default_rng(25)
    normals = torch.as_tensor(rng.standard_normal((S, steps + 1, 6, B)))
    uniforms = torch.as_tensor(rng.uniform(1e-12, 1.0, (S, steps, B)))
    x0 = torch.as_tensor(z.reshape(B, 6).T.astype(np.float64))
    tau0 = torch.as_tensor(np.linspace(0.1, 0.6, B))
    kw = dict(nx_occ=nx_up, ny_occ=ny_up, num_shells=ks, target=0.5,
              gain=0.3, reinit=reinit)
    xs, lp, rate, tau = metropolis_chains(x0, tau0, 0, steps=steps,
                                          segments=S, noise=(normals, uniforms),
                                          **kw)
    x, t = x0, tau0
    for s in range(S):
        if reinit and s > 0:  # the restart draw sits in slot `steps`
            x = normals[s, steps]
        nz = (normals[s:s + 1], uniforms[s:s + 1])
        xs1, lp1, rate1, _ = metropolis_chains(x, t, 0, steps=steps,
                                               segments=1, noise=nz, **kw)
        torch.testing.assert_close(xs[s], xs1[0], rtol=0, atol=0)
        torch.testing.assert_close(lp[s], lp1[0], rtol=0, atol=0)
        torch.testing.assert_close(rate[s], rate1[0], rtol=0, atol=0)
        x = xs1[0]
        if not reinit:
            t = adapt_tau(MCMCState(x=None, logp=None, tau=t,
                                    accept_rate=rate1[0]), 0.5, 0.3)
    torch.testing.assert_close(tau, t, rtol=1e-15, atol=0)
    assert 0.2 < float(rate.mean()) < 0.95


# ---- the whole update: Slater VGH -> Hessian flow -> Eloc -> REINFORCE -> Adam ----


def _models(p):
    cnf = CNF(backflow_apply, backflow_divergence, backflow_field_tensors,
              steps=STEPS, method=METHOD)
    model = GSVMC(3, 0, FreeFermion(ORB), cnf, CoulombPairPotential(0.5),
                  HOPotential())
    jcnf = JCNF(j_apply, j_div, j_ft, steps=STEPS, method=METHOD)
    jmodel = JGSVMC(3, 0, JFreeFermion(JHO2D()), jcnf, JCoulomb(0.5), JHO())
    return model, jmodel


def test_update_and_adam_match_jax_pallas_path(inputs):
    """The port's no-autograd update (plain chain, f32) against the JAX
    production update (``loss_metrics_grads_pallas`` in interpret mode +
    ``optax.adam``), for two iterations on the same walkers.

    Tolerances are those of tests/test_pallas_slater_vgh.py:190-196 (two
    orderings of one f32 computation): E 1e-5; loss and gradients rtol
    1e-4, atol 1e-6.  Parameters after each Adam step: rtol 1e-5, atol
    1e-7 (Adam's step is lr-sized, so gradient noise moves them by
    ~lr * 1e-4)."""
    z, p = inputs
    lr = 1e-3
    model, jmodel = _models(p)
    jcfg = JConfig(nup=3, batch=B, dtype="float32", ode_steps=STEPS,
                   pallas_local_energy=True, pallas_interpret=True, lr=lr)
    jopt = optax.adam(lr)
    jparams = jax_params(p)
    jstate = jtrain.TrainState(params=jparams, opt_state=jopt.init(jparams),
                               key=jax.random.PRNGKey(0), step=jnp.zeros((), jnp.int32),
                               walkers=jnp.asarray(z), tau=jnp.full((B,), 0.1))
    jupdate = jtrain._make_gs_update(jmodel, jopt, jcfg, None)

    flow = Backflow(torch_params(p, torch.float32))
    state = TrainState(flow=flow, optimizer=make_adam(flow, lr),
                       generator=torch.Generator().manual_seed(0), step=0,
                       walkers_cm=torch.as_tensor(z.reshape(B, 6).T.copy()),
                       tau=torch.full((B,), 0.1))
    update = _make_gs_update(model)
    z_cm = torch.as_tensor(z.reshape(B, 6).T.copy())

    for _ in range(2):
        jloss, jm, jgrads = jmodel.loss_metrics_grads_pallas(
            jstate.params, jnp.asarray(z), pallas_interpret=True)
        loss, m, grads = model.loss_metrics_grads_cm(state.params, z_cm)
        np.testing.assert_allclose(float(m["E"]), float(jm["E"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["E_std"]), float(jm["E_std"]), rtol=1e-5)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(flat_torch(grads), flat_np(jgrads), rtol=1e-4,
                                   atol=1e-6)

        jp_new, jopt_state, _, _ = jupdate(jstate, jnp.asarray(z))
        jstate = jstate._replace(params=jp_new, opt_state=jopt_state)
        update(state, z_cm)
        np.testing.assert_allclose(flat_torch(state.params),
                                   flat_np(jp_new), rtol=1e-5, atol=1e-7)
