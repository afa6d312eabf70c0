"""The adaptive and adjoint ODE solvers, the trajectory integrator and the
CNF's solver dispatch of ``fermiflow_tpu_torch`` against the JAX package's.

Seeded numpy inputs (float64): the linear ODE dx/dt = a1 a2 x of
``tests/test_ode.py`` and the backflow field at N = 2, widths 8.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fermiflow_tpu import ode as jode
from fermiflow_tpu.flow import CNF as JCNF
from fermiflow_tpu.nn.backflow import backflow_apply as jbackflow_apply
from fermiflow_tpu.nn.backflow import backflow_divergence as jbackflow_divergence
from fermiflow_tpu.physics import HO2D as JHO2D
from fermiflow_tpu.physics import FreeFermion as JFreeFermion

from fermiflow_tpu_torch import ode
from fermiflow_tpu_torch.flow import CNF
from fermiflow_tpu_torch.nn.backflow import backflow_apply, backflow_divergence
from fermiflow_tpu_torch.physics import HO2D, FreeFermion

from _torch_port import jax_params, np_params, torch_params, walkers

T = 1.0
TOL = 1e-10


def f_linear(p, t, x):
    return p["a1"] * p["a2"] * x


def cnfs(**kw):
    base = dict(t0=0.0, t1=1.0, steps=3, method="dopri5", rtol=1e-8,
                atol=1e-10)
    base.update(kw)
    return (CNF(backflow_apply, backflow_divergence, **base),
            JCNF(jbackflow_apply, jbackflow_divergence, **base))


def flow_inputs(seed=0, B=4, n=2, d_mu=8):
    p = np_params(seed, std=0.4, d_mu=d_mu)
    z = walkers(seed + 1, B, n)
    return torch_params(p), torch.as_tensor(z), jax_params(p), jnp.asarray(z)


def close(t, j, tol=TOL):
    np.testing.assert_allclose(np.asarray(t.detach()), np.asarray(j),
                               rtol=tol, atol=tol)


def adaptive_counts(odeint_adaptive, f, params, x0, t0, t1, rtol, atol,
                    same):
    """(result, attempts, accepted steps) of an adaptive solver: every
    attempt evaluates f 7 times and first at the current state, which
    changes exactly when the previous attempt was accepted (the last one
    always is)."""
    starts = []

    def counted(p, t, x):
        starts.append(x)
        return f(p, t, x)

    out = odeint_adaptive(counted, params, x0, t0, t1, rtol=rtol, atol=atol)
    firsts = starts[::7]
    changes = sum(not same(a, b) for a, b in zip(firsts, firsts[1:]))
    return out, len(starts) // 7, changes + 1


@pytest.mark.parametrize("t0,t1", [(0.0, 1.0), (1.0, 0.0)])
def test_adaptive_step_counts_and_values_match_jax(t0, t1):
    """The backflow field at rtol 1e-8 (rejections happen): the same attempts,
    the same accepted steps and the same state, forward and backward."""
    params, z, jparams, jz = flow_inputs()
    f = lambda p, t, x: backflow_apply(p, x)
    jf = lambda p, t, x: jbackflow_apply(p, x)
    out, attempts, accepted = adaptive_counts(
        ode.odeint_adaptive, f, params, z, t0, t1, 1e-8, 1e-10, torch.equal)
    with jax.disable_jit():  # the while_loop runs eagerly: f sees each state
        jout, *jcounts = adaptive_counts(
            jode.odeint_adaptive, jf, jparams, jz, t0, t1, 1e-8, 1e-10,
            np.array_equal)
    assert [attempts, accepted] == jcounts
    assert attempts > accepted > 1
    close(out, jout)
    # The differentiable variant is the same loop here; JAX's masked scan
    # reaches the same state.
    jdiff = jax.jit(lambda p, x: jode.odeint_adaptive(
        jf, p, x, t0, t1, rtol=1e-8, atol=1e-10, max_steps=64,
        differentiable=True))(jparams, jz)
    close(ode.odeint_adaptive(f, params, z, t0, t1, rtol=1e-8, atol=1e-10,
                              max_steps=64, differentiable=True), jdiff)


def test_adaptive_linear_solution_and_gradient():
    a1 = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
    p = {"a1": a1, "a2": torch.tensor(-0.4, dtype=torch.float64)}
    x0 = torch.tensor(1.5, dtype=torch.float64)
    xT = ode.odeint_adaptive(f_linear, p, x0, 0.0, T, rtol=1e-10, atol=1e-12,
                             differentiable=True)
    np.testing.assert_allclose(float(xT.detach()), 1.5 * np.exp(-0.28),
                               rtol=1e-9)
    (g,) = torch.autograd.grad(xT, a1)
    np.testing.assert_allclose(float(g), 1.5 * np.exp(-0.28) * -0.4 * T,
                               rtol=1e-7)


def test_adjoint_linear_derivatives_match_jax_to_third_order():
    def solve_j(a1):
        return jode.odeint_adjoint(f_linear, {"a1": a1, "a2": jnp.asarray(-0.4)},
                                   jnp.asarray(1.3), 0.0, T, 16, "dopri5")

    a1 = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
    y = ode.odeint_adjoint(f_linear, {"a1": a1, "a2": torch.tensor(
        -0.4, dtype=torch.float64)}, torch.tensor(1.3, dtype=torch.float64),
        0.0, T, 16, "dopri5")
    derivs = [y]
    for _ in range(3):
        (g,) = torch.autograd.grad(derivs[-1], a1, create_graph=True)
        derivs.append(g)
    jd = [solve_j, jax.grad(solve_j), jax.grad(jax.grad(solve_j)),
          jax.grad(jax.grad(jax.grad(solve_j)))]
    for t, jf in zip(derivs, jd):
        close(t, jf(jnp.asarray(0.7)))
    np.testing.assert_allclose(
        float(derivs[3]), -1.3 * np.exp(-0.28) * (0.4 * T) ** 3, rtol=1e-8)


# A loss linear in the solve's outputs: its cotangent does not depend on
# the parameters.  (For a nonlinear one, PyTorch differentiates the
# cotangent's dependence through the adjoint again, where JAX's custom_vjp
# differentiates the forward solve; the two then differ by the integration
# error.)
W = np.random.default_rng(11).standard_normal((4, 2, 2))


@pytest.fixture(scope="module")
def adjoint_ref():
    """JAX's adjoint log-likelihood, its parameter gradient and a
    Hessian-vector product (second order), at N = 2, the two-body field
    alone (its compile is half that with the one-body MLP)."""
    params, z, jparams, jz = flow_inputs(seed=3, d_mu=None)
    _, jcnf = cnfs()
    v = jax.tree_util.tree_map(jnp.ones_like, jparams)

    def loss(p):
        xT, dlp = jcnf.delta_logp(p, jz, use_adjoint=True)
        return jnp.sum(jnp.asarray(W) * xT) + jnp.sum(dlp)

    def gv(p):
        g = jax.grad(loss)(p)
        return sum(jnp.vdot(a, b) for a, b in zip(jax.tree_util.tree_leaves(g),
                                                  jax.tree_util.tree_leaves(v)))

    ref = jax.jit(lambda p: (loss(p), jax.grad(loss)(p), jax.grad(gv)(p)))
    return params, z, jax.device_get(ref(jparams))


def _leaves(params):
    return [params[m][k] for m in ("eta", "mu") if params[m] is not None
            for k in ("w1", "b1", "w2")]


def test_adjoint_delta_logp_matches_jax_to_second_order(adjoint_ref):
    params, z, (jl, jg, jhv) = adjoint_ref
    cnf, _ = cnfs()
    leaves = _leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    w = torch.as_tensor(W)
    xT, dlp = cnf.delta_logp(params, z, use_adjoint=True)
    loss = torch.sum(w * xT) + torch.sum(dlp)
    grads = torch.autograd.grad(loss, leaves, create_graph=True)
    hv = torch.autograd.grad(sum(g.sum() for g in grads), leaves)
    close(loss, jl)
    for t, j in zip(grads, _leaves(jg)):
        close(t, j)
    for t, j in zip(hv, _leaves(jhv)):
        close(t, j)
    # Against the fixed grid's exact discrete gradient: equal up to the
    # reversal error, here of 16 dopri5 steps.
    fine = dataclasses.replace(cnf, steps=16)
    xa, dla = fine.delta_logp(params, z, use_adjoint=True)
    ga = torch.autograd.grad(torch.sum(w * xa) + torch.sum(dla), leaves)
    xf, dlf = fine.delta_logp(params, z)
    gf = torch.autograd.grad(torch.sum(w * xf) + torch.sum(dlf), leaves)
    for a, b in zip(ga, gf):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-8)


@pytest.mark.parametrize("solver", ["fixed", "adaptive", "adjoint"])
def test_cnf_generate_dispatches_the_solver_as_jax(solver):
    params, z, jparams, jz = flow_inputs(seed=5)
    cnf, jcnf = cnfs(solver=solver)
    close(cnf.generate(params, z),
          jax.jit(jcnf.generate)(jparams, jz) if solver != "adaptive"
          else jcnf.generate(jparams, jz))


def test_trajectory_and_reversibility_match_jax():
    params, z, jparams, jz = flow_inputs(seed=7, B=6)
    cnf, jcnf = cnfs()
    frames = cnf.generate_trajectory(params, z, nframes=4)
    jframes = jax.jit(lambda p, x: jcnf.generate_trajectory(p, x, 4))(jparams, jz)
    assert frames.shape == jframes.shape == (4, 6, 2, 2)
    close(frames, jframes)
    assert torch.equal(frames[0], z)
    # The last frame is generate on the trajectory's grid (3 frames x 4).
    fine = dataclasses.replace(cnf, steps=12)
    close(frames[-1], fine.generate(params, z), 1e-12)

    occ = np.arange(2, dtype=np.int32)
    base = FreeFermion(HO2D())
    jbase = JFreeFermion(JHO2D())
    diag = cnf.check_reversibility(params, lambda q: base.log_prob(occ, (), q),
                                   z)
    jdiag = jax.jit(lambda p, x: jcnf.check_reversibility(
        p, lambda q: jbase.log_prob(occ, (), q), x))(jparams, jz)
    for k in ("max_abs_z_err", "max_abs_logp_err"):
        np.testing.assert_allclose(float(diag[k]), float(jdiag[k]),
                                   rtol=1e-8, atol=1e-13)


def test_odeint_trajectory_linear_matches_jax():
    p = {"a1": torch.tensor(0.7, dtype=torch.float64),
         "a2": torch.tensor(-0.4, dtype=torch.float64)}
    ts = np.linspace(0.0, T, 5)
    frames = ode.odeint_trajectory(f_linear, p, torch.tensor(
        [1.0, 2.0], dtype=torch.float64), torch.as_tensor(ts),
        steps_per_frame=8)
    jframes = jode.odeint_trajectory(
        f_linear, {"a1": jnp.asarray(0.7), "a2": jnp.asarray(-0.4)},
        jnp.asarray([1.0, 2.0]), jnp.asarray(ts), steps_per_frame=8)
    close(frames, jframes)
    np.testing.assert_allclose(frames[:, 0].numpy(), np.exp(-0.28 * ts),
                               atol=1e-9)
