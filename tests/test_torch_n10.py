"""The port's ground-state slice at N = 10 (the closed shell after N = 6,
nx + ny <= 3, Hermite orders 0..3) against the JAX package, float64, CPU.

Both packages get the same seeded numpy inputs at a small size: B = 8
walkers, d_eta = d_mu = 8 hidden units, dopri5 with 2 steps.  The JAX side
is its plain (XLA) reference of each function, never a Pallas kernel in
interpret mode: ``FreeFermion.log_prob`` / ``log_prob_vgh``,
``vmc.hessian_flow.hessian_flow``, ``GSVMC.local_energy_from_base`` and a
continuous adjoint built from ``jax.vjp`` of the backflow field on the JAX
package's ``odeint`` grid.  The port's side is what its kernels are held to
on the card: the plain versions ``slater_vgh_cm_plain``,
``hessian_flow_cm_plain``, ``reinforce_cm_plain`` and the plain kernel
chain of ``GSVMC.loss_metrics_grads_cm``.  The math is the same closed form
on both sides and only the order of sums differs: every comparison holds to
1e-9 relative to the largest entry (tests/test_torch_modules.py's bound).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fermiflow_tpu.flow import CNF as JCNF
from fermiflow_tpu.nn.backflow import backflow_apply as j_apply
from fermiflow_tpu.nn.backflow import backflow_divergence as j_div
from fermiflow_tpu.nn.backflow_derivs import backflow_field_tensors as j_ft
from fermiflow_tpu.ode import odeint as j_odeint
from fermiflow_tpu.physics import HO2D as JHO2D
from fermiflow_tpu.physics import CoulombPairPotential as JCoulomb
from fermiflow_tpu.physics import FreeFermion as JFreeFermion
from fermiflow_tpu.physics import HOPotential as JHO
from fermiflow_tpu.vmc import GSVMC as JGSVMC
from fermiflow_tpu.vmc import hessian_flow as jhf

from fermiflow_tpu_torch.flow import CNF
from fermiflow_tpu_torch.nn.backflow import (
    backflow_apply,
    backflow_divergence,
    backflow_init_zeros,
)
from fermiflow_tpu_torch.nn.backflow_derivs import backflow_field_tensors
from fermiflow_tpu_torch.ops import hessian_flow as hf
from fermiflow_tpu_torch.ops import reinforce as rf
from fermiflow_tpu_torch.ops.metropolis import (
    check_gs_occupation,
    metropolis_chains,
    slater_logp_qn,
)
from fermiflow_tpu_torch.ops.slater_vgh import pack_triu, slater_vgh_cm_plain
from fermiflow_tpu_torch.physics import (
    HO2D,
    CoulombPairPotential,
    FreeFermion,
    HOPotential,
)
from fermiflow_tpu_torch.vmc import GSVMC

from _torch_port import flat_np, flat_torch, jax_params, np_params, torch_params

torch.set_num_threads(1)

N, B, STEPS, METHOD, T0, T1 = 10, 8, 2, "dopri5", 0.0, 1.0
RTOL = 1e-9
ORB = HO2D()


def close(a, b, rtol=RTOL):
    """Within rtol of the largest |entry| of b (entries that cancel to
    roundoff are held to that absolute bound)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max())


def qnums(nup, ndown):
    up, dn = np.arange(nup), np.arange(ndown)
    q = [tuple(int(v) for v in a) for a in
         (ORB.nx[up], ORB.ny[up], ORB.nx[dn], ORB.ny[dn])]
    return dict(nx_occ=q[0], ny_occ=q[1], nx_dn=q[2], ny_dn=q[3],
                num_shells=max(q[0] + q[1] + q[2] + q[3]) + 1)


def equilibrated(nup, ndown, seed):
    """(d, B) walkers from the port's plain sampler on the |det|^2 density,
    from seeded Gaussians, f64: away from the nodal surface."""
    n = nup + ndown
    rng = np.random.default_rng(seed)
    z0 = torch.as_tensor(rng.standard_normal((2 * n, B)))
    xs, _, _, _ = metropolis_chains(
        z0, torch.full((B,), 0.3, dtype=torch.float64), seed, steps=100,
        segments=1, **qnums(nup, ndown))
    return xs[-1]


def models(Z, nup=N, ndown=0):
    cnf = CNF(backflow_apply, backflow_divergence, backflow_field_tensors,
              steps=STEPS, method=METHOD)
    model = GSVMC(nup, ndown, FreeFermion(HO2D()), cnf, CoulombPairPotential(Z),
                  HOPotential())
    jcnf = JCNF(j_apply, j_div, j_ft, steps=STEPS, method=METHOD)
    jmodel = JGSVMC(nup, ndown, JFreeFermion(JHO2D()), jcnf, JCoulomb(Z),
                    JHO())
    return model, jmodel


def jax_adjoint(p, x1, g1, w):
    """grad_theta sum_i w_i log p_theta(x1_i) by the continuous adjoint on
    the flow's grid, every vector-Jacobian product from ``jax.vjp`` of the
    JAX backflow (tests/test_torch_kernels.py's oracle, in JAX): the
    function ``reinforce_cm_plain`` computes in closed form."""
    th0 = jax.tree_util.tree_map(jnp.zeros_like, p)

    def rhs(pp, t, state):
        x, a, _ = state
        (v, _), vjp = jax.vjp(lambda xx, q: (j_apply(q, xx), j_div(q, xx)),
                              x, pp)
        gx, gp = vjp((a, -w))
        return v, -gx, jax.tree_util.tree_map(lambda u: -u, gp)

    a1 = (-w[:, None] * g1).reshape(x1.shape)
    _, _, th = j_odeint(rhs, p, (x1, a1, th0), T1, T0, steps=STEPS,
                        method=METHOD)
    return th


# ---- the sampler's log density and the Slater value/gradient/Hessian ----


@pytest.mark.parametrize("nup,ndown", [(10, 0), (6, 4)])
def test_base_density_and_vgh_match_jax(nup, ndown):
    """The log density the samplers' plain version walks on, and y, g and
    the packed Hessian of ``slater_vgh_cm_plain`` (kernel 2's plain
    version), against ``FreeFermion.log_prob`` and ``log_prob_vgh``."""
    n = nup + ndown
    z_cm = equilibrated(nup, ndown, 40 + nup)
    x = z_cm.T.reshape(B, n, 2)
    q = qnums(nup, ndown)
    jbd = JFreeFermion(JHO2D())
    occ_up, occ_dn = np.arange(nup), np.arange(ndown)
    jx = jnp.asarray(x.numpy())
    lp = slater_logp_qn(x, q["nx_occ"] + q["nx_dn"], q["ny_occ"] + q["ny_dn"],
                        nup, q["num_shells"])
    close(lp.numpy(), jbd.log_prob(occ_up, occ_dn, jx))
    y, g, Hp = slater_vgh_cm_plain(z_cm, **q)
    jy, jg, jH = jbd.log_prob_vgh(occ_up, occ_dn, jx)
    assert Hp.shape == (2 * n * (2 * n + 1) // 2, B)
    assert q["num_shells"] == (4 if nup == 10 else 3)
    close(y.numpy(), jy)
    close(g.T.numpy(), jg)
    close(Hp.T.numpy(), pack_triu(torch.as_tensor(np.array(jH))).numpy())


# ---- kernel 3: the Hessian flow ----


def test_hessian_flow_matches_jax():
    """``hessian_flow_cm_plain`` (kernel 3's plain version, packed H)
    against ``vmc.hessian_flow.hessian_flow`` (full H) from the same base
    (y, g, H), both with the closed-form field tensors."""
    z_cm = equilibrated(N, 0, 41)
    q = qnums(N, 0)
    y, g, Hp = slater_vgh_cm_plain(z_cm, **q)
    p = np_params(42)
    out = hf.hessian_flow_cm_plain(torch_params(p), z_cm, y, g, Hp, T0, T1,
                                   STEPS, METHOD)
    H0 = np.zeros((B, 2 * N, 2 * N))
    iu = np.triu_indices(2 * N)
    H0[:, iu[0], iu[1]] = Hp.T.numpy()
    H0[:, iu[1], iu[0]] = Hp.T.numpy()
    ref = jhf.hessian_flow(j_ft, jax_params(p),
                           jnp.asarray(z_cm.T.reshape(B, N, 2).numpy()),
                           jnp.asarray(y.numpy()), jnp.asarray(g.T.numpy()),
                           jnp.asarray(H0), T0, T1, steps=STEPS, method=METHOD)
    jx, jlp, jg, jH = (np.asarray(r) for r in ref)
    close(out[0].T.numpy(), jx.reshape(B, 2 * N))
    close(out[1].numpy(), jlp)
    close(out[2].T.numpy(), jg)
    close(out[3].T.numpy(), jH[:, iu[0], iu[1]])


# ---- kernels 4 and 4b: the REINFORCE adjoint and its block sum ----


@pytest.mark.parametrize("d_mu", [8, None])
def test_reinforce_matches_jax_adjoint(d_mu):
    """``reinforce_cm_plain`` (kernel 4's plain version; the block sum's
    is the sum over walkers) against the continuous adjoint from JAX
    vector-Jacobian products on the same grid, and its z_back against the
    JAX backward solve."""
    rng = np.random.default_rng(43)
    x1 = rng.standard_normal((B, N, 2))
    g1 = rng.standard_normal((B, 2 * N))
    w = rng.standard_normal(B) / B
    p = np_params(44, d_mu=d_mu)
    grads, z_back = rf.reinforce_cm_plain(
        torch_params(p), torch.as_tensor(x1.reshape(B, 2 * N).T.copy()),
        torch.as_tensor(g1.T.copy()), torch.as_tensor(w), T0, T1, STEPS,
        METHOD)
    th = jax_adjoint(jax_params(p), jnp.asarray(x1), jnp.asarray(g1),
                     jnp.asarray(w))
    close(flat_torch(grads), flat_np(th))
    jz = j_odeint(lambda pp, t, x: j_apply(pp, x), jax_params(p),
                  jnp.asarray(x1), T1, T0, steps=STEPS, method=METHOD)
    close(z_back.T.numpy(), np.asarray(jz).reshape(B, 2 * N))


# ---- the slice as a whole: one ground-state update ----


def test_gs_update_matches_jax():
    """One update of the port's kernel chain in its plain versions
    (``loss_metrics_grads_cm``: Slater VGH -> Hessian flow -> REINFORCE
    adjoint) at N = 10, Z = 0.5 against the JAX reference: E and E_std from
    ``local_energy_from_base``, the loss sum((Eloc - E) / B log p), and the
    gradient by the continuous adjoint from x and grad log p."""
    model, jmodel = models(0.5)
    z_cm = equilibrated(N, 0, 45)
    p = np_params(46)
    loss, m, grads = model.loss_metrics_grads_cm(torch_params(p), z_cm)
    jp = jax_params(p)
    x, eloc, logp, g = jmodel.local_energy_from_base(
        jp, jnp.asarray(z_cm.T.reshape(B, N, 2).numpy()), return_grad=True)
    E, E_std = jnp.mean(eloc), jnp.std(eloc)
    w = (eloc - E) / B
    close(float(m["E"]), float(E))
    close(float(m["E_std"]), float(E_std))
    close(float(loss), float(jnp.sum(w * logp)))
    close(flat_torch(grads), flat_np(jax_adjoint(jp, x, g, w)))


# ---- the identity-flow oracle ----


def test_identity_flow_eloc_is_30_at_z0():
    """Identity flow, no interaction, N = 10: every walker's Eloc is the
    sum of the ten lowest orbital energies, 1 + 2*2 + 3*3 + 4*4 = 30,
    through the port's plain kernel chain and through the JAX reference."""
    model, jmodel = models(0.0)
    z_cm = equilibrated(N, 0, 47)
    params = backflow_init_zeros(8, 8)
    _, eloc, _, _ = model.local_energy_cm(params, z_cm)
    np.testing.assert_allclose(eloc.numpy(), 30.0, rtol=0, atol=1e-9)
    jzero = jax_params(np_params(0, std=0.0))
    _, jeloc, _ = jmodel.local_energy_from_base(
        jzero, jnp.asarray(z_cm.T.reshape(B, N, 2).numpy()))
    np.testing.assert_allclose(np.asarray(jeloc), 30.0, rtol=0, atol=1e-9)


# ---- what the kernels are built for ----


@pytest.mark.parametrize("n", [7, 8, 9, 10])
def test_n7_to_10_lane_plans_own_everything_once(n):
    """The N >= 7 lane plans of the Hessian flow (a warp per walker, its
    pair and one-body MLP inputs in one list) and the adjoint (16 lanes,
    pairs in chunks of 16, 48 of 50 units dealt and the last 2 run by every
    lane): every item has one owner, in a slot the kernel compiles."""
    d = 2 * n
    P = n * (n - 1) // 2
    assert hf.lanes_for(n) == 32 and rf.lanes_for(n) == 16
    hplan = hf.lane_plan(n)
    inputs, slots = hplan.pop("mlp_inputs")
    owned = sorted(i for items in inputs for i, _ in items)
    assert owned == sorted([("pair", p) for p in range(P)]
                           + [("one_body", i) for i in range(n)])
    for items in inputs:
        used = [s for _, s in items]
        assert len(set(used)) == len(used) and all(0 <= s < slots
                                                   for s in used)
    for plan, counts, last in (
            (hplan, {"entries": 2 * d + 1 + d * (d + 1) // 2}, {}),
            (rf.lane_plan(n, 50, 50), {"entries": 2 * d, "eta_units": 48,
                                       "mu_units": 48, "pairs": P,
                                       "one_body": n},
             {"eta_last": [48, 49], "mu_last": [48, 49]})):
        assert set(plan) == set(counts) | set(last)
        for kind, count in counts.items():
            per_lane, slots = plan[kind]
            owned = sorted(i for items in per_lane for i, _ in items)
            assert owned == list(range(count)), kind
            for items in per_lane:
                used = [s for _, s in items]
                assert len(set(used)) == len(used) and all(
                    0 <= s < slots for s in used), kind
        for kind, units in last.items():
            per_lane, slots = plan[kind]
            assert slots == len(units) and all(
                items == list(zip(units, range(slots))) for items in per_lane)
    # The adjoint's pairs: 16 per chunk, one per lane (45 pairs, 3 chunks
    # at N = 10); the Hessian flow's state: 8 entries per lane at N = 10,
    # and its 55 MLP inputs 2 slots.
    assert rf.lane_plan(10, 50, 50)["pairs"][1] == 3
    assert hf.lane_plan(10)["entries"][1] == 8
    assert hf.lane_plan(10)["mlp_inputs"][1] == 2


def test_ground_state_kernels_take_n_up_to_10():
    """The occupations the CUDA wrappers accept: the closed shells to N = 6
    below order 3, to N = 10 below order 4; N = 11 or a higher order
    raises, never a quiet fall back to the plain version."""
    for n in (2, 6, 7, 10):
        q = qnums(n, 0)
        check_gs_occupation("sampler", q["nx_occ"], q["ny_occ"])
    q10 = qnums(10, 0)
    with pytest.raises(ValueError, match="N ≤ 10"):
        check_gs_occupation("sampler", q10["nx_occ"] + (0,),
                            q10["ny_occ"] + (4,))
    with pytest.raises(ValueError, match="N ≤ 10"):
        check_gs_occupation("Slater VGH", (0, 0, 1, 0, 1, 3),
                            (0, 1, 0, 2, 1, 0))
