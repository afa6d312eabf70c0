"""The port's kernel modules, through their plain versions, against the
JAX package's Pallas kernels run in interpret mode (float32, CPU).

The CUDA kernels run only on the card (``chip_smoke.py`` holds them against
these plain versions there).  Here a CPU tensor takes each wrapper's plain
path, which must reproduce the TPU kernel's arithmetic.  Tolerances are
those of the JAX package's own interpret tests of the same kernel
(tests/test_pallas_*.py, tests/test_hessian_flow.py), or tighter.

Every Pallas call uses one set of shapes (N=3, B=64, d_eta=d_mu=8, dopri5,
2 steps) and the call signature ``GSVMC.loss_metrics_grads_pallas`` uses, so
the whole-update tests at the end (ground state and finite T, N=3 with
deltaE=2: 21 states) reuse the compiled interpret programs.
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
from fermiflow_tpu.ops.pallas_metropolis import metropolis_free_fermion as j_single
from fermiflow_tpu.ops.pallas_metropolis import metropolis_free_fermion_chains as j_chains
from fermiflow_tpu.ops.pallas_metropolis import (
    metropolis_free_fermion_multistate as j_multistate,
)
from fermiflow_tpu.ops.pallas_reinforce import reinforce_flow_grad_pallas
from fermiflow_tpu.ops.pallas_slater_vgh import slater_vgh_ms_pallas, slater_vgh_pallas
from fermiflow_tpu.physics import HO2D as JHO2D
from fermiflow_tpu.physics import CoulombPairPotential as JCoulomb
from fermiflow_tpu.physics import FreeFermion as JFreeFermion
from fermiflow_tpu.physics import HOPotential as JHO
from fermiflow_tpu.vmc import BetaVMC as JBetaVMC
from fermiflow_tpu.vmc import GSVMC as JGSVMC

from fermiflow_tpu_torch.flow import CNF
from fermiflow_tpu_torch.nn.backflow import (
    Backflow,
    backflow_apply,
    backflow_divergence,
)
from fermiflow_tpu_torch.nn.backflow_derivs import backflow_field_tensors
from fermiflow_tpu_torch.ode import odeint
from fermiflow_tpu_torch.ops.hessian_flow import (
    hessian_flow_packed,
    lane_plan,
    reciprocal_margin,
)
from fermiflow_tpu_torch.ops.metropolis import (
    metropolis_chains,
    metropolis_free_fermion,
    metropolis_free_fermion_chains,
    metropolis_free_fermion_multistate,
    metropolis_multistate_cm,
)
from fermiflow_tpu_torch.ops.reinforce import block_sum, reinforce_flow_grad
from fermiflow_tpu_torch.ops.reinforce import lane_plan as reinforce_lane_plan
from fermiflow_tpu_torch.ops.slater_vgh import pack_triu, slater_vgh, slater_vgh_ms
from fermiflow_tpu_torch.physics import (
    HO2D,
    CoulombPairPotential,
    FreeFermion,
    HOPotential,
)
from fermiflow_tpu_torch.train import TrainState, _make_gs_update, make_adam
from fermiflow_tpu_torch.vmc import BetaVMC, GSVMC

from _torch_port import (
    flat_np,
    flat_torch,
    jax_params,
    np_params,
    torch_params,
    walkers,
)

torch.set_num_threads(1)


def finished(out):
    """``out`` once every array in it is computed.

    A Pallas call in interpret mode runs io_callbacks that dispatch JAX work
    of their own.  JAX work dispatched from the test's thread while those
    callbacks run can deadlock the CPU client: ``optax``'s update right after
    ``loss_metrics_grads_pallas``, both eager, hung about one run in ten.  So
    every interpret-mode result here is waited for before the next JAX call.
    """
    return jax.block_until_ready(out)


def finishing(fn):
    """``fn`` whose results are ``finished`` before it returns."""
    return lambda *args, **kwargs: finished(fn(*args, **kwargs))


B, STEPS, METHOD, T0, T1 = 64, 2, "dopri5", 0.0, 1.0
ORB = HO2D()
OCC_MS, _ = ORB.fermion_states(3, 0, 2.0)  # 21 states, quantum numbers < 4
KS_MS = 4


def ms_qnums(seed):
    """Uniformly drawn states of the N=3, deltaE=2 table and their (B, n)
    quantum numbers."""
    idx = np.random.default_rng(seed).integers(0, len(OCC_MS), B)
    occ = OCC_MS[idx]
    return idx, ORB.nx[occ].astype(np.int32), ORB.ny[occ].astype(np.int32)


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
    jy, jg, jH = finished(slater_vgh_pallas(jnp.asarray(z), nx_up, ny_up, ks,
                                            nx_dn, ny_dn, interpret=True))
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


# ---- kernel 6: Slater value / gradient / packed Hessian, per-walker states ----


def test_slater_vgh_ms_plain_matches_pallas_interpret():
    """The mixed-state VGH's plain version against ``slater_vgh_ms_pallas``
    (packed H) on walkers in uniformly drawn states, at the tolerances of
    tests/test_pallas_slater_vgh.py:117."""
    idx, nx, ny = ms_qnums(26)
    x = walkers(27, B, 3, dtype=np.float32)
    jy, jg, jH = finished(slater_vgh_ms_pallas(
        jnp.asarray(x), jnp.asarray(nx), jnp.asarray(ny), KS_MS,
        interpret=True, packed=True))
    y, g, Hp = slater_vgh_ms(torch.as_tensor(x), torch.as_tensor(nx),
                             torch.as_tensor(ny), KS_MS)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=3e-3, atol=3e-3)
    np.testing.assert_allclose(Hp.numpy(), np.asarray(jH), rtol=5e-3, atol=5e-3)


# ---- kernel 3: Hessian flow ----


def test_hessian_flow_plain_matches_pallas_interpret(inputs):
    z, p = inputs
    nx_up, ny_up, nx_dn, ny_dn, ks = qnums(3, 0)
    jz = jnp.asarray(z)
    jy, jg, jH = finished(slater_vgh_pallas(jz, nx_up, ny_up, ks, nx_dn, ny_dn,
                                            interpret=True))
    ref = finished(hessian_flow_pallas(jax_params(p), jz, jy, jg, jH, T0, T1,
                                       steps=STEPS, method=METHOD,
                                       interpret=True))
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


@pytest.mark.parametrize("n,lanes", [(n, lanes) for n in (2, 3, 4, 5, 6)
                                     for lanes in (4, 8)]
                         + [(n, 32) for n in (7, 8, 9, 10)])
def test_hessian_flow_lane_plan_owns_everything_once(n, lanes):
    # csrc/hessian_flow.cu deals state entries and MLP inputs over the lanes
    # of a walker's group; every item must have exactly one owner, in a
    # register slot the kernel compiles.  A lane's MLP inputs share one
    # hidden-unit loop: up to n = 6 its pairs in slots 0..QP-1, then its
    # one-body inputs from slot QP on; from n = 7 (a warp) the pairs and
    # then the particles as one list, so that no lane holds more than
    # ceil((P + n) / 32).
    d = 2 * n
    n_entries = 2 * d + 1 + d * (d + 1) // 2
    n_pairs = n * (n - 1) // 2
    qp, qn = -(-n_pairs // lanes), -(-n // lanes)
    plan = lane_plan(n, lanes)
    assert set(plan) == {"entries", "mlp_inputs"}
    per_lane, slots = plan["entries"]
    assert slots == -(-n_entries // lanes) and len(per_lane) == lanes
    assert sorted(e for items in per_lane for e, _ in items) \
        == list(range(n_entries))
    for lane, items in enumerate(per_lane):
        assert items == [(e, e // lanes) for e in range(lane, n_entries,
                                                        lanes)]
    per_lane, slots = plan["mlp_inputs"]
    assert len(per_lane) == lanes
    owned = sorted(item for items in per_lane for item, _ in items)
    assert owned == sorted([("pair", p) for p in range(n_pairs)]
                           + [("one_body", i) for i in range(n)])
    if lanes == 32:
        bound = -(-(n_pairs + n) // lanes)
        assert slots == bound
        inputs = [("pair", p) for p in range(n_pairs)] \
            + [("one_body", i) for i in range(n)]
        for lane, items in enumerate(per_lane):
            assert len(items) <= bound
            assert items == [(inputs[k], k // lanes)
                             for k in range(lane, n_pairs + n, lanes)]
        return
    assert slots == qp + qn
    for lane, items in enumerate(per_lane):
        pairs = [(p, slot) for (kind, p), slot in items if kind == "pair"]
        ones = [(i, slot) for (kind, i), slot in items if kind == "one_body"]
        assert items == [(("pair", p), s) for p, s in pairs] \
            + [(("one_body", i), s) for i, s in ones]
        assert pairs == [(p, p // lanes) for p in range(lane, n_pairs, lanes)]
        assert ones == [(i, qp + i // lanes) for i in range(lane, n, lanes)]
        assert all(s < slots for _, s in items)


@pytest.mark.parametrize("with_mu", [True, False])
def test_hessian_flow_reciprocal_margin(with_mu):
    # The largest r |w1|max + |b1|max over the batch's pair (eta) and
    # one-body (mu) inputs, and the share of walkers with every input under
    # the kernel's limit of 80, against a loop over walkers and inputs.
    gen = torch.Generator().manual_seed(5)
    z = 2.0 * torch.randn((64, 4, 2), generator=gen)
    p = {"eta": {"w1": torch.randn((1, 6), generator=gen),
                 "b1": torch.randn((6,), generator=gen)},
         "mu": ({"w1": torch.randn((1, 5), generator=gen),
                 "b1": torch.randn((5,), generator=gen)} if with_mu else None)}
    p["eta"]["w1"][0, 2] = -30.0  # some walkers past the limit
    got = reciprocal_margin(p, z)
    we, be = float(p["eta"]["w1"].abs().max()), float(p["eta"]["b1"].abs().max())
    per_walker = []
    for zw in z.tolist():
        sums = [np.hypot(zw[i][0] - zw[j][0], zw[i][1] - zw[j][1]) * we + be
                for i in range(4) for j in range(i + 1, 4)]
        if with_mu:
            wm = float(p["mu"]["w1"].abs().max())
            bm = float(p["mu"]["b1"].abs().max())
            sums += [np.hypot(*zw[i]) * wm + bm for i in range(4)]
        per_walker.append(max(sums))
    assert got["limit"] == 80.0
    assert got["largest"] == pytest.approx(max(per_walker), rel=1e-6)
    share = float(np.mean([s < 80.0 for s in per_walker]))
    assert 0.0 < share < 1.0 and got["share_under"] == share


@pytest.mark.parametrize("n,lanes", [(n, lanes) for n in (2, 3, 4, 5, 6)
                                     for lanes in (4, 8)]
                         + [(n, 16) for n in (7, 8, 9, 10)])
def test_reinforce_lane_plan_owns_everything_once(n, lanes):
    # csrc/reinforce.cu deals state entries and an MLP's first d - d % lanes
    # hidden units round robin, gives each lane a contiguous block of MLP
    # inputs to total, and has every lane run the last d % lanes units on
    # the inputs it totals; every item, and every (unit, input) term, must
    # have exactly one owner, in a register slot the kernel compiles.
    d = 50
    counts = {"entries": 4 * n, "eta_units": d - d % lanes,
              "mu_units": d - d % lanes, "pairs": n * (n - 1) // 2,
              "one_body": n}
    plan = reinforce_lane_plan(n, d, d, lanes)
    assert set(plan) == set(counts) | {"eta_last", "mu_last"}
    for kind, count in counts.items():
        per_lane, slots = plan[kind]
        assert len(per_lane) == lanes
        owned = [item for items in per_lane for item, _ in items]
        assert sorted(owned) == list(range(count))
        # Inputs: chunks of 16 (kChunkInputs), qc contiguous to a lane.
        qc = min(-(-count // lanes), 16 // lanes)
        for lane, items in enumerate(per_lane):
            assert [slot for _, slot in items] == list(range(len(items)))
            assert len(items) <= slots
            owner = (lambda i: i % (lanes * qc) // qc) \
                if kind in ("pairs", "one_body") else (lambda i: i % lanes)
            assert all(owner(item) == lane for item, _ in items)
        assert slots == -(-count // lanes)
    for mlp, inputs in (("eta", "pairs"), ("mu", "one_body")):
        terms = []
        last, slots = plan[f"{mlp}_last"]
        for lane in range(lanes):
            mine = [i for i, _ in plan[inputs][0][lane]]
            units = [u for u, _ in plan[f"{mlp}_units"][0][lane]]
            terms += [(u, i) for u in units for i in range(counts[inputs])]
            assert [j for _, j in last[lane]] == list(range(slots))
            terms += [(u, i) for u, _ in last[lane] for i in mine]
        assert sorted(terms) == [(u, i) for u in range(d)
                                 for i in range(counts[inputs])]
    # The production widths: 48 of the 50 units dealt, 2 left to every lane.
    assert [len(u) for u in plan["eta_units"][0]] == [48 // lanes] * lanes
    assert plan["eta_last"][1] == plan["mu_last"][1] == 2


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
    jgrads, jz = finished(reinforce_flow_grad_pallas(
        jax_params(p), jnp.asarray(x1), jnp.asarray(ghat), jnp.asarray(w),
        T0, T1, steps=STEPS, method=METHOD, interpret=True))
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
    jxs, jlp, jrate, jtau = finished(j_chains(
        jnp.asarray(x0), 7, jnp.asarray(tau0), steps, S, nx_up, ny_up, ks,
        interpret=True, nx_dn=nx_dn, ny_dn=ny_dn, target=0.5, gain=gain,
        reinit=reinit))
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


# ---- kernels 5 and 7: one fixed-tau chain, static and per-walker states ----


@pytest.mark.parametrize("steps", [0, 4])
@pytest.mark.parametrize("kind", ["single", "multistate"])
def test_single_chain_plain_matches_pallas_interpret(inputs, kind, steps):
    """The single-segment sampler (kernel 5) and the mixed-state sampler
    (kernel 7), plain versions, against the TPU kernels in interpret mode.

    At steps=0 the chain is its start: logp against the kernel's and against
    ``FreeFermion.log_prob[_multstates]`` (tests/test_pallas_metropolis.py:36
    and :76, atol 1e-4 and 1e-3).  At steps=4 both run on the interpreter's
    stubbed random stream, as the multi-segment test above."""
    z, _ = inputs
    x0 = 0.5 * z
    tau0 = np.linspace(0.05, 0.2, B).astype(np.float32)
    normals, uniforms = _interpret_noise(1, steps, 3)
    noise = (normals[0, :steps], uniforms[0])
    if kind == "single":
        nx_up, ny_up, _, _, ks = qnums(3, 0)
        jx, jlp, jacc = finished(j_single(jnp.asarray(x0), 7, jnp.asarray(tau0),
                                          steps, nx_up, ny_up, ks,
                                          interpret=True))
        x, lp, acc = metropolis_free_fermion(
            torch.as_tensor(x0), 7, torch.as_tensor(tau0), steps, nx_up,
            ny_up, ks, noise=noise)
        ref = JFreeFermion(JHO2D()).log_prob(np.arange(3), (),
                                             jnp.asarray(x0, jnp.float64))
        ref_atol = 1e-4
    else:
        idx, nx, ny = ms_qnums(28)
        jx, jlp, jacc = finished(j_multistate(
            jnp.asarray(x0), 7, jnp.asarray(tau0), steps, jnp.asarray(nx),
            jnp.asarray(ny), KS_MS, interpret=True))
        x, lp, acc = metropolis_free_fermion_multistate(
            torch.as_tensor(x0), 7, torch.as_tensor(tau0), steps,
            torch.as_tensor(nx), torch.as_tensor(ny), KS_MS, noise=noise)
        ref = JFreeFermion(JHO2D()).log_prob_multstates(
            jnp.asarray(OCC_MS), jnp.asarray(idx), jnp.asarray(x0, jnp.float64))
        ref_atol = 1e-3
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    if steps == 0:
        np.testing.assert_array_equal(x.numpy(), x0)
        np.testing.assert_allclose(lp.numpy(), np.asarray(ref), atol=ref_atol)
    else:
        assert 0.0 < float(acc.mean()) < 1.0


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
    # The JAX update calls this method, then optax: see ``finished``.
    jmodel.loss_metrics_grads_pallas = finishing(jmodel.loss_metrics_grads_pallas)
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


def test_beta_update_and_adam_match_jax_pallas_path():
    """The port's finite-T no-autograd update (``BetaVMC.loss_metrics_grads_cm``:
    mixed-state VGH -> Hessian flow -> Eloc -> phi loss and per-state
    baseline -> REINFORCE adjoint; plain versions, f32) against the JAX
    package's ``loss_metrics_grads_pallas`` in interpret mode, on walkers
    equilibrated in their own states, then one Adam step on each side.

    Tolerances as the ground-state update's above: E, F, S and their spreads
    1e-5; loss, every flow gradient leaf and the logits gradient rtol 1e-4,
    atol 1e-6; parameters after Adam rtol 1e-5, atol 1e-7.  The exception
    is the logit of a state no walker is in: its gradient is -p_s sum(Floc
    - F) / B, zero but for f32 roundoff of opposite sign in the two
    packages, and Adam's first step moves it by lr times that sign, so
    there each side is held to a move of at most lr."""
    p = np_params(29, dtype=np.float32)
    idx, _, _ = ms_qnums(30)
    cnf = CNF(backflow_apply, backflow_divergence, backflow_field_tensors,
              steps=STEPS, method=METHOD)
    model = BetaVMC(2.0, 3, 0, 2.0, ORB, FreeFermion(ORB), cnf,
                    CoulombPairPotential(0.5), HOPotential())
    jcnf = JCNF(j_apply, j_div, j_ft, steps=STEPS, method=METHOD)
    jorb = JHO2D()
    jmodel = JBetaVMC(2.0, 3, 0, 2.0, jorb, JFreeFermion(jorb), jcnf,
                      JCoulomb(0.5), JHO())
    nx_cm, ny_cm = model.qnums_cm(torch.as_tensor(idx))
    z0 = torch.as_tensor(walkers(31, B, 3).reshape(B, 6).T.copy())
    z_cm, _, _ = metropolis_multistate_cm(
        z0, torch.full((B,), 0.3, dtype=torch.float64), 31, steps=100,
        nx_cm=nx_cm, ny_cm=ny_cm, num_shells=KS_MS)
    z_cm = z_cm.float().contiguous()
    z = z_cm.T.reshape(B, 3, 2).numpy()
    logits = (0.3 * np.random.default_rng(32).standard_normal(len(OCC_MS))
              ).astype(np.float32)

    jparams = {"flow": jax_params(p), "log_state_weights": jnp.asarray(logits)}
    jloss, jm, jgrads = finished(jmodel.loss_metrics_grads_pallas(
        jparams, jnp.asarray(idx), jnp.asarray(z), pallas_interpret=True))
    flow = Backflow(torch_params(p, torch.float32))
    lg = torch.nn.Parameter(torch.tensor(logits))
    params = {"flow": flow.params(), "log_state_weights": lg}
    loss, m, grads = model.loss_metrics_grads_cm(params, torch.as_tensor(idx),
                                                 z_cm)
    for key in ("E", "E_std", "F", "F_std", "S", "S_analytical"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(flat_torch(grads["flow"]),
                               flat_np(jgrads["flow"]), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(grads["log_state_weights"].numpy(),
                               np.asarray(jgrads["log_state_weights"]),
                               rtol=1e-4, atol=1e-6)

    jopt = optax.adam(1e-3)
    updates, _ = jopt.update(jgrads, jopt.init(jparams), jparams)
    jnew = optax.apply_updates(jparams, updates)
    opt = make_adam(flow, 1e-3, extra=[lg])
    for name, mod in (("eta", flow.eta), ("mu", flow.mu)):
        for k, v in mod.items():
            v.grad = grads["flow"][name][k]
    lg.grad = grads["log_state_weights"]
    opt.step()
    np.testing.assert_allclose(flat_torch(flow.params()), flat_np(jnew["flow"]),
                               rtol=1e-5, atol=1e-7)
    occupied = np.bincount(idx, minlength=len(OCC_MS)) > 0
    assert not occupied.all()
    new, jnew_lg = lg.detach().numpy(), np.asarray(jnew["log_state_weights"])
    np.testing.assert_allclose(new[occupied], jnew_lg[occupied], rtol=1e-5,
                               atol=1e-7)
    for moved in (new - logits, jnew_lg - logits):
        assert np.abs(moved[~occupied]).max() <= 1e-3 * (1 + 1e-5)
