"""The PyTorch port's plain modules against the JAX package, float64, CPU.

Both packages get the same seeded numpy inputs.  The math is the same
closed form on both sides and only the order of floating-point sums
differs, so every comparison holds to 1e-9 relative (atol 1e-10 for
entries that are zero up to roundoff).
"""

import ast
import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fermiflow_tpu.config import Config as JConfig
from fermiflow_tpu.flow import CNF as JCNF
from fermiflow_tpu.nn import backflow as jbf
from fermiflow_tpu.nn import mlp as jmlp
from fermiflow_tpu.nn.backflow_derivs import backflow_field_tensors as j_ft
from fermiflow_tpu.ode import TABLEAUS as J_TABLEAUS
from fermiflow_tpu.ode import odeint as j_odeint
from fermiflow_tpu.ops import logdet as jlogdet
from fermiflow_tpu.physics import HO2D as JHO2D
from fermiflow_tpu.physics import CoulombPairPotential as JCoulomb
from fermiflow_tpu.physics import FreeFermion as JFreeFermion
from fermiflow_tpu.physics import HOPotential as JHO
from fermiflow_tpu.physics import hermite_functions as j_hermite
from fermiflow_tpu.physics import slater as jslater
from fermiflow_tpu.vmc import hessian_flow as jhf

from fermiflow_tpu_torch.config import Config
from fermiflow_tpu_torch.flow import CNF
from fermiflow_tpu_torch.nn import backflow as tbf
from fermiflow_tpu_torch.nn import mlp as tmlp
from fermiflow_tpu_torch.nn.backflow_derivs import backflow_field_tensors
from fermiflow_tpu_torch.ode import TABLEAUS, odeint
from fermiflow_tpu_torch.ops import logdet
from fermiflow_tpu_torch.physics import (
    HO2D,
    CoulombPairPotential,
    FreeFermion,
    HOPotential,
    hermite_functions,
)
from fermiflow_tpu_torch.physics import slater
from fermiflow_tpu_torch.vmc import hessian_flow as thf

from _torch_port import jax_params, np_params, torch_params, walkers

RTOL, ATOL = 1e-9, 1e-10


def close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(
        t.detach().numpy() if isinstance(t, torch.Tensor) else t,
        np.asarray(j), rtol=rtol, atol=atol)


def T(a):
    return torch.as_tensor(a)


def jit(fn, *args):
    """Run a JAX function as one compiled program: far cheaper to compile
    at test sizes than op-by-op dispatch."""
    return jax.jit(fn)(*(jnp.asarray(a) for a in args))


# ---- config.py ----


def test_config_json_round_trips_between_packages():
    cfg = Config(nup=3, Z=0.25, d_mu=None, batch=64, dtype="float32",
                 device="cpu")
    jcfg = JConfig.from_json(cfg.to_json())
    assert json.loads(jcfg.to_json()) == json.loads(cfg.to_json())
    back = Config.from_json(JConfig(nup=5, persistent_walkers=True).to_json())
    assert back.nup == 5 and back.persistent_walkers and back.device == "cuda"
    assert cfg.torch_dtype() == torch.float32
    with pytest.raises(ValueError, match="bfloat16"):
        Config(dtype="bfloat16").torch_dtype()


# ---- physics/orbitals.py ----


@pytest.mark.parametrize(
    "N,deltaE,count",
    [(3, 2, 21), (6, 2, 54), (6, 4, 524), (10, 4, 1781)],
)
def test_state_enumeration_matches_jax(N, deltaE, count):
    occ, Es = HO2D().fermion_states(N, 0, deltaE)
    jocc, jEs = JHO2D().fermion_states(N, 0, deltaE)
    assert occ.shape == (count, N)
    np.testing.assert_array_equal(occ, jocc)  # same state order
    np.testing.assert_array_equal(Es, jEs)


def test_orbitals_match_jax():
    orb, jorb = HO2D(), JHO2D()
    np.testing.assert_array_equal(orb.nx, jorb.nx)
    np.testing.assert_array_equal(orb.ny, jorb.ny)
    np.testing.assert_array_equal(orb.Es, jorb.Es)
    for n in range(5):
        assert orb.E_indices(n) == jorb.E_indices(n)
    x = walkers(0, 16, 4)
    close(hermite_functions(T(x[..., 0]), 8), j_hermite(jnp.asarray(x[..., 0]), 8))
    occ = [0, 2, 4, 7]
    close(orb.eval_orbitals(occ, T(x)), jorb.eval_orbitals(occ, jnp.asarray(x)))


# ---- physics/potentials.py ----


def test_potentials_match_jax():
    x = walkers(1, 16, 4)
    xd = x.reshape(16, 8).T
    for tp, jp in ((HOPotential(), JHO()),
                   (CoulombPairPotential(0.7), JCoulomb(0.7))):
        close(tp.V(T(x)), jp.V(jnp.asarray(x)))
        close(tp.V_rows(T(xd), 4, 2), jp.V_rows(jnp.asarray(xd), 4, 2))
        close(tp.V_rows(T(xd), 4, 2), tp.V(T(x)))


# ---- ops/logdet.py ----


def test_logdet_matches_jax():
    D = np.random.default_rng(2).standard_normal((32, 5, 5))
    close(logdet.logabsdet(T(D)), jit(jlogdet.logabsdet, D))
    close(logdet.gauss_jordan_inv(T(D)), jit(jlogdet.gauss_jordan_inv, D),
          rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(
        logdet.logabsdet(T(D)).numpy(), np.linalg.slogdet(D)[1], rtol=1e-10)


# ---- physics/slater.py and physics/base_dist.py ----


def test_slater_derivs_and_logdet_vgh_match_jax():
    orb, jorb = HO2D(), JHO2D()
    occ = np.arange(4)
    x = walkers(3, 16, 4)
    derivs = slater.slater_derivs(orb, occ, T(x))
    jderivs = jit(lambda xx: jslater.slater_derivs(jorb, occ, xx), x)
    for a, b in zip(derivs, jderivs):
        close(a, b)
    for a, b in zip(slater.logdet_vgh(*derivs),
                    jit(jslater.logdet_vgh, *jderivs)):
        close(a, b, rtol=1e-8, atol=1e-8)
    close(slater.log_abs_slater_det(orb, occ, T(x)),
          jit(lambda xx: jslater.log_abs_slater_det(jorb, occ, xx), x))


@pytest.mark.parametrize("nup,ndown", [(3, 0), (2, 1)])
def test_free_fermion_log_prob_and_vgh_match_jax(nup, ndown):
    bd, jbd = FreeFermion(HO2D()), JFreeFermion(JHO2D())
    up, dn = np.arange(nup), np.arange(ndown)
    x = walkers(4, 32, nup + ndown)
    close(bd.log_prob(up, dn, T(x)), jit(lambda xx: jbd.log_prob(up, dn, xx), x))
    for a, b in zip(bd.log_prob_vgh(up, dn, T(x)),
                    jit(lambda xx: jbd.log_prob_vgh(up, dn, xx), x)):
        close(a, b, rtol=1e-8, atol=1e-8)


# ---- nn/mlp.py, nn/backflow.py, nn/backflow_derivs.py ----


def test_mlp_matches_jax():
    p = np_params(5)["eta"]
    tp = {k: T(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    r = np.abs(walkers(5, 8, 3))[..., 0]
    close(tmlp.mlp_apply(tp, T(r[..., None])), jmlp.mlp_apply(jp, jnp.asarray(r[..., None])))
    close(tmlp.mlp_grad(tp, T(r[..., None])), jmlp.mlp_grad(jp, jnp.asarray(r[..., None])))
    for a, b in zip(tmlp.mlp_derivs3(tp, T(r)), jmlp.mlp_derivs3(jp, jnp.asarray(r))):
        close(a, b)
    z = tmlp.mlp_init_zeros(1, 4)
    assert all(float(v.abs().sum()) == 0 for v in z.values())
    g = tmlp.mlp_init_gaussian(torch.Generator().manual_seed(0), 1, 4, std=1e-3)
    assert g["w1"].shape == (1, 4) and g["b1"].shape == (4,) and g["w2"].shape == (4, 1)


@pytest.mark.parametrize("d_mu", [8, None])
def test_backflow_matches_jax(d_mu):
    p = np_params(6, d_mu=d_mu)
    x = walkers(6, 16, 4)
    close(tbf.backflow_apply(torch_params(p), T(x)),
          jbf.backflow_apply(jax_params(p), jnp.asarray(x)))
    close(tbf.backflow_divergence(torch_params(p), T(x)),
          jbf.backflow_divergence(jax_params(p), jnp.asarray(x)))
    # The Backflow module's live parameter view and the numpy round trip.
    flow = tbf.Backflow(torch_params(p))
    back = tbf.params_to_numpy(flow.params())
    np.testing.assert_array_equal(back["eta"]["w1"], p["eta"]["w1"])
    assert (back["mu"] is None) == (d_mu is None)
    zeros = tbf.backflow_init_zeros(8, d_mu)
    close(tbf.backflow_apply(zeros, T(x)), np.zeros_like(x), atol=0)


@pytest.mark.parametrize("d_mu", [8, None])
def test_field_tensors_match_jax(d_mu):
    p = np_params(7, d_mu=d_mu)
    x, g = walkers(7, 16, 4), walkers(8, 16, 4)
    ft = backflow_field_tensors(torch_params(p), T(x), T(g))
    jft = jax.jit(j_ft)(jax_params(p), jnp.asarray(x), jnp.asarray(g))
    assert set(ft) == set(jft)
    for k in ft:
        close(ft[k], jft[k], rtol=1e-8, atol=1e-9)


# ---- ode/integrators.py and flow/cnf.py ----


def test_tableaus_match_jax():
    assert set(TABLEAUS) == set(J_TABLEAUS)
    for k, tab in TABLEAUS.items():
        assert tab.a == J_TABLEAUS[k].a and tab.b == J_TABLEAUS[k].b
        assert tab.c == J_TABLEAUS[k].c and tab.stages == J_TABLEAUS[k].stages


@pytest.mark.parametrize("method", ["euler", "midpoint", "rk4", "dopri5"])
def test_odeint_matches_jax(method):
    """A time-dependent backflow ODE, forward and backward in time."""
    p = np_params(9)
    x = walkers(9, 8, 3)

    def f(pp, t, s):
        xx, lp = s
        return (tbf.backflow_apply(pp, xx) * (1 + t), -tbf.backflow_divergence(pp, xx))

    def jf(pp, t, s):
        xx, lp = s
        return (jbf.backflow_apply(pp, xx) * (1 + t), -jbf.backflow_divergence(pp, xx))

    for t0, t1 in ((0.0, 1.0), (1.0, 0.0)):
        out = odeint(f, torch_params(p), (T(x), torch.zeros(8, dtype=torch.float64)),
                     t0, t1, steps=3, method=method)
        jout = j_odeint(jf, jax_params(p), (jnp.asarray(x), jnp.zeros(8)),
                        t0, t1, steps=3, method=method)
        for a, b in zip(out, jout):
            close(a, b)


def test_cnf_generate_and_delta_logp_match_jax():
    p = np_params(10)
    z = walkers(10, 8, 3)
    cnf = CNF(tbf.backflow_apply, tbf.backflow_divergence, steps=3)
    jcnf = JCNF(jbf.backflow_apply, jbf.backflow_divergence, steps=3)
    x = cnf.generate(torch_params(p), T(z))
    close(x, jcnf.generate(jax_params(p), jnp.asarray(z)))
    for a, b in zip(cnf.delta_logp(torch_params(p), x),
                    jcnf.delta_logp(jax_params(p), jnp.asarray(x.numpy()))):
        close(a, b)


# ---- vmc/hessian_flow.py ----


@pytest.mark.parametrize("d_mu", [8, None])
def test_hessian_flow_and_local_energy_match_jax(d_mu):
    p = np_params(11, d_mu=d_mu)
    bd, jbd = FreeFermion(HO2D()), JFreeFermion(JHO2D())
    up = np.arange(3)
    z = walkers(11, 16, 3)
    y0, g0, H0 = bd.log_prob_vgh(up, (), T(z))
    out = thf.hessian_flow(backflow_field_tensors, torch_params(p), T(z), y0, g0,
                           H0, 0.0, 1.0, steps=2, method="dopri5")
    jout = jax.jit(lambda pp, zz: jhf.hessian_flow(
        j_ft, pp, zz, *jbd.log_prob_vgh(up, (), zz), 0.0, 1.0, steps=2,
        method="dopri5"))(jax_params(p), jnp.asarray(z))
    for a, b in zip(out, jout):
        close(a, b, rtol=1e-8, atol=1e-8)

    pot, jpot = CoulombPairPotential(0.5), JCoulomb(0.5)
    res = thf.local_energy_flow(
        backflow_field_tensors, lambda zz: bd.log_prob_vgh(up, (), zz), pot,
        torch_params(p), T(z), 0.0, 1.0, steps=2, method="dopri5",
        return_grad=True)
    jres = jax.jit(lambda pp, zz: jhf.local_energy_flow(
        j_ft, lambda zs: jbd.log_prob(up, (), zs), jpot, pp, zz, 0.0, 1.0,
        steps=2, method="dopri5", return_grad=True,
        base_vgh=lambda z_: jbd.log_prob_vgh(up, (), z_)))(
            jax_params(p), jnp.asarray(z))
    for a, b in zip(res, jres):
        close(a, b, rtol=1e-8, atol=1e-8)


# ---- import hygiene ----


def test_port_imports_neither_jax_nor_the_jax_package():
    """An AST scan of every file of the port and of chip_smoke.py."""
    root = pathlib.Path(__file__).resolve().parent.parent
    files = sorted((root / "fermiflow_tpu_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    assert len(files) > 20
    banned = ("jax", "jaxlib", "optax", "fermiflow_tpu")
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in banned, f"{path}: imports {name}"
