"""Public names of the JAX package that the port had lacked, against the JAX
functions on the CPU in float64:

* ``vmc/hessian_flow.base_val_grad_hess``, the nested-autodiff base
  (logp, grad, Hessian), and ``local_energy_flow``'s fallback to it when no
  closed-form ``base_vgh`` is given;
* ``MetricsLogger.log``, the one-iteration record of the loop at
  ``--steps-per-call 1`` (the first record carries no timing);
* ``BetaVMC.potential``.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fermiflow_tpu.cli import common as jcommon
from fermiflow_tpu.cli import ground_state as jground_state
from fermiflow_tpu.config import Config as JConfig
from fermiflow_tpu.nn.backflow_derivs import backflow_field_tensors as j_ft
from fermiflow_tpu.physics import HO2D as JHO2D
from fermiflow_tpu.physics import CoulombPairPotential as JCoulomb
from fermiflow_tpu.physics import FreeFermion as JFreeFermion
from fermiflow_tpu.utils import MetricsLogger as JMetricsLogger
from fermiflow_tpu.vmc import hessian_flow as jhf

from fermiflow_tpu_torch.cli import common, ground_state
from fermiflow_tpu_torch.config import Config
from fermiflow_tpu_torch.nn.backflow_derivs import backflow_field_tensors
from fermiflow_tpu_torch.physics import HO2D, CoulombPairPotential, FreeFermion
from fermiflow_tpu_torch.utils import MetricsLogger
from fermiflow_tpu_torch.vmc import hessian_flow as thf

from _torch_port import jax_params, np_params, torch_params, walkers

torch.set_num_threads(1)

OCCS = [(3, 0), (2, 1)]


def close(t, j, rtol=1e-9, atol=1e-10):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("nup,ndown", OCCS)
def test_base_val_grad_hess_matches_jax_and_the_closed_form(nup, ndown):
    bd, jbd = FreeFermion(HO2D()), JFreeFermion(JHO2D())
    up, dn = np.arange(nup), np.arange(ndown)
    z = walkers(5, 16, nup + ndown)
    out = thf.base_val_grad_hess(lambda zs: bd.log_prob(up, dn, zs),
                                 torch.as_tensor(z))
    jout = jax.jit(lambda zz: jhf.base_val_grad_hess(
        lambda zs: jbd.log_prob(up, dn, zs), zz))(jnp.asarray(z))
    assert [t.shape for t in out] == [(16,), (16, 2 * (nup + ndown)),
                                      (16, 2 * (nup + ndown),
                                       2 * (nup + ndown))]
    for a, b in zip(out, jout):
        close(a, b, rtol=1e-9, atol=1e-9)
    for a, b in zip(out, bd.log_prob_vgh(up, dn, torch.as_tensor(z))):
        close(a, b.numpy(), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("nup,ndown", OCCS)
def test_local_energy_flow_falls_back_to_nested_autodiff(nup, ndown):
    """``base_vgh=None``: the port's Hessian flow from ``base_val_grad_hess``
    equals the JAX function's fallback and the closed-form route."""
    bd, jbd = FreeFermion(HO2D()), JFreeFermion(JHO2D())
    up, dn = np.arange(nup), np.arange(ndown)
    p = np_params(3)
    z = walkers(7, 16, nup + ndown)
    pot, jpot = CoulombPairPotential(0.5), JCoulomb(0.5)
    kw = dict(steps=2, method="dopri5", return_grad=True)
    res = thf.local_energy_flow(
        backflow_field_tensors, None, pot, torch_params(p), torch.as_tensor(z),
        0.0, 1.0, base_logp_single=lambda zs: bd.log_prob(up, dn, zs), **kw)
    closed = thf.local_energy_flow(
        backflow_field_tensors, lambda zz: bd.log_prob_vgh(up, dn, zz), pot,
        torch_params(p), torch.as_tensor(z), 0.0, 1.0, **kw)
    jres = jax.jit(lambda pp, zz: jhf.local_energy_flow(
        j_ft, lambda zs: jbd.log_prob(up, dn, zs), jpot, pp, zz, 0.0, 1.0,
        **kw))(jax_params(p), jnp.asarray(z))
    for a, b, c in zip(res, jres, closed):
        close(a, b, rtol=1e-8, atol=1e-8)
        close(a, c.detach().numpy(), rtol=1e-8, atol=1e-8)
    with pytest.raises(ValueError, match="base_vgh or base_logp_single"):
        thf.local_energy_flow(backflow_field_tensors, None, pot,
                              torch_params(p), torch.as_tensor(z), 0.0, 1.0)


def test_metrics_logger_log_matches_jax(tmp_path):
    """Both loggers on the same metrics (tensors in the port, arrays in the
    JAX package): the same records but for the wall times, no timing on the
    first, both timing keys from the second on, one JSON line each."""
    metrics = [{"E": 5.25, "E_std": 0.5, "accept_rate": 0.8, "loss": -0.1},
               {"E": 5.125, "E_std": 0.25, "accept_rate": 0.75, "loss": 0.2}]
    port = MetricsLogger(str(tmp_path / "port.jsonl"))
    ref = JMetricsLogger(str(tmp_path / "jax.jsonl"))
    for step, m in enumerate(metrics, start=1):
        rec = port.log(step, {k: torch.tensor([v], dtype=torch.float64)
                              for k, v in m.items()})
        jrec = ref.log(step, {k: jnp.asarray(v) for k, v in m.items()})
        assert rec.keys() == jrec.keys()
        assert {k: rec[k] for k in m} == {k: jrec[k] for k in m} == m
    port.close()
    ref.close()
    rows = [json.loads(s) for s in (tmp_path / "port.jsonl").read_text()
            .splitlines()]
    jrows = [json.loads(s) for s in (tmp_path / "jax.jsonl").read_text()
             .splitlines()]
    assert [r.keys() for r in rows] == [r.keys() for r in jrows]
    assert "iter_seconds" not in rows[0] and "iter_seconds" in rows[1]


def test_k1_cli_rows_have_the_jax_keys(tmp_path):
    """The two ground-state CLIs at ``--steps-per-call 1``: their metrics
    rows have the same key sets, row by row."""
    argv = ["--nup", "2", "--Z", "0.5", "--batch", "16", "--iternum", "3",
            "--Deta", "4", "--Dmu", "4", "--ode-steps", "1", "--mcmc-steps",
            "2", "--equilibrium-steps", "2", "--dtype", "float64", "--lr",
            "1e-3", "--persistent", "--steps-per-call", "1"]
    ground_state.main(argv + ["--device", "cpu", "--metrics",
                              str(tmp_path / "port.jsonl")])
    jground_state.main(argv + ["--metrics", str(tmp_path / "jax.jsonl")])
    keys = [[sorted(json.loads(s)) for s in (tmp_path / f).read_text()
             .splitlines()] for f in ("port.jsonl", "jax.jsonl")]
    assert len(keys[0]) == 3
    assert keys[0] == keys[1]


def test_beta_potential_matches_jax():
    base = dict(nup=3, Z=0.7, beta=2.0, deltaE=2.0, batch=16, d_eta=8,
                d_mu=8, dtype="float64", seed=0)
    model, _ = common.build_beta(Config(device="cpu", **base))
    jmodel, _ = jcommon.build_beta(JConfig(**base))
    x = walkers(9, 16, 3)
    close(model.potential(torch.as_tensor(x)),
          jax.jit(jmodel.potential)(jnp.asarray(x)))
    # Pair plus single-particle potential, as the ground state's.
    close(model.potential(torch.as_tensor(x)),
          (model.pair_potential(torch.as_tensor(x))
           + model.sp_potential(torch.as_tensor(x))).numpy())
