"""The nested-jvp local-energy engine of ``fermiflow_tpu_torch`` against the
JAX package's (``vmc/local_energy.py``, ``GSVMC``/``BetaVMC.loss_and_metrics``).

The same seeded numpy walkers and flow weights go through both packages in
float64 at N = 2-3, widths 8, one dopri5 step.  Each JAX reference is one
jitted program (module fixtures), so the comparisons share its compile.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fermiflow_tpu.cli import common as jcommon
from fermiflow_tpu.config import Config as JConfig
from fermiflow_tpu.nn.backflow import backflow_apply as jbackflow_apply
from fermiflow_tpu.vmc.local_energy import divergence_fwd as jdivergence_fwd
from fermiflow_tpu.vmc.local_energy import y_grad_laplacian as jy_grad_laplacian

from fermiflow_tpu_torch.cli import common
from fermiflow_tpu_torch.config import Config
from fermiflow_tpu_torch.nn.backflow import backflow_apply, backflow_divergence
from fermiflow_tpu_torch.ops.logdet import gauss_jordan_inv, logabsdet
from fermiflow_tpu_torch.train import init_gs_state, make_gs_train_step
from fermiflow_tpu_torch.vmc.local_energy import (
    divergence_fwd,
    y_grad_laplacian,
)

from _torch_port import flat_np, flat_torch, jax_params, np_params, torch_params
from _torch_port import walkers as np_walkers

B = 8
RTOL = 1e-10  # the engine against JAX's
RTOL_LOSS = 1e-8  # loss, metrics and gradients against JAX autodiff


def configs(**kw):
    base = dict(nup=3, Z=0.5, d_eta=8, d_mu=8, ode_steps=1, dtype="float64",
                batch=B)
    base.update(kw)
    return Config(device="cpu", **base), JConfig(**base)


def close(t, j, rtol):
    np.testing.assert_allclose(np.asarray(t.detach()), np.asarray(j),
                               rtol=rtol, atol=rtol)


@pytest.fixture(scope="module")
def gs():
    """Port and JAX GS models, inputs, and the JAX engine's outputs, loss
    and gradients from one jitted program."""
    cfg, jcfg = configs(nup=2)
    model, _ = common.build_gs(cfg)
    jmodel, _ = jcommon.build_gs(jcfg)
    p = np_params(3)
    x = np_walkers(4, B, 2)

    @jax.jit
    def ref(pp, xx):
        ygl = jy_grad_laplacian(lambda xs: jmodel.log_prob(pp, xs), xx)
        (loss, m), grads = jax.value_and_grad(
            jmodel.loss_and_metrics, has_aux=True)(pp, xx)
        div = jdivergence_fwd(lambda xs: jbackflow_apply(pp, xs), xx)
        return ygl, loss, m, grads, div

    return model, p, x, jax.device_get(ref(jax_params(p), jnp.asarray(x)))


@pytest.mark.parametrize("mode,chunk", [("fwdfwd", None), ("fwdfwd", 4),
                                        ("fwdrev", None)])
def test_y_grad_laplacian_matches_jax(gs, mode, chunk):
    model, p, x, (jygl, *_) = gs
    params = torch_params(p)
    out = y_grad_laplacian(lambda xs: model.log_prob(params, xs),
                           torch.as_tensor(x), chunk_size=chunk, mode=mode)
    for t, j in zip(out, jygl):
        assert t.shape == j.shape
        close(t, j, RTOL)


def test_y_grad_laplacian_rejects_ragged_chunks(gs):
    model, p, x, _ = gs
    with pytest.raises(ValueError, match="not divisible"):
        y_grad_laplacian(lambda xs: xs.sum(), torch.as_tensor(x), chunk_size=3)


def test_divergence_fwd_matches_jax_and_closed_form(gs):
    _, p, x, (*_, jdiv) = gs
    params = torch_params(p)
    xt = torch.as_tensor(x)
    div = divergence_fwd(lambda xs: backflow_apply(params, xs), xt)
    close(div, jdiv, RTOL)
    close(div, backflow_divergence(params, xt), RTOL)


def test_gs_loss_and_gradients_match_jax(gs):
    model, p, x, (_, jloss, jm, jgrads, _) = gs
    params = torch_params(p)
    for leaf in (v for m in params.values() if m for v in m.values()):
        leaf.requires_grad_(True)
    loss, m = model.loss_and_metrics(params, torch.as_tensor(x))
    loss.backward()
    close(loss, jloss, RTOL_LOSS)
    for k in ("E", "E_std"):
        close(m[k], jm[k], RTOL_LOSS)
    grads = {name: None if mlp is None else {k: v.grad for k, v in mlp.items()}
             for name, mlp in params.items()}
    np.testing.assert_allclose(flat_torch(grads), flat_np(jgrads),
                               rtol=RTOL_LOSS, atol=RTOL_LOSS)


@pytest.fixture(scope="module")
def beta():
    # The two-body field alone (the GS case covers the one-body MLP): it
    # halves the JAX compile.
    cfg, jcfg = configs(nup=2, beta=2.0, deltaE=2.0, boltzmann=True,
                        d_mu=None)
    model, _ = common.build_beta(cfg)
    jmodel, _ = jcommon.build_beta(jcfg)
    p = np_params(5, d_mu=None)
    x = np_walkers(6, B, 2)
    rng = np.random.default_rng(7)
    idx = rng.integers(0, model.Nstates, B).astype(np.int32)
    logits = 0.5 * rng.standard_normal(model.Nstates)

    @jax.jit
    def ref(pp, ii, xx):
        return jax.value_and_grad(jmodel.loss_and_metrics, has_aux=True)(
            pp, ii, xx)

    jp = {"flow": jax_params(p), "log_state_weights": jnp.asarray(logits)}
    return model, p, logits, idx, x, jax.device_get(
        ref(jp, jnp.asarray(idx), jnp.asarray(x)))


def test_beta_loss_and_gradients_match_jax(beta):
    model, p, logits, idx, x, ((jloss, jm), jgrads) = beta
    flow = torch_params(p)
    for leaf in (v for m in flow.values() if m for v in m.values()):
        leaf.requires_grad_(True)
    lw = torch.tensor(logits, requires_grad=True)
    loss, m = model.loss_and_metrics(
        {"flow": flow, "log_state_weights": lw}, torch.as_tensor(idx),
        torch.as_tensor(x))
    loss.backward()
    close(loss, jloss, RTOL_LOSS)
    for k in ("E", "E_std", "F", "F_std", "S", "S_analytical"):
        close(m[k], jm[k], RTOL_LOSS)
    grads = {name: None if mlp is None else {k: v.grad for k, v in mlp.items()}
             for name, mlp in flow.items()}
    np.testing.assert_allclose(flat_torch(grads), flat_np(jgrads["flow"]),
                               rtol=RTOL_LOSS, atol=RTOL_LOSS)
    close(lw.grad, jgrads["log_state_weights"], RTOL_LOSS)


def test_engines_agree_at_identity_init():
    """tests/test_hessian_flow.py:136 in the port: from the identity flow,
    the Hessian-flow and nested-jvp train steps see the same base samples
    and give the same first-step metrics."""
    metrics = {}
    for engine in ("nested_jvp", "hessian_flow"):
        cfg = Config(nup=3, Z=0.5, batch=32, d_eta=8, d_mu=8, ode_steps=4,
                     equilibrium_steps=6, seed=11, local_energy=engine,
                     dtype="float64", device="cpu")
        model, params = common.build_gs(cfg)
        state = init_gs_state(model, params, cfg, torch.device("cpu"))
        _, metrics[engine] = make_gs_train_step(model, cfg)(state)
    for k in ("E", "E_std"):
        np.testing.assert_allclose(float(metrics["nested_jvp"][k]),
                                   float(metrics["hessian_flow"][k]),
                                   atol=1e-9)


def test_pivot_under_vmap_equals_the_loop():
    """``_pivot`` builds its one-hot without a host read, so ``vmap`` over
    the determinant and the inverse runs and equals the per-matrix loop
    bitwise."""
    D = torch.as_tensor(np.random.default_rng(8).standard_normal((6, 4, 4)))
    vm = torch.func.vmap(logabsdet)(D)
    assert torch.equal(vm, torch.stack([logabsdet(d) for d in D]))
    vi = torch.func.vmap(gauss_jordan_inv)(D)
    assert torch.equal(vi, torch.stack([gauss_jordan_inv(d) for d in D]))
    np.testing.assert_allclose(vi.numpy(), np.linalg.inv(D.numpy()),
                               rtol=1e-10, atol=1e-12)


def test_models_sample_walkers_and_push_them_through_the_flow():
    """``GSVMC.sample`` and ``BetaVMC.sample`` (the JAX models' sampling
    entry points): base walkers by the plain sampler from the generator,
    x = generate(z), states drawn from the logits."""
    cfg, _ = configs(nup=2)
    model, _ = common.build_gs(cfg)
    params = torch_params(np_params(9))
    z, x = model.sample(params, torch.Generator().manual_seed(0), 16,
                        equilibrium_steps=20)
    assert z.shape == x.shape == (16, 2, 2)
    assert torch.equal(x, model.cnf.generate(params, z))
    assert torch.isfinite(model.log_prob(params, x)).all()
    z2, _ = model.sample(params, torch.Generator().manual_seed(0), 16,
                         equilibrium_steps=20)
    assert torch.equal(z, z2)

    cfg, _ = configs(nup=2, deltaE=2.0, boltzmann=True)
    bmodel, bparams = common.build_beta(cfg)
    bparams = {"flow": params, "log_state_weights": bparams[
        "log_state_weights"]}
    idx, z, x = bmodel.sample(bparams, torch.Generator().manual_seed(1), 16,
                              equilibrium_steps=20)
    assert idx.shape == (16,) and 0 <= int(idx.min())
    assert int(idx.max()) < bmodel.Nstates and z.shape == x.shape == (16, 2, 2)
    assert torch.equal(x, bmodel.cnf.generate(params, z))
    assert torch.isfinite(bmodel.log_prob(params, x, idx)).all()
