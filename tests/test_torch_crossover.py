"""The crossover diagnostics of the port against the JAX package on the CPU,
in float64 at small widths (d_eta = d_mu = 8, dopri5 x 2, N = 3 and 6):

- ``cli/crossover_analysis.py``: ``CNF.generate`` and ``structure`` against
  JAX ``cnf.generate`` and the arithmetic of
  ``validation/crossover_analysis.py:73-101``, reproduced here;
- ``FreeFermion.sample(use_pallas=True)``: the route (kernel #5's plain
  version on the CPU for a polarized float32 draw, the plain sampler
  otherwise) and, by distribution, the JAX ``sample``;
- ``cli/ode_steps_study.py``: E(steps), per-walker Eloc and the loss
  gradient against the JAX study's arithmetic on the same parameters and
  walkers, at Z = 8.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fermiflow_tpu import mcmc as jmcmc
from fermiflow_tpu.cli import common as jcommon
from fermiflow_tpu.config import Config as JConfig
from fermiflow_tpu.physics import HO2D as JHO2D
from fermiflow_tpu.physics import FreeFermion as JFreeFermion

from fermiflow_tpu_torch import mcmc
from fermiflow_tpu_torch.cli import common, crossover_analysis, ode_steps_study
from fermiflow_tpu_torch.config import Config
from fermiflow_tpu_torch.nn.backflow import params_from_jax
from fermiflow_tpu_torch.ops import metropolis as ops_metropolis
from fermiflow_tpu_torch.physics import HO2D, FreeFermion

from _torch_port import jax_params, np_params, walkers

torch.set_num_threads(1)

STEPS, WIDTH, RMAX, BINS = 2, 8, 6.0, 120


def configs(nup, Z, steps=STEPS, batch=64):
    kw = dict(nup=nup, Z=Z, batch=batch, d_eta=WIDTH, d_mu=WIDTH,
              ode_steps=steps, dtype="float64")
    return Config(device="cpu", **kw), JConfig(**kw)


def jax_script(x, Z):
    """``validation/crossover_analysis.py:73-101`` on walkers x (B, n, dim):
    r, the pairs, V_int, V_trap and the histograms' counts."""
    n = x.shape[1]
    r = jnp.linalg.norm(x, axis=-1)
    diff = x[:, :, None, :] - x[:, None, :, :]
    dij = jnp.linalg.norm(diff + jnp.eye(n, dtype=x.dtype)[..., None],
                          axis=-1)
    iu = jnp.triu_indices(n, k=1)
    pair = dij[:, iu[0], iu[1]]
    v_int = Z * jnp.sum(1.0 / pair, axis=-1)
    v_trap = 0.5 * jnp.sum(x**2, axis=(-2, -1))
    r, pair, v_int, v_trap = (np.asarray(a) for a in (r, pair, v_int, v_trap))
    edges = np.linspace(0.0, RMAX, BINS + 1)
    hist_r, _ = np.histogram(r.ravel(), bins=edges)
    hist_pair, _ = np.histogram(pair.ravel(), bins=edges)
    return r, pair, v_int, v_trap, hist_r, hist_pair


def counts(density, norm):
    """Histogram counts back from n(r) or g(r) (``norm``: B or the number of
    pair samples)."""
    edges = np.linspace(0.0, RMAX, BINS + 1)
    area = 2 * np.pi * 0.5 * (edges[1:] + edges[:-1]) * np.diff(edges)
    return np.rint(np.asarray(density) * area * norm).astype(np.int64)


def assert_hist_close(h, h_ref):
    """Equal bin by bin, allowing one count moved between neighbouring
    bins (a value on a bin edge, rounded the other way)."""
    d = h - h_ref
    assert d.sum() == 0 and np.abs(d).sum() <= 2, np.nonzero(d)
    assert np.abs(np.cumsum(d)).max() <= 1


@pytest.mark.parametrize("nup,Z", [(3, 8.0), (6, 0.5)])
def test_generate_and_structure_match_the_jax_script(nup, Z):
    """x = flow(z) and the per-walker structure (r, pairs, V_int, V_trap)
    to rtol 1e-10, n(r) and g(r) bin by bin, and the normalisation
    2 pi sum r n(r) dr = N x (share of positions inside rmax)."""
    B = 512
    cfg, jcfg = configs(nup, Z)
    model, _ = common.build_gs(cfg)
    jmodel, _ = jcommon.build_gs(jcfg)
    p = np_params(60 + nup)
    z = 1.5 * walkers(61 + nup, B, nup)

    jx = np.asarray(jmodel.cnf.generate(jax_params(p), jnp.asarray(z)))
    x = model.cnf.generate(params_from_jax(p, torch.float64),
                           torch.as_tensor(z))
    np.testing.assert_allclose(x.numpy(), jx, rtol=1e-10, atol=1e-12)

    r, pair, v_int, v_trap, hist_r, hist_pair = jax_script(jnp.asarray(jx), Z)
    for a, b in zip(crossover_analysis.pair_observables(x, Z),
                    (r, pair, v_int, v_trap)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-10, atol=1e-12)

    rec = crossover_analysis.structure(x, Z, RMAX, BINS)
    assert_hist_close(counts(rec["n_of_r"], B), hist_r)
    assert_hist_close(counts(rec["g_of_r"], pair.shape[0]), hist_pair)
    for key, ref in (("mean_r", r.mean()), ("rms_r", np.sqrt((r**2).mean())),
                     ("mean_pair_distance", pair.mean()),
                     ("V_int", v_int.mean()), ("V_trap", v_trap.mean())):
        np.testing.assert_allclose(rec[key], ref, rtol=1e-10)
    assert rec["walkers"] == B and rec["n0"] == rec["n_of_r"][0]
    # Some positions lie beyond rmax, so the check is not vacuous.
    assert rec["inside_fraction"] < 1.0
    np.testing.assert_allclose(rec["norm_integral"],
                               nup * rec["inside_fraction"], atol=1e-12)


def test_crossover_cli_keys_and_normalisation(tmp_path):
    """The CLI at a checkpoint of 2 CPU iterations: the JAX script's keys,
    and n(r) integrates to N x (share inside rmax)."""
    from fermiflow_tpu_torch.cli import ground_state

    small = ["--nup", "3", "--Deta", "8", "--Dmu", "8", "--ode-steps", "2",
             "--device", "cpu"]
    ground_state.main(small + [
        "--Z", "2.0", "--batch", "32", "--iternum", "2", "--lr", "1e-2",
        "--dtype", "float32", "--persistent", "--mcmc-steps", "3",
        "--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every", "2"])
    rec = crossover_analysis.main(small + [
        "--ckpt", str(tmp_path / "ck"), "--Z", "2.0", "--walkers", "256",
        "--train-batch", "32", "--equil", "20", "--out",
        str(tmp_path / "x.json")])
    jax_keys = {"Z", "nup", "walkers", "ckpt_step", "mean_r", "rms_r",
                "mean_pair_distance", "V_int", "V_int_sem", "V_trap",
                "V_trap_sem", "r_edges", "n_of_r", "g_of_r"}
    assert jax_keys <= set(rec) and rec["ckpt_step"] == 2
    assert len(rec["n_of_r"]) == BINS and len(rec["r_edges"]) == BINS + 1
    assert abs(rec["norm_integral"] - 3 * rec["inside_fraction"]) < 1e-6


# ---- FreeFermion.sample(use_pallas=True) ----


@pytest.mark.parametrize("ndown,dtype,routed", [
    (0, torch.float32, True), (0, torch.float64, False),
    (1, torch.float32, False)])
def test_sample_route(monkeypatch, ndown, dtype, routed):
    """A polarized float32 draw goes through ``metropolis_free_fermion``
    (kernel #5; on the CPU its plain version), any other through the plain
    ``mcmc.metropolis``, as in the JAX package.  Without ``use_pallas`` the
    plain sampler always."""
    calls = []
    for mod, name in ((ops_metropolis, "metropolis_free_fermion"),
                      (mcmc, "metropolis")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    fb = FreeFermion(HO2D())
    x, acc = fb.sample(np.arange(2), np.arange(ndown),
                       torch.Generator().manual_seed(0), (16,),
                       equilibrium_steps=3, dtype=dtype, use_pallas=True,
                       return_accept=True)
    assert x.shape == (16, 2 + ndown, 2) and x.dtype == dtype
    assert acc.shape == (16,)
    assert calls == ["metropolis_free_fermion" if routed else "metropolis"]
    calls.clear()
    fb.sample(np.arange(2), np.arange(ndown), torch.Generator().manual_seed(0),
              (16,), equilibrium_steps=3, dtype=dtype)
    assert calls == ["metropolis"]


@pytest.mark.parametrize("nup", [3, 6])
def test_sample_kernel_route_matches_jax_by_distribution(nup):
    """The kernel route (plain version of kernel #5, float32) against the
    JAX ``sample`` (the plain sampler, float32) from Gaussians, 200 steps at
    tau = 0.1 over 4096 walkers: <sum x^2> within 5 combined standard
    errors, the mean acceptance equal to the JAX sampler's to 0.01."""
    B, steps, tau = 4096, 200, 0.1
    x, acc = FreeFermion(HO2D()).sample(
        np.arange(nup), np.arange(0), torch.Generator().manual_seed(nup),
        (B,), equilibrium_steps=steps, tau=tau, dtype=torch.float32,
        use_pallas=True, return_accept=True)

    jbd = JFreeFermion(JHO2D())
    up, dn = np.arange(nup), np.arange(0)
    key = jax.random.PRNGKey(nup)
    jx = np.asarray(jbd.sample(up, dn, key, (B,), equilibrium_steps=steps,
                               tau=tau, dtype=jnp.float32))
    # The acceptance of that same draw: ``sample``'s own steps.
    k_init, k_mcmc = jax.random.split(key)
    x0 = jax.random.normal(k_init, (B, nup, 2), dtype=jnp.float32)
    st = jax.jit(lambda k, y: jmcmc.metropolis(
        lambda v: jbd.log_prob(up, dn, v), k, y, steps, tau))(k_mcmc, x0)
    # The same chains, compiled apart (float32 rounding differs).
    np.testing.assert_allclose(np.asarray(st.x), jx, rtol=0, atol=1e-4)

    r2 = (x.double()**2).sum((-2, -1)).numpy()
    jr2 = (jx.astype(np.float64)**2).sum((-2, -1))
    se = np.hypot(r2.std(), jr2.std()) / np.sqrt(B)
    assert abs(r2.mean() - jr2.mean()) < 5 * se, (r2.mean(), jr2.mean(), se)
    assert abs(float(acc.mean()) - float(st.accept_rate.mean())) < 0.01


# ---- cli/ode_steps_study.py ----


def test_ode_steps_study_matches_the_jax_arithmetic():
    """At Z = 8 (N = 3) on f64 walkers of the plain sampler: E for 2 and 4
    steps against the JAX ``loss_and_metrics_from_base`` to rtol 1e-10, the
    loss gradient against ``jax.grad`` of it to 1e-9 (of its largest
    entry), and ``study``'s rows from those numbers."""
    Z, B = 8.0, 32
    p = np_params(70)
    params = params_from_jax(p, torch.float64)
    base = ode_steps_study.make_model(3, Z, 2)
    z = base.basedist.sample(base.occ_up, base.occ_down,
                             torch.Generator().manual_seed(71), (B,),
                             equilibrium_steps=100, tau=0.1)
    jz, jp = jnp.asarray(z.numpy()), jax_params(p)
    ref = {}
    for s in (2, 4):
        jmodel, _ = jcommon.build_gs(configs(3, Z, s, B)[1])
        (_, jm), jtree = jax.jit(jax.value_and_grad(
            jmodel.loss_and_metrics_from_base, has_aux=True))(jp, jz)
        # The JAX study's flattening: the tree's leaves in its order.
        jflat = np.concatenate([np.asarray(a).ravel() for a in
                                jax.tree_util.tree_leaves(jtree)])
        eloc, grad = ode_steps_study.observables(
            ode_steps_study.make_model(3, Z, s), params, z)
        np.testing.assert_allclose(eloc.mean(), float(jm["E"]), rtol=1e-10)
        np.testing.assert_allclose(grad, jflat, rtol=1e-9,
                                   atol=1e-9 * np.abs(jflat).max())
        ref[s] = (eloc, jflat)

    res = ode_steps_study.study(params, z, 3, Z, [2], reference_grid=4)
    (row,) = res["rows"]
    e2, g2 = ref[2]
    e4, g4 = ref[4]
    np.testing.assert_allclose(res["E_ref"], e4.mean(), rtol=1e-12)
    np.testing.assert_allclose(row["E"], e2.mean(), rtol=1e-12)
    np.testing.assert_allclose(row["max_dEloc"], np.abs(e2 - e4).max(),
                               rtol=1e-3)
    np.testing.assert_allclose(
        row["grad_rel_err"],
        np.linalg.norm(g2 - g4) / np.linalg.norm(g4), rtol=1e-3)
    assert res["batch"] == B and 0 < row["dE"] < 1e-2
