"""Two of the JAX package's oracles through the port, on the CPU in float64:

* the closed-form interacting Taut eigenstates (``tests/test_taut.py``):
  the port's nested-jvp engine ``vmc/local_energy.y_grad_laplacian`` on a
  torch copy of their log-density gives Eloc = 3 (singlet, m = 0, Z = 1)
  and 4 (triplet, m = 1, Z = sqrt 3) on every walker;
* unbiased persistent finite-T sampling (``tests/test_train.py``
  ``test_beta_persistent_sampling_unbiased``): the port's
  ``init_beta_state`` / ``make_beta_train_step`` and its maximal-coupling
  ``_coupled_state_refresh`` keep every chain on its state under frozen
  logits, sample the softmax occupation, and give per-state virial moments
  <r^2/2> = E_s/2 at the identity flow, also under drifting logits.
"""

import numpy as np
import pytest
import torch

from fermiflow_tpu_torch.cli import common
from fermiflow_tpu_torch.config import Config
from fermiflow_tpu_torch.physics import CoulombPairPotential, HOPotential
from fermiflow_tpu_torch.train import init_beta_state, make_beta_train_step
from fermiflow_tpu_torch.vmc.local_energy import y_grad_laplacian

SQRT3 = float(np.sqrt(3.0))


def _logp_taut(x, m, Z):
    """log |Psi|^2 of the Taut state (``tests/test_taut.py:_logp_taut``):
    e^{-2R^2} (1 + r/Z)^2 u_x^{2m} e^{-r^2/2}, x (..., 2, 2)."""
    R2 = torch.sum(torch.mean(x, dim=-2) ** 2, dim=-1)
    u = x[..., 0, :] - x[..., 1, :]
    r = torch.sqrt(torch.sum(u**2, dim=-1))
    out = -2.0 * R2 - 0.5 * r**2 + 2.0 * torch.log1p(r / Z)
    if m:
        out = out + 2.0 * m * torch.log(torch.abs(u[..., 0]))
    return out


@pytest.mark.parametrize("m,Z,E_exact", [(0, 1.0, 3.0), (1, SQRT3, 4.0)],
                         ids=["singlet_Z1", "triplet_Zsqrt3"])
def test_taut_closed_form_is_eigenstate(m, Z, E_exact):
    x = torch.as_tensor(np.random.default_rng(11).standard_normal((256, 2, 2)))
    # The JAX test's shift off the coordinate singularities (r = 0 and, for
    # m = 1, the u_x = 0 node).
    ux = torch.abs(x[:, 0, 0] - x[:, 1, 0])
    shift = torch.tensor([[1.0, 0.0], [-0.3, 0.0]], dtype=x.dtype)
    x = torch.where((ux < 0.3)[:, None, None], x + shift, x)

    _, grad, lap = y_grad_laplacian(lambda xs: _logp_taut(xs, m, Z), x)
    kinetic = -0.25 * lap - 0.125 * torch.sum(grad**2, dim=(-2, -1))
    eloc = kinetic + HOPotential()(x) + CoulombPairPotential(Z)(x)
    np.testing.assert_allclose(eloc.numpy(), E_exact, rtol=0, atol=1e-9)


def _per_state_virial_errors(state, model):
    """Per-state |<r^2/2> - E_s/2| and its MC sem (states with >= 50
    walkers), the JAX test's helper."""
    r2 = 0.5 * np.sum(state.walkers.numpy() ** 2, axis=(-2, -1))
    idx = state.state_idx.numpy()
    Es = np.asarray(model.Es_original)
    errs = []
    for s in np.unique(idx):
        vals = r2[idx == s]
        if len(vals) < 50:
            continue
        sem = vals.std() / np.sqrt(len(vals))
        errs.append((float(abs(vals.mean() - Es[s] / 2.0)), float(sem)))
    assert len(errs) >= 3  # several states actually populated
    return errs


def test_beta_persistent_sampling_unbiased():
    """The JAX test's configuration: ``small_gs_cfg`` widths, beta = 1,
    deltaE = 2, Boltzmann logits, batch 2048, 10 Metropolis steps an
    iteration, 30 burn-in calls, lr 0 (frozen parameters: Adam at lr 0
    leaves every parameter and logit where it is)."""
    cfg = Config(nup=3, Z=0.0, batch=2048, d_eta=8, d_mu=8, ode_steps=4,
                 equilibrium_steps=10, mcmc_steps=10, iternum=3, seed=0,
                 persistent_walkers=True, lr=0.0, device="cpu")
    cfg.beta, cfg.deltaE, cfg.boltzmann = 1.0, 2.0, True
    model, params = common.build_beta(cfg)
    p = torch.softmax(params["log_state_weights"], dim=-1).numpy()
    state = init_beta_state(model, params, cfg, torch.device("cpu"))
    step = make_beta_train_step(model, cfg)

    for _ in range(30):  # burn-in: 300 Metropolis steps per chain
        state, metrics = step(state)
    # Frozen logits: the coupling never switches a chain's state.
    assert float(metrics["state_switch_frac"]) == 0.0

    # The occupation is the softmax of the logits.
    counts = np.bincount(state.state_idx.numpy(),
                         minlength=model.Nstates) / cfg.batch
    np.testing.assert_allclose(counts, p, atol=4 * np.sqrt(p.max() / cfg.batch))

    for err, sem in _per_state_virial_errors(state, model):
        assert err < 4 * sem + 0.02, (err, sem)

    # Drifting logits (simulated training): a TV-sized fraction of chains
    # switches, and the moments stay unbiased.
    sw = []
    for k in range(15):
        noise = np.random.default_rng(k).standard_normal(model.Nstates)
        with torch.no_grad():
            state.log_state_weights.add_(0.05 * torch.as_tensor(noise))
        state, metrics = step(state)
        sw.append(float(metrics["state_switch_frac"]))
    assert 0.0 < np.mean(sw) < 0.1, sw
    for err, sem in _per_state_virial_errors(state, model):
        assert err < 4 * sem + 0.05, (err, sem)
