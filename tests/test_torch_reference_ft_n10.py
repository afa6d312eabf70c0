"""The port's finite-temperature step at N = 10 (beta 1, deltaE 4: 1781
Slater states, Hermite depth 8) against the benchmark's plain reference
``portbench/reference.py``, float64, CPU.

The reference works out the orbitals, the state table, the flow, the local
energy, the REINFORCE gradient and Adam again, in plain PyTorch; it is what
the cell ``ft_n10.fresh_k1`` holds the card's runs to.  Here both sides run
at a small size (B = 32 walkers, d_eta = d_mu = 4, dopri5 x 2, and x 4 to
show the flow gradient's gap is the integrator's) with seeded
random flow weights (std 0.3) and random logits, on two paths of the port:
the plain kernel chain ``BetaVMC.loss_metrics_grads_cm`` on given walkers
and states, and the body of the captured chunk (``make_beta_train_step``:
the Categorical draw over the 1781 states, the mixed-state sampler, the
chain and Adam) run eagerly, whose walkers and states the reference then
takes.  No JAX.

Tolerances, each with its reason:

* F, E, S and S_analytical, and the logits' gradient: the same closed forms
  on the same float64 inputs, only the order of the sums differs (the
  reference's local energy runs the Hessian ODE on full matrices, the
  port's on the packed triangle): 1e-10 relative.
* The flow's gradient: the port integrates the continuous adjoint of the
  fixed dopri5 grid backwards, the reference differentiates its own
  reverse-ODE integration by autograd; the two differ by the integrator's
  truncation error, not by roundoff: at these weights up to 4.1e-4 of the
  largest entry at 2 steps and 6.8e-6 at 4 (about h^6), under 1e-8 at 8
  steps and weights of std 0.1.  ``FLOW_RTOL`` allows about five times
  that at each grid, far under a wrong term's gap.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from fermiflow_tpu_torch.cli import common
from fermiflow_tpu_torch.config import Config
from fermiflow_tpu_torch.nn.backflow import backflow_init_gaussian
from fermiflow_tpu_torch.physics import HO2D
from fermiflow_tpu_torch.train import init_beta_state, make_beta_train_step
from fermiflow_tpu_torch.vmc.gs import PLAIN_OPS

torch.set_num_threads(1)

_SPEC = importlib.util.spec_from_file_location(
    "portbench_reference",
    Path(__file__).resolve().parent.parent / "portbench" / "reference.py")
reference = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(reference)

N, B, WIDTH, BETA, DELTA_E, LR = 10, 32, 4, 1.0, 4.0, 3e-3
RTOL = 1e-10
FLOW_RTOL = {2: 2e-3, 4: 3.5e-5}
KEYS = ("E", "F", "S", "S_analytical")
OCC, ENERGIES = reference.slater_states(N, DELTA_E)


def cfg(steps: int) -> Config:
    return Config(nup=N, Z=0.5, beta=BETA, deltaE=DELTA_E, boltzmann=True,
                  batch=B, d_eta=WIDTH, d_mu=WIDTH, ode_steps=steps,
                  dtype="float64", lr=LR, device="cpu", seed=2_000_000_011)


def ref_model(steps: int):
    return reference.Model(dict(nup=N, Z=0.5, ode_steps=steps, lr=LR,
                                beta=BETA, deltaE=DELTA_E))


def random_params(seed: int):
    """Flow weights of std 0.3 and logits Boltzmann plus unit noise."""
    g = torch.Generator().manual_seed(seed)
    flow = backflow_init_gaussian(g, WIDTH, WIDTH, std=0.3)
    es = torch.as_tensor(ENERGIES)
    logits = -BETA * (es - es[0]) + torch.randn(len(es), generator=g,
                                                dtype=torch.float64)
    return flow, logits


def reference_params(flow: dict, logits: torch.Tensor) -> dict:
    p = {f"{m}.{k}": flow[m][k].detach().clone() for m in ("eta", "mu")
         for k in ("w1", "b1", "w2")}
    p["logits"] = logits.detach().clone()
    return p


def assert_matches(metrics: dict, grads: dict, ref_m: dict, ref_g: dict,
                   steps: int):
    for key in KEYS:
        assert float(metrics[key]) == pytest.approx(ref_m[key], rel=RTOL), key
    for k, want in ref_g.items():
        scale = float(want.abs().max())
        gap = float((grads[k].reshape(want.shape) - want).abs().max())
        tol = (RTOL if k == "logits" else FLOW_RTOL[steps]) * scale
        assert gap <= tol, (k, gap / scale)


def test_reference_state_table_is_the_ports():
    """The reference's own enumeration of the Slater states at N = 10,
    deltaE = 4 is the port's: 1781 states, the same occupations in the same
    order, the same energies."""
    occ, es = HO2D().fermion_states(N, 0, DELTA_E)
    assert OCC.shape == (1781, N) and ref_model(2).num == 8
    np.testing.assert_array_equal(OCC, occ)
    np.testing.assert_array_equal(ENERGIES, es)


@pytest.mark.parametrize("steps", sorted(FLOW_RTOL))
def test_plain_chain_matches_the_reference(steps):
    """``loss_metrics_grads_cm`` with the plain ops on Gaussian walkers in
    states drawn uniformly from the 1781 (one holding quantum number 7)."""
    model, _ = common.build_beta(cfg(steps))
    model.ops = PLAIN_OPS
    ref = ref_model(steps)
    flow, logits = random_params(11)
    g = torch.Generator().manual_seed(12)
    z = torch.randn(B, N, 2, generator=g, dtype=torch.float64)
    states = torch.randint(0, model.Nstates, (B,), generator=g)
    states[0] = int(np.flatnonzero(ref.nx_tab.max(1) == 7)[0])
    _, metrics, grads = model.loss_metrics_grads_cm(
        {"flow": flow, "log_state_weights": logits}, states.to(torch.int32),
        z.reshape(B, 2 * N).T.contiguous())
    grads = {f"{m}.{k}": v for m, mod in grads["flow"].items()
             for k, v in mod.items()} | {"logits": grads["log_state_weights"]}
    ref_m, ref_g, _, _ = reference.step(ref, reference_params(flow, logits),
                                        {}, z, states, block=16)
    assert_matches(metrics, grads, ref_m, ref_g, steps)


@pytest.mark.parametrize("steps", sorted(FLOW_RTOL))
def test_chunk_body_matches_the_reference(steps):
    """One iteration of the finite-T training step, as the captured chunk
    runs it, eagerly on the CPU (fresh walkers and fresh states from the
    Categorical, 100 steps of the plain mixed-state sampler): its row and
    the gradient each leaf handed Adam, against the reference's step on the
    walkers and states the iteration left in the state."""
    c = cfg(steps)
    model, params = common.build_beta(c)
    state = init_beta_state(model, params, c, torch.device("cpu"))
    flow, logits = random_params(13)
    with torch.no_grad():
        for m in ("eta", "mu"):
            for k, p in getattr(state.flow, m).items():
                p.copy_(flow[m][k])
        state.log_state_weights.copy_(logits)
    p0 = reference_params(flow, logits)
    step = make_beta_train_step(model, c)
    state, metrics = step(state)
    leaves = {f"{m}.{k}": p for m in ("eta", "mu")
              for k, p in getattr(state.flow, m).items()}
    grads = {k: p.grad for k, p in leaves.items()} | {
        "logits": state.log_state_weights.grad}
    z = state.walkers_cm.T.reshape(B, N, 2)
    ref_m, ref_g, _, _ = reference.step(ref_model(steps), p0, {}, z,
                                        state.state_idx.long(), block=16)
    assert_matches(metrics, grads, ref_m, ref_g, steps)
