"""Finite-temperature variational Monte Carlo (port of ``fermiflow_tpu/vmc/beta.py``).

A learnable Categorical over the truncated many-body Slater basis (logits
``log_state_weights``), composed with the shared flow.  Estimators:

    Floc = Eloc + logp_states / beta
    S    = -mean(logp_states)            (MC entropy)
    S_an = -sum(p log p)                 (von Neumann, analytic)

Two REINFORCE surrogate losses over disjoint parameter groups:

    loss_phi   = mean[logp_states (Floc - F)]       (occupation logits)
    loss_theta = mean[logp_full (Eloc - E_state)]   (flow parameters)

with E_state the mean Eloc of the walkers in the same state.  Every walker
carries a dense state index; the per-state sums are a one-hot (Nstates, B)
product, which sums in a fixed order on every device (JAX: ``segment_sum``).

Three gradient paths, as in ``vmc/gs.py``:
  * ``loss_and_metrics``: Eloc by the nested-jvp engine on generated
    walkers, gradient by autograd (``--local-energy nested_jvp``);
  * ``loss_and_metrics_from_base``: Eloc by the Hessian flow (plain, or the
    kernel chain), gradient by autograd, any dtype;
  * ``loss_metrics_grads_cm``: no autograd.  Mixed-state Slater VGH ->
    Hessian flow -> Eloc -> phi loss and weights -> REINFORCE adjoint, on
    coordinate-major (rows, B) buffers.

With ``mesh`` (``parallel/mesh.py``) a rank holds its rows of the global
batch, as in ``vmc/gs.py``: F, E and S are global means, F_std and E_std
two-pass global standard deviations, the per-state counts and sums (and
those of Floc - F) sums over ranks, and the weights divide by the global
batch.  S_analytical comes from the replicated logits.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from fermiflow_tpu_torch.flow.cnf import CNF
from fermiflow_tpu_torch.parallel.mesh import (
    all_sum_tensors,
    all_sum_tree,
    global_batch,
    local_mean,
    walker_mean,
    walker_std,
)
from fermiflow_tpu_torch.physics.base_dist import FreeFermion
from fermiflow_tpu_torch.physics.orbitals import HO2D
from fermiflow_tpu_torch.vmc.gs import (
    GSVMC,
    KERNEL_OPS,
    ChainOps,
    _detach,
    flow_local_energy_cm,
)
from fermiflow_tpu_torch.vmc.hessian_flow import local_energy_flow
from fermiflow_tpu_torch.vmc.local_energy import y_grad_laplacian

__all__ = ["BetaVMC"]


class BetaVMC:
    """Finite-T VMC model.  Parameters: ``{"flow": flow params,
    "log_state_weights": (Nstates,)}``."""

    def __init__(self, beta: float, nup: int, ndown: int, deltaE: float,
                 orbitals: HO2D, basedist: FreeFermion, cnf: CNF,
                 pair_potential: Callable, sp_potential: Callable | None = None,
                 ops: ChainOps = KERNEL_OPS, laplacian_chunk: int | None = None):
        self.beta = beta
        self.laplacian_chunk = laplacian_chunk
        self.nup, self.ndown = nup, ndown
        self.n = nup + ndown
        occ, Es = orbitals.fermion_states(nup, ndown, deltaE)
        self.occ_table = occ  # (Nstates, nup) numpy int32
        self.Es_original = Es  # (Nstates,) numpy float64
        self.Nstates = occ.shape[0]
        self.basedist = basedist
        self.cnf = cnf
        self.pair_potential = pair_potential
        self.sp_potential = sp_potential
        self.ops = ops
        self._state_qnums = {}  # device -> (nx, ny) tables, (n, Nstates) int32

    def init_log_state_weights(self, boltzmann: bool,
                               generator: torch.Generator | None = None,
                               dtype=torch.float64, device=None) -> torch.Tensor:
        """Boltzmann init -beta (E_s - E_0), or standard Gaussian logits drawn
        from ``generator``."""
        if boltzmann:
            Es = self.Es_original
            return torch.as_tensor(-self.beta * (Es - Es[0]), dtype=dtype,
                                   device=device)
        if generator is None:
            raise ValueError("random init requires a generator")
        return torch.randn((self.Nstates,), generator=generator, dtype=dtype,
                           device=generator.device).to(device)

    # -- sampling --

    def sample(self, params, generator: torch.Generator, batch: int,
               equilibrium_steps: int = 100, tau: float = 0.1,
               dtype=torch.float64):
        """(state_idx, z, x): states from the Categorical of the logits, z
        from each state's Slater density by the plain sampler, x = flow(z);
        every draw from ``generator``."""
        probs = torch.softmax(params["log_state_weights"].detach(), dim=-1)
        state_idx = torch.multinomial(probs.to(generator.device), batch,
                                      replacement=True, generator=generator)
        z = self.basedist.sample_multstates(
            self.occ_table, state_idx, generator,
            equilibrium_steps=equilibrium_steps, tau=tau, dtype=dtype)
        return state_idx, z, self.cnf.generate(params["flow"], z)

    # -- likelihood --

    def log_prob(self, flow_params, x: torch.Tensor,
                 state_idx: torch.Tensor) -> torch.Tensor:
        """Conditional log p_theta(x | state) via the reverse flow."""
        z, delta_logp = self.cnf.delta_logp(flow_params, x)
        return (self.basedist.log_prob_multstates(self.occ_table, state_idx, z)
                - delta_logp)

    def potential(self, x: torch.Tensor) -> torch.Tensor:
        """Pair plus single-particle potential at x (batch, n, dim), the
        ground state's (``GSVMC.potential``)."""
        return GSVMC.potential(self, x)

    # The same potential from coordinate-major rows as the ground state's.
    potential_rows = GSVMC.potential_rows

    def _qnum_tables(self):
        """(nx_tab, ny_tab, kshells): the orbitals' quantum-number tables and
        the Hermite depth covering the truncated state space."""
        orb = self.basedist.orbitals
        ks = int(max(orb.nx[self.occ_table].max(),
                     orb.ny[self.occ_table].max())) + 1
        return orb.nx, orb.ny, ks

    def qnums_cm(self, state_idx: torch.Tensor):
        """(nx_cm, ny_cm): (n, B) int32 quantum numbers of each walker's
        occupied orbitals, on ``state_idx``'s device, walkers contiguous."""
        dev = state_idx.device
        tabs = self._state_qnums.get(dev)
        if tabs is None:
            nx_tab, ny_tab, _ = self._qnum_tables()
            tabs = self._state_qnums[dev] = tuple(
                torch.as_tensor(np.ascontiguousarray(t[self.occ_table].T),
                                dtype=torch.int32, device=dev)
                for t in (nx_tab, ny_tab))
        idx = state_idx.long()
        return tabs[0][:, idx].contiguous(), tabs[1][:, idx].contiguous()

    # -- Hessian-flow path: local energy directly from base samples --

    def local_energy_from_base(self, flow_params, state_idx: torch.Tensor,
                               z: torch.Tensor, return_grad: bool = False):
        """(x, eloc, logp[, g]) by the plain Hessian flow from z (B, n, dim),
        each walker in its own Slater state."""
        return local_energy_flow(
            self.cnf.field_tensors,
            lambda z_: self.basedist.log_prob_vgh_multstates(
                self.occ_table, state_idx, z_),
            self.potential, flow_params, z, self.cnf.t0, self.cnf.t1,
            steps=self.cnf.steps, method=self.cnf.method,
            return_grad=return_grad)

    def _state_sums(self, state_idx: torch.Tensor, *values: torch.Tensor):
        """Per-state walker counts and per-state sums of each value (B,),
        by a one-hot (Nstates, B) product."""
        states = torch.arange(self.Nstates, device=state_idx.device)
        onehot = (state_idx[None, :] == states[:, None]).to(values[0].dtype)
        return (onehot.sum(1),) + tuple(onehot @ v for v in values)

    def _observables(self, logits: torch.Tensor, state_idx: torch.Tensor,
                     eloc: torch.Tensor, mesh=None):
        """(floc, F, metrics) from detached logits and local energies."""
        lps_all = torch.log_softmax(logits, dim=-1)
        lps = lps_all[state_idx]
        floc = eloc + lps / self.beta
        E, F, mean_lps = walker_mean(mesh, eloc, floc, lps)
        E_std, F_std = walker_std(mesh, (eloc, E), (floc, F))
        metrics = {
            "E": E, "E_std": E_std, "F": F, "F_std": F_std, "S": -mean_lps,
            "S_analytical": -torch.sum(lps_all * torch.exp(lps_all)),
        }
        return floc, F, metrics

    def _losses_from_eloc(self, params, state_idx, x, eloc, mesh=None):
        """Both surrogate losses (this rank's share, differentiable in
        params) and the metrics, given detached local energies."""
        logits = params["log_state_weights"]
        logp = self.log_prob(params["flow"], x, state_idx)
        floc, F, metrics = self._observables(logits.detach(), state_idx, eloc,
                                             mesh)
        lps = torch.log_softmax(logits, dim=-1)[state_idx]
        loss_phi = local_mean(mesh, lps * (floc - F))
        counts, sums = all_sum_tensors(mesh,
                                       *self._state_sums(state_idx, eloc))
        baseline = (sums / counts.clamp_min(1.0))[state_idx]
        loss_theta = local_mean(mesh, logp * (eloc - baseline))
        return loss_phi + loss_theta, metrics

    def loss_and_metrics(self, params, state_idx: torch.Tensor,
                         x: torch.Tensor, mesh=None):
        """Surrogate loss (phi and theta terms, disjoint parameters) and the
        metrics for generated walkers x (B, n, dim); the local energy comes
        from the nested-jvp engine under detached flow parameters."""
        flow = _detach(params["flow"])
        with torch.no_grad():
            _, grad_logp, lap_logp = y_grad_laplacian(
                lambda xs, idx: self.log_prob(flow, xs, idx), x, state_idx,
                chunk_size=self.laplacian_chunk)
            eloc = (-0.25 * lap_logp
                    - 0.125 * torch.sum(grad_logp**2, dim=(-2, -1))
                    + self.potential(x))
        return self._losses_from_eloc(params, state_idx, x, eloc, mesh)

    def loss_and_metrics_from_base(self, params, state_idx: torch.Tensor,
                                   z: torch.Tensor, chain: bool = False,
                                   mesh=None):
        """Surrogate loss and metrics from base samples z (B, n, dim); the
        local energy comes from the Hessian flow under detached parameters,
        the plain one, or with ``chain`` the VGH and Hessian-flow kernels of
        ``self.ops``."""
        with torch.no_grad():
            flow = _detach(params["flow"])
            if chain:
                B, n, dim = z.shape
                nx_cm, ny_cm = self.qnums_cm(state_idx)
                _, _, ks = self._qnum_tables()
                z_cm = z.reshape(B, n * dim).T.contiguous()
                y, g0, Hp0 = self.ops.slater_vgh_ms(z_cm, nx_cm, ny_cm, ks)
                x_cm, eloc, _, _ = flow_local_energy_cm(self, flow, z_cm, y,
                                                        g0, Hp0)
                x = x_cm.T.reshape(B, n, dim)
            else:
                x, eloc, _ = self.local_energy_from_base(flow, state_idx, z)
        return self._losses_from_eloc(params, state_idx, x, eloc, mesh)

    def _phi_loss_and_weights(self, params, state_idx: torch.Tensor,
                              eloc: torch.Tensor, mesh=None):
        """(w, loss_phi, grad_logits, metrics): the phi loss (this rank's
        share) and its gradient in closed form, and the per-state-baselined
        theta weights w (B,).

        d/dl mean_b log_softmax(l)[s_b] c_b = (sum_{b: s_b = s} c_b
        - p_s sum_b c_b) / B with c = Floc - F held fixed, and sum_b c_b = 0
        (F is the mean of Floc).  So the gradient is the per-state sums of c
        over B, with no second term: in floating point that term is
        roundoff alone, which Adam, dividing by its running scale, would
        turn into steps of the logits of states no walker occupies (steps
        that also differ with the order of the sums, so between process
        counts).  The sums run over the global batch (one collective with
        the per-state counts and sums).
        """
        logits = params["log_state_weights"].detach()
        B = global_batch(mesh, eloc.shape[0])
        floc, F, metrics = self._observables(logits, state_idx, eloc, mesh)
        c = floc - F
        lps_all = torch.log_softmax(logits, dim=-1)
        loss_phi = local_mean(mesh, lps_all[state_idx] * c)
        counts, sums, c_sums = all_sum_tensors(
            mesh, *self._state_sums(state_idx, eloc, c))
        grad_logits = c_sums / B
        baseline = (sums / counts.clamp_min(1.0))[state_idx]
        w = (eloc - baseline) / B
        return w, loss_phi, grad_logits, metrics

    @torch.no_grad()
    def loss_metrics_grads_cm(self, params, state_idx: torch.Tensor,
                              z_cm: torch.Tensor, mesh=None):
        """(loss, metrics, grads) for base walkers z_cm (d, B) in states
        state_idx (B,), with no autograd: the kernel chain of ``self.ops``
        (with ``mesh``, on this rank's rows; the flow's gradient and the loss
        summed over ranks)."""
        flow = _detach(params["flow"])
        cnf = self.cnf
        nx_cm, ny_cm = self.qnums_cm(state_idx)
        _, _, ks = self._qnum_tables()
        y, g0, Hp0 = self.ops.slater_vgh_ms(z_cm, nx_cm, ny_cm, ks)
        x, eloc, logp, g = flow_local_energy_cm(self, flow, z_cm, y, g0, Hp0)
        w, loss_phi, grad_logits, metrics = self._phi_loss_and_weights(
            params, state_idx, eloc, mesh)
        grads_flow, _ = self.ops.reinforce(flow, x, g, w.contiguous(), cnf.t0,
                                           cnf.t1, steps=cnf.steps,
                                           method=cnf.method)
        summed = all_sum_tree(mesh, {"flow": grads_flow,
                                     "loss": loss_phi + torch.sum(w * logp)})
        return summed["loss"], metrics, {"flow": summed["flow"],
                                         "log_state_weights": grad_logits}
