"""Ground-state variational Monte Carlo estimator (port of ``fermiflow_tpu/vmc/gs.py``).

Local energy Eloc = -1/4 lap logp - 1/8 |grad logp|^2 + V(x) and the
REINFORCE surrogate loss = mean[(Eloc - E) logp_theta(x)], Eloc detached.

Three gradient paths:
  * ``loss_and_metrics``: Eloc by the nested-jvp engine
    (``vmc/local_energy.py``) on generated walkers x, logp_theta by the
    reverse ODE, gradient by autograd (``--local-energy nested_jvp``);
  * ``loss_and_metrics_from_base``: Eloc from the Hessian flow (the plain
    one, or the kernel chain), logp_theta by the reverse ODE, gradient by
    autograd (any dtype);
  * ``loss_metrics_grads``: no autograd at all.  The Slater-VGH, Hessian-flow
    and REINFORCE-adjoint kernel modules chain on coordinate-major (rows, B)
    buffers with no relayout, as the TPU tile chain does.

Each loss takes ``mesh`` (``parallel/mesh.py``), a walker mesh whose rank
holds its rows of the global batch: E is the global mean, E_std the
two-pass global standard deviation, the REINFORCE weights divide by the
global batch and the no-autograd gradient and loss are summed over ranks,
replicated on every rank.  The autograd losses return this rank's share
of the global loss; the caller sums their gradients over ranks.  Local
energies are per walker and need no mesh.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from fermiflow_tpu_torch.flow.cnf import CNF
from fermiflow_tpu_torch.ops.hessian_flow import (
    hessian_flow_cm,
    hessian_flow_cm_plain,
)
from fermiflow_tpu_torch.ops.reinforce import reinforce_cm, reinforce_cm_plain
from fermiflow_tpu_torch.parallel.mesh import (
    all_sum_tree,
    global_batch,
    local_mean,
    walker_mean,
    walker_std,
)
from fermiflow_tpu_torch.ops.slater_vgh import (
    slater_vgh_cm,
    slater_vgh_cm_plain,
    slater_vgh_ms_cm,
    slater_vgh_ms_cm_plain,
)
from fermiflow_tpu_torch.physics.base_dist import FreeFermion
from fermiflow_tpu_torch.vmc.hessian_flow import local_energy_flow
from fermiflow_tpu_torch.vmc.local_energy import y_grad_laplacian

__all__ = ["GSVMC", "ChainOps", "KERNEL_OPS", "PLAIN_OPS",
           "flow_local_energy_cm"]


class ChainOps(NamedTuple):
    """The coordinate-major operations the no-autograd updates chain (the
    finite-T update takes the mixed-state VGH in place of ``slater_vgh``)."""

    slater_vgh: Callable
    hessian_flow: Callable
    reinforce: Callable
    slater_vgh_ms: Callable


# The kernel wrappers (plain versions only for CPU tensors), and the plain
# versions on any device, which chip_smoke.py holds the kernels against.
KERNEL_OPS = ChainOps(slater_vgh_cm, hessian_flow_cm, reinforce_cm,
                      slater_vgh_ms_cm)
PLAIN_OPS = ChainOps(slater_vgh_cm_plain, hessian_flow_cm_plain,
                     reinforce_cm_plain, slater_vgh_ms_cm_plain)


def _detach(params):
    return {k: None if v is None else {kk: t.detach() for kk, t in v.items()}
            for k, v in params.items()}


_DIAG_ROWS = {}  # (d, device) -> the packed Hessian's diagonal rows


def _diag_rows(d: int, device) -> torch.Tensor:
    """Rows of the diagonal (p, p) of a packed upper triangle, p*d - p(p-1)/2,
    as an index tensor on ``device``, made once (indexing by a Python list
    copies it to the card, and waits for the copy, at every call)."""
    rows = _DIAG_ROWS.get((d, device))
    if rows is None:
        rows = _DIAG_ROWS[(d, device)] = torch.as_tensor(
            [p * d - p * (p - 1) // 2 for p in range(d)], device=device)
    return rows


def flow_local_energy_cm(model, params, z_cm: torch.Tensor, y: torch.Tensor,
                         g0: torch.Tensor, Hp0: torch.Tensor):
    """Hessian flow from base samples z_cm (d, B) and their base (y, g0, Hp0)
    -> x (d, B), eloc (B,), logp (B,), g (d, B), through ``model.ops``."""
    d = z_cm.shape[0]
    cnf = model.cnf
    x, logp, g, Hp = model.ops.hessian_flow(params, z_cm, y, g0, Hp0, cnf.t0,
                                            cnf.t1, steps=cnf.steps,
                                            method=cnf.method)
    lap = Hp.index_select(0, _diag_rows(d, Hp.device)).sum(0)
    eloc = -0.25 * lap - 0.125 * torch.sum(g * g, dim=0) \
        + model.potential_rows(x)
    return x, eloc, logp, g


class GSVMC:
    """Ground-state VMC model (static configuration; methods are functions
    of the parameter dict)."""

    def __init__(self, nup: int, ndown: int, basedist: FreeFermion, cnf: CNF,
                 pair_potential: Callable, sp_potential: Callable | None = None,
                 ops: ChainOps = KERNEL_OPS, laplacian_chunk: int | None = None):
        self.nup, self.ndown = nup, ndown
        self.ops = ops
        # Batch chunk of the nested-jvp engine (a memory bound).
        self.laplacian_chunk = laplacian_chunk
        self.n = nup + ndown
        self.occ_up = np.arange(nup, dtype=np.int32)
        self.occ_down = np.arange(ndown, dtype=np.int32)
        self.basedist = basedist
        self.cnf = cnf
        self.pair_potential = pair_potential
        self.sp_potential = sp_potential

    def sample(self, params, generator: torch.Generator, batch: int,
               equilibrium_steps: int = 100, tau: float = 0.1,
               dtype=torch.float64):
        """(z, x): z from the Slater density by the plain sampler (draws from
        ``generator``), x = flow(z)."""
        z = self.basedist.sample(self.occ_up, self.occ_down, generator,
                                 (batch,), equilibrium_steps=equilibrium_steps,
                                 tau=tau, dtype=dtype)
        return z, self.cnf.generate(params, z)

    def potential(self, x: torch.Tensor) -> torch.Tensor:
        pot = self.pair_potential(x)
        if self.sp_potential is not None:
            pot = pot + self.sp_potential(x)
        return pot

    def potential_rows(self, xd: torch.Tensor) -> torch.Tensor:
        """Potential from coordinate-major rows xd (n*dim, B)."""
        dim = self.basedist.dim
        V = self.pair_potential.V_rows(xd, self.n, dim)
        if self.sp_potential is not None:
            V = V + self.sp_potential.V_rows(xd, self.n, dim)
        return V

    def log_prob(self, params, x: torch.Tensor) -> torch.Tensor:
        """log p_theta(x) via the reverse flow."""
        z, delta_logp = self.cnf.delta_logp(params, x)
        return self.basedist.log_prob(self.occ_up, self.occ_down, z) - delta_logp

    def occ_qnums(self):
        """Occupied orbitals' 1D quantum numbers and the Hermite depth."""
        orb = self.basedist.orbitals
        nx_up = tuple(int(v) for v in orb.nx[self.occ_up])
        ny_up = tuple(int(v) for v in orb.ny[self.occ_up])
        nx_dn = tuple(int(v) for v in orb.nx[self.occ_down])
        ny_dn = tuple(int(v) for v in orb.ny[self.occ_down])
        ks = int(max(nx_up + ny_up + nx_dn + ny_dn)) + 1
        return nx_up, ny_up, nx_dn, ny_dn, ks

    def local_energy(self, params, x: torch.Tensor):
        """(eloc, logp) per walker of x (B, n, dim) by the nested-jvp engine:
        -1/4 lap logp - 1/8 |grad logp|^2 + V."""
        logp, grad_logp, lap_logp = y_grad_laplacian(
            lambda xs: self.log_prob(params, xs), x,
            chunk_size=self.laplacian_chunk)
        kinetic = -0.25 * lap_logp - 0.125 * torch.sum(grad_logp**2,
                                                       dim=(-2, -1))
        return kinetic + self.potential(x), logp

    def loss_and_metrics(self, params, x: torch.Tensor, mesh=None):
        """REINFORCE surrogate (differentiable in params) and {E, E_std} for
        generated walkers x.  The local energy is computed with the
        parameters detached; only ``log_prob`` carries their gradient."""
        with torch.no_grad():
            eloc, _ = self.local_energy(_detach(params), x)
        logp = self.log_prob(params, x)
        return self._reinforce_loss(eloc, logp, mesh)

    @staticmethod
    def _reinforce_loss(eloc, logp, mesh):
        """mean[(Eloc - E) logp] (this rank's share) and {E, E_std}."""
        E = walker_mean(mesh, eloc)
        E_std = walker_std(mesh, (eloc, E))
        loss = local_mean(mesh, (eloc - E) * logp)
        return loss, {"E": E, "E_std": E_std}

    def local_energy_from_base(self, params, z: torch.Tensor,
                               return_grad: bool = False,
                               chain: bool = False):
        """(x, eloc, logp[, g]) by the Hessian flow from z (B, n, dim): the
        plain one, or with ``chain`` ``local_energy_cm`` (the VGH and
        Hessian-flow kernels of ``self.ops``) in the same layout."""
        if chain:
            B, n, dim = z.shape
            x, eloc, logp, g = self.local_energy_cm(
                params, z.reshape(B, n * dim).T.contiguous())
            out = (x.T.reshape(B, n, dim), eloc, logp)
            return out + (g.T.contiguous(),) if return_grad else out
        return local_energy_flow(
            self.cnf.field_tensors,
            lambda z_: self.basedist.log_prob_vgh(self.occ_up, self.occ_down, z_),
            self.potential, params, z, self.cnf.t0, self.cnf.t1,
            steps=self.cnf.steps, method=self.cnf.method,
            return_grad=return_grad)

    def loss_and_metrics_from_base(self, params, z: torch.Tensor,
                                   chain: bool = False, mesh=None):
        """REINFORCE surrogate (differentiable in params) and {E, E_std}.

        Eloc comes from the plain Hessian flow, or with ``chain`` from
        ``local_energy_cm`` (the VGH and Hessian-flow kernels of
        ``self.ops``); either way autograd of ``log_prob`` gives the
        gradient in place of the REINFORCE adjoint."""
        with torch.no_grad():
            x, eloc, _ = self.local_energy_from_base(_detach(params), z,
                                                     chain=chain)
        return self._reinforce_loss(eloc, self.log_prob(params, x), mesh)

    def loss_metrics_grads(self, params, z: torch.Tensor, mesh=None):
        """(loss, metrics, grads) for walkers z (B, n, dim), no autograd."""
        B, n, dim = z.shape
        return self.loss_metrics_grads_cm(
            params, z.reshape(B, n * dim).T.contiguous(), mesh)

    @torch.no_grad()
    def local_energy_cm(self, params, z_cm: torch.Tensor):
        """Slater VGH -> Hessian flow -> observables, coordinate-major.

        z_cm (d, B) -> x (d, B), eloc (B,), logp (B,), g (d, B); every
        buffer stays (rows, B).
        """
        params = _detach(params)
        nx_up, ny_up, nx_dn, ny_dn, ks = self.occ_qnums()
        y, g0, Hp0 = self.ops.slater_vgh(z_cm, nx_up, ny_up, ks, nx_dn, ny_dn)
        return flow_local_energy_cm(self, params, z_cm, y, g0, Hp0)

    @torch.no_grad()
    def loss_metrics_grads_cm(self, params, z_cm: torch.Tensor, mesh=None):
        """The kernel chain on coordinate-major walkers z_cm (d, B):
        ``local_energy_cm`` then the REINFORCE adjoint (with ``mesh``, on
        this rank's rows; the gradient and loss summed over ranks)."""
        params = _detach(params)
        cnf = self.cnf
        x, eloc, logp, g = self.local_energy_cm(params, z_cm)
        E = walker_mean(mesh, eloc)
        E_std = walker_std(mesh, (eloc, E))
        w = (eloc - E) / global_batch(mesh, z_cm.shape[1])
        grads, _ = self.ops.reinforce(params, x, g, w.contiguous(), cnf.t0,
                                      cnf.t1, steps=cnf.steps,
                                      method=cnf.method)
        summed = all_sum_tree(mesh, {"grads": grads,
                                     "loss": torch.sum(w * logp)})
        return summed["loss"], {"E": E, "E_std": E_std}, summed["grads"]
