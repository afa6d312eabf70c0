"""Ground-state variational Monte Carlo estimator (port of ``fermiflow_tpu/vmc/gs.py``).

Local energy Eloc = -1/4 lap logp - 1/8 |grad logp|^2 + V(x) and the
REINFORCE surrogate loss = mean[(Eloc - E) logp_theta(x)], Eloc detached.

Two gradient paths:
  * ``loss_and_metrics_from_base``: Eloc from the Hessian flow, logp_theta by
    the reverse ODE, gradient by autograd (the reference path, any dtype);
  * ``loss_metrics_grads``: no autograd at all.  The Slater-VGH, Hessian-flow
    and REINFORCE-adjoint kernel modules chain on coordinate-major (rows, B)
    buffers with no relayout, as the TPU tile chain does.
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
from fermiflow_tpu_torch.ops.slater_vgh import slater_vgh_cm, slater_vgh_cm_plain
from fermiflow_tpu_torch.physics.base_dist import FreeFermion
from fermiflow_tpu_torch.vmc.hessian_flow import local_energy_flow

__all__ = ["GSVMC", "ChainOps", "KERNEL_OPS", "PLAIN_OPS"]


class ChainOps(NamedTuple):
    """The three coordinate-major operations the no-autograd update chains."""

    slater_vgh: Callable
    hessian_flow: Callable
    reinforce: Callable


# The kernel wrappers (plain versions only for CPU tensors), and the plain
# versions on any device, which chip_smoke.py holds the kernels against.
KERNEL_OPS = ChainOps(slater_vgh_cm, hessian_flow_cm, reinforce_cm)
PLAIN_OPS = ChainOps(slater_vgh_cm_plain, hessian_flow_cm_plain,
                     reinforce_cm_plain)


def _detach(params):
    return {k: None if v is None else {kk: t.detach() for kk, t in v.items()}
            for k, v in params.items()}


class GSVMC:
    """Ground-state VMC model (static configuration; methods are functions
    of the parameter dict)."""

    def __init__(self, nup: int, ndown: int, basedist: FreeFermion, cnf: CNF,
                 pair_potential: Callable, sp_potential: Callable | None = None,
                 ops: ChainOps = KERNEL_OPS):
        self.nup, self.ndown = nup, ndown
        self.ops = ops
        self.n = nup + ndown
        self.occ_up = np.arange(nup, dtype=np.int32)
        self.occ_down = np.arange(ndown, dtype=np.int32)
        self.basedist = basedist
        self.cnf = cnf
        self.pair_potential = pair_potential
        self.sp_potential = sp_potential

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

    def local_energy_from_base(self, params, z: torch.Tensor,
                               return_grad: bool = False):
        """(x, eloc, logp[, g]) by the plain Hessian flow from z (B, n, dim)."""
        return local_energy_flow(
            self.cnf.field_tensors,
            lambda z_: self.basedist.log_prob_vgh(self.occ_up, self.occ_down, z_),
            self.potential, params, z, self.cnf.t0, self.cnf.t1,
            steps=self.cnf.steps, method=self.cnf.method,
            return_grad=return_grad)

    def loss_and_metrics_from_base(self, params, z: torch.Tensor):
        """REINFORCE surrogate (differentiable in params) and {E, E_std}."""
        with torch.no_grad():
            x, eloc, _ = self.local_energy_from_base(_detach(params), z)
        logp = self.log_prob(params, x)
        E = torch.mean(eloc)
        E_std = torch.std(eloc, correction=0)
        loss = torch.mean((eloc - E) * logp)
        return loss, {"E": E, "E_std": E_std}

    def loss_metrics_grads(self, params, z: torch.Tensor):
        """(loss, metrics, grads) for walkers z (B, n, dim), no autograd."""
        B, n, dim = z.shape
        return self.loss_metrics_grads_cm(
            params, z.reshape(B, n * dim).T.contiguous())

    @torch.no_grad()
    def local_energy_cm(self, params, z_cm: torch.Tensor):
        """Slater VGH -> Hessian flow -> observables, coordinate-major.

        z_cm (d, B) -> x (d, B), eloc (B,), logp (B,), g (d, B); every
        buffer stays (rows, B).
        """
        params = _detach(params)
        d = z_cm.shape[0]
        cnf = self.cnf
        nx_up, ny_up, nx_dn, ny_dn, ks = self.occ_qnums()
        y, g0, Hp0 = self.ops.slater_vgh(z_cm, nx_up, ny_up, ks, nx_dn, ny_dn)
        x, logp, g, Hp = self.ops.hessian_flow(params, z_cm, y, g0, Hp0,
                                               cnf.t0, cnf.t1, steps=cnf.steps,
                                               method=cnf.method)
        # Diagonal (p, p) of the packed upper triangle sits at row p*d - p(p-1)/2.
        diag = [p * d - p * (p - 1) // 2 for p in range(d)]
        lap = Hp[diag].sum(0)
        eloc = -0.25 * lap - 0.125 * torch.sum(g * g, dim=0) \
            + self.potential_rows(x)
        return x, eloc, logp, g

    @torch.no_grad()
    def loss_metrics_grads_cm(self, params, z_cm: torch.Tensor):
        """The kernel chain on coordinate-major walkers z_cm (d, B):
        ``local_energy_cm`` then the REINFORCE adjoint."""
        params = _detach(params)
        B = z_cm.shape[1]
        cnf = self.cnf
        x, eloc, logp, g = self.local_energy_cm(params, z_cm)
        E = torch.mean(eloc)
        E_std = torch.std(eloc, correction=0)
        w = (eloc - E) / B
        grads, _ = self.ops.reinforce(params, x, g, w.contiguous(), cnf.t0,
                                      cnf.t1, steps=cnf.steps,
                                      method=cnf.method)
        loss = torch.sum(w * logp)
        return loss, {"E": E, "E_std": E_std}, grads
