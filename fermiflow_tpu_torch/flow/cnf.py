"""Continuous normalizing flow over fermion coordinates
(port of ``fermiflow_tpu/flow/cnf.py``)."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from fermiflow_tpu_torch.ode import (
    odeint,
    odeint_adaptive,
    odeint_adjoint,
    odeint_trajectory,
)

__all__ = ["CNF"]


@dataclasses.dataclass(frozen=True)
class CNF:
    """Static configuration of the flow; methods are pure functions of params.

    Attributes:
      velocity: (params, x) -> v; divergence: (params, x) -> div v.
      field_tensors: closed-form field derivatives (nn/backflow_derivs.py)
        used by the Hessian-flow local energy.
      t0, t1, steps, method: the fixed integration grid.
      solver: "fixed" | "adaptive" | "adjoint" for ``generate``; the
        likelihood path and the Hessian flow keep the fixed grid.
      rtol, atol: the adaptive solver's tolerances.
    """

    velocity: Callable
    divergence: Callable
    field_tensors: Callable | None = None
    t0: float = 0.0
    t1: float = 1.0
    steps: int = 16
    method: str = "dopri5"
    solver: str = "fixed"
    rtol: float = 1e-6
    atol: float = 1e-8

    def _flow_rhs(self, p, t, x):
        return self.velocity(p, x)

    def _coupled_rhs(self, p, t, state):
        xt, _ = state
        return (self.velocity(p, xt), -self.divergence(p, xt))

    def generate(self, params, z: torch.Tensor) -> torch.Tensor:
        """Push base samples z -> x through the flow."""
        if self.solver == "adaptive":
            return odeint_adaptive(self._flow_rhs, params, z, self.t0,
                                   self.t1, rtol=self.rtol, atol=self.atol)
        if self.solver == "adjoint":
            return odeint_adjoint(self._flow_rhs, params, z, self.t0, self.t1,
                                  self.steps, self.method)
        return odeint(self._flow_rhs, params, z, self.t0, self.t1,
                      steps=self.steps, method=self.method)

    def generate_trajectory(self, params, z: torch.Tensor,
                            nframes: int) -> torch.Tensor:
        """Frames of the generative ODE for density movies:
        (nframes, *z.shape), z first."""
        ts = torch.linspace(self.t0, self.t1, nframes, dtype=z.dtype)
        return odeint_trajectory(self._flow_rhs, params, z, ts,
                                 method=self.method)

    def delta_logp(self, params, x: torch.Tensor, use_adjoint: bool = False):
        """Reverse-integrate (x, logdet) from t1 to t0: returns (z, delta_logp)
        with log p_x(x) = log p_z(z) - delta_logp."""
        lp0 = torch.zeros(x.shape[:-2], dtype=x.dtype, device=x.device)
        solve = odeint_adjoint if use_adjoint else odeint
        return solve(self._coupled_rhs, params, (x, lp0), self.t1, self.t0,
                     steps=self.steps, method=self.method)

    def check_reversibility(self, params, base_log_prob: Callable,
                            z: torch.Tensor) -> dict:
        """Round-trip z -> x -> z diagnostic: max |z_rev - z| and
        max |logp_rev - logp| (``base_log_prob``: batched log p_z)."""
        x = self.generate(params, z)
        _, logp_fwd = odeint(self._coupled_rhs, params, (z, base_log_prob(z)),
                             self.t0, self.t1, steps=self.steps,
                             method=self.method)
        z_rev, dlp = self.delta_logp(params, x)
        logp_rev = base_log_prob(z_rev) - dlp
        return {"max_abs_z_err": torch.max(torch.abs(z_rev - z)),
                "max_abs_logp_err": torch.max(torch.abs(logp_rev - logp_fwd))}
