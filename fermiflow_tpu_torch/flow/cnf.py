"""Continuous normalizing flow over fermion coordinates
(port of ``fermiflow_tpu/flow/cnf.py``, fixed-grid solver only)."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from fermiflow_tpu_torch.ode import odeint

__all__ = ["CNF"]


@dataclasses.dataclass(frozen=True)
class CNF:
    """Static configuration of the flow; methods are pure functions of params.

    Attributes:
      velocity: (params, x) -> v; divergence: (params, x) -> div v.
      field_tensors: closed-form field derivatives (nn/backflow_derivs.py)
        used by the Hessian-flow local energy.
      t0, t1, steps, method: the fixed integration grid.
    """

    velocity: Callable
    divergence: Callable
    field_tensors: Callable | None = None
    t0: float = 0.0
    t1: float = 1.0
    steps: int = 16
    method: str = "dopri5"

    def generate(self, params, z: torch.Tensor) -> torch.Tensor:
        """Push base samples z -> x through the flow."""
        return odeint(lambda p, t, x: self.velocity(p, x), params, z,
                      self.t0, self.t1, steps=self.steps, method=self.method)

    def delta_logp(self, params, x: torch.Tensor):
        """Reverse-integrate (x, logdet) from t1 to t0: returns (z, delta_logp)
        with log p_x(x) = log p_z(z) - delta_logp."""
        def f(p, t, state):
            xt, _ = state
            return (self.velocity(p, xt), -self.divergence(p, xt))

        lp0 = torch.zeros(x.shape[:-2], dtype=x.dtype, device=x.device)
        return odeint(f, params, (x, lp0), self.t1, self.t0,
                      steps=self.steps, method=self.method)
