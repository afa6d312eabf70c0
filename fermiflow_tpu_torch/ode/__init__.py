from fermiflow_tpu_torch.ode.adaptive import odeint_adaptive
from fermiflow_tpu_torch.ode.adjoint import odeint_adjoint
from fermiflow_tpu_torch.ode.integrators import (
    TABLEAUS,
    odeint,
    odeint_trajectory,
    rk_step,
    tree_map,
)

__all__ = ["TABLEAUS", "odeint", "odeint_adaptive", "odeint_adjoint",
           "odeint_trajectory", "rk_step", "tree_map"]
