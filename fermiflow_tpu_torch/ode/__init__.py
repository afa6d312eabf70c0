from fermiflow_tpu_torch.ode.integrators import TABLEAUS, odeint, rk_step, tree_map

__all__ = ["TABLEAUS", "odeint", "rk_step", "tree_map"]
