from fermiflow_tpu_torch.nn.backflow import (
    Backflow,
    backflow_apply,
    backflow_divergence,
    backflow_init_gaussian,
    backflow_init_zeros,
    params_from_jax,
    params_to_numpy,
)
from fermiflow_tpu_torch.nn.mlp import (
    mlp_apply,
    mlp_derivs3,
    mlp_grad,
    mlp_init_gaussian,
    mlp_init_zeros,
)

__all__ = [
    "Backflow",
    "backflow_apply",
    "backflow_divergence",
    "backflow_init_gaussian",
    "backflow_init_zeros",
    "params_from_jax",
    "params_to_numpy",
    "mlp_apply",
    "mlp_derivs3",
    "mlp_grad",
    "mlp_init_gaussian",
    "mlp_init_zeros",
]
