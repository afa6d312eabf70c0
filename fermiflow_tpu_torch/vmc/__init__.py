from fermiflow_tpu_torch.vmc.gs import GSVMC

__all__ = ["GSVMC"]
