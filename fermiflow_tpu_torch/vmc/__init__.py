from fermiflow_tpu_torch.vmc.beta import BetaVMC
from fermiflow_tpu_torch.vmc.gs import GSVMC

__all__ = ["BetaVMC", "GSVMC"]
