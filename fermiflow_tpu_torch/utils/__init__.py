from fermiflow_tpu_torch.utils.checkpointing import (
    restore_checkpoint,
    save_checkpoint,
)
from fermiflow_tpu_torch.utils.metrics import MetricsLogger
from fermiflow_tpu_torch.utils.profiling import PhaseTimer, trace

__all__ = ["MetricsLogger", "restore_checkpoint", "save_checkpoint", "trace",
           "PhaseTimer"]
