from fermiflow_tpu_torch.utils.metrics import MetricsLogger

__all__ = ["MetricsLogger"]
