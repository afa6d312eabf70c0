from fermiflow_tpu_torch.flow.cnf import CNF

__all__ = ["CNF"]
