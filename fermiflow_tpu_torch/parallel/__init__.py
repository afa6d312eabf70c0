from fermiflow_tpu_torch.parallel.mesh import (
    WalkerMesh,
    all_mean,
    all_sum,
    init_distributed,
    make_walker_mesh,
    shard_walkers,
)

__all__ = ["WalkerMesh", "make_walker_mesh", "shard_walkers",
           "init_distributed", "all_sum", "all_mean"]
