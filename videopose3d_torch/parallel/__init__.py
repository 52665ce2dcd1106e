from videopose3d_torch.parallel.mesh import (
    BatchShard,
    DataParallel,
    all_reduce_,
    all_reduce_gradients,
    all_reduce_sum,
    broadcast_module,
    initialize_distributed,
    launcher_world_size,
    process_info,
    rank_rows,
    shard_batch_size,
)

__all__ = ["BatchShard", "DataParallel", "all_reduce_", "all_reduce_gradients",
           "all_reduce_sum", "broadcast_module", "initialize_distributed",
           "launcher_world_size", "process_info", "rank_rows", "shard_batch_size"]
