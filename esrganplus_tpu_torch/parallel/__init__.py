from esrganplus_tpu_torch.parallel.mesh import (
    all_reduce,
    all_reduce_grads,
    backend,
    barrier,
    destroy_process_group,
    global_rows,
    init_process_group,
    is_initialized,
    local_batch_size,
    local_rows,
    rank,
    reduce_logs,
    replicate_tree,
    row_offset,
    world_size,
)

__all__ = ["init_process_group", "destroy_process_group", "is_initialized", "rank",
           "world_size", "backend", "barrier", "local_batch_size", "local_rows",
           "row_offset", "global_rows", "replicate_tree", "all_reduce", "all_reduce_grads",
           "reduce_logs"]
