"""Multi-process data parallelism (``torch.distributed``): the group, its
host traffic and launcher (``distributed.py``), and the collectives and
row placement of a data-parallel step (``mesh.py``)."""

from sgg_torch.parallel.distributed import (  # noqa: F401
    Group, all_agree, current, gather_rows, host_all_reduce, host_mean,
    init_group, initialize, launched, local_device, process_local_indices,
    rank, shutdown, spawn, sync_processes, using, world_size,
)
from sgg_torch.parallel.mesh import (  # noqa: F401
    GradReducer, all_reduce, all_reduce_metrics, all_reduce_scalars,
    bits_equal_to_rank0, global_rand, replicate, shard_rows,
)
