from foundationpose_tpu_torch.parallel import multihost  # noqa: F401
from foundationpose_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    all_gather_rows,
    all_reduce_grads,
    all_sum,
    get_mesh,
    make_device_mesh,
    replicate,
    shard_batch,
    shard_rows,
)
