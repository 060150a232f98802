from layoutdm_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_group,
    gather_rows,
    make_mesh,
    replicate,
    shard_batch,
)
