from layoutdm_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_group,
    make_mesh,
    replicate,
    shard_batch,
)
