"""Data parallelism of the port: one process per GPU (counterpart of
`clip_event_tpu/parallel/`, the `dp` mesh; reference DDP/NCCL stack,
`utils.py:541-616`)."""

from clip_event_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    initialize_distributed,
    make_mesh,
    replicate,
    shard_batch,
)
