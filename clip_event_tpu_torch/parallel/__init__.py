"""Parallelism of the port: one process per GPU on a (dcn × dp × tp) or
(dp × pp) mesh (counterpart of `clip_event_tpu/parallel/`; reference
DDP/NCCL stack, `utils.py:541-616`), Megatron tensor parallelism over the
tp ranks (`sharding.py`), GPipe over the pp ranks (`pipeline.py`) and
ZeRO-1 / FSDP over the data ranks on top of either (`sharding.py`)."""

from clip_event_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    initialize_distributed,
    make_mesh,
    replicate,
    shard_batch,
)
