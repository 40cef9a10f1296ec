"""Parallelism layer: device meshes + sharding rules.

Replaces the reference's torch DDP/NCCL runtime (SURVEY.md section 2.3)
with ``jax.sharding.Mesh`` + named shardings: batch over the 'data' axis
(gradient psum == DDP allreduce, inserted by XLA), the candidate-class axis
optionally over 'model' for large open-vocabulary label tables (the softmax
logsumexp becomes an all-reduce automatically).
"""

from rangeclip.parallel.mesh import (
    make_mesh,
    shard_batch,
    shard_state,
    replicate,
    shard_class_tables,
)

__all__ = [
    "make_mesh",
    "shard_batch",
    "shard_state",
    "replicate",
    "shard_class_tables",
]
