"""Data-parallel synthesis and training across ``torch.distributed`` ranks.

Counterpart of ``self_attention_tacotron_tpu/parallel``: a mesh with a ``data``
axis (the batch split over ranks, for training and batched synthesis) and a
``model`` axis (the widest parameters placed in slices), over the ranks of the
default process group. See ``parallel/mesh.py`` and ``parallel/shard.py``.
"""

from self_attention_tacotron_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    init_from_env,
    make_mesh,
    param_sharding_rules,
    replicated,
    shard_batch,
    shard_params,
    spawn,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "init_from_env",
    "spawn",
    "batch_sharding",
    "replicated",
    "shard_batch",
    "shard_params",
    "param_sharding_rules",
]
