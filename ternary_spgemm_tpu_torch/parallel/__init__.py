"""Multi-card execution — counterpart of ``ternary_spgemm_tpu/parallel/``
on ``torch.distributed``: mesh construction and container sharding
(:mod:`.sharding`), the column-, row- and ring-sharded SpMM
(:mod:`.spgemm`), the tensor-parallel fused SwiGLU (:mod:`.ffn`) and the
GPipe pipeline (:mod:`.pipeline`), each running the port's kernels on the
ranks' local shards; and the ring all-gather SpMM on one card
(:mod:`.ring_kernel`, its ranks groups of blocks of one launch; with one
rank a card it needs several cards).
"""

from ternary_spgemm_tpu_torch.parallel.ffn import tensor_parallel_fused_swiglu
from ternary_spgemm_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    pipeline_lm_apply,
    stack_stages,
)
from ternary_spgemm_tpu_torch.parallel.ring_kernel import (  # noqa: F401
    ring_allgather_spgemm,
    ring_allgather_spgemm_plain,
    ring_launch,
)
from ternary_spgemm_tpu_torch.parallel.sharding import (  # noqa: F401
    SHARDABLE_FORMATS,
    column_leaf_specs,
    container_from_local_shard,
    init_distributed,
    localize,
    make_mesh,
    placements,
    row_leaf_specs,
    shard_container,
    spec_tree,
)
from ternary_spgemm_tpu_torch.parallel.spgemm import (
    column_sharded_spgemm,
    overlapped_gather_spgemm,
    row_sharded_spgemm,
)

__all__ = [
    "SHARDABLE_FORMATS", "make_mesh", "shard_container", "spec_tree",
    "column_leaf_specs", "row_leaf_specs", "localize",
    "container_from_local_shard",
    "column_sharded_spgemm", "row_sharded_spgemm", "overlapped_gather_spgemm",
    "ring_allgather_spgemm", "tensor_parallel_fused_swiglu",
    "pipeline_apply", "pipeline_lm_apply", "stack_stages",
]
