"""Parallel schemes — counterpart of ``ternary_spgemm_tpu/parallel/``.

Only the ring all-gather SpMM is here so far (:mod:`.ring_kernel`, one
card, its ranks emulated by groups of blocks); the sharded SpMM, FFN and
pipeline schemes come with the port's multi-card work.
"""

from ternary_spgemm_tpu_torch.parallel.ring_kernel import (  # noqa: F401
    ring_allgather_spgemm,
    ring_allgather_spgemm_plain,
    ring_launch,
)
