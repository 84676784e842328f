"""Execution across images: the batched fleet on one card
(:mod:`.runner`) and multi-process data parallelism (:mod:`.multihost`)."""

from .multihost import (  # noqa: F401
    barrier, gather_pytree, gather_scalars, host_slice, initialize, is_multihost,
    process_count, process_index, rank_suffix,
)
