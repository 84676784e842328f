"""Execution across images and cards: the batched fleet on one card
(:mod:`.runner`), multi-process data parallelism (:mod:`.multihost`), and the
(dp, tp) mesh (:mod:`.mesh`, with the tensor-parallel UNet of :mod:`.tp`)."""

from .mesh import (  # noqa: F401
    Mesh, batch_sharding, dp_mean, dp_sum, gather_batch, make_mesh, replicated, shard_batch,
    shard_params,
)
from .multihost import (  # noqa: F401
    barrier, gather_pytree, gather_scalars, host_slice, initialize, is_multihost,
    process_count, process_index, rank_suffix,
)
