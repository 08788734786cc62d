"""Distribution utilities: ring collectives over a mesh axis."""
from repro_torch.distributed.collectives import (
    all_gather, all_reduce_max, ring_all_gather, ring_hop, ring_reduce_scatter,
    ring_streamed_map,
)

__all__ = ["all_gather", "all_reduce_max", "ring_all_gather", "ring_hop",
           "ring_reduce_scatter", "ring_streamed_map"]
