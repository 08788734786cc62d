"""Distribution utilities: ring collectives over a mesh axis, int8
gradient compression with error feedback, the GPipe pipeline."""
from repro_torch.distributed.collectives import (
    all_gather, all_reduce_max, ordered_sum, ring_all_gather, ring_all_reduce, ring_hop,
    ring_reduce_scatter, ring_streamed_map,
)
from repro_torch.distributed.compression import (
    EFState, compressed_psum, compression_ratio, init_ef,
)
from repro_torch.distributed.pipeline import bubble_fraction, pipeline_forward

__all__ = ["all_gather", "all_reduce_max", "ordered_sum", "ring_all_gather", "ring_all_reduce", "ring_hop",
           "ring_reduce_scatter", "ring_streamed_map", "EFState", "compressed_psum",
           "compression_ratio", "init_ef", "bubble_fraction", "pipeline_forward"]
