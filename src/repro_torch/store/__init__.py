from .blockdev import (BlockDevice, DeviceFailedError, PAGE_BYTES,
                       SLOTS_PER_PAGE)
from .graphstore import (GraphStore, bucket_pairs, csr_from_pairs,
                         mirror_edges, preprocess_edges)
from .sampler import (sample_batch, sample_batch_ref, pad_batch,
                      SampledBatch, LayerBlock)

__all__ = ["BlockDevice", "DeviceFailedError", "PAGE_BYTES",
           "SLOTS_PER_PAGE", "GraphStore", "preprocess_edges",
           "mirror_edges", "bucket_pairs", "csr_from_pairs",
           "sample_batch", "sample_batch_ref", "pad_batch", "SampledBatch",
           "LayerBlock"]
