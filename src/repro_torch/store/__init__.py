from .blockdev import (BlockDevice, DeviceFailedError, PAGE_BYTES,
                       SLOTS_PER_PAGE)
from .graphstore import (GraphStore, bucket_pairs, csr_from_pairs,
                         mirror_edges, preprocess_edges)
from .endpoint import (LocalShardEndpoint, RopShardEndpoint, ShardEndpoint,
                       ShardHost, ShardService, make_local_endpoints,
                       make_rop_endpoints)
from .ingest import MutationFirehose, distributed_update_graph
from .sharded import (FlowControl, ReplicatedGraphStore, ShardedGraphStore,
                      partition_csr)
from .sampler import (sample_batch, sample_batch_ref, pad_batch,
                      SampledBatch, LayerBlock)

__all__ = ["BlockDevice", "DeviceFailedError", "PAGE_BYTES",
           "SLOTS_PER_PAGE", "GraphStore", "ShardedGraphStore",
           "ReplicatedGraphStore", "FlowControl", "partition_csr",
           "ShardEndpoint", "ShardService", "LocalShardEndpoint",
           "RopShardEndpoint", "ShardHost", "make_local_endpoints",
           "make_rop_endpoints",
           "preprocess_edges", "mirror_edges", "bucket_pairs",
           "csr_from_pairs", "MutationFirehose", "distributed_update_graph",
           "sample_batch", "sample_batch_ref",
           "pad_batch", "SampledBatch", "LayerBlock"]
