from .batcher import (ServiceProgram, split_service_dfg, sample_group,
                      pad_group, fingerprint_weights)

__all__ = ["ServiceProgram", "split_service_dfg", "sample_group",
           "pad_group", "fingerprint_weights"]
