from .batcher import (ServiceProgram, split_service_dfg, sample_group,
                      pad_group, fingerprint_weights)
from .scheduler import BatchScheduler, AdmissionError, QoSTelemetry
from .runtime import ServingRuntime
from .supervisor import ShardSupervisor, HealthPolicy

__all__ = ["ServiceProgram", "split_service_dfg", "sample_group",
           "pad_group", "fingerprint_weights", "BatchScheduler",
           "AdmissionError", "QoSTelemetry", "ServingRuntime",
           "ShardSupervisor", "HealthPolicy"]
