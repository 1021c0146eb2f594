from .transport import PCIeChannel, serialize, deserialize
from .server import RPCServer, MethodStats
from .client import RPCClient
from .queues import (MultiQueueRoP, QueuePair, AsyncRPCClient,
                     QueueFullError, BackpressureError)

__all__ = ["PCIeChannel", "serialize", "deserialize", "RPCServer",
           "MethodStats", "RPCClient", "MultiQueueRoP", "QueuePair",
           "AsyncRPCClient", "QueueFullError", "BackpressureError"]
