"""Training on one device or on a mesh of slots: AdamW with ZeRO-1 specs,
the int8 error-feedback compressed mean, tensors laid out over slots,
checkpoints in the reference's layout, and the fault-tolerant trainer."""
from . import optimizer, checkpoint, trainer, collectives, sharded
from .optimizer import AdamWConfig
from .trainer import Trainer, make_train_step
from .checkpoint import Checkpointer

__all__ = ["optimizer", "checkpoint", "trainer", "collectives", "sharded",
           "AdamWConfig", "Trainer", "make_train_step", "Checkpointer"]
