"""Single-device training: AdamW, the int8 error-feedback compressed mean,
checkpoints in the reference's layout, and the fault-tolerant trainer."""
from . import optimizer, checkpoint, trainer, collectives
from .optimizer import AdamWConfig
from .trainer import Trainer, make_train_step
from .checkpoint import Checkpointer

__all__ = ["optimizer", "checkpoint", "trainer", "collectives",
           "AdamWConfig", "Trainer", "make_train_step", "Checkpointer"]
