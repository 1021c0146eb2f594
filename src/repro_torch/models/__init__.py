"""LM models on tensors: the attention and recurrent (Mamba, mLSTM,
sLSTM) mixer families, decoder, VLM and encoder-decoder, their training
losses (see ``api``)."""
from . import layers
from .api import ModelAPI, build

__all__ = ["ModelAPI", "build", "layers"]
