"""LM models on tensors: the attention-mixer families, decoder,
VLM and encoder-decoder (see ``api``)."""
from . import layers
from .api import ModelAPI, build

__all__ = ["ModelAPI", "build", "layers"]
