"""LM models on tensors: the attention/MLP decoder LMs (see ``api``)."""
from . import layers
from .api import ModelAPI, build

__all__ = ["ModelAPI", "build", "layers"]
