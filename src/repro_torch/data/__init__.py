"""Synthetic training data (see ``pipeline``)."""
from .pipeline import Pipeline, synth_batch

__all__ = ["Pipeline", "synth_batch"]
