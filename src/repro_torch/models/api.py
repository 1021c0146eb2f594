"""Model API for the LM path: parameter defs and parameters on a device.

Counterpart of ``repro/models/api.py`` (``ModelAPI.param_defs``,
``init_params``, ``build``).  Two ways to get parameters:

* :meth:`ModelAPI.init_params` materialises the reference's shapes,
  inits, scales and dtypes on a device from an explicit
  ``torch.Generator`` (not jax.random's values);
* :meth:`ModelAPI.params_from_numpy` carries the reference's own tree
  (nested dicts and tuples of arrays, the stacked period axis kept) into
  the port, so both packages compute the same function.

Encoder-decoder families and the train/prefill/decode functions over a
dense cache wait for their ROADMAP items.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import layers as L
from . import transformer as T


@dataclass
class ModelAPI:
    cfg: ModelConfig
    tp: int

    def param_defs(self):
        if self.cfg.family == "encdec":
            raise T._not_ported("the encoder-decoder family")
        return T.decoder_param_defs(self.cfg, self.tp)

    def init_params(self, seed: int = 0, device=None):
        """The parameter tree on ``device`` (default: the card)."""
        return L.init_tree(self.param_defs(), seed, resolve_device(device))

    def params_from_numpy(self, tree, device=None):
        """The reference's parameter tree (``np.asarray`` of each leaf of
        ``repro``'s ``init_params``) as the port's tensors on ``device``;
        raises ``ValueError`` where a shape or the structure differs."""
        dev = resolve_device(device)

        def leaf(d: L.ParamDef, a):
            a = np.asarray(a)
            if tuple(a.shape) != tuple(d.shape):
                raise ValueError(f"parameter of shape {a.shape}, expected "
                                 f"{d.shape}")
            return torch.from_numpy(np.array(a)).to(
                device=dev, dtype=getattr(torch, d.dtype))

        return L.tree_map(leaf, self.param_defs(), tree)


def build(cfg: ModelConfig, tp: int = 1) -> ModelAPI:
    return ModelAPI(cfg=cfg, tp=tp)
