"""Unified model API for the LM paths: parameter defs, parameters on a
device, cache defs, and the prefill/decode functions over dense caches.

Counterpart of ``repro/models/api.py`` (``ModelAPI.param_defs``,
``init_params``, ``cache_defs``, ``prefill``, ``decode``, ``build``).  Two
ways to get parameters:

* :meth:`ModelAPI.init_params` materialises the reference's shapes,
  inits, scales and dtypes on a device from an explicit
  ``torch.Generator`` (not jax.random's values);
* :meth:`ModelAPI.params_from_numpy` carries the reference's own tree
  (nested dicts and tuples of arrays, the stacked period axis kept) into
  the port, so both packages compute the same function.

Caches are ``layers.init_tree(api.cache_defs(b, s), 0, device)``; prefill
and decode write them in place and return them.  ``train_loss`` is the
reference's, differentiable with ``torch.autograd``.  The dry-run specs
(``abstract_*``, ``*_pspecs``, ``input_specs``) wait for their ROADMAP
item.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import encdec as E
from . import layers as L
from . import transformer as T
from .vlm import vlm_prefill, vlm_train_loss


@dataclass
class ModelAPI:
    cfg: ModelConfig
    tp: int

    def param_defs(self):
        if self.cfg.family == "encdec":
            return E.encdec_param_defs(self.cfg, self.tp)
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

    # ---------------------------------------------------------------- cache
    def cache_defs(self, batch: int, seq: int, *, long_mode: bool = False):
        """ParamDefs of the dense caches (zeros, ``cfg.dtype``); a VLM's
        seq covers its patches, which are part of the prefill."""
        if self.cfg.family == "encdec":
            return E.encdec_cache_defs(self.cfg, batch, seq, tp=self.tp)
        return T.decoder_cache_defs(self.cfg, batch, seq, tp=self.tp,
                                    long_mode=long_mode)

    # ------------------------------------------------------------ functions
    def train_loss(self, params, batch):
        """(loss, metrics) of one batch: tokens and labels (labels < 0
        masked), and the frames or patches where the family takes them."""
        cfg = self.cfg
        if cfg.family == "encdec":
            return E.encdec_train_loss(params, cfg, batch["frames"],
                                       batch["tokens"], batch["labels"])
        if cfg.family == "vlm":
            return vlm_train_loss(params, cfg, batch["patches"],
                                  batch["tokens"], batch["labels"])
        return T.lm_train_loss(params, cfg, batch["tokens"], batch["labels"])

    def prefill(self, params, batch, caches):
        """(last logits, caches), and the encoder's output for encdec."""
        cfg = self.cfg
        if cfg.family == "encdec":
            return E.encdec_prefill(params, cfg, batch["frames"],
                                    batch["tokens"], caches)
        if cfg.family == "vlm":
            return vlm_prefill(params, cfg, batch["patches"],
                               batch["tokens"], caches)
        return T.lm_prefill(params, cfg, batch["tokens"], caches)

    def decode(self, params, batch, caches):
        """One step: (logits, caches)."""
        cfg = self.cfg
        if cfg.family == "encdec":
            return E.encdec_decode(params, cfg, batch["tokens"], caches,
                                   batch["lengths"], batch["enc_out"])
        return T.lm_decode(params, cfg, batch["tokens"], caches,
                           batch["lengths"])


def build(cfg: ModelConfig, tp: int = 1) -> ModelAPI:
    return ModelAPI(cfg=cfg, tp=tp)
