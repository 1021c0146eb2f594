"""Unified model API for the LM paths: parameter defs, parameters on a
device, abstract and PartitionSpec trees, cache defs, the prefill/decode
functions over dense caches, and the dry-run ``input_specs``.

Counterpart of ``repro/models/api.py``, method for method.  Two ways to
get parameters:

* :meth:`ModelAPI.init_params` materialises the reference's shapes,
  inits, scales and dtypes on a device from an explicit
  ``torch.Generator`` (not jax.random's values);
* :meth:`ModelAPI.params_from_numpy` carries the reference's own tree
  (nested dicts and tuples of arrays, the stacked period axis kept) into
  the port, so both packages compute the same function.

Caches are ``layers.init_tree(api.cache_defs(b, s), 0, device)``; prefill
and decode write them in place and return them.  ``train_loss`` is the
reference's, differentiable with ``torch.autograd``.  ``abstract_*`` and
``input_specs`` give tensors on the ``meta`` device (shapes and dtypes,
no storage); ``*_pspecs`` give ``layers.PSpec`` trees resolved against
the mesh of ``layers.use_mesh``, equal to the reference's entry for
entry.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeConfig
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

    def abstract_params(self, *, dtype=None):
        """dtype="bfloat16" gives the serving-weight tree (inference cells
        hold bf16 weights; training holds fp32 masters)."""
        tree = L.abstract_tree(self.param_defs())
        if dtype is None:
            return tree
        dt = getattr(torch, dtype)
        return L.tree_map(lambda a: torch.empty(
            a.shape, dtype=dt if a.dtype.is_floating_point else a.dtype,
            device="meta"), tree)

    def param_pspecs(self):
        return L.pspec_tree(self.param_defs())

    def model_split(self) -> bool:
        """Whether a meshed step splits this architecture's compute over
        the model axis, to train (``train/trainer.py::MeshStep``) and to
        serve (``launch/serve.py::MeshServe``: prefill and decode, each
        slot on its own block of every cache): where every layer is GQA
        attention (global, local or NoPE), MLA, Mamba, mLSTM or sLSTM and
        the gated MLP, an MoE FFN or none, with an embedding and logits
        (split by vocabulary rows, or along ``d_model`` where the
        vocabulary does not divide the model degree), as in llama3.2-3b,
        gemma3-12b/27b, internvl2-76b, phi3.5-moe, llama4-scout,
        minicpm3-4b, jamba-v0.1-52b (the ``hybrid`` family: Mamba layers
        by inner channels beside GQA attention, gated MLPs and MoE FFNs),
        xlstm-125m (the ``ssm`` family: mLSTM by rows of C, sLSTM whole
        on each data row's first slot) and seamless-m4t-large-v2 (the
        ``encdec`` family: the encoder's attention and the decoder's
        self- and cross-attention by heads, the encoder's output sent to
        each model slot once a step where the cross ``wk``/``wv`` split:
        ``encdec.py``)."""
        return all(k in ("attn", "local", "nope", "mamba", "mlstm", "slstm")
                   for k in self.cfg.period_pattern)

    # ---------------------------------------------------------------- cache
    def cache_defs(self, batch: int, seq: int, *, long_mode: bool = False):
        """ParamDefs of the dense caches (zeros, ``cfg.dtype``); a VLM's
        seq covers its patches, which are part of the prefill."""
        if self.cfg.family == "encdec":
            return E.encdec_cache_defs(self.cfg, batch, seq, tp=self.tp)
        return T.decoder_cache_defs(self.cfg, batch, seq, tp=self.tp,
                                    long_mode=long_mode)

    def abstract_cache(self, batch, seq, **kw):
        return L.abstract_tree(self.cache_defs(batch, seq, **kw))

    def cache_pspecs(self, batch, seq, **kw):
        return L.pspec_tree(self.cache_defs(batch, seq, **kw))

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

    # ----------------------------------------------------------- input specs
    def input_specs(self, shape: ShapeConfig) -> dict:
        """Stand-ins for every model input on the ``meta`` device."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        dt = getattr(torch, cfg.dtype)

        def t(*dims, dtype=torch.int32):
            return torch.empty(dims, dtype=dtype, device="meta")

        if shape.kind == "train":
            if cfg.family == "encdec":
                return {"frames": t(b, s // 2, cfg.d_model, dtype=dt),
                        "tokens": t(b, s // 2), "labels": t(b, s // 2)}
            if cfg.family == "vlm":
                p = cfg.num_patches
                return {"patches": t(b, p, cfg.d_model, dtype=dt),
                        "tokens": t(b, s - p), "labels": t(b, s - p)}
            return {"tokens": t(b, s), "labels": t(b, s)}
        if shape.kind == "prefill":
            if cfg.family == "encdec":
                return {"frames": t(b, s, cfg.d_model, dtype=dt),
                        "tokens": t(b, s)}
            if cfg.family == "vlm":
                p = cfg.num_patches
                return {"patches": t(b, p, cfg.d_model, dtype=dt),
                        "tokens": t(b, s - p)}
            return {"tokens": t(b, s)}
        # decode
        out = {"tokens": t(b, 1), "lengths": t(b)}
        if cfg.family == "encdec":
            out["enc_out"] = t(b, s, cfg.d_model, dtype=dt)
        return out

    def input_pspecs(self, shape: ShapeConfig) -> dict:
        dp = () if _is_long_mode(shape) else L.DP
        by_ndim = {3: L.resolve_pspec((dp, None, None)),
                   2: L.resolve_pspec((dp, None)),
                   1: L.resolve_pspec((dp,))}
        return {k: by_ndim[v.dim()]
                for k, v in self.input_specs(shape).items()}


def _is_long_mode(shape: ShapeConfig) -> bool:
    return shape.kind == "decode" and shape.global_batch == 1


def build(cfg: ModelConfig, tp: int = 1) -> ModelAPI:
    return ModelAPI(cfg=cfg, tp=tp)
