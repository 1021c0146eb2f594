"""VLM backbone (internvl2): precomputed patch embeddings (the stubbed
InternViT frontend) prepended to the text embedding sequence, then the
standard decoder stack.

Counterpart of ``repro/models/vlm.py``'s ``vlm_prefill``; the training
loss waits for its ROADMAP item."""
from __future__ import annotations

import torch

from . import layers as L
from .transformer import decoder_forward


def vlm_prefill(params, cfg, patches, tokens, caches):
    """patches (B,P,D) float, tokens (B,T_text) -> (last logits, caches)."""
    xt = L.embed_apply(params["embed"], tokens, cfg)
    x = torch.cat([patches.to(xt.dtype), xt], dim=1)
    x, caches, _ = decoder_forward(params, cfg, x, caches=caches,
                                   cache_len=0)
    return L.logits_apply(params["embed"], x[:, -1:], cfg), caches
