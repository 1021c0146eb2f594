"""VLM backbone (internvl2): precomputed patch embeddings (the stubbed
InternViT frontend) prepended to the text embedding sequence, then the
standard decoder stack.  Loss is computed on text positions only.

Counterpart of ``repro/models/vlm.py``."""
from __future__ import annotations

import torch

from . import layers as L
from .transformer import chunked_xent, decoder_forward


def vlm_train_loss(params, cfg, patches, tokens, labels):
    """patches (B,P,D) float; tokens/labels (B,T_text)."""
    xt = L.embed_apply(params["embed"], tokens, cfg)
    x = torch.cat([patches.to(xt.dtype), xt], dim=1)
    x, _, aux = decoder_forward(params, cfg, x, remat=(cfg.remat == "full"))
    x_text = x[:, patches.shape[1]:]
    mask = (labels >= 0).float()
    loss = chunked_xent(params, cfg, x_text, torch.clamp(labels, min=0),
                        mask)
    return loss + 0.01 * aux, {"xent": loss, "aux": aux}


def vlm_prefill(params, cfg, patches, tokens, caches):
    """patches (B,P,D) float, tokens (B,T_text) -> (last logits, caches)."""
    xt = L.embed_apply(params["embed"], tokens, cfg)
    x = torch.cat([patches.to(xt.dtype), xt], dim=1)
    x, caches, _ = decoder_forward(params, cfg, x, caches=caches,
                                   cache_len=0)
    return L.logits_apply(params["embed"], x[:, -1:], cfg), caches
