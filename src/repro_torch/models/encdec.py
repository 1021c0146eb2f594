"""Encoder-decoder backbone (seamless-m4t): bidirectional encoder over
precomputed frame embeddings (the stubbed speech frontend), causal
decoder with per-layer cross-attention.

Counterpart of ``repro/models/encdec.py``.  Both stacks are the
reference's period-1 scans, Python loops over the stacked layers here;
with ``remat`` each layer's body runs under non-reentrant
``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``.  On
the card the encoder's attention is the flash_attention kernel with
``causal=False``, and so is cross-attention (no ``kv_len``, one query at
decode); the decoder's self-attention is the dense cache's
(``layers.attn_apply``).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from . import layers as L
from .transformer import chunked_xent


def encdec_param_defs(cfg, tp: int):
    enc_layer = {"attn": L.attn_defs(cfg, tp), "mlp": L.mlp_defs(cfg, tp)}
    dec_layer = {"self": L.attn_defs(cfg, tp),
                 "cross": L.attn_defs(cfg, tp),
                 "mlp": L.mlp_defs(cfg, tp)}
    return {
        "embed": L.embed_defs(cfg, tp),
        "enc": L.stack_defs(enc_layer, cfg.enc_layers),
        "enc_ln": L.norm_def(cfg.d_model),
        "dec": L.stack_defs(dec_layer, cfg.num_layers),
    }


def _cross_kv(p_cross, enc_out, cfg):
    """Per-layer projected encoder KV (B,S,KVH,hd)."""
    k = torch.einsum("bsd,dhk->bshk", enc_out,
                     p_cross["wk"].to(enc_out.dtype))
    v = torch.einsum("bsd,dhk->bshk", enc_out,
                     p_cross["wv"].to(enc_out.dtype))
    return k, v


def encode(params, cfg, frames, *, remat=False):
    """frames (B,S,D) -> encoder output (B,S,D)."""
    def body(x, i):
        p = L.take_layer(params["enc"], i)
        x, _ = L.attn_apply(p["attn"], x, cfg, causal=False)
        return L.mlp_apply(p["mlp"], x, cfg)

    x = frames.to(getattr(torch, cfg.dtype))
    for i in range(cfg.enc_layers):
        x = checkpoint(body, x, i, use_reentrant=False) if remat \
            else body(x, i)
    return L.rms_norm(x, params["enc_ln"], cfg.norm_eps)


def decode_stack(params, cfg, x, enc_out, *, caches=None, cache_len=None,
                 positions=None, enc_len=None, remat=False):
    """Decoder over x (B,T,D); caches = {"self": stacked attn caches},
    written in place and returned."""
    def body(x, enc_out, i):
        p = L.take_layer(params["dec"], i)
        c = None if caches is None else L.take_layer(caches["self"], i)
        x, _ = L.attn_apply(p["self"], x, cfg, causal=True,
                            positions=positions, cache=c,
                            cache_len=cache_len)
        kv = _cross_kv(p["cross"], enc_out, cfg)
        x, _ = L.attn_apply(p["cross"], x, cfg, kv_override=kv,
                            kv_len=enc_len)
        return L.mlp_apply(p["mlp"], x, cfg)

    for i in range(cfg.num_layers):
        x = checkpoint(body, x, enc_out, i, use_reentrant=False) if remat \
            else body(x, enc_out, i)
    return x, caches


def encdec_train_loss(params, cfg, frames, tokens, labels):
    remat = cfg.remat == "full"
    enc_out = encode(params, cfg, frames, remat=remat)
    x = L.embed_apply(params["embed"], tokens, cfg)
    x, _ = decode_stack(params, cfg, x, enc_out, remat=remat)
    mask = (labels >= 0).float()
    loss = chunked_xent(params, cfg, x, torch.clamp(labels, min=0), mask)
    return loss, {"xent": loss}


def encdec_prefill(params, cfg, frames, tokens, caches):
    enc_out = encode(params, cfg, frames)
    x = L.embed_apply(params["embed"], tokens, cfg)
    x, caches = decode_stack(params, cfg, x, enc_out, caches=caches,
                             cache_len=0)
    return L.logits_apply(params["embed"], x[:, -1:], cfg), caches, enc_out


def encdec_decode(params, cfg, tokens, caches, lengths, enc_out):
    x = L.embed_apply(params["embed"], tokens, cfg)
    positions = lengths[:, None] + torch.arange(
        tokens.shape[1], device=lengths.device)[None, :]
    x, caches = decode_stack(params, cfg, x, enc_out, caches=caches,
                             cache_len=lengths, positions=positions)
    return L.logits_apply(params["embed"], x, cfg), caches


def encdec_cache_defs(cfg, batch: int, seq: int, *, tp: int,
                      long_mode: bool = False):
    return {"self": L.stack_defs(
        L.attn_cache_defs(cfg, batch, seq, tp=tp, long_mode=long_mode),
        cfg.num_layers)}
