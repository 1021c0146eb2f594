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

A meshed step that splits over the model axis (parameters as
``layers.Blocks``) runs the same code on each data row's model slots:
the encoder's attention and every decoder attention on each slot's
heads, the MLPs on its columns, the embedding and logits on its
vocabulary rows or ``d_model`` columns (``layers.py``'s split forms),
``enc_ln`` on the row's first slot.  The encoder's output is sent to
each model slot once a step where the cross-attention's ``wk``/``wv``
are split, and every decoder layer's cross-attention projects its KV
heads from that slot's replica (:func:`cross_input`,
``layers._cross_split``); where they are replicated k/v are projected on
the first slot, a layer at a time, and each slot sent its KV heads.
Under remat both stacks run with checkpoint's early stop off, as
``transformer.decoder_forward`` does, so the recompute sends again what
the forward sent.
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

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


def cross_input(params, enc_out):
    """The encoder's output as the decoder's cross-attention reads it:
    itself, or in a split step a ``layers.Replicas``: sent once to each
    model slot where the cross ``wk``/``wv`` are split (the backward sums
    the slots' gradients in slot order on the row's first slot), else on
    the first slot alone.  A ``Replicas`` is returned as it is."""
    wk = params["dec"]["cross"]["wk"]
    if not isinstance(wk, L.Blocks) or isinstance(enc_out, L.Replicas):
        return enc_out
    if wk.dim is None:
        return L.Replicas((enc_out,))
    return L.Replicas(wk.row.scatter(enc_out))


def _layers(body, x, n, *rest, remat, split):
    """``body(x, *rest, i)`` for each of n layers, each under
    non-reentrant checkpoint with ``remat``, with checkpoint's early stop
    off in a split step, so that the recompute sends again what the
    forward sent."""
    for i in range(n):
        if not remat:
            x = body(x, *rest, i)
            continue
        with set_checkpoint_early_stop(False) if split \
                else contextlib.nullcontext():
            x = checkpoint(body, x, *rest, i, use_reentrant=False)
    return x


def encode(params, cfg, frames, *, remat=False):
    """frames (B,S,D) -> encoder output (B,S,D)."""
    def body(x, i):
        p = L.take_layer(params["enc"], i)
        x, _ = L.attn_apply(p["attn"], x, cfg, causal=False)
        return L.mlp_apply(p["mlp"], x, cfg)

    split = L.is_split(params)
    x = _layers(body, frames.to(getattr(torch, cfg.dtype)), cfg.enc_layers,
                remat=remat, split=split)
    ln = params["enc_ln"]
    return L.rms_norm(x, ln.whole if split else ln, cfg.norm_eps)


def decode_stack(params, cfg, x, enc_out, *, caches=None, cache_len=None,
                 positions=None, enc_len=None, remat=False):
    """Decoder over x (B,T,D); caches = {"self": stacked attn caches},
    written in place and returned."""
    split = L.is_split(params)
    enc_out = cross_input(params, enc_out)

    def body(x, enc_out, i):
        p = L.take_layer(params["dec"], i)
        c = None if caches is None else L.take_layer(caches["self"], i)
        x, _ = L.attn_apply(p["self"], x, cfg, causal=True,
                            positions=positions, cache=c,
                            cache_len=cache_len)
        kv = enc_out if split else _cross_kv(p["cross"], enc_out, cfg)
        x, _ = L.attn_apply(p["cross"], x, cfg, kv_override=kv,
                            kv_len=enc_len)
        return L.mlp_apply(p["mlp"], x, cfg)

    return _layers(body, x, cfg.num_layers, enc_out, remat=remat,
                   split=split), caches


def encdec_train_loss(params, cfg, frames, tokens, labels):
    remat = cfg.remat == "full"
    enc_out = encode(params, cfg, frames, remat=remat)
    x = L.embed_apply(params["embed"], tokens, cfg)
    x, _ = decode_stack(params, cfg, x, enc_out, remat=remat)
    mask = (labels >= 0).float()
    loss = chunked_xent(params, cfg, x, torch.clamp(labels, min=0), mask)
    return loss, {"xent": loss}


def encdec_prefill(params, cfg, frames, tokens, caches):
    """(last logits, caches, the encoder's output): in a split step the
    output as :func:`cross_input` gives it, a replica on each model slot
    that reads one."""
    enc_out = cross_input(params, encode(params, cfg, frames))
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
