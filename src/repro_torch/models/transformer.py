"""Decoder-LM assembly: period-stacked heterogeneous layer stacks.

Counterpart of ``repro/models/transformer.py``.  Every arch's layer
sequence is ``period_pattern * n_periods + remainder``; weights (and
dense caches) are stacked per position-in-period with a leading
``n_periods`` dim, exactly as in the reference, so its trees carry over
leaf for leaf.  The reference's ``lax.scan`` over periods is a Python
loop here that indexes the stacked params and caches at ``[per]`` (views,
so the caches are written in place), as ``PagedLM`` indexes its layers.
Training (``remat``, the losses) waits for its ROADMAP item.  The
attention mixers (GQA with the local ring, MLA) and the MLP and MoE FFNs
are ported; the recurrent mixers raise ``NotImplementedError`` naming
theirs.
"""
from __future__ import annotations

import torch

from . import layers as L

_RECURRENT_ITEM = "Recurrent mixers (Mamba, mLSTM, sLSTM)"
_RECURRENT = ("mamba", "mlstm", "slstm")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: see ROADMAP.md, "
                               f"'{_RECURRENT_ITEM}'")


# --------------------------------------------------------------- param defs
def mixer_defs(cfg, kind: str, tp: int):
    if kind in ("attn", "local", "nope"):
        return L.mla_defs(cfg, tp) if cfg.mla is not None \
            else L.attn_defs(cfg, tp)
    if kind in _RECURRENT:
        raise _not_ported(f"the {kind} mixer")
    raise ValueError(kind)


def ffn_defs(cfg, kind: str, tp: int):
    if kind == "none":
        return None
    if kind == "moe":
        return L.moe_defs(cfg, tp)
    return L.mlp_defs(cfg, tp)


def _pos_ffn_kind(cfg, pos: int) -> str:
    kind = cfg.period_pattern[pos]
    if kind in ("mlstm", "slstm") and cfg.d_ff == 0:
        return "none"
    if cfg.moe is not None:
        assert len(cfg.period_pattern) % cfg.moe.every == 0 or \
            cfg.moe.every % len(cfg.period_pattern) == 0, \
            "MoE interval must align with the period"
        return cfg.ffn_kind(pos)
    return "mlp"


def decoder_param_defs(cfg, tp: int):
    stack = []
    for pos, kind in enumerate(cfg.period_pattern):
        blk = {"mixer": mixer_defs(cfg, kind, tp)}
        fk = _pos_ffn_kind(cfg, pos)
        if fk != "none":
            blk["ffn"] = ffn_defs(cfg, fk, tp)
        stack.append(L.stack_defs(blk, cfg.n_periods))
    rem = []
    for pos, kind in enumerate(cfg.remainder_kinds):
        blk = {"mixer": mixer_defs(cfg, kind, tp)}
        fk = _pos_ffn_kind(cfg, pos)
        if fk != "none":
            blk["ffn"] = ffn_defs(cfg, fk, tp)
        rem.append(blk)
    return {"embed": L.embed_defs(cfg, tp),
            "stack": tuple(stack), "rem": tuple(rem)}


# ------------------------------------------------------------ cache defs
def block_cache_defs(cfg, kind: str, batch: int, seq: int, *, tp: int,
                     long_mode: bool = False):
    if kind in ("attn", "nope"):
        return L.mla_cache_defs(cfg, batch, seq, tp=tp, long_mode=long_mode) \
            if cfg.mla is not None \
            else L.attn_cache_defs(cfg, batch, seq, tp=tp, long_mode=long_mode)
    if kind == "local":
        w = min(cfg.window_size, seq)
        # local layers only ever need the trailing window of cache (ring)
        return L.mla_cache_defs(cfg, batch, w, tp=tp) if cfg.mla is not None \
            else L.attn_cache_defs(cfg, batch, w, tp=tp)
    if kind in _RECURRENT:
        raise _not_ported(f"the {kind} mixer's cache")
    raise ValueError(kind)


def decoder_cache_defs(cfg, batch: int, seq: int, *, tp: int,
                       long_mode: bool = False):
    stack = [L.stack_defs(
        block_cache_defs(cfg, kind, batch, seq, tp=tp, long_mode=long_mode),
        cfg.n_periods) for kind in cfg.period_pattern]
    rem = [block_cache_defs(cfg, kind, batch, seq, tp=tp, long_mode=long_mode)
           for kind in cfg.remainder_kinds]
    return {"stack": tuple(stack), "rem": tuple(rem)}


# ------------------------------------------------------------- block apply
def apply_block(cfg, kind: str, blk_params, x, *, cache=None, cache_len=None,
                positions=None):
    """Returns (x, cache, aux); the cache is written in place."""
    p_mix = blk_params["mixer"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind in ("attn", "local", "nope"):
        if cfg.mla is not None:
            x, new_c = L.mla_apply(p_mix, x, cfg, positions=positions,
                                   cache=cache, cache_len=cache_len)
        else:
            # local layers: attn_apply implements ring-cache semantics
            x, new_c = L.attn_apply(p_mix, x, cfg, kind=kind,
                                    positions=positions, cache=cache,
                                    cache_len=cache_len)
    elif kind in _RECURRENT:
        raise _not_ported(f"the {kind} mixer")
    else:
        raise ValueError(kind)
    if "ffn" in blk_params:
        ffn_p = blk_params["ffn"]
        if "router" in ffn_p:
            x, aux = L.moe_apply(ffn_p, x, cfg)
        else:
            x = L.mlp_apply(ffn_p, x, cfg)
    return x, new_c, aux


# ---------------------------------------------------------------- forward
def decoder_forward(params, cfg, x, *, caches=None, cache_len=None,
                    positions=None):
    """x (B,T,D) hidden states -> (hidden, caches, aux_sum); ``caches`` is
    written in place and returned (None without caches)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for per in range(cfg.n_periods):
        aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        for pos, kind in enumerate(cfg.period_pattern):
            c = None if caches is None \
                else L.take_layer(caches["stack"][pos], per)
            x, _, aux = apply_block(cfg, kind,
                                    L.take_layer(params["stack"][pos], per),
                                    x, cache=c, cache_len=cache_len,
                                    positions=positions)
            aux_sum = aux_sum + aux
        aux_total = aux_total + aux_sum
    for pos, kind in enumerate(cfg.remainder_kinds):
        c = None if caches is None else caches["rem"][pos]
        x, _, aux = apply_block(cfg, kind, params["rem"][pos], x,
                                cache=c, cache_len=cache_len,
                                positions=positions)
        aux_total = aux_total + aux
    return x, caches, aux_total


# ----------------------------------------------------------- full LM paths
def lm_prefill(params, cfg, tokens, caches):
    """Fill caches for the prompt; returns (last_logits, caches)."""
    x = L.embed_apply(params["embed"], tokens, cfg)
    x, caches, _ = decoder_forward(params, cfg, x, caches=caches,
                                   cache_len=0)
    logits = L.logits_apply(params["embed"], x[:, -1:], cfg)
    return logits, caches


def lm_decode(params, cfg, tokens, caches, lengths):
    """One decode step: tokens (B,1), lengths (B,) current cache fill."""
    x = L.embed_apply(params["embed"], tokens, cfg)
    positions = lengths[:, None] + torch.arange(
        tokens.shape[1], device=lengths.device)[None, :]
    x, caches, _ = decoder_forward(params, cfg, x, caches=caches,
                                   cache_len=lengths, positions=positions)
    logits = L.logits_apply(params["embed"], x, cfg)
    return logits, caches
