"""Decoder-LM assembly: period-stacked heterogeneous layer stacks.

Counterpart of ``repro/models/transformer.py``.  Every arch's layer
sequence is ``period_pattern * n_periods + remainder``; weights (and
dense caches) are stacked per position-in-period with a leading
``n_periods`` dim, exactly as in the reference, so its trees carry over
leaf for leaf.  The reference's ``lax.scan`` over periods is a Python
loop here that indexes the stacked params and caches at ``[per]`` (views,
so the caches are written in place), as ``PagedLM`` indexes its layers.
Every mixer (GQA with the local ring, MLA, Mamba, mLSTM, sLSTM) writes
its cache in place and returns the tree it was given;
:func:`decoder_forward` raises if one returns another.  With ``remat``
each period's body runs under ``torch.utils.checkpoint`` (non-reentrant),
as the reference's ``jax.checkpoint``: its activations are recomputed in
the backward pass instead of kept.  The loss is the reference's chunked
cross-entropy, a Python loop over sequence chunks.

A meshed train step that splits over the model axis (parameters as
``layers.Blocks``) runs the same code: the layers take their split
forms, each chunk's logits stay in each model slot's vocabulary block,
or, row-parallel, the slots' partials are summed on the row's first
slot (``layers.xent_terms``), and a period's recompute runs its whole body
again, so the split layers' sends are re-issued in the backward pass
(checkpoint's early stop, which would end the recompute at the last
saved tensor, before the period's last sum, is off there).  So does a
split serving step (``launch/serve.py::MeshServe``): split parameters,
caches as ``layers.CacheBlocks`` (KV caches) and ``layers.StateBlocks``
(recurrent states), each slot's block written in place, no remat, and the last position's logits a ``layers.Blocks`` of each
model slot's vocabulary block (row-parallel: of the whole logits on the
row's first slot).
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from . import layers as L
from . import mamba as M
from . import xlstm as X


# --------------------------------------------------------------- param defs
def mixer_defs(cfg, kind: str, tp: int):
    if kind in ("attn", "local", "nope"):
        return L.mla_defs(cfg, tp) if cfg.mla is not None \
            else L.attn_defs(cfg, tp)
    if kind == "mamba":
        return M.mamba_defs(cfg, tp)
    if kind == "mlstm":
        return X.mlstm_defs(cfg, tp)
    if kind == "slstm":
        return X.slstm_defs(cfg, tp)
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
    if kind == "mamba":
        return M.mamba_cache_defs(cfg, batch, tp=tp)
    if kind == "mlstm":
        return X.mlstm_cache_defs(cfg, batch, tp=tp)
    if kind == "slstm":
        return X.slstm_cache_defs(cfg, batch, tp=tp)
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
    elif kind == "mamba":
        x, new_c = M.mamba_apply(p_mix, x, cfg, cache=cache,
                                 cache_len=cache_len)
    elif kind == "mlstm":
        x, new_c = X.mlstm_apply(p_mix, x, cfg, cache=cache,
                                 cache_len=cache_len)
    elif kind == "slstm":
        x, new_c = X.slstm_apply(p_mix, x, cfg, cache=cache,
                                 cache_len=cache_len)
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
def _block(cfg, kind, blk_params, x, cache, cache_len, positions):
    """``apply_block`` with the in-place cache contract held: a mixer that
    returns another tree than the cache it was given would leave that
    cache unwritten, so this raises."""
    x, new_c, aux = apply_block(cfg, kind, blk_params, x, cache=cache,
                                cache_len=cache_len, positions=positions)
    if new_c is not cache:
        raise RuntimeError(f"the {kind} mixer returned a new cache instead "
                           "of writing the one it was given")
    return x, aux


def decoder_forward(params, cfg, x, *, caches=None, cache_len=None,
                    positions=None, remat: bool = False):
    """x (B,T,D) hidden states -> (hidden, caches, aux_sum); ``caches`` is
    written in place and returned (None without caches).  ``remat`` runs
    each period's body under non-reentrant ``checkpoint`` (the remainder
    layers are not, as in the reference)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    def period_body(x, per):
        aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        for pos, kind in enumerate(cfg.period_pattern):
            c = None if caches is None \
                else L.take_layer(caches["stack"][pos], per)
            x, aux = _block(cfg, kind, L.take_layer(params["stack"][pos], per),
                            x, c, cache_len, positions)
            aux_sum = aux_sum + aux
        return x, aux_sum

    split = L.is_split(params)
    for per in range(cfg.n_periods):
        if remat:
            with set_checkpoint_early_stop(False) if split \
                    else contextlib.nullcontext():
                x, aux_sum = checkpoint(period_body, x, per,
                                        use_reentrant=False)
        else:
            x, aux_sum = period_body(x, per)
        aux_total = aux_total + aux_sum
    for pos, kind in enumerate(cfg.remainder_kinds):
        c = None if caches is None else caches["rem"][pos]
        x, aux = _block(cfg, kind, params["rem"][pos], x, c, cache_len,
                        positions)
        aux_total = aux_total + aux
    return x, caches, aux_total


# -------------------------------------------------------------------- loss
def chunked_xent(params, cfg, hidden, labels, mask):
    """Cross-entropy without materialising (B,T,V): a loop over sequence
    chunks of ``cfg.loss_chunk`` (or T if shorter, lowered until it divides
    T, as the reference), each chunk's logits (B,chunk,V) in fp32, or,
    split over the model axis, (B,chunk,V/tp) on each model slot (the
    row-parallel form: a (B,chunk,V) partial on each)."""
    t = hidden.shape[1]
    ck = min(cfg.loss_chunk, t)
    while t % ck:
        ck -= 1
    split = L.is_split(params["embed"])
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for s in range(0, t, ck):
        lab, m = labels[:, s:s + ck], mask[:, s:s + ck]
        if split:
            lse, gold = L.xent_terms(params["embed"], hidden[:, s:s + ck],
                                     lab, cfg)
        else:
            logits = L.logits_apply(params["embed"], hidden[:, s:s + ck],
                                    cfg).float()
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, lab.long()[..., None])[..., 0]
        nll = (lse - gold) * m
        tot = tot + nll.sum()
        cnt = cnt + m.sum()
    return tot / torch.clamp(cnt, min=1.0)


# ----------------------------------------------------------- full LM paths
def lm_train_loss(params, cfg, tokens, labels):
    """(loss + 0.01 * aux, {"xent", "aux"}); labels < 0 are masked."""
    x = L.embed_apply(params["embed"], tokens, cfg)
    x, _, aux = decoder_forward(params, cfg, x, remat=(cfg.remat == "full"))
    mask = (labels >= 0).float()
    loss = chunked_xent(params, cfg, x, torch.clamp(labels, min=0), mask)
    return loss + 0.01 * aux, {"xent": loss, "aux": aux}


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
