"""Decoder-LM parameter layout: period-stacked heterogeneous layer stacks.

Counterpart of ``repro/models/transformer.py``'s parameter defs.  Every
arch's layer sequence is ``period_pattern * n_periods + remainder``;
weights are stacked per position-in-period with a leading ``n_periods``
dim, exactly as in the reference, so its parameter trees carry over
leaf for leaf.  The port has the attention and MLP kinds; every other
mixer or FFN kind raises ``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

from . import layers as L

_FAMILIES_ITEM = "Other model families and the dense-cache path"


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: see ROADMAP.md, "
                               f"'{_FAMILIES_ITEM}'")


# --------------------------------------------------------------- param defs
def mixer_defs(cfg, kind: str, tp: int):
    if kind in ("attn", "local", "nope"):
        if cfg.mla is not None:
            raise _not_ported("multi-head latent attention (MLA)")
        return L.attn_defs(cfg, tp)
    if kind in ("mamba", "mlstm", "slstm"):
        raise _not_ported(f"the {kind} mixer")
    raise ValueError(kind)


def ffn_defs(cfg, kind: str, tp: int):
    if kind == "none":
        return None
    if kind == "moe":
        raise _not_ported("the MoE FFN")
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
