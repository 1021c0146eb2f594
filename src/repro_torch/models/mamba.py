"""Mamba (S6) mixer for the Jamba hybrid: the selective SSM on tensors.

Counterpart of ``repro/models/mamba.py``.  Train and prefill run the
causal depthwise conv over T, then the selective scan, a Python loop over
time where the reference runs ``lax.scan`` with one step a chunk (its
Q = 1); the state is fp32.  Decode is the one-step update over the conv
window and the SSM state, O(1) in sequence length.  There is no TPU
kernel behind either: the reference computes them in ``jnp``, so they are
plain torch on the card too, apart from the block's norm (the rmsnorm
kernel, through ``layers.rms_norm``).

The cache is written in place: prefill and decode ``copy_`` the conv
tail and the SSM state into the tensors they are given and return the
same tree, where the reference returns a fresh one.

On a meshed step's model axis (``layers.Blocks`` leaves) the layer
splits by inner channels as the reference's specs split ``di``
(:func:`_mamba_split`), each slot on its own channels of the conv, the
scan and the state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import (DP, Blocks, ParamDef, _div, columns_slot, norm_def,
                     put_state, rms_norm, whole_on_first)


def mamba_defs(cfg, tp: int):
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    dtr = s.dt_rank or -(-d // 16)
    di_ax = "model" if _div(di, tp) else None
    return {
        "in_proj": ParamDef((d, 2 * di), (None, di_ax)),
        "conv_w": ParamDef((s.d_conv, di), (None, di_ax)),
        "conv_b": ParamDef((di,), (di_ax,), init="zeros"),
        "x_proj": ParamDef((di, dtr + 2 * s.d_state), (di_ax, None)),
        "dt_proj": ParamDef((dtr, di), (None, di_ax)),
        "dt_bias": ParamDef((di,), (di_ax,), init="zeros"),
        "A_log": ParamDef((di, s.d_state), (di_ax, None), init="ones"),
        "D": ParamDef((di,), (di_ax,), init="ones"),
        "out_proj": ParamDef((di, d), (di_ax, None)),
        "ln": norm_def(d),
    }


def _split_xdbc(xdb, dtr, n):
    return xdb[..., :dtr], xdb[..., dtr:dtr + n], xdb[..., dtr + n:]


def _conv_step(window, w, b):
    """window (B, d_conv, di) -> conv output at the last position."""
    return torch.einsum("bcd,cd->bd", window, w) + b


def _dt(dt_r, p):
    """softplus(dt_r @ dt_proj + dt_bias) in dt_r's dtype, then fp32."""
    return F.softplus(dt_r @ p["dt_proj"].to(dt_r.dtype)
                      + p["dt_bias"].to(dt_r.dtype)).float()


def mamba_apply(p, x, cfg, *, cache=None, cache_len=None):
    """x (B,T,D) -> (y, cache).  cache = {"conv": (B,dc-1,di), "ssm":
    (B,di,N)}, written in place; train/prefill pass cache=None.  With
    ``layers.Blocks`` leaves, split over the model axis
    (:func:`_mamba_split`)."""
    if isinstance(p["in_proj"], Blocks):
        return _mamba_split(p, x, cfg, cache=cache), cache
    s = cfg.ssm
    b, t, d = x.shape
    di = s.expand * d
    dtr = s.dt_rank or -(-d // 16)
    n = s.d_state

    xn = rms_norm(x, p["ln"], cfg.norm_eps)
    xz = xn @ p["in_proj"].to(xn.dtype)
    xin, z = xz[..., :di], xz[..., di:]

    A = -torch.exp(p["A_log"].float())                       # (di, N)

    if t > 1 or cache is None:
        # train / prefill: causal depthwise conv over T + selective scan
        pad = xin.new_zeros((b, s.d_conv - 1, di))
        xp = torch.cat([pad, xin], dim=1)
        xc = sum(xp[:, i: i + t, :] * p["conv_w"][i].to(xin.dtype)
                 for i in range(s.d_conv)) + p["conv_b"].to(xin.dtype)
        xc = F.silu(xc)
        xdb = xc @ p["x_proj"].to(xc.dtype)
        dt_r, b_ssm, c_ssm = _split_xdbc(xdb, dtr, n)
        dt = _dt(dt_r, p)
        b32, c32, x32 = b_ssm.float(), c_ssm.float(), xc.float()
        h = torch.zeros((b, di, n), dtype=torch.float32, device=x.device)
        ys = []
        for i in range(t):                       # the reference's scan, Q = 1
            dti = dt[:, i]
            decay = torch.exp(dti[..., None] * A)              # (B,di,N)
            h = h * decay + (dti * x32[:, i])[..., None] \
                * b32[:, i][:, None, :]
            ys.append(torch.einsum("bdn,bn->bd", h, c32[:, i]))
        y = torch.stack(ys, dim=1).to(x.dtype)
        y = y + xc * p["D"].to(xc.dtype)
        if cache is not None:                    # prefill fills the cache
            cache["conv"].copy_(xp[:, -(s.d_conv - 1):, :])
            cache["ssm"].copy_(h)
    else:
        window = torch.cat([cache["conv"].to(xin.dtype), xin], dim=1)
        xc = F.silu(_conv_step(window, p["conv_w"].to(xin.dtype),
                               p["conv_b"].to(xin.dtype)))       # (B,di)
        xdb = xc @ p["x_proj"].to(xc.dtype)
        dt_r, b_ssm, c_ssm = _split_xdbc(xdb, dtr, n)
        dt = _dt(dt_r, p)
        h = cache["ssm"]
        decay = torch.exp(dt[..., None] * A)
        h = h * decay + (dt * xc.float())[..., None] \
            * b_ssm.float()[:, None, :]
        y = torch.einsum("bdn,bn->bd", h, c_ssm.float())
        y = (y.to(x.dtype) + xc * p["D"].to(xc.dtype))[:, None, :]
        cache["conv"].copy_(window[:, 1:, :])
        cache["ssm"].copy_(h)

    y = y * F.silu(z)
    out = y @ p["out_proj"].to(y.dtype)
    return x + out, cache


# ========================================================= the model axis
def _conv_slot(xin, conv_w, conv_b, x_proj, *, cfg, at, conv=None):
    """Slot's channels (B,T,c) through the causal depthwise conv and SiLU,
    and its rows of ``x_proj``: (xc, its partial of (dt_r | B | C), the
    conv tail).  ``conv`` (B,dc-1,c), its block of the conv cache, to
    decode one step (xc then (B,c))."""
    dc = cfg.ssm.d_conv
    w, b = at(conv_w).to(xin.dtype), at(conv_b).to(xin.dtype)
    if conv is None:
        t = xin.shape[1]
        xp = torch.cat([xin.new_zeros((xin.shape[0], dc - 1, xin.shape[2])),
                        xin], dim=1)
        xc = F.silu(sum(xp[:, i: i + t, :] * w[i] for i in range(dc)) + b)
        tail = xp[:, -(dc - 1):, :]
    else:
        window = torch.cat([conv.to(xin.dtype), xin], dim=1)
        xc = F.silu(_conv_step(window, w, b))
        tail = window[:, 1:, :]
    return xc, xc @ at(x_proj).to(xc.dtype), tail


def _scan_slot(xc, xdb, z, dt_proj, dt_bias, A_log, D, out_proj, *, cfg, at,
               dtype, ssm=None):
    """Slot's channels through the selective scan (``ssm`` (B,c,N), its
    block of the state, to decode one step), the skip, the gate and its
    rows of ``out_proj``: (its partial output (B,T,D), the last state)."""
    s = cfg.ssm
    dtr = s.dt_rank or -(-cfg.d_model // 16)
    dt_r, b_ssm, c_ssm = _split_xdbc(xdb, dtr, s.d_state)
    dt = _dt(dt_r, {"dt_proj": at(dt_proj), "dt_bias": at(dt_bias)})
    A = -torch.exp(at(A_log).float())
    Dm = at(D).to(xc.dtype)
    if ssm is None:
        b, t, c = xc.shape
        b32, c32, x32 = b_ssm.float(), c_ssm.float(), xc.float()
        h = torch.zeros((b, c, s.d_state), dtype=torch.float32,
                        device=xc.device)
        ys = []
        for i in range(t):
            dti = dt[:, i]
            h = h * torch.exp(dti[..., None] * A) \
                + (dti * x32[:, i])[..., None] * b32[:, i][:, None, :]
            ys.append(torch.einsum("bdn,bn->bd", h, c32[:, i]))
        y = torch.stack(ys, dim=1).to(dtype) + xc * Dm
    else:
        h = ssm * torch.exp(dt[..., None] * A) \
            + (dt * xc.float())[..., None] * b_ssm.float()[:, None, :]
        y = torch.einsum("bdn,bn->bd", h, c_ssm.float())
        y = (y.to(dtype) + xc * Dm)[:, None, :]
    y = y * F.silu(z)
    return y @ at(out_proj).to(y.dtype), h


def _mamba_split(p, x, cfg, *, cache=None):
    """``mamba_apply`` on a row's model slots, each on its block of the
    inner channels (``mamba_defs``' split of ``di``).  The row's first
    slot runs the norm and sends the normed activation to every slot;
    each slot's columns of ``in_proj`` come back to the first slot,
    concatenated in slot order, and each slot is sent its channels of
    ``x`` and of ``z`` (column ranges from the layouts: a slot's
    ``in_proj`` block is not its channel block).  Each slot runs the
    causal conv and SiLU over its channels and its rows of ``x_proj``;
    the partials are summed in slot order on the first slot and the
    whole (dt_r | B | C) sent to every slot, which runs ``dt_proj``'s
    columns, the selective scan over its channels (a Python loop over
    time, no move inside it), the skip and the gate, and its rows of
    ``out_proj``; the partial outputs are summed in slot order.  With a
    cache (:class:`layers.StateBlocks`, each slot's block its channels
    of ``conv`` and ``ssm``) prefill writes each slot's block in place
    and decode reads it there: no cache byte moves between the row's
    slots (in long mode each block's replicas are sent it).  Where the
    spec leaves ``di`` whole (``dim`` None) the whole layer runs on the
    first slot, its caches replicated."""
    if p["in_proj"].dim is None:
        return whole_on_first(mamba_apply, p, x, cfg, cache)
    row = p["in_proj"].row
    at = p["in_proj"].part
    tp = len(p["in_proj"].blocks)
    di = cfg.ssm.expand * cfg.d_model
    c = di // tp
    decode = cache is not None and x.shape[1] == 1
    xn = rms_norm(x, p["ln"].whole, cfg.norm_eps)
    xs = row.scatter(xn)
    xz = row.concat([row.run(m, columns_slot, xs[m], p["in_proj"].blocks[m],
                             at=at) for m in range(tp)], dim=2)
    xins = row.scatter(xz, dim=2, ranges=[(m * c, (m + 1) * c)
                                          for m in range(tp)])
    zs = row.scatter(xz, dim=2, ranges=[(di + m * c, di + (m + 1) * c)
                                        for m in range(tp)])
    convs = [row.run(m, _conv_slot, xins[m], p["conv_w"].blocks[m],
                     p["conv_b"].blocks[m], p["x_proj"].blocks[m], cfg=cfg,
                     at=at, conv=cache["conv"].at(m) if decode else None)
             for m in range(tp)]
    xdbs = row.scatter(row.reduce([cv[1] for cv in convs]))
    outs = [row.run(m, _scan_slot, convs[m][0], xdbs[m], zs[m],
                    *(p[k].blocks[m] for k in ("dt_proj", "dt_bias", "A_log",
                                               "D", "out_proj")),
                    cfg=cfg, at=at, dtype=x.dtype,
                    ssm=cache["ssm"].at(m) if decode else None)
            for m in range(tp)]
    if cache is not None:
        for m in range(tp):
            put_state(cache["conv"], m, convs[m][2])
            put_state(cache["ssm"], m, outs[m][1])
    return x + row.reduce([o[0] for o in outs])


def mamba_cache_defs(cfg, batch: int, *, tp: int):
    s = cfg.ssm
    di = s.expand * cfg.d_model
    di_ax = "model" if _div(di, tp) else None
    return {"conv": ParamDef((batch, s.d_conv - 1, di), (DP, None, di_ax),
                             init="zeros", dtype=cfg.dtype),
            "ssm": ParamDef((batch, di, s.d_state), (DP, di_ax, None),
                            init="zeros", dtype="float32")}
