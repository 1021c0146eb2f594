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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import DP, ParamDef, _div, norm_def, rms_norm


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
    (B,di,N)}, written in place; train/prefill pass cache=None."""
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


def mamba_cache_defs(cfg, batch: int, *, tp: int):
    s = cfg.ssm
    di = s.expand * cfg.d_model
    di_ax = "model" if _div(di, tp) else None
    return {"conv": ParamDef((batch, s.d_conv - 1, di), (DP, None, di_ax),
                             init="zeros", dtype=cfg.dtype),
            "ssm": ParamDef((batch, di, s.d_state), (DP, di_ax, None),
                            init="zeros", dtype="float32")}
