"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM
(scalar memory with recurrent weights) on tensors.

Counterpart of ``repro/models/xlstm.py``.  Both blocks carry O(1)-size
recurrent state.  Train and prefill run the recurrence as a Python loop
over time where the reference runs ``lax.scan``, with the exp-gating
stabiliser kept exactly: ``m`` starts at -1e30, and the normaliser is
clamped at 1.0 (mLSTM's |n.q|) and 1e-6 (sLSTM's n).  There is no TPU
kernel behind either; they are plain torch on the card too, apart from
the blocks' norms (the rmsnorm kernel, through ``layers.rms_norm``).

The caches are written in place: prefill and decode ``copy_`` the new
state into the tensors they are given and return the same tree, where
the reference returns a fresh one.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .layers import DP, ParamDef, _div, norm_def, rms_norm

_M0 = -1e30                                  # the stabiliser's start


# ===================================================================== mLSTM
def mlstm_defs(cfg, tp: int):
    d = cfg.d_model
    di = 2 * d                                   # projected block dim
    nh = cfg.num_heads
    di_ax = "model" if _div(di, tp) else None
    return {
        "up_proj": ParamDef((d, 2 * di), (None, di_ax)),
        "wq": ParamDef((di, di), (None, di_ax)),
        "wk": ParamDef((di, di), (None, di_ax)),
        "wv": ParamDef((di, di), (None, di_ax)),
        "wi": ParamDef((di, nh), (None, None)),
        "wf": ParamDef((di, nh), (None, None)),
        "down_proj": ParamDef((di, d), (di_ax, None)),
        "ln": norm_def(d),
    }


def _mlstm_step(C, n, m, qt, kt, vt, it, ft):
    """One mLSTM step in fp32: C (B,NH,hd,hd), n (B,NH,hd), m (B,NH);
    q/k/v (B,NH,hd), gates (B,NH) -> (C, n, m, h)."""
    m_new = torch.maximum(ft + m, it)
    i = torch.exp(it - m_new)
    f = torch.exp(ft + m - m_new)
    C = f[..., None, None] * C + i[..., None, None] \
        * (vt[..., :, None] * kt[..., None, :])        # v k^T
    n = f[..., None] * n + i[..., None] * kt
    num = torch.einsum("bhij,bhj->bhi", C, qt)
    den = torch.clamp(torch.abs(torch.einsum("bhj,bhj->bh", n, qt)), min=1.0)
    return C, n, m_new, num / den[..., None]


def _mlstm_scan(q, k, v, i_g, f_g, nh):
    """q/k/v (B,T,NH,hd); i_g/f_g (B,T,NH) pre-activation gates ->
    ((B,T,NH,hd) fp32, (C, n, m))."""
    b, t, _, hd = q.shape
    dev = q.device
    C = torch.zeros((b, nh, hd, hd), dtype=torch.float32, device=dev)
    n = torch.zeros((b, nh, hd), dtype=torch.float32, device=dev)
    m = torch.full((b, nh), _M0, dtype=torch.float32, device=dev)
    q, k, v, i_g, f_g = (a.float() for a in (q, k, v, i_g, f_g))
    hs = []
    for s in range(t):
        C, n, m, h = _mlstm_step(C, n, m, q[:, s], k[:, s], v[:, s],
                                 i_g[:, s], f_g[:, s])
        hs.append(h)
    return torch.stack(hs, dim=1), (C, n, m)


def mlstm_apply(p, x, cfg, *, cache=None, cache_len=None):
    """x (B,T,D) -> (y, cache); cache = {"C", "n", "m"}, written in
    place; train/prefill pass cache=None."""
    b, t, d = x.shape
    di = 2 * d
    nh = cfg.num_heads
    hd = di // nh
    xn = rms_norm(x, p["ln"], cfg.norm_eps)
    uz = xn @ p["up_proj"].to(xn.dtype)
    u, z = uz[..., :di], uz[..., di:]
    q = (u @ p["wq"].to(u.dtype)).reshape(b, t, nh, hd)
    k = (u @ p["wk"].to(u.dtype)).reshape(b, t, nh, hd)
    # the reference divides by a NumPy float64, which JAX promotes to
    # fp32: a bf16 k leaves this in fp32, unrounded
    k = k.float() / np.sqrt(hd)
    v = (u @ p["wv"].to(u.dtype)).reshape(b, t, nh, hd)
    i_g = u @ p["wi"].to(u.dtype)
    f_g = u @ p["wf"].to(u.dtype)

    if t > 1 or cache is None:
        h, state = _mlstm_scan(q, k, v, i_g, f_g, nh)
        if cache is not None:
            for key, a in zip(("C", "n", "m"), state):
                cache[key].copy_(a)
    else:
        C, n, m, h = _mlstm_step(
            cache["C"], cache["n"], cache["m"],
            *(a[:, 0].float() for a in (q, k, v, i_g, f_g)))
        h = h[:, None]
        for key, a in (("C", C), ("n", n), ("m", m)):
            cache[key].copy_(a)

    h = h.to(x.dtype).reshape(b, t, di)
    y = h * F.silu(z)
    out = y @ p["down_proj"].to(y.dtype)
    return x + out, cache


def mlstm_cache_defs(cfg, batch: int, *, tp: int):
    di = 2 * cfg.d_model
    nh = cfg.num_heads
    hd = di // nh
    return {"C": ParamDef((batch, nh, hd, hd), (DP, None, None, None),
                          init="zeros", dtype="float32"),
            "n": ParamDef((batch, nh, hd), (DP, None, None), init="zeros",
                          dtype="float32"),
            "m": ParamDef((batch, nh), (DP, None), init="zeros",
                          dtype="float32")}


# ===================================================================== sLSTM
def slstm_defs(cfg, tp: int):
    d = cfg.d_model
    nh = cfg.num_heads
    hd = d // nh
    return {
        "wz": ParamDef((d, d), (None, None)),
        "wi": ParamDef((d, d), (None, None)),
        "wf": ParamDef((d, d), (None, None)),
        "wo": ParamDef((d, d), (None, None)),
        "rz": ParamDef((nh, hd, hd), (None, None, None)),
        "ri": ParamDef((nh, hd, hd), (None, None, None)),
        "rf": ParamDef((nh, hd, hd), (None, None, None)),
        "ro": ParamDef((nh, hd, hd), (None, None, None)),
        "up_proj": ParamDef((d, 2 * d), (None, None)),
        "down_proj": ParamDef((d, d), (None, None)),
        "ln": norm_def(d),
    }


def _slstm_cell(p, xt, carry, nh, hd):
    """One sLSTM step.  xt (B,d) fp32; carry = (c, h, n, m): c, n, m
    (B,NH,hd), h (B,d)."""
    c, h, n, m = carry
    hr = h.reshape(h.shape[0], nh, hd)

    def rec(w, r):
        return (xt @ w).reshape(-1, nh, hd) + torch.einsum(
            "bhj,hij->bhi", hr, r)

    z = torch.tanh(rec(p["wz"], p["rz"]))
    i_t = rec(p["wi"], p["ri"])
    f_t = rec(p["wf"], p["rf"])
    o = torch.sigmoid(rec(p["wo"], p["ro"]))
    m_new = torch.maximum(f_t + m, i_t)        # per-unit exp-gating stabiliser
    i = torch.exp(i_t - m_new)
    f = torch.exp(f_t + m - m_new)
    c = f * c + i * z
    n = torch.clamp(f * n + i, min=1e-6)
    h_new = o * (c / n)
    return (c, h_new.reshape(h.shape[0], -1), n, m_new)


_SLSTM_WEIGHTS = ("wz", "wi", "wf", "wo", "rz", "ri", "rf", "ro")


def slstm_apply(p, x, cfg, *, cache=None, cache_len=None):
    """x (B,T,D) -> (y, cache); cache = {"c", "h", "n", "m"}, written in
    place; train/prefill pass cache=None."""
    b, t, d = x.shape
    nh = cfg.num_heads
    hd = d // nh
    xn = rms_norm(x, p["ln"], cfg.norm_eps).float()
    pf = {k: p[k].float() for k in _SLSTM_WEIGHTS}
    f32, dev = torch.float32, x.device

    if t > 1 or cache is None:
        carry = (torch.zeros((b, nh, hd), dtype=f32, device=dev),
                 torch.zeros((b, d), dtype=f32, device=dev),
                 torch.full((b, nh, hd), 1e-6, dtype=f32, device=dev),
                 torch.full((b, nh, hd), _M0, dtype=f32, device=dev))
        hs = []
        for s in range(t):
            carry = _slstm_cell(pf, xn[:, s], carry, nh, hd)
            hs.append(carry[1])
        h = torch.stack(hs, dim=1)                         # (B,T,d)
    else:
        carry = _slstm_cell(pf, xn[:, 0],
                            (cache["c"], cache["h"], cache["n"], cache["m"]),
                            nh, hd)
        h = carry[1][:, None]
    if cache is not None:
        for key, a in zip(("c", "h", "n", "m"), carry):
            cache[key].copy_(a)

    h = h.to(x.dtype)
    uz = h @ p["up_proj"].to(h.dtype)
    u, z = uz[..., :d], uz[..., d:]
    y = (u * F.silu(z)) @ p["down_proj"].to(h.dtype)
    return x + y, cache


def slstm_cache_defs(cfg, batch: int, *, tp: int):
    d = cfg.d_model
    nh = cfg.num_heads
    hd = d // nh
    return {"c": ParamDef((batch, nh, hd), (DP, None, None), init="zeros",
                          dtype="float32"),
            "h": ParamDef((batch, d), (DP, None), init="zeros",
                          dtype="float32"),
            "n": ParamDef((batch, nh, hd), (DP, None, None), init="zeros",
                          dtype="float32"),
            "m": ParamDef((batch, nh, hd), (DP, None, None), init="zeros",
                          dtype="float32")}
