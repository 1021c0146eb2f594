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

On a meshed step's model axis (``layers.Blocks`` leaves) mLSTM splits by
rows of C (:func:`_mlstm_split`): a slot's columns of ``wv`` and rows of
``down_proj`` are rows of its heads' C, so it runs those rows, beside
the whole q, k and gates of its heads; its state stays replicated, as
the reference's spec has it.  sLSTM, replicated throughout, runs whole
on the row's first slot.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .layers import (DP, Blocks, ParamDef, _div, columns_slot, norm_def,
                     put_state, rms_norm, whole_on_first)

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
    """q/k (B,T,NH,hd); v (B,T,NH,R), R = hd, or a slot's R rows of each
    head's C (``_mlstm_split``); i_g/f_g (B,T,NH) pre-activation gates
    -> ((B,T,NH,R) fp32, (C (B,NH,R,hd), n, m))."""
    b, t, _, hd = q.shape
    dev = q.device
    C = torch.zeros((b, nh, v.shape[-1], hd), dtype=torch.float32,
                    device=dev)
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
    place; train/prefill pass cache=None.  With ``layers.Blocks`` leaves,
    split over the model axis (:func:`_mlstm_split`)."""
    if isinstance(p["up_proj"], Blocks):
        return _mlstm_split(p, x, cfg, cache=cache), cache
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


# ------------------------------------------------- mLSTM on the model axis
def slot_rows(di: int, nh: int, tp: int, m: int) -> tuple:
    """Model slot m's channels [m c, (m + 1) c) of the inner dim, c =
    di/tp, as rows of C: (h0, G, r0, R), the slot holding rows [r0, r0 +
    R) of each of heads [h0, h0 + G) (its v columns, and the rows of
    each head's C = v k^T that they make).  A block inside one head has
    G = 1; one of whole heads r0 = 0, R = hd; a block that does neither
    raises ``NotImplementedError``."""
    hd, c = di // nh, di // tp
    lo = m * c
    if hd % c == 0:
        return lo // hd, 1, lo % hd, c
    if c % hd == 0:
        return lo // hd, c // hd, 0, hd
    raise NotImplementedError(
        f"{c} inner channels a slot over heads of {hd}: a slot's rows of "
        "C would cross a head unevenly")


def _mlstm_qkv(u, wq, wk, wv, *, at):
    """Slot's columns of q, k and v (B,T,c)."""
    return tuple(u @ at(w).to(u.dtype) for w in (wq, wk, wv))


def _mlstm_slot(q, k, v, i_g, f_g, z, down, *, g, r, hd, dtype, at,
                state=None):
    """Slot's rows of the mLSTM recurrence: q/k (B,T,G hd), the whole of
    the G heads its block touches; v (B,T,G R) its own columns, R rows
    of each of those heads' C (:func:`slot_rows`); the
    gates (B,T,G); ``z`` its channels.  Runs n, m and the normaliser of
    those heads (as every slot touching them does, the same) and its R
    rows of each head's C, from zeros or, to decode, from ``state``
    (C (B,G,R,hd), n, m); then the gate and its rows of ``down_proj``:
    (partial output (B,T,D), the new (C, n, m))."""
    b, t = q.shape[:2]
    q = q.reshape(b, t, g, hd)
    # fp32, as in mlstm_apply: JAX promotes k / np.sqrt(hd) so
    k = k.reshape(b, t, g, hd).float() / np.sqrt(hd)
    v = v.reshape(b, t, g, r)
    if state is None:
        h, state = _mlstm_scan(q, k, v, i_g, f_g, g)
    else:
        *state, h = _mlstm_step(*state, *(a[:, 0].float()
                                          for a in (q, k, v, i_g, f_g)))
        h = h[:, None]
    y = h.to(dtype).reshape(b, t, g * r) * F.silu(z)
    return y @ at(down).to(y.dtype), tuple(state)


def _mlstm_state(cache, rows, m):
    """Model slot m's state from its own replica of the cache: its rows
    of C, n and m of the heads its block touches."""
    h0, g, r0, r = rows
    return (cache["C"].at(m)[:, h0:h0 + g, r0:r0 + r],
            cache["n"].at(m)[:, h0:h0 + g], cache["m"].at(m)[:, h0:h0 + g])


def _mlstm_write(cache, states, rows, nh):
    """The new state into every model slot's replica (and its replicas'):
    each slot's rows of C, and n and m from the first slot that computed
    each head, to the row's first slot, assembled there and sent whole to
    every other model slot, so every replica holds the same bytes."""
    ck = cache["C"]
    row = ck.row
    b, _, hd, _ = ck.at(0).shape
    first = row.slots[0]
    C = torch.empty((b, nh, hd, hd), dtype=torch.float32,
                    device=states[0][0].device)
    n_parts, m_parts, done = [], [], 0
    for s, ((h0, g, r0, r), st) in enumerate(zip(rows, states)):
        C[:, h0:h0 + g, r0:r0 + r] = row.send(st[0], row.slots[s], first)
        if h0 + g > done:            # heads no earlier slot computed
            lo = done - h0
            n_parts.append(row.send(st[1][:, lo:], row.slots[s], first))
            m_parts.append(row.send(st[2][:, lo:], row.slots[s], first))
            done = h0 + g
    whole = {"C": C, "n": torch.cat(n_parts, dim=1),
             "m": torch.cat(m_parts, dim=1)}
    for key, new in whole.items():
        put_state(cache[key], 0, new)
        for s in range(1, len(rows)):
            put_state(cache[key], s, row.send_to(new, s))


def _mlstm_split(p, x, cfg, *, cache=None):
    """``mlstm_apply`` on a row's model slots, by rows of C.  The first
    slot runs the norm and sends the normed activation to every slot;
    each slot's columns of ``up_proj`` come back concatenated in slot
    order, and each slot is sent the whole ``u`` (the input dim of
    ``wq``/``wk``/``wv`` is replicated) and its channels of ``z``; each
    computes its columns of q, k and v.  The q and k columns come back to
    the first slot, which also runs the replicated gates, and each slot
    is sent the whole q, k and gates of the heads its block touches
    (:func:`slot_rows`).  A slot's v columns are rows of its heads' C
    (C[i, j] = v_i k_j) and its h rows are its ``down_proj`` rows: each
    slot runs n, m and the normaliser of its heads (redundantly, the
    same on every slot touching them) and its rows of C, over time in a
    Python loop with no move inside it, then the gate and its rows of
    ``down_proj``; the partials are summed in slot order.  The cache
    (replicated over the model axis, as the reference's spec) is read
    from each slot's own replica and written whole on every replica
    (:func:`_mlstm_write`).  Where the spec leaves ``di`` whole the
    layer runs on the first slot, its replicas copied after it."""
    if p["up_proj"].dim is None:
        return whole_on_first(mlstm_apply, p, x, cfg, cache)
    row = p["up_proj"].row
    at = p["up_proj"].part
    tp = len(p["up_proj"].blocks)
    di, nh = 2 * cfg.d_model, cfg.num_heads
    hd, c = di // nh, di // tp
    rows = [slot_rows(di, nh, tp, m) for m in range(tp)]
    heads = [(h0, h0 + g) for h0, g, _, _ in rows]
    decode = cache is not None and x.shape[1] == 1
    xn = rms_norm(x, p["ln"].whole, cfg.norm_eps)
    xs = row.scatter(xn)
    uz = row.concat([row.run(m, columns_slot, xs[m], p["up_proj"].blocks[m],
                             at=at) for m in range(tp)], dim=2)
    us = row.scatter(uz, dim=2, ranges=[(0, di)] * tp)
    zs = row.scatter(uz, dim=2, ranges=[(di + m * c, di + (m + 1) * c)
                                        for m in range(tp)])
    qkv = [row.run(m, _mlstm_qkv, us[m], *(p[k].blocks[m]
                                           for k in ("wq", "wk", "wv")),
                   at=at) for m in range(tp)]
    u = uz[..., :di]
    cols = [(h0 * hd, h1 * hd) for h0, h1 in heads]
    qs, ks = (row.scatter(row.concat([a[j] for a in qkv], dim=2), dim=2,
                          ranges=cols) for j in (0, 1))
    i_s, f_s = (row.scatter(u @ p[k].whole.to(u.dtype), dim=2,
                            ranges=heads) for k in ("wi", "wf"))
    outs = [row.run(m, _mlstm_slot, qs[m], ks[m], qkv[m][2], i_s[m], f_s[m],
                    zs[m], p["down_proj"].blocks[m], g=rows[m][1],
                    r=rows[m][3], hd=hd,
                    dtype=x.dtype, at=at,
                    state=_mlstm_state(cache, rows[m], m) if decode
                    else None)
            for m in range(tp)]
    if cache is not None:
        _mlstm_write(cache, [o[1] for o in outs], rows, nh)
    return x + row.reduce([o[0] for o in outs])


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
    place; train/prefill pass cache=None.  With ``layers.Blocks`` leaves
    (a split step; the reference replicates every sLSTM leaf over the
    model axis) the block runs whole on the row's first slot, and a
    cache's replicas on the other slots are sent the first slot's state
    after it (``layers.whole_on_first``)."""
    if isinstance(p["up_proj"], Blocks):
        return whole_on_first(slstm_apply, p, x, cfg, cache), cache
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
