"""Model substrate for the LM path: ParamDef-driven parameters and the
attention / MLP / embedding building blocks, on tensors.

Counterpart of ``repro/models/layers.py`` for the decoder LMs whose
layers are attention and MLP.  Parameters are declared as ``ParamDef``
trees (nested dicts and tuples, as in the reference) and materialised on
a device.  The port's mesh (``launch/mesh.py``) serves the GNN engine
only; the LM path is not sharded, so the reference's ``shard()``
constraints are the identity and are left out, and the PartitionSpecs
of each ``ParamDef`` with them; ``tp`` stays an argument of the defs
because it decides head padding.

Where the reference reaches a Pallas kernel or computes one's function,
the port calls the kernel's wrapper through ``kernels.ops``: ``rms_norm``
is the rmsnorm kernel, and ``_sdpa`` on a CUDA tensor is the
flash_attention kernel.  On CPU tensors both are their plain versions.

JAX promotes a bf16 activation times an fp32 weight to fp32, and torch's
matmul does not promote: :func:`einsum` casts both operands to the
promoted type first, where the reference's einsums promote.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ops as K
from ..kernels.ref import NEG_INF


# ----------------------------------------------------------------- ParamDef
@dataclass(frozen=True)
class ParamDef:
    shape: tuple
    init: str = "normal"          # normal | zeros | ones
    scale: float = 0.02
    dtype: str = "float32"

    def materialize(self, gen: torch.Generator,
                    device: torch.device) -> torch.Tensor:
        dt = getattr(torch, self.dtype)
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dt, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dt, device=device)
        x = torch.randn(self.shape, generator=gen, dtype=torch.float32,
                        device=device)
        return x.mul_(self.scale).to(dt)


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the leaves of nested dicts, tuples and lists (dict
    keys in sorted order, JAX's leaf order), zipped with trees of the
    same structure in ``rest``; raises ``ValueError`` where they differ."""
    if isinstance(tree, dict):
        if any(not isinstance(r, dict) or sorted(r) != sorted(tree)
               for r in rest):
            raise ValueError(f"tree structures differ at keys {sorted(tree)}")
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        if any(not isinstance(r, (tuple, list)) or len(r) != len(tree)
               for r in rest):
            raise ValueError(f"tree structures differ at a sequence of "
                             f"{len(tree)}")
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def init_tree(defs, seed: int, device: torch.device):
    """Materialise every ParamDef of ``defs`` on ``device`` from one
    ``torch.Generator`` seeded with ``seed``, in leaf order.  Same shapes,
    inits, scales and dtypes as the reference; not jax.random's values."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return tree_map(lambda d: d.materialize(gen, device), defs)


def stack_defs(defs, n: int):
    """Prepend a layer-stack dimension (the reference scans over it)."""
    return tree_map(lambda d: replace(d, shape=(n,) + tuple(d.shape)), defs)


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum`` with JAX's dtype promotion (bf16 x fp32 -> fp32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


# ------------------------------------------------------------------ norms
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * w in fp32, in x's dtype: the rmsnorm
    kernel on the card."""
    return K.rmsnorm(x, w, eps=eps)


def norm_def(d: int) -> ParamDef:
    return ParamDef((d,), init="ones")


# ------------------------------------------------------------------- rope
def rope_tables(positions: torch.Tensor, dim: int, theta: float):
    """positions (...,) int -> (..., dim/2) cos/sin tables."""
    half = dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., T, H, D); cos/sin = positions-shaped + (D/2,): (T,D/2) or
    (B,T,D/2).  One head axis is inserted; leading dims broadcast."""
    half = x.shape[-1] // 2
    cos = cos[..., None, :]                        # (..., T, 1, D/2)
    sin = sin[..., None, :]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * cos - x2 * sin,
                      x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def _act(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


# ================================================================ attention
def padded_heads(h: int, kvh: int, tp: int) -> int:
    """Pad the query-head dim to the TP degree when not divisible (Megatron
    head padding), keeping it divisible by the KV heads."""
    if tp <= 1 or h % tp == 0:
        return h
    hp = -(-h // tp) * tp
    while hp % kvh != 0:
        hp += tp
    return hp


def attn_defs(cfg, tp: int) -> dict:
    d, h, kvh, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                     cfg.resolved_head_dim)
    hp = padded_heads(h, kvh, tp)
    return {
        "wq": ParamDef((d, hp, hd)),
        "wk": ParamDef((d, kvh, hd)),
        "wv": ParamDef((d, kvh, hd)),
        "wo": ParamDef((hp, hd, d)),
        "ln": norm_def(d),
    }


def _is_scalar(q_pos0) -> bool:
    return not isinstance(q_pos0, torch.Tensor) or q_pos0.dim() == 0


def _attn_mask(b, t, s, *, causal, window, q_pos0, kv_len, device):
    """(B, t, s) boolean visibility mask; q_pos0 scalar or (B,)."""
    ar = torch.arange(t, device=device)
    if _is_scalar(q_pos0):
        q_pos = (q_pos0 + ar).expand(b, t)
    else:
        q_pos = q_pos0[:, None] + ar[None, :]
    k_pos = torch.arange(s, device=device)
    mask = torch.ones((b, t, s), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos[..., None] >= k_pos
    if window and window > 0:
        mask &= (q_pos[..., None] - k_pos) < window
    if kv_len is not None:
        mask &= k_pos[None, None, :] < kv_len[:, None, None]
    return mask


_CHUNK_Q_ABOVE = 1024       # stream softmax over q chunks beyond this T
_CHUNK_Q = 512


def _sdpa_core(q, k, v, *, causal, window, q_pos0, kv_len, dtype):
    """The plain masked attention: scores and the PV product in fp32 over
    the operands' own values (bf16 operands widen exactly)."""
    b, t, kvh, g, hd = q.shape
    s = k.shape[1]
    scale = 1.0 / np.sqrt(hd)
    scores = torch.einsum("btkgd,bskd->bkgts", q.float(), k.float()) * scale
    mask = _attn_mask(b, t, s, causal=causal, window=window, q_pos0=q_pos0,
                      kv_len=kv_len, device=q.device)
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", p.to(v.dtype).float(), v.float())
    return out.to(dtype or q.dtype)


def _sdpa_on_card(q, k, v, *, causal, window, q_pos0, kv_len, dtype):
    """The flash_attention kernel over the (B,T,KVH,G,hd) activations in
    place (head h = kvh*G + g reads KV head h // G)."""
    if window and window > 0:
        raise NotImplementedError(
            "sliding-window (local) attention on the card is not ported "
            "yet: see ROADMAP.md, 'Sliding-window flash attention'")
    if kv_len is not None or not _is_scalar(q_pos0) or int(q_pos0) != 0:
        raise NotImplementedError(
            "attention over a dense KV cache (kv_len, q_pos0) is not ported "
            "yet: see ROADMAP.md, 'Other model families and the dense-cache "
            "path'")
    b, t, kvh, g, hd = q.shape
    qh = q.reshape(b, t, kvh * g, hd).permute(0, 2, 1, 3)   # (B,H,T,hd) view
    out = K.flash_attention(qh, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3),
                            causal=causal)
    return out.permute(0, 2, 1, 3).reshape(b, t, kvh, g, hd).to(
        dtype or q.dtype)


def _sdpa(q, k, v, *, causal, window, q_pos0=0, kv_len=None, dtype=None):
    """q (B,T,KVH,G,hd), k/v (B,S,KVH,hd): masked attention, fp32 softmax.

    ``window > 0``: sliding-window (local) causal attention.
    ``kv_len`` (B,) masks cache positions >= length (decode).
    On a CUDA tensor this is the flash_attention kernel (causal or full,
    ``window == 0``, ``q_pos0 == 0``, no ``kv_len``: prefill); anything
    else there raises ``NotImplementedError``.  On the CPU, long
    sequences stream over q chunks as in the reference, so the score
    matrix peak is (cq, S), not (T, S).
    """
    if q.device.type == "cuda":
        return _sdpa_on_card(q, k, v, causal=causal, window=window,
                             q_pos0=q_pos0, kv_len=kv_len, dtype=dtype)
    b, t, kvh, g, hd = q.shape
    if t <= _CHUNK_Q_ABOVE or t % _CHUNK_Q != 0 or not _is_scalar(q_pos0):
        return _sdpa_core(q, k, v, causal=causal, window=window,
                          q_pos0=q_pos0, kv_len=kv_len, dtype=dtype)
    outs = [_sdpa_core(q[:, i:i + _CHUNK_Q], k, v, causal=causal,
                       window=window, q_pos0=q_pos0 + i, kv_len=kv_len,
                       dtype=dtype)
            for i in range(0, t, _CHUNK_Q)]
    return torch.cat(outs, dim=1)


# ===================================================================== MLP
def mlp_defs(cfg, tp: int, d_ff: int = 0) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "w_gate": ParamDef((d, f)),
        "w_in": ParamDef((d, f)),
        "w_out": ParamDef((f, d)),
        "ln": norm_def(d),
    }


def mlp_apply(p, x, cfg):
    xn = rms_norm(x, p["ln"], cfg.norm_eps)
    a = _act(cfg.act)(torch.einsum("btd,df->btf", xn,
                                   p["w_gate"].to(xn.dtype)))
    u = torch.einsum("btd,df->btf", xn, p["w_in"].to(xn.dtype))
    h = a * u
    y = torch.einsum("btf,fd->btd", h, p["w_out"].to(h.dtype))
    return x + y


# ================================================================ embedding
def embed_defs(cfg, tp: int) -> dict:
    v, d = cfg.vocab_size, cfg.d_model
    defs = {"tokens": ParamDef((v, d), scale=1.0 / np.sqrt(d)),
            "final_ln": norm_def(d)}
    if not cfg.tie_embeddings:
        defs["head"] = ParamDef((d, v))
    return defs


def embed_apply(p, tokens, cfg):
    """Rows of the table in ``cfg.dtype``: gathered first, then rounded
    (round to nearest even, as JAX's cast of the whole table)."""
    x = p["tokens"][tokens.long()].to(getattr(torch, cfg.dtype))
    if cfg.name.startswith("gemma3"):
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def logits_apply(p, x, cfg):
    xn = rms_norm(x, p["final_ln"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return torch.einsum("btd,vd->btv", xn, p["tokens"].to(xn.dtype))
    return torch.einsum("btd,dv->btv", xn, p["head"].to(xn.dtype))
