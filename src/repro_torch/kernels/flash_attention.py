"""Flash attention (causal, full or sliding-window; online softmax) for
prefill, on Hopper.

Replaces the Pallas kernel ``repro/kernels/flash_attention.py::
_flash_kernel`` (``pallas_call`` at ``flash_attention.py:98``).  CUDA
source: ``csrc/flash_attention.cu``.

q (B,Hq,T,D), k/v (B,Hkv,S,D), all fp32 or all bf16 (the TPU kernel
takes any float dtype, widens to fp32 on load and writes q's dtype; so
does this one), GQA by index (query head h reads KV head h // (Hq/Hkv));
causal means key j is visible to query i when j <= i, and ``window > 0``
adds i - j < window (gemma3's local layers).  Bound on the H100:
operations at prefill shapes (about 4*T*S*D/2 flops per head over the
visible pairs, against 67 TFLOP/s of fp32, or 989 of bf16 tensor cores
for bf16 inputs); key tiles past the diagonal or below the window are
skipped.  One block per (batch*head, query tile) walks the key tiles
with the softmax state in registers (the TPU kernel carried it across
its in-order grid instead); causal launches start the heaviest query
tiles first.  The two types get two designs:

* fp32: FMA arithmetic (TF32 would miss the reference's 3e-5), 32
  queries a block (16 at D = 256) in two parts that take alternate key
  tiles; QK^T keeps each lane's slice of q in registers and sums the
  slices with shuffles, PV is register-tiled, K/V tiles are
  double-buffered through ``cp.async``.
* bf16: Hopper's tensor cores.  128 queries a block, 64 to each of two
  consumer warpgroups that run QK^T and P.V as ``wgmma`` products (bf16
  operands, fp32 accumulators) with the online softmax on the
  accumulators in registers; a producer warpgroup fills a two-stage
  ring of K/V tiles in shared memory by TMA (or by checked copies where
  rows are not 16-byte aligned).  P is rounded to bf16 before P.V.

The kernels read and write through strides (only the head dim must be
contiguous), so the model's (B,T,H,D) activations go in without a
transposed or padded copy, and the output keeps q's memory layout.

Gradients: where q, k or v requires one (grad mode on), the wrapper runs
:class:`FlashAttentionFn`, whose forward is the same kernel (the plain
version on the CPU) and whose backward rebuilds the probabilities from q
and k under the same mask in plain torch, fp32 inside
(:func:`attention_backward`): the TPU kernel had no backward either, XLA
differentiated the reference's ``jnp`` attention.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import NEG_INF, attention_ref, wide

launches = 0

HEAD_DIMS = (16, 32, 64, 128, 256)     # head dims with a compiled kernel
_ENTRY = {torch.float32: "repro_flash_attention_f32",
          torch.bfloat16: "repro_flash_attention_bf16"}
# fewest query rows a block, by dtype (fp32 at D = 256; bf16 at any D)
QUERY_TILE = {torch.float32: 16, torch.bfloat16: 128}


def _check(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"flash_attention: {name} is on {t.device}, "
                         f"expected {device}")
    if t.dtype not in _ENTRY:
        raise TypeError(f"flash_attention: {name} has dtype {t.dtype}; the "
                        f"kernel takes {' or '.join(map(str, _ENTRY))}")
    if t.dim() != 4 or t.stride(-1) != 1:
        raise ValueError(f"flash_attention: {name} must be 4-d with a "
                         f"contiguous last dim, got {tuple(t.shape)} "
                         f"strides {t.stride()}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B,Hq,T,D); k,v (B,Hkv,S,D) with Hq % Hkv == 0 -> (B,Hq,T,D) in
    q's dtype; ``window > 0`` hides keys ``window`` or more positions
    before the query.  Through :class:`FlashAttentionFn` where a gradient
    is asked for."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, causal, window)
    return _flash_attention(q, k, v, causal=causal, window=window)


class FlashAttentionFn(torch.autograd.Function):
    """The flash_attention kernel with a gradient: forward the kernel (the
    plain version on the CPU), backward :func:`attention_backward`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _flash_attention(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, do, causal=ctx.causal,
                                        window=ctx.window)
        return dq, dk, dv, None, None


def attention_backward(q, k, v, do, *, causal: bool = True, window: int = 0):
    """(dq, dk, dv) of ``attention_ref`` for the output gradient ``do``,
    fp32 inside (float64 for float64 operands), in the operands' dtypes:
    P is rebuilt from q and k under the same causal and window mask, query
    head h reads KV head h // G, and dk, dv sum the G query heads of each
    KV head."""
    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    g = hq // hkv
    ct = wide(q.dtype)
    scale = d ** -0.5
    qf = q.to(ct).reshape(b, hkv, g, t, d)
    kf, vf = k.to(ct), v.to(ct)
    dof = do.to(ct).reshape(b, hkv, g, t, d)
    sc = torch.einsum("bkgtd,bksd->bkgts", qf, kf) * scale
    tt = torch.arange(t, device=q.device)[:, None]
    ss = torch.arange(s, device=q.device)[None, :]
    if causal:
        sc = torch.where(tt >= ss, sc, NEG_INF)
    if window > 0:
        sc = torch.where(tt - ss < window, sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    dv = torch.einsum("bkgts,bkgtd->bksd", p, dof)
    dp = torch.einsum("bkgtd,bksd->bkgts", dof, vf)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bkgts,bksd->bkgtd", ds, kf) * scale
    dk = torch.einsum("bkgts,bkgtd->bksd", ds, qf) * scale
    return (dq.reshape(b, hq, t, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _checked(q, k, v) -> None:
    """Every check the kernel's launch makes, for a CUDA call and a
    ``meta`` one alike."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q.device)
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"flash_attention: dtypes q {q.dtype} k {k.dtype} "
                        f"v {v.dtype} differ")
    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    if (tuple(v.shape) != tuple(k.shape) or k.shape[0] != b
            or k.shape[3] != d or hkv == 0 or hq % hkv):
        raise ValueError(f"flash_attention shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if -(-t // QUERY_TILE[q.dtype]) > 65535:
        raise ValueError(f"flash_attention: T = {t} needs more than the "
                         f"grid's 65535 tiles of {QUERY_TILE[q.dtype]} "
                         "queries")
    _build.check_sizes("flash_attention", b, hq, t, s)


def _flash_attention(q, k, v, *, causal: bool, window: int) -> torch.Tensor:
    """The kernel on CUDA tensors, the plain version on CPU ones; on
    ``meta`` tensors the kernel's checks and an empty output, no launch."""
    global launches
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention: tensors on {q.device}; the "
                         "kernel takes CUDA tensors (meta ones for its "
                         "checks alone) and the plain version CPU ones")
    _checked(q, k, v)
    out = torch.empty_like(q)       # keeps a dense q's layout, e.g. (B,T,H,D)
    if out.numel() == 0 or q.device.type == "meta":
        return out
    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    strides = [x for tensor in (q, k, v, out) for x in tensor.stride()[:3]]
    lib = _build.library()
    with torch.cuda.device(q.device):
        rc = getattr(lib, _ENTRY[q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
            hkv, t, s, d, int(causal), max(int(window), 0), 1.0 / d ** 0.5,
            *strides, _build.stream(q.device))
    _build.raise_on(rc, "flash_attention")
    launches += 1
    return out
