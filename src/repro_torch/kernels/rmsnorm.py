"""Fused RMSNorm — each row held in registers, on Hopper.

Replaces the Pallas kernel ``repro/kernels/rmsnorm.py::_rmsnorm_kernel``
(``pallas_call`` at ``rmsnorm.py:36``).  CUDA source: ``csrc/rmsnorm.cu``.

Computes ``x * rsqrt(mean(x^2) + eps) * w`` over the last dim in fp32 and
stores it in x's dtype (fp32 or bf16).  Bound on the H100: bytes (each
element read once and written once for three flops).  The TPU kernel
kept 256-row slabs in VMEM; here ``threads_per_row(F, rows)`` threads own a row
and hold it in registers as 16-byte vectors (8-byte for bf16), so x is
read once: at the LM's width (F = 3072) 128 threads of 6 vectors each at
the 500 prefill rows (one wave of blocks over the card), 256 of 3 at the
1-4 decode rows (one short block a row).  Rows not aligned to the vector size
take element loads with the same arithmetic.

Gradients: where x or w requires one (grad mode on), the wrapper runs
:class:`RMSNormFn`, whose forward is the same kernel (the plain version
on the CPU) and whose backward is the closed form in plain torch, in fp32
(:func:`rmsnorm_backward`): the TPU kernel had no backward either, XLA
differentiated the reference's ``jnp`` norm.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import rmsnorm_ref, wide

launches = 0

_ENTRY = {torch.float32: "repro_rmsnorm_f32",
          torch.bfloat16: "repro_rmsnorm_bf16"}
MAX_CHUNKS = 8              # 4-element vectors the kernel's registers hold
MAX_THREADS = 512
WIDE = 132                  # rows that give each SM of an H100 a block


def threads_per_row(f: int, rows: int) -> int:
    """Threads that share a row of F elements: enough for each to hold 6
    vectors of 4 when the rows fill the card (blocks small enough for one
    wave), 3 when they do not (each row's block short); a power of two up
    to a warp, whole warps beyond.  At F = 3072: 128 and 256."""
    chunks = -(-f // 4)
    per = -(-chunks // (6 if rows >= WIDE else 3))
    if per <= 32:
        return 1 << (per - 1).bit_length()
    return min(MAX_THREADS, -(-per // 32) * 32)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """x (..., F) fp32 or bf16; w (F,) -> x's shape and dtype; through
    :class:`RMSNormFn` where a gradient is asked for."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return RMSNormFn.apply(x, w, eps)
    return _rmsnorm(x, w, eps)


class RMSNormFn(torch.autograd.Function):
    """The rmsnorm kernel with a gradient: forward the kernel (the plain
    version on the CPU), backward :func:`rmsnorm_backward`."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _rmsnorm(x, w, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_backward(x, w, dy, eps=ctx.eps)
        return dx, dw, None


def rmsnorm_backward(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, *,
                     eps: float = 1e-6):
    """(dx, dw) of y = x * r * w, r = rsqrt(mean(x^2) + eps), in closed
    form in fp32 (float64 for float64 x): dx = r * (dy*w - x * r^2 *
    mean(dy*w*x)), dw = sum over rows of dy * x * r; in x's and w's
    dtypes."""
    ct = wide(x.dtype)
    xf, g = x.to(ct), dy.to(ct) * w.to(ct)
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    dx = r * (g - xf * (r * r) * (g * xf).mean(dim=-1, keepdim=True))
    dw = (dy.to(ct) * xf * r).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dw.to(w.dtype)


def _checked(x: torch.Tensor,
             w: torch.Tensor) -> tuple[int, int, torch.Tensor]:
    """Every check the kernel's launch makes, for a CUDA call and a
    ``meta`` one alike: (rows, F, w in fp32)."""
    if x.dtype not in _ENTRY:
        raise TypeError(f"rmsnorm: dtype {x.dtype} not in {list(_ENTRY)}")
    _build.check("rmsnorm", "x", x, dtype=x.dtype, ndim=x.dim(),
                 device=x.device)
    f = x.shape[-1]
    if tuple(w.shape) != (f,):
        raise ValueError(f"rmsnorm: w {tuple(w.shape)} != ({f},)")
    w32 = w.float()                  # the kernel scales in fp32
    _build.check("rmsnorm", "w", w32, dtype=torch.float32, ndim=1,
                 device=x.device)
    if f > MAX_THREADS * MAX_CHUNKS * 4:
        raise ValueError(f"rmsnorm: F = {f} > {MAX_THREADS * MAX_CHUNKS * 4}"
                         ", more than the kernel holds in registers")
    rows = x.numel() // f if f else 0
    _build.check_sizes("rmsnorm", rows, f)
    return rows, f, w32


def _rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """The kernel on a CUDA tensor, the plain version on a CPU one; on a
    ``meta`` tensor the kernel's checks and an empty output, no launch."""
    global launches
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps=eps)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"rmsnorm: tensors on {x.device}; the kernel takes "
                         "CUDA tensors (meta ones for its checks alone) and "
                         "the plain version CPU ones")
    rows, f, w32 = _checked(x, w)
    out = torch.empty_like(x)
    if rows == 0 or x.device.type == "meta":
        return out
    lib = _build.library()
    with torch.cuda.device(x.device):
        rc = getattr(lib, _ENTRY[x.dtype])(x.data_ptr(), w32.data_ptr(),
                                           out.data_ptr(), rows, f, eps,
                                           threads_per_row(f, rows),
                                           _build.stream(x.device))
    _build.raise_on(rc, "rmsnorm")
    launches += 1
    return out
