"""Fused RMSNorm — one row per block, on Hopper.

Replaces the Pallas kernel ``repro/kernels/rmsnorm.py::_rmsnorm_kernel``
(``pallas_call`` at ``rmsnorm.py:36``).  CUDA source: ``csrc/rmsnorm.cu``.

Computes ``x * rsqrt(mean(x^2) + eps) * w`` over the last dim in fp32 and
stores it in x's dtype (fp32 or bf16).  Bound on the H100: bytes (each
element read once and written once for three flops).  The TPU kernel
kept 256-row slabs in VMEM; here a block of 256 threads owns one row and
reads it with neighbouring threads on neighbouring elements, which at
the LM's widths (F = 3072) is a few KB a row.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import rmsnorm_ref

launches = 0

_ENTRY = {torch.float32: "repro_rmsnorm_f32",
          torch.bfloat16: "repro_rmsnorm_bf16"}


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """x (..., F) fp32 or bf16; w (F,) -> x's shape and dtype."""
    global launches
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: tensors on {x.device}; the kernel takes "
                         "CUDA tensors and the plain version CPU ones")
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
    rows = x.numel() // f if f else 0
    _build.check_sizes("rmsnorm", rows, f)
    out = torch.empty_like(x)
    if rows == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(x.device):
        rc = getattr(lib, _ENTRY[x.dtype])(x.data_ptr(), w32.data_ptr(),
                                           out.data_ptr(), rows, f, eps,
                                           _build.stream(x.device))
    _build.raise_on(rc, "rmsnorm")
    launches += 1
    return out
