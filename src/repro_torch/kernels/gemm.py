"""Blocked GEMM — the "systolic array" User logic, on Hopper.

Replaces the Pallas kernel ``repro/kernels/gemm.py::_gemm_kernel``
(``pallas_call`` at ``gemm.py:63``).  CUDA source: ``csrc/gemm.cu``.

Bound on the H100: operations at the service's shapes (2*M*N*K fp32
FMAs against 67 TFLOP/s, since TF32 would miss the reference's 1e-5;
bytes are a few MB).  The kernel stays on the fp32 FMA pipes: 24x64
output tiles of 6x4 a thread (32x32 of 2x4 at N <= 64) so the service's
3072-row products fill the card, fragments read from shared memory 16
bytes at a time, and three ``cp.async`` stages so the next K slices
load while this one computes.  bf16 inputs accumulate in fp32 and store
bf16.  The tile shape depends on N only and each output is one in-order
chain over K, so a row's result never depends on M: fused batches stay
bit-identical to serial runs.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import gemm_ref

launches = 0

_ENTRY = {torch.float32: "repro_gemm_f32", torch.bfloat16: "repro_gemm_bf16"}


def gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M,K) @ b (K,N) -> (M,N) in a's dtype (fp32 accumulate)."""
    global launches
    if a.device.type == "cpu":
        return gemm_ref(a, b).to(a.dtype)
    if a.device.type != "cuda":
        raise ValueError(f"gemm: tensors on {a.device}; the kernel takes "
                         "CUDA tensors and the plain version CPU ones")
    if a.dtype not in _ENTRY:
        raise TypeError(f"gemm: dtype {a.dtype} not in {list(_ENTRY)}")
    _build.check("gemm", "a", a, dtype=a.dtype, ndim=2, device=a.device)
    _build.check("gemm", "b", b, dtype=a.dtype, ndim=2, device=a.device)
    (m, k), (k2, n) = a.shape, b.shape
    if k != k2:
        raise ValueError(f"gemm shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    _build.check_sizes("gemm", m, k, n)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(a.device):
        rc = getattr(lib, _ENTRY[a.dtype])(a.data_ptr(), b.data_ptr(),
                                           out.data_ptr(), m, k, n,
                                           _build.stream(a.device))
    _build.raise_on(rc, "gemm")
    launches += 1
    return out
