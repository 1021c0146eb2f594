"""Build and bind the port's CUDA kernels.

All sources under ``csrc/`` build into one shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds).  The build happens at first use, on the machine with the card,
into ``build/repro_torch_kernels/<hash>/`` at the repository root, keyed
by a hash of the sources and flags: ``python3 chip_smoke.py`` alone
builds them.  Each source compiles in its own ``nvcc`` process, all
started together, then one link.  A failed ``nvcc`` raises with its
stderr; nothing falls back.

Each C entry takes device pointers, int sizes and the caller's stream and
returns ``cudaGetLastError()``; :func:`raise_on` turns a non-zero code
into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
INT_MAX = 2**31 - 1

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "repro_spmm_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "repro_sddmm_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "repro_gemm_f32": [_P, _P, _P, _I, _I, _I, _P],
    "repro_gemm_bf16": [_P, _P, _P, _I, _I, _I, _P],
    "repro_agg_combine_rows": [_I],
    "repro_agg_combine_f32": [_P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def build_dir() -> Path:
    """Directory of the library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): the port's "
                           "kernels are built with nvcc at first use")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run commands in parallel; raise with the stderr of any that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    logs, failed = [], []
    for cmd, p in zip(cmds, procs):
        out, err = p.communicate()
        logs.append(f"$ {' '.join(cmd)}\n{out}{err}")
        if p.returncode:
            failed.append(f"$ {' '.join(cmd)}\n(exit {p.returncode})\n{err}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def build() -> Path:
    """Build the library unless this hash is already built; returns its
    path.  ``build.log`` beside it keeps nvcc's and ptxas' output."""
    out_dir = build_dir()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = Path(tempfile.mkdtemp(prefix=".tmp-", dir=BUILD_ROOT))
    try:
        units = [p for p in sources() if p.suffix == ".cu"]
        objs = [tmp / (p.stem + ".o") for p in units]
        logs = _run_all([[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(p),
                          "-o", str(o)] for p, o in zip(units, objs)])
        logs += _run_all([[nvcc, "-shared", *map(str, objs),
                           "-o", str(tmp / LIB_NAME)]])
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "build.log").write_text("\n".join(logs))
        os.replace(tmp / LIB_NAME, lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc} "
                           f"({torch.cuda.get_device_name()})")


def check(kernel: str, name: str, t, *, dtype: torch.dtype, ndim: int,
          device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``ndim``-d ``dtype`` tensor on
    ``device``: the kernels take nothing else."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{kernel}: {name} must be a tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, expected "
                         f"{device}")
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: {name} has dtype {t.dtype}, expected "
                        f"{dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, "
                         f"expected {ndim} dims")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def check_ell(kernel: str, h, nbr, mask) -> None:
    """Checks shared by the gather kernels: h (N,F) fp32 on a CUDA
    device, nbr (D,K) int32 and mask (D,K) fp32 beside it."""
    if h.device.type != "cuda":
        raise ValueError(f"{kernel}: tensors on {h.device}; the kernel "
                         "takes CUDA tensors and the plain version CPU ones")
    check(kernel, "h", h, dtype=torch.float32, ndim=2, device=h.device)
    check(kernel, "nbr", nbr, dtype=torch.int32, ndim=2, device=h.device)
    check(kernel, "mask", mask, dtype=torch.float32, ndim=2, device=h.device)
    if tuple(mask.shape) != tuple(nbr.shape):
        raise ValueError(f"{kernel}: mask {tuple(mask.shape)} != nbr "
                         f"{tuple(nbr.shape)}")
    check_sizes(kernel, *h.shape, *nbr.shape)


def check_sizes(kernel: str, *sizes: int) -> None:
    if any(s > INT_MAX for s in sizes):
        raise ValueError(f"{kernel}: sizes {sizes} exceed the kernel's "
                         "32-bit int arguments")
