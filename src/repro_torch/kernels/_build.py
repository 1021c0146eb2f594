"""Build and bind the port's CUDA kernels.

All sources under ``csrc/`` build into one shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds).  The build happens at first use, on the machine with the card,
into ``build/repro_torch_kernels/<hash>/`` at the repository root, keyed
by a hash of the sources and flags: ``python3 chip_smoke.py`` alone
builds them.  Each source compiles in its own ``nvcc`` process, all
started together, then one link.  A failed ``nvcc`` raises with its
stderr; nothing falls back.  The headers of :func:`generated` (tables
that the wrappers own, such as agg_combine's tiles) are written beside
the objects and hashed with the sources.

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

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
SIGNATURES = {
    "repro_spmm_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "repro_sddmm_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "repro_gemm_f32": [_P, _P, _P, _I, _I, _I, _P],
    "repro_gemm_bf16": [_P, _P, _P, _I, _I, _I, _P],
    "repro_agg_combine_f32": [_P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "repro_rmsnorm_f32": [_P, _P, _P, _I, _I, _F, _I, _P],
    "repro_rmsnorm_bf16": [_P, _P, _P, _I, _I, _F, _I, _P],
    "repro_flash_attention_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                  _I, _F, *[_L] * 12, _P],
    "repro_flash_attention_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                   _I, _I, _F, *[_L] * 12, _P],
    "repro_decode_attention_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                   _I, _I, _I, _I, _I, _F, _P],
    "repro_decode_attention_bf16": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                    _I, _I, _I, _I, _I, _F, _P],
    "repro_decode_attention_partial_f32": [_P] * 8 + [_I] * 9 + [_F, _P],
    "repro_decode_attention_partial_bf16": [_P] * 8 + [_I] * 9 + [_F, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def generated() -> dict[str, str]:
    """Headers made from the wrappers' tables, by file name:
    ``agg_tiles.inc`` holds one ``REPRO_AGG_TILE(index, BD, BN, TM, BK,
    STAGES, PW)`` line for each of ``agg_combine.TILES``, which the C
    entry's switch includes, so the wrapper's table is the one list;
    ``wgmma.inc`` the tensor-core products of :func:`wgmma_inc`."""
    from .agg_combine import TILES
    tiles = "".join(f"REPRO_AGG_TILE({i}, {', '.join(map(str, t))})\n"
                    for i, t in enumerate(TILES))
    return {"agg_tiles.inc": tiles, "wgmma.inc": wgmma_inc()}


WGMMA_N = (16, 32, 64, 128, 256)     # widths N of the m64nNk16 products


def wgmma_inc() -> str:
    """Hopper's bf16 tensor-core product ``wgmma.mma_async.m64nNk16``
    (fp32 accumulators, N / 2 a thread) for each N of WGMMA_N, as two
    specialisations each of the templates that ``flash_attention.cu``
    declares: ``wgmma_ss<N>(d, a, b, scale_d)`` with A and B from shared
    memory, both K-major (descriptors a, b), and ``wgmma_rs<N>(d, a, b,
    scale_d)`` with A from four registers a thread and B MN-major (the
    transpose bit).  ``scale_d`` 0 overwrites d, 1 adds to it.  Inline
    PTX names every accumulator, up to 128 of them, so the operand lists
    are written here rather than by hand."""
    out = []
    for n in WGMMA_N:
        r = n // 2
        acc = ", ".join(f"%{i}" for i in range(r))
        outs = ", ".join(f'"+f"(d[{i}])' for i in range(r))
        shape = f"m64n{n}k16.f32.bf16.bf16"
        out.append(
            f"template <> __device__ __forceinline__ void wgmma_ss<{n}>(\n"
            f"    float (&d)[{r}], uint64_t a, uint64_t b, int scale_d) {{\n"
            f'  asm volatile("{{\\n.reg .pred p;\\n"\n'
            f'      "setp.ne.b32 p, %{r + 2}, 0;\\n"\n'
            f'      "wgmma.mma_async.sync.aligned.{shape} "\n'
            f'      "{{{acc}}}, %{r}, %{r + 1}, p, 1, 1, 0, 0;\\n}}\\n"\n'
            f"      : {outs}\n"
            f'      : "l"(a), "l"(b), "r"(scale_d));\n'
            f"}}\n"
            f"template <> __device__ __forceinline__ void wgmma_rs<{n}>(\n"
            f"    float (&d)[{r}], const uint32_t (&a)[4], uint64_t b,\n"
            f"    int scale_d) {{\n"
            f'  asm volatile("{{\\n.reg .pred p;\\n"\n'
            f'      "setp.ne.b32 p, %{r + 5}, 0;\\n"\n'
            f'      "wgmma.mma_async.sync.aligned.{shape} "\n'
            f'      "{{{acc}}}, {{%{r}, %{r + 1}, %{r + 2}, %{r + 3}}}, '
            f'%{r + 4}, p, 1, 1, 1;\\n}}\\n"\n'
            f"      : {outs}\n"
            f'      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),\n'
            f'        "r"(scale_d));\n'
            f"}}\n")
    return "".join(out)


def write_generated(directory: Path) -> None:
    for name, text in generated().items():
        (Path(directory) / name).write_text(text)


def build_dir() -> Path:
    """Directory of the library for the current sources, generated
    headers and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    files = [(p.name, p.read_bytes()) for p in sources()]
    files += [(k, v.encode()) for k, v in sorted(generated().items())]
    for name, data in files:
        h.update(name.encode())
        h.update(data)
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
        write_generated(tmp)
        units = [p for p in sources() if p.suffix == ".cu"]
        objs = [tmp / (p.stem + ".o") for p in units]
        logs = _run_all([[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-I", str(tmp),
                          "-c", str(p), "-o", str(o)]
                         for p, o in zip(units, objs)])
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
