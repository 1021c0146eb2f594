"""The port's kernels: plain versions (``ref``), CUDA wrappers and the
User-logic bitstreams (``ops``).

Each wrapper module keeps a plain integer ``launches`` that grows by one
where the wrapper launches its kernel; :func:`launch_counts` reads them
and :func:`reset_launch_counts` zeroes them.
"""
import importlib

from . import ref
from .ops import (gemm, spmm, sddmm, agg_combine, agg_combine_partial,
                  BITSTREAMS, program_config)

KERNELS = ("agg_combine", "spmm", "gemm", "sddmm")


def _module(name: str):
    return importlib.import_module(f"{__name__}.{name}")


def launch_counts() -> dict[str, int]:
    return {name: _module(name).launches for name in KERNELS}


def reset_launch_counts() -> None:
    for name in KERNELS:
        _module(name).launches = 0


__all__ = ["ref", "gemm", "spmm", "sddmm", "agg_combine",
           "agg_combine_partial", "BITSTREAMS", "program_config", "KERNELS",
           "launch_counts", "reset_launch_counts"]
