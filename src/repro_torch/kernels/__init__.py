"""The port's kernels: plain versions (``ref``), CUDA wrappers and the
User-logic bitstreams (``ops``).

Each wrapper module keeps a plain integer ``launches`` that grows by one
where the wrapper launches its kernel (``decode_attention``'s partial
entry in ``partial_launches`` of the same module); :func:`launch_counts`
reads them (the partial entry's as "decode_attention_partial") and
:func:`reset_launch_counts` zeroes them.
"""
import importlib

from . import ref
from .ops import (gemm, spmm, sddmm, agg_combine, agg_combine_partial,
                  rmsnorm, flash_attention, decode_attention,
                  decode_attention_partial, BITSTREAMS, program_config)

KERNELS = ("agg_combine", "spmm", "gemm", "sddmm", "rmsnorm",
           "flash_attention", "decode_attention")


def _module(name: str):
    return importlib.import_module(f"{__name__}.{name}")


def launch_counts() -> dict[str, int]:
    """Each kernel's launches, and decode_attention's partial entry's as
    "decode_attention_partial"."""
    out = {name: _module(name).launches for name in KERNELS}
    out["decode_attention_partial"] = _module(
        "decode_attention").partial_launches
    return out


def reset_launch_counts() -> None:
    for name in KERNELS:
        _module(name).launches = 0
    _module("decode_attention").partial_launches = 0


__all__ = ["ref", "gemm", "spmm", "sddmm", "agg_combine",
           "agg_combine_partial", "rmsnorm", "flash_attention",
           "decode_attention", "decode_attention_partial", "BITSTREAMS",
           "program_config", "KERNELS",
           "launch_counts", "reset_launch_counts"]
