"""XBuilder — accelerator building system (paper §4.3), on Hopper.

Counterpart of ``repro/core/xbuilder.py``.  The paper splits the FPGA die
into **Shell** (fixed logic: storage, runtime, ICAP engine) and **User**
(swappable accelerator, programmed as a partial bitstream through
``Program()``).  On the card the analog is run-time re-binding of kernels:

  * **Shell** = the always-present plain-torch C-kernels (registry label
    ``"cpu"``, priority 50).  The label is the paper's; the ops run on
    whatever device their tensors are on, the service's device.
  * **User bitstreams** = named kernel sets (``kernels/ops.py``: the CUDA
    GEMM kernel as the systolic array, the gather kernels as the vector
    processor).  ``program()`` registers a bitstream's device + kernels
    into the registry; ``unprogram()`` removes it (DFX decoupler).

Building blocks (paper Table 2): GEMM, ElementWise, Reduce, SpMM, SDDMM.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import torch

from .registry import KernelRegistry

SHELL_DEVICE = "cpu"
SHELL_PRIORITY = 50


@dataclass
class Bitstream:
    """A 'partial bitfile': a device plus its C-kernel implementations."""
    device: str
    priority: int
    kernels: dict[str, Callable] = field(default_factory=dict)


class XBuilder:
    def __init__(self, registry: KernelRegistry):
        self.registry = registry
        self.loaded: dict[str, Bitstream] = {}
        self.reconfig_log: list[tuple[str, float]] = []
        self._install_shell()

    # ----------------------------------------------------------- Shell logic
    def _install_shell(self) -> None:
        r = self.registry
        r.register_device(SHELL_DEVICE, SHELL_PRIORITY)
        for name, fn in shell_kernels().items():
            r.register_op(name, SHELL_DEVICE, fn)

    # ------------------------------------------------------------ User logic
    def program(self, bitstream: Bitstream) -> float:
        """Paper Program(bitfile): swap in User logic; returns reconfig secs."""
        t0 = time.perf_counter()
        if bitstream.device in self.loaded:
            self.unprogram(bitstream.device)
        self.registry.register_device(bitstream.device, bitstream.priority)
        for op, fn in bitstream.kernels.items():
            self.registry.register_op(op, bitstream.device, fn)
        self.loaded[bitstream.device] = bitstream
        dt = time.perf_counter() - t0
        self.reconfig_log.append((bitstream.device, dt))
        return dt

    def unprogram(self, device: str) -> None:
        if device == SHELL_DEVICE:
            raise ValueError("Shell logic cannot be unprogrammed")
        self.registry.unregister_device(device)
        self.loaded.pop(device, None)


# ----------------------------------------------------------- Shell C-kernels
def shell_kernels() -> dict[str, Callable]:
    """Plain-torch implementations of the Table-2 building blocks plus the
    GNN C-operations used by the paper's DFG example (Fig. 10).  GEMM,
    SpMM and SDDMM are the kernels' plain versions; every sum runs in a
    fixed order, so a row's result never depends on the batch."""
    from ..kernels import ref        # kernels.ops imports this module

    def elementwise(x, y=None, *, op: str = "relu"):
        if op == "relu":
            return torch.relu(x)
        if op == "add":
            return x + y
        if op == "mul":
            return x * y
        raise ValueError(op)

    def reduce_(x, *, axis: int = 1, op: str = "sum"):
        if op == "max":
            return x.amax(dim=axis)
        if op not in ("sum", "mean"):
            raise ValueError(op)
        s = x.new_zeros(x.shape[:axis] + x.shape[axis + 1:])
        for part in x.unbind(dim=axis):          # in order along ``axis``
            s = s + part
        return s if op == "sum" else s / x.shape[axis]

    def bias_add(x, b):
        return x + b[None, :]

    return {
        "GEMM": ref.gemm_ref,
        "SpMM": ref.spmm_ref,
        "SpMM_Mean": lambda h, nbr, mask: ref.spmm_ref(h, nbr, mask,
                                                       mode="mean"),
        "SpMM_Sum": lambda h, nbr, mask: ref.spmm_ref(h, nbr, mask,
                                                      mode="sum"),
        "SDDMM": ref.sddmm_ref,
        "ElementWise": elementwise,
        "ReLU": lambda x: elementwise(x, op="relu"),
        "Add": lambda x, y: elementwise(x, y, op="add"),
        "Mul": lambda x, y: elementwise(x, y, op="mul"),
        "Reduce": reduce_,
        "BiasAdd": bias_add,
        "Scale": lambda x, s: x * s,
    }
