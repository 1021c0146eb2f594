"""C-operation / C-kernel registry — paper Table 3 semantics.

Copy of ``repro/core/registry.py`` for the PyTorch port, verbatim:
its relative imports resolve inside ``repro_torch``, which
keeps the reference's module layout.

Two metadata structures drive GraphRunner's dynamic binding:

  * **device table**: device name -> priority (RegisterDevice),
  * **operation table**: C-operation name -> [(device, C-kernel ptr), ...]
    (RegisterOpDefinition; multiple kernels per operation allowed).

At execution time the engine resolves each C-operation to the registered
C-kernel whose device has the *highest priority* — e.g. with
CPU=50 < vector=150 < systolic=300, a GEMM with all three kernels runs on
the systolic implementation.  This is exactly how the paper routes GEMM to
Gemmini and SpMM to Hwacha in the Hetero configuration.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable


@dataclass
class KernelRegistry:
    devices: dict[str, int] = field(default_factory=dict)
    ops: dict[str, list[tuple[str, Callable]]] = field(default_factory=dict)
    unjittable: set[str] = field(default_factory=set)
    # monotonically bumped on every (un)registration — the engine's whole-DFG
    # jit cache keys on it so reprogramming invalidates stale traces.
    version: int = 0

    # -- paper: RegisterDevice(newDevice)
    def register_device(self, name: str, priority: int) -> None:
        self.devices[name] = int(priority)
        self.version += 1

    # -- paper: RegisterOpDefinition(newOp)
    def register_op(self, op_name: str, device: str, fn: Callable, *,
                    jittable: bool = True) -> None:
        if device not in self.devices:
            raise KeyError(f"device {device!r} not registered")
        lst = self.ops.setdefault(op_name, [])
        lst[:] = [(d, f) for (d, f) in lst if d != device]   # re-registration wins
        lst.append((device, fn))
        if not jittable:
            self.unjittable.add(op_name)
        else:
            self.unjittable.discard(op_name)                 # re-registration wins
        self.version += 1

    def unregister_device(self, device: str) -> None:
        """Drop a device and all its kernels (XBuilder partial reconfig)."""
        self.devices.pop(device, None)
        for name in list(self.ops):
            self.ops[name] = [(d, f) for (d, f) in self.ops[name] if d != device]
            if not self.ops[name]:
                del self.ops[name]
                self.unjittable.discard(name)
        self.version += 1

    def resolve(self, op_name: str) -> tuple[str, Callable]:
        cands = self.ops.get(op_name)
        if not cands:
            raise KeyError(f"no C-kernel registered for C-operation {op_name!r}")
        return max(cands, key=lambda df: self.devices.get(df[0], -1))

    def dispatch(self, op_name: str, *args, **kwargs):
        _, fn = self.resolve(op_name)
        return fn(*args, **kwargs)

    def snapshot(self) -> dict:
        return {op: [d for d, _ in lst] for op, lst in self.ops.items()}
