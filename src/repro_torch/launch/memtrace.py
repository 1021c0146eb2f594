"""What a step holds and computes, from the aten ops it runs: the live
bytes of its storages and their peak, the flops of its products, and
the bytes its ops read and write.  The dry run (``launch/dryrun.py``)
runs a cell's step under a :class:`StepTrace` on ``meta`` tensors; the
same trace runs on CPU and CUDA tensors alike.

* **Live bytes.**  A storage counts from the op whose output first holds
  it until it is freed: each is keyed by its
  ``torch.multiprocessing.reductions.StorageWeakRef``, and a weak
  reference to its Python object, which lives exactly as long as the
  storage, takes it out when it expires.  Views and in-place ops share
  their input's storage and add nothing; autograd's saved tensors leave
  when backward releases them, and a checkpointed region's recomputed
  activations when backward has used them.  An op's output that shares
  the storage of an input the trace does not hold (a tensor from before
  the trace, or made under :meth:`StepTrace.paused`) stays uncounted:
  the dry run's tensors of other slots.  :meth:`StepTrace.hold` counts a
  step's arguments from the start.
* **Flops.**  Each product (``mm``, ``bmm``, ``addmm``, ``baddbmm``, the
  convolutions and attention ops of ``torch.utils.flop_counter``'s
  registry, which einsums lower to) at its shapes, in ``flops`` and
  ``dot_flops`` alike; an LM kernel call on the card's route (CUDA or
  ``meta`` tensors), which no aten op shows, by its cost function
  (``kernels/cost.py``).  The trace sees those calls by wrapping the
  LM kernels' wrappers where the models call them (``kernels/ops.py``;
  decode_attention's partial entry among them) for
  as long as it is entered; a call on CPU tensors runs the plain
  version, whose aten ops it sees itself.  ``flops``
  its work over the positions its mask or lengths leave (the page
  table's capacity on ``meta``), ``dot_flops`` its products over every
  query and key, as an HLO dot is counted.
* **Bytes accessed.**  Each op's input tensors read once and outputs
  written once, views and ``empty`` allocations none, plus each kernel
  call's bytes from its cost function: the traffic of an eager step
  with no fusion, an upper bound on its HBM bytes.
"""
from __future__ import annotations

import contextlib
import functools
import weakref

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..kernels import cost, ops
from ..models import layers as L

LM_KERNELS = ("rmsnorm", "flash_attention", "decode_attention",
              "decode_attention_partial")
_NO_TRAFFIC = frozenset(("empty", "empty_like", "empty_strided", "new_empty",
                         "new_empty_strided"))


def _tensors(values) -> list:
    """The tensors among ``values`` and in its lists and tuples (an aten
    op's arguments and results nest no deeper)."""
    out = []
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out.extend(t for t in v if isinstance(t, torch.Tensor))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepTrace(TorchDispatchMode):
    """Under ``with StepTrace() as tr:``, the ops run and the LM kernels
    called; then ``tr.peak_bytes``, ``tr.live_bytes``, ``tr.held_bytes``,
    ``tr.flops``,
    ``tr.dot_flops``, ``tr.bytes_accessed`` and ``tr.kernel_calls`` (by
    kernel name)."""

    def __init__(self):
        super().__init__()
        self._live: dict = {}           # StorageWeakRef -> (bytes, weakref)
        self._paused = 0
        self._wrapped: dict = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self.held_bytes = 0
        self.flops = 0.0
        self.dot_flops = 0.0
        self.bytes_accessed = 0.0
        self.kernel_calls: dict[str, int] = {}

    def __enter__(self):
        self._wrapped = {n: getattr(ops, n) for n in LM_KERNELS}
        for name, fn in self._wrapped.items():
            setattr(ops, name, self._counted(name, fn))
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            for name, fn in self._wrapped.items():
                setattr(ops, name, fn)

    # ------------------------------------------------------------ storages
    def _add(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = StorageWeakRef(st)
        if key in self._live:
            return 0
        n = st.nbytes()
        self._live[key] = (n, weakref.ref(st, functools.partial(self._drop,
                                                                key)))
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return n

    def _drop(self, key, _ref) -> None:
        n, _ = self._live.pop(key)
        self.live_bytes -= n

    def hold(self, tree, arguments: int | None = None) -> int:
        """Count the storages of ``tree``'s tensors as live from now;
        returns the bytes newly counted.  ``arguments`` of them (default:
        all) are the step's arguments, summed in ``held_bytes``; the rest
        is held beyond them, as temporary bytes are."""
        n = sum(self._add(t) for t in L.tree_leaves(tree))
        self.held_bytes += n if arguments is None else arguments
        return n

    @contextlib.contextmanager
    def paused(self):
        """Ops inside the block count nothing: their outputs are not
        held, their work and kernel calls not counted."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    # ------------------------------------------------------------ counting
    def _counted(self, name: str, fn):
        """``fn``, the LM kernel wrapper ``name``, counting each call that
        took the card's route."""
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            if args[0].device.type != "cpu":
                self.kernel_call(name, args, kwargs)
            return out
        return call

    def kernel_call(self, name: str, args, kwargs) -> None:
        if self._paused:
            return
        nbytes, flops = cost.lm_call_cost(name, args, kwargs)
        self.flops += flops
        self.dot_flops += cost.lm_dot_flops(name, args, kwargs)
        self.bytes_accessed += nbytes
        self.kernel_calls[name] = self.kernel_calls.get(name, 0) + 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused:
            return out
        ins = _tensors(args)
        if kwargs:
            ins += _tensors(kwargs.values())
        outs = _tensors((out,))
        own = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            if t.untyped_storage()._cdata not in own:
                self._add(t)
        packet = func.overloadpacket
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += f
            self.dot_flops += f
        if not func.is_view and packet.__name__ not in _NO_TRAFFIC:
            self.bytes_accessed += sum(map(_nbytes, ins)) \
                + sum(map(_nbytes, outs))
        return out
