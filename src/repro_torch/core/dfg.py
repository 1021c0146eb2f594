"""GraphRunner's dataflow-graph (DFG) program model — paper §4.2, Fig. 10.

Users describe a GNN (or any computation) as a DFG of abstract C-operations
via ``createIn/createOp/createOut``; ``save()`` emits the paper's markup
file: a topologically-sorted node list where each node records its sequence
number, C-operation name, input refs (``"<node>_<slot>"`` or an input name)
and output refs.  The engine deserializes the markup, resolves every
C-operation against the registry (device-priority dynamic binding) and
executes node by node — no cross-compilation, reprogrammable at run time.

Counterpart of ``repro/core/dfg.py``: the markup, ``topo_nodes`` and the
AggCombine fusion pass are the reference's own, so a DFG saved by either
package loads in the other.  The engine runs eagerly on torch tensors.
"""
from __future__ import annotations

import json
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any

import torch

from ..locks import witness_lock
from .registry import KernelRegistry
from .spmd import build_sharded_program, mesh_descriptor


@dataclass
class _Node:
    seq: int
    op: str
    inputs: list[str]
    outputs: list[str]
    attrs: dict = field(default_factory=dict)


class Ref(str):
    """A value reference inside a DFG ("Weight", "2_0", ...)."""


class DFG:
    def __init__(self):
        self._nodes: list[_Node] = []
        self._ins: list[str] = []
        self._outs: dict[str, str] = {}
        self._markup_cache: str | None = None   # memoized save() output

    # ------------------------------------------------- paper creation API
    def create_in(self, name: str) -> Ref:
        self._ins.append(name)
        self._markup_cache = None
        return Ref(name)

    def create_op(self, op: str, inputs: list[Ref], n_out: int = 1,
                  attrs: dict | None = None) -> list[Ref]:
        seq = len(self._nodes)
        outs = [f"{seq}_{i}" for i in range(n_out)]
        self._nodes.append(_Node(seq, op, [str(i) for i in inputs], outs,
                                 attrs or {}))
        self._markup_cache = None
        return [Ref(o) for o in outs]

    def create_out(self, name: str, src: Ref) -> None:
        self._outs[name] = str(src)
        self._markup_cache = None

    # ------------------------------------------------- markup (de)serialize
    def save(self) -> str:
        """Markup file (paper Fig. 10c), JSON-encoded.  Memoized: the jit
        engine keys its trace cache on this string every call, and a
        round-tripped DFG already holds its own markup."""
        if self._markup_cache is None:
            self._markup_cache = json.dumps({
                "inputs": self._ins,
                "nodes": [{"seq": n.seq, "op": n.op, "in": n.inputs,
                           "out": n.outputs, "attrs": n.attrs}
                          for n in self._nodes],
                "outputs": self._outs,
            })
        return self._markup_cache

    @classmethod
    def load(cls, markup: str) -> "DFG":
        obj = json.loads(markup)
        dfg = cls()
        dfg._ins = list(obj["inputs"])
        dfg._nodes = [_Node(n["seq"], n["op"], list(n["in"]), list(n["out"]),
                            dict(n.get("attrs", {}))) for n in obj["nodes"]]
        dfg._outs = dict(obj["outputs"])
        dfg._markup_cache = markup
        return dfg

    # ------------------------------------------------- topological order
    def topo_nodes(self) -> list[_Node]:
        """Nodes sorted so every input is produced before use (paper: the DFG
        is converted to a computational structure by topological sort)."""
        produced = set(self._ins)
        remaining = list(self._nodes)
        order: list[_Node] = []
        while remaining:
            progressed = False
            for n in list(remaining):
                if all(i in produced for i in n.inputs):
                    order.append(n)
                    produced.update(n.outputs)
                    remaining.remove(n)
                    progressed = True
            if not progressed:
                raise ValueError("DFG has a cycle or missing input: "
                                 f"{[n.op for n in remaining]}")
        return order


# GCN layer chain folded into the fused aggregate-combine C-operation:
# SpMM_Mean -> GEMM -> BiasAdd -> ReLU   =>   AggCombine(h, nbr, mask, w, b)
_FUSE_CHAIN = ("SpMM_Mean", "GEMM", "BiasAdd", "ReLU")
_FUSED_OP = "AggCombine"


def fuse_aggregate_combine(nodes: list[_Node],
                           protected: set[str]) -> list[_Node]:
    """Rewrite SpMM_Mean->GEMM->BiasAdd->ReLU chains into AggCombine nodes.

    A chain fuses only when every intermediate value has exactly one
    consumer and is not a DFG output (``protected``).  The fused node is
    placed at the ReLU's position, where all five inputs are available.
    """
    uses: dict[str, int] = {}
    consumer: dict[str, _Node] = {}
    for n in nodes:
        for i in n.inputs:
            uses[i] = uses.get(i, 0) + 1
            consumer[i] = n
    for r in protected:
        uses[r] = uses.get(r, 0) + 2        # never fuse across an output

    drop: set[int] = set()
    replace: dict[int, _Node] = {}          # seq of ReLU node -> fused node
    for n in nodes:
        if n.op != _FUSE_CHAIN[0] or n.seq in drop:
            continue
        chain = [n]
        ok = True
        for want in _FUSE_CHAIN[1:]:
            ref = chain[-1].outputs[0]
            nxt = consumer.get(ref)
            if (len(chain[-1].outputs) != 1 or uses.get(ref) != 1
                    or nxt is None or nxt.op != want or nxt.inputs[0] != ref):
                ok = False
                break
            chain.append(nxt)
        if not ok:
            continue
        spmm_n, gemm_n, bias_n, relu_n = chain
        fused = _Node(relu_n.seq, _FUSED_OP,
                      list(spmm_n.inputs) + [gemm_n.inputs[1],
                                             bias_n.inputs[1]],
                      list(relu_n.outputs), {})
        drop.update(x.seq for x in (spmm_n, gemm_n, bias_n))
        replace[relu_n.seq] = fused

    if not replace:
        return nodes
    return [replace.get(n.seq, n) for n in nodes if n.seq not in drop]


class Engine:
    """GraphRunner execution engine: dynamic binding + per-node execution.

    Two execution paths share the dynamic-binding semantics:

      * **eager** (default): resolve + dispatch node by node, with honest
        per-node timings (``self.timings``);
      * **planned** (``run(..., jit=True)``): the maximal suffix of the DFG
        after the last stateful C-operation (registered with
        ``jittable=False``, e.g. the near-storage BatchPre) is resolved
        *once* into a plan of bound C-kernels, cached per (markup, registry
        version, input shapes/dtypes), and each run walks the plan
        eagerly.  The cache key, LRU bound and ``cache_stats()`` keys are
        the reference's (``repro/core/dfg.py``), where an entry holds a
        compiled XLA program; here it holds the resolved plan.
        Re-programming User logic bumps the registry version and
        invalidates stale plans.

    Both paths first apply the aggregate-combine fusion pass whenever a
    fused ``AggCombine`` C-kernel is resolvable (``fuse=None`` -> auto).

    **SPMD** (``mesh=``, a ``launch.mesh.Mesh`` of device slots): the
    planned path runs the suffix over the mesh instead of the plan walk —
    hidden/embedding dims striped across the ``model`` axis, super-batch
    rows across ``data``, psum/all_gather at combine boundaries (see
    ``core/spmd.py``).  The eager prefix (BatchPre) is unchanged; the mesh
    joins the plan-cache key, so one engine can serve meshed and
    un-meshed programs side by side, and ``mesh`` can be re-pointed.
    """

    def __init__(self, registry: KernelRegistry, *, mesh=None,
                 jit_cache_size: int = 32):
        self.registry = registry
        self.mesh = mesh
        self.trace: list[tuple[str, str]] = []     # (op, device) per executed node
        self.timings: list[tuple[str, str, float]] = []
        if jit_cache_size < 1:
            raise ValueError(f"jit_cache_size must be >= 1, got "
                             f"{jit_cache_size}")
        self._jit_cache: OrderedDict = OrderedDict()
        self._jit_cache_size = jit_cache_size
        # the serving runtime's scheduler and immediate-pool threads may
        # run the engine at once: lookup, insert and eviction hold a lock
        self._cache_lock = witness_lock("dfg._cache_lock", threading.Lock())
        self._cache_hits = 0
        self._cache_misses = 0
        self._cache_evictions = 0

    def cache_stats(self) -> dict:
        """LRU plan-cache counters."""
        return {"size": len(self._jit_cache),
                "capacity": self._jit_cache_size,
                "hits": self._cache_hits,
                "misses": self._cache_misses,
                "evictions": self._cache_evictions}

    def run(self, dfg: DFG, feeds: dict[str, Any], *, jit: bool = False,
            fuse: bool | None = None) -> dict[str, Any]:
        env: dict[str, Any] = dict(feeds)
        missing = [i for i in dfg._ins if i not in env]
        if missing:
            raise KeyError(f"missing DFG inputs: {missing}")
        order = dfg.topo_nodes()
        if fuse is None:
            fuse = _FUSED_OP in self.registry.ops
        if fuse:
            order = fuse_aggregate_combine(order, set(dfg._outs.values()))
        self.trace = []
        self.timings = []
        if jit:
            return self._run_planned(dfg, order, env, fuse)
        for node in order:
            self._exec_node(node, env)
        return {name: env[src] for name, src in dfg._outs.items()}

    # ------------------------------------------------------------ eager path
    def _exec_node(self, node: _Node, env: dict[str, Any]) -> None:
        device, fn = self.registry.resolve(node.op)
        self.trace.append((node.op, device))
        t0 = time.perf_counter()
        _apply(node, fn, env)
        _block([env[r] for r in node.outputs])
        self.timings.append((node.op, device, time.perf_counter() - t0))

    # ---------------------------------------------------------- planned path
    def _run_planned(self, dfg: DFG, order: list[_Node], env: dict[str, Any],
                     fuse: bool) -> dict[str, Any]:
        # eager prefix: through the last stateful node
        cut = 0
        for idx, node in enumerate(order):
            if node.op in self.registry.unjittable:
                cut = idx + 1
        for node in order[:cut]:
            self._exec_node(node, env)
        suffix = order[cut:]
        if not suffix:
            return {name: env[src] for name, src in dfg._outs.items()}

        produced: set[str] = set()
        for n in suffix:
            produced.update(n.outputs)
        in_refs = sorted({i for n in suffix for i in n.inputs
                          if i not in produced})
        suffix_outs = [src for src in dict.fromkeys(dfg._outs.values())
                       if src in produced]
        arr_refs, sig, static_env = [], [], {}
        for r in in_refs:
            v = env[r]
            if hasattr(v, "shape") and hasattr(v, "dtype"):
                arr_refs.append(r)
                sig.append((r, tuple(v.shape), str(v.dtype)))
            else:                       # non-array feeds key by value
                static_env[r] = v
                sig.append((r, "static", repr(v)))
        mesh = self.mesh
        mesh_key = None
        if mesh is not None:
            mesh_key = (mesh_descriptor(mesh), tuple(mesh.devices.flat))
        key = (dfg.save(), self.registry.version, fuse, tuple(sig),
               tuple(suffix_outs), mesh_key)
        with self._cache_lock:
            hit = self._jit_cache.get(key)
            if hit is not None:
                self._jit_cache.move_to_end(key)
                self._cache_hits += 1
            else:
                self._cache_misses += 1
                resolved = [self.registry.resolve(n.op) for n in suffix]
                trace = [(n.op, d) for n, (d, _) in zip(suffix, resolved)]
                if mesh is None:
                    plan = [(n, fn) for n, (_, fn) in zip(suffix, resolved)]
                else:
                    plan = build_sharded_program(
                        suffix, resolved, arr_refs, static_env, suffix_outs,
                        env, mesh, self.registry)
                hit = (plan, trace)
                self._jit_cache[key] = hit
                while len(self._jit_cache) > self._jit_cache_size:
                    self._jit_cache.popitem(last=False)
                    self._cache_evictions += 1
        plan, trace = hit
        self.trace.extend(trace)
        t0 = time.perf_counter()
        if callable(plan):                           # the sharded program
            env.update(zip(suffix_outs, plan(*(env[r] for r in arr_refs))))
        else:
            for node, fn in plan:
                _apply(node, fn, env)
        _block([env[r] for r in suffix_outs])
        self.timings.append(("__dfg_jit__", "jit", time.perf_counter() - t0))
        return {name: env[src] for name, src in dfg._outs.items()}


def _apply(node: _Node, fn, env: dict[str, Any]) -> None:
    args = [env[i] for i in node.inputs]
    out = fn(*args, **node.attrs) if node.attrs else fn(*args)
    if len(node.outputs) == 1:
        env[node.outputs[0]] = out
    else:
        for ref, val in zip(node.outputs, out):
            env[ref] = val


def _block(values) -> None:
    """Wait for the card when any value is a CUDA tensor, so per-node
    timings are honest."""
    if any(isinstance(v, torch.Tensor) and v.is_cuda
           for v in _flatten(values)):
        torch.cuda.synchronize()


def _flatten(values):
    for v in values:
        if isinstance(v, (tuple, list)):
            yield from _flatten(v)
        else:
            yield v
