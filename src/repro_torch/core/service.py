"""HolisticGNN service facade on one device — the CSSD-resident endpoint
exposing the paper's Table-1 RPCs (GraphStore bulk/unit ops, GraphRunner
Run/Plugin, XBuilder Program) over one object, suitable for RPCServer
dispatch.

Counterpart of ``repro/core/service.py`` for a single-device store.
``run`` executes the near-storage inference pipeline: the DFG's
``BatchPre`` C-operation samples, reindexes and gathers embeddings
*against the page store*, moves the sampled block onto the service's
device, and the engine binds and executes the model's C-operations by
device priority.  Weights arrive as NumPy feed dicts (as over RPC) or as
tensors and are kept on the device; results come back as NumPy.

The sharded and replicated arrays, the SPMD engine, the mutation firehose
and the shard admin RPCs are not ported yet; each raises
``NotImplementedError`` naming its ``ROADMAP.md`` item.
"""
from __future__ import annotations

import importlib

import numpy as np
import torch

from ..device import resolve_device
from ..store.blockdev import BlockDevice
from ..store.graphstore import GraphStore
from ..store.sampler import sample_batch
from .dfg import DFG, Engine
from .registry import KernelRegistry
from .xbuilder import XBuilder, Bitstream, SHELL_DEVICE
from . import gnn

_ARRAY_ITEM = "Sharded and replicated stores"
_SPMD_ITEM = "SPMD engine"
_FIREHOSE_ITEM = "Mutation firehose and shard admin RPCs"


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: see ROADMAP.md, "
                               f"'{item}'")


class HolisticGNNService:
    """The device-resident service object: Table-1 RPC surface over one
    single-device store plus the DFG engine, kernel registry and
    XBuilder.  ``device`` is where sampled blocks, weights and compute
    live: ``None`` means ``"cuda"`` and raises ``RuntimeError`` on a host
    without CUDA; the tests pass ``device="cpu"``."""

    def __init__(self, *, h_threshold: int = 128, pad_to: int = 64,
                 dev: BlockDevice | None = None,
                 cache_pages: int | None = None,
                 n_shards: int = 1, devs: list | None = None,
                 endpoints: list | None = None,
                 replication: int = 1,
                 mesh=None, model_parallel: int | None = None,
                 jit_cache_size: int = 32,
                 device: str | torch.device | None = None):
        """``n_shards``, ``devs``, ``endpoints`` and ``replication`` build
        a CSSD array in the reference; ``mesh`` and ``model_parallel``
        its SPMD engine.  Neither is ported: asking raises."""
        self.device = resolve_device(device)
        if endpoints is not None or devs is not None or n_shards > 1 \
                or replication > 1:
            raise _not_ported("a sharded or replicated store", _ARRAY_ITEM)
        if mesh is not None or model_parallel is not None:
            raise _not_ported("the SPMD engine", _SPMD_ITEM)
        self.store = GraphStore(dev or BlockDevice(), h_threshold=h_threshold)
        if cache_pages:
            self.store.attach_cache_pages(cache_pages)
        self.registry = KernelRegistry()
        self.xbuilder = XBuilder(self.registry)
        for name, fn in gnn.extra_shell_kernels().items():
            self.registry.register_op(name, SHELL_DEVICE, fn)
        self._register_batchpre()
        self.engine = Engine(self.registry, jit_cache_size=jit_cache_size)
        self.pad_to = pad_to
        self._programs: dict[str, object] = {}   # markup -> ServiceProgram
        self._weight_store: dict[str, dict] = {} # weights_ref -> feed dict

    def _tensor(self, v) -> torch.Tensor:
        """A feed or weight as a tensor on the service's device."""
        if isinstance(v, torch.Tensor):
            return v.to(self.device)
        return torch.tensor(np.asarray(v), device=self.device)

    # ------------------------------------------------------------- GraphStore
    def update_graph(self, edge_array, embeddings=None,
                     already_undirected=False):
        """Bulk UpdateGraph RPC.  ``already_undirected=True`` skips the
        [G-2] mirror pass for pre-symmetrized datasets."""
        edges = np.asarray(edge_array)
        emb = None if embeddings is None else np.asarray(embeddings)
        tl = self.store.update_graph(edges, emb,
                                     already_undirected=bool(already_undirected))
        return {"total_s": tl.total, "user_visible_s": tl.user_visible}

    def add_vertex(self, vid, embed=None):
        """Unit AddVertex RPC: insert ``vid`` (optional embedding row)."""
        self.store.add_vertex(int(vid), embed)

    def delete_vertex(self, vid):
        """Unit DeleteVertex RPC: remove ``vid`` and every incident edge."""
        self.store.delete_vertex(int(vid))

    def add_edge(self, dst, src):
        """Unit AddEdge RPC: undirected edge insert (both directions)."""
        self.store.add_edge(int(dst), int(src))

    def delete_edge(self, dst, src):
        """Unit DeleteEdge RPC: undirected edge delete (both directions)."""
        self.store.delete_edge(int(dst), int(src))

    def update_embed(self, vid, embed):
        """Unit UpdateEmbed RPC: overwrite ``vid``'s embedding row."""
        self.store.update_embed(int(vid), np.asarray(embed))

    def get_embed(self, vid):
        """Point read of one vertex embedding."""
        return self.store.get_embed(int(vid))

    def get_neighbors(self, vid):
        """Point read of one vertex's sorted neighbor list."""
        return self.store.get_neighbors(int(vid))

    # ------------------------------------------- array-only RPCs (not ported)
    def open_firehose(self, *args, **kwargs):
        """Mutation firehose: not ported (raises)."""
        raise _not_ported("the mutation firehose", _FIREHOSE_ITEM)

    def flush_firehose(self, *args, **kwargs):
        """Mutation firehose: not ported (raises)."""
        raise _not_ported("the mutation firehose", _FIREHOSE_ITEM)

    def close_firehose(self, *args, **kwargs):
        """Mutation firehose: not ported (raises)."""
        raise _not_ported("the mutation firehose", _FIREHOSE_ITEM)

    def fail_shard(self, *args, **kwargs):
        """Shard fault injection: needs a replicated array (raises)."""
        raise _not_ported("fail_shard", _FIREHOSE_ITEM)

    def rebuild_shard(self, *args, **kwargs):
        """Shard rebuild: needs a replicated array (raises)."""
        raise _not_ported("rebuild_shard", _FIREHOSE_ITEM)

    def probe_shards(self, *args, **kwargs):
        """Shard health probe: needs a sharded array (raises)."""
        raise _not_ported("probe_shards", _FIREHOSE_ITEM)

    def reshard(self, *args, **kwargs):
        """Elastic reshard: needs a sharded array (raises)."""
        raise _not_ported("reshard", _FIREHOSE_ITEM)

    # ------------------------------------------------------------ GraphRunner
    def _register_batchpre(self):
        def batch_pre(targets, seed=0, *, fanouts):
            batch = sample_batch(self.store, np.asarray(targets), list(fanouts),
                                 rng=np.random.default_rng(int(seed)),
                                 pad_to=self.pad_to)
            outs = [self._tensor(batch.embeddings)]
            for blk in batch.layers:
                outs.append(self._tensor(blk.nbr))
                outs.append(self._tensor(blk.mask))
            return tuple(outs)
        # stateful (touches the page store): runs eagerly ahead of the
        # engine's cached plan.
        self.registry.register_op("BatchPre", SHELL_DEVICE, batch_pre,
                                  jittable=False)

    def run(self, dfg: str, batch, weights: dict | None = None,
            fanouts=None, seed: int = 0, jit: bool = True,
            weights_ref: str | None = None):
        """Paper Run(DFG, batch).

        * If the DFG starts with a ``BatchPre`` node (service-style DFG),
          only the raw target VIDs are fed; sampling happens near storage.
        * Otherwise (model-only DFG, Fig. 10b) the service samples first and
          feeds H/nbr/mask inputs directly.

        ``jit=True`` (default) runs the model portion through the engine's
        cached plan; the sampler's ``pad_to`` bucketing keeps the number of
        distinct shape signatures small.
        """
        dfg_obj = DFG.load(dfg) if isinstance(dfg, str) else dfg
        feeds = self._resolve_weights(weights, weights_ref)
        if "Batch" in dfg_obj._ins:
            feeds["Batch"] = np.asarray(batch)
            if "Seed" in dfg_obj._ins:     # per-request sampling stream
                feeds["Seed"] = int(seed)
        else:
            if fanouts is None:
                raise ValueError("model-only DFG needs fanouts")
            b = sample_batch(self.store, np.asarray(batch), list(fanouts),
                             rng=np.random.default_rng(seed), pad_to=self.pad_to)
            feeds["H"] = self._tensor(b.embeddings)
            for l, blk in enumerate(b.layers):
                feeds[f"nbr{l}"] = self._tensor(blk.nbr)
                feeds[f"mask{l}"] = self._tensor(blk.mask)
        out = self.engine.run(dfg_obj, feeds, jit=jit)
        return {k: _to_numpy(v) for k, v in out.items()}

    def put_weights(self, name: str, weights: dict) -> dict:
        """Register a model's weights on the service's device under
        ``name``; clients then pass ``weights_ref=name`` per request
        instead of re-shipping the weight set each time."""
        stored = {k: self._tensor(v) for k, v in weights.items()}
        self._weight_store[name] = stored
        return {"name": name, "tensors": len(stored),
                "bytes": int(sum(v.numel() * v.element_size()
                                 for v in stored.values()))}

    def _resolve_weights(self, weights: dict | None,
                         weights_ref: str | None) -> dict:
        out = {}
        if weights_ref is not None:
            stored = self._weight_store.get(weights_ref)
            if stored is None:
                raise KeyError(f"unknown weights_ref {weights_ref!r} "
                               "(register with put_weights first)")
            out.update(stored)
        for k, v in (weights or {}).items():     # per-request overrides win
            out[k] = self._tensor(v)
        return out

    def _service_program(self, markup: str):
        """Cached BatchPre/model split of a service DFG (serving hot path)."""
        if markup not in self._programs:
            from ..serve.batcher import split_service_dfg
            self._programs[markup] = split_service_dfg(DFG.load(markup))
        return self._programs[markup]

    def run_batch(self, dfg, requests, weights: dict | None = None,
                  jit: bool = True, weights_ref: str | None = None):
        """Continuous-batching entry: several Run requests against the same
        service DFG as ONE fused engine execution.

        ``requests`` is a list of ``{"targets": [...], "seed": int}``.  The
        group is sampled near storage in one pass per hop (per-request rng
        segments keep each request's sample bit-identical to a solo run),
        composed into a block-diagonal super-batch, bucket-padded, moved to
        the device and run through the cached plan; each request gets back
        exactly its own output rows.  Returns a list of per-request result
        dicts.
        """
        from ..serve.batcher import sample_group, pad_group
        markup = dfg if isinstance(dfg, str) else dfg.save()
        prog = self._service_program(markup)
        if prog is None:
            raise ValueError("run_batch needs a BatchPre-led service DFG")
        batch, slices = sample_group(
            self.store, [r["targets"] for r in requests],
            [int(r.get("seed", 0)) for r in requests], prog.fanouts)
        batch = pad_group(batch, self.pad_to)
        feeds = self._resolve_weights(weights, weights_ref)
        feeds[prog.feed_refs[0]] = self._tensor(batch.embeddings)
        for l, blk in enumerate(batch.layers):
            feeds[prog.feed_refs[1 + 2 * l]] = self._tensor(blk.nbr)
            feeds[prog.feed_refs[2 + 2 * l]] = self._tensor(blk.mask)
        out = {k: _to_numpy(v)
               for k, v in self.engine.run(prog.model, feeds, jit=jit).items()}
        return [{k: v[off: off + n] for k, v in out.items()}
                for off, n in slices]

    def stats(self):
        """Store / cache / device / engine counters (the `stats` RPC).  The
        RPC dispatcher injects its own rolling per-method stats under
        ``rpc``."""
        st = self.store.stats
        dev = self.store.dev.stats
        out = {
            "store": {"pages_h": st.pages_h,
                      "pages_l": st.pages_l,
                      "unit_updates": st.unit_updates,
                      "l_evictions": st.l_evictions,
                      "num_vertices": self.store.num_vertices,
                      "n_shards": 1,
                      "io_wait_us": 0.0},
            "device": {"read_pages": dev.read_pages,
                       "written_pages": dev.written_pages,
                       "read_bytes": dev.read_bytes,
                       "written_bytes": dev.written_bytes},
        }
        if self.store.cache is not None:
            out["embcache"] = self.store.cache.stats.snapshot()
        out["engine"] = self.engine_stats()
        return out

    def engine_stats(self) -> dict:
        """Engine counters: the bounded plan cache (``mesh`` stays None:
        the SPMD engine is not ported)."""
        return {"mesh": None, "jit_cache": self.engine.cache_stats()}

    def close(self) -> None:
        """Release resources; a no-op for a single-device store."""
        if hasattr(self.store, "close"):
            self.store.close()

    def plugin(self, shared_lib: str):
        """Paper Plugin(shared_lib): import a module exposing register(api)."""
        mod = importlib.import_module(shared_lib)
        mod.register(self.registry)
        return sorted(self.registry.devices)

    # --------------------------------------------------------------- XBuilder
    def program(self, device: str, priority: int, kernels: str):
        """Paper Program(bitfile): ``kernels`` names a module whose
        ``bitstream()`` returns {op_name: fn} — the partial bitfile."""
        mod = importlib.import_module(kernels)
        bs = Bitstream(device=device, priority=int(priority),
                       kernels=mod.bitstream())
        return self.xbuilder.program(bs)


def _to_numpy(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def make_service_dfg(model: str, num_layers: int, fanouts) -> DFG:
    """Service-style DFG whose first node is BatchPre (paper Fig. 10a)."""
    g = DFG()
    batch = g.create_in("Batch")
    seed = g.create_in("Seed")                # per-request sampling stream
    outs = g.create_op("BatchPre", [batch, seed], n_out=1 + 2 * num_layers,
                       attrs={"fanouts": list(fanouts)})
    h, rest = outs[0], outs[1:]
    model_dfg = gnn.BUILD_DFG[model](num_layers)
    # splice: rewire the model DFG's inputs onto BatchPre outputs
    remap = {"H": str(h)}
    for l in range(num_layers):
        remap[f"nbr{l}"] = str(rest[2 * l])
        remap[f"mask{l}"] = str(rest[2 * l + 1])
    base = len(g._nodes)
    for node in model_dfg._nodes:
        new_in = []
        for i in node.inputs:
            if i in remap:
                new_in.append(remap[i])
            elif "_" in i and i.split("_")[0].isdigit():
                s, slot = i.rsplit("_", 1)
                new_in.append(f"{int(s) + base}_{slot}")
            else:                                     # weight input
                if i not in g._ins:
                    g.create_in(i)
                new_in.append(i)
        outs2 = [f"{node.seq + base}_{o.rsplit('_', 1)[1]}" for o in node.outputs]
        g._nodes.append(type(node)(node.seq + base, node.op, new_in, outs2,
                                   dict(node.attrs)))
    for name, src in model_dfg._outs.items():
        s, slot = src.rsplit("_", 1)
        g.create_out(name, f"{int(s) + base}_{slot}")
    return g
