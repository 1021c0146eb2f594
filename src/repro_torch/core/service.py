"""HolisticGNN service facade — the CSSD-resident endpoint exposing the
paper's Table-1 RPCs (GraphStore bulk/unit ops, GraphRunner Run/Plugin,
XBuilder Program) over one object, suitable for RPCServer dispatch.

Counterpart of ``repro/core/service.py``, over one device, a sharded
array or a replicated array (the store modules are the reference's).
``run`` executes the near-storage inference pipeline: the DFG's
``BatchPre`` C-operation samples, reindexes and gathers embeddings
*against the page store*, moves the sampled block onto the service's
device, and the engine binds and executes the model's C-operations by
device priority.  Weights arrive as NumPy feed dicts (as over RPC) or as
tensors and are kept on the device; results come back as NumPy.

``mesh=`` / ``model_parallel=`` run the model portion on the SPMD
engine (``core/spmd.py``) over a (data, model) mesh of device slots
(``launch/mesh.py``), whose slots may share one card.
"""
from __future__ import annotations

import importlib

import numpy as np
import torch

from ..device import resolve_device
from ..launch.mesh import device_pool, make_host_mesh
from ..store.blockdev import BlockDevice
from ..store.graphstore import GraphStore
from ..store.sampler import sample_batch
from .dfg import DFG, Engine
from .registry import KernelRegistry
from .spmd import mesh_descriptor
from .xbuilder import XBuilder, Bitstream, SHELL_DEVICE
from . import gnn


class HolisticGNNService:
    """The device-resident service object: Table-1 RPC surface over one
    store (single device, sharded array, or replicated array) plus the
    DFG engine, kernel registry and XBuilder.  ``device`` is where
    sampled blocks, weights and compute live: ``None`` means ``"cuda"``
    and raises ``RuntimeError`` on a host without CUDA; the tests pass
    ``device="cpu"``."""

    def __init__(self, *, h_threshold: int = 128, pad_to: int = 64,
                 dev: BlockDevice | None = None,
                 cache_pages: int | None = None,
                 n_shards: int = 1, devs: list | None = None,
                 endpoints: list | None = None,
                 replication: int = 1,
                 stats_staleness_s: float = 0.0,
                 flow=None,
                 mesh=None, model_parallel: int | None = None,
                 jit_cache_size: int = 32,
                 device: str | torch.device | None = None):
        """``n_shards > 1`` (or an explicit ``devs`` device list) backs the
        service with a hash-partitioned CSSD array (``ShardedGraphStore``)
        instead of one device; every RPC below is shard-transparent, and
        sampling stays bit-identical to the single-device store.
        ``endpoints=[...]`` passes the array as pre-built
        ``ShardEndpoint`` objects instead (e.g. ``make_rop_endpoints(N)``
        for shards behind their own RoP links).

        ``replication=R >= 2`` upgrades the array to a
        ``ReplicatedGraphStore``: R-way replica placement with
        replica-spread reads (fed by a gossiped counter view refreshed at
        most every ``stats_staleness_s`` seconds), write fan-out, and the
        ``fail_shard`` / ``rebuild_shard`` RPCs.  ``flow`` (a
        ``store.sharded.FlowControl``) tunes the array's flow control.

        ``mesh`` (a ``launch.mesh.Mesh`` of device slots, each of the
        service device's type) switches the engine's planned path to
        SPMD execution: hidden/embedding dims striped across the mesh's
        ``model`` axis, super-batch rows across ``data``
        (``core/spmd.py``).  ``model_parallel=M`` is the convenience
        knob: it builds a host mesh over the service device's pool
        (``launch.mesh.device_pool``: the visible cards, or 8 CPU slots)
        with the model axis pinned to M (``make_host_mesh``).
        ``jit_cache_size`` bounds the engine's LRU plan cache."""
        self.device = resolve_device(device)
        if mesh is None and model_parallel is not None:
            mesh = make_host_mesh(model=int(model_parallel),
                                  devices=device_pool(self.device))
        if mesh is not None:
            kinds = sorted({d.type for d in mesh.devices.flat})
            if kinds != [self.device.type]:
                raise ValueError(f"mesh slots on {kinds} for a service on "
                                 f"{self.device.type!r}")
        if endpoints is not None or devs is not None or n_shards > 1 \
                or replication > 1:
            if dev is not None:
                raise ValueError("dev= is single-device only; pass the "
                                 "array as devs=[...] or endpoints=[...] "
                                 "instead")
            arr_n = None if (devs is not None or endpoints is not None) \
                else n_shards
            if replication > 1:
                from ..store.sharded import ReplicatedGraphStore
                self.store = ReplicatedGraphStore(
                    n_shards=arr_n, devs=devs, endpoints=endpoints,
                    replication=replication, h_threshold=h_threshold,
                    stats_staleness_s=stats_staleness_s, flow=flow)
            else:
                from ..store.sharded import ShardedGraphStore
                self.store = ShardedGraphStore(
                    n_shards=arr_n, devs=devs, endpoints=endpoints,
                    h_threshold=h_threshold, flow=flow)
        else:
            self.store = GraphStore(dev or BlockDevice(),
                                    h_threshold=h_threshold)
        if cache_pages:
            self.store.attach_cache_pages(cache_pages)
        self.registry = KernelRegistry()
        self.xbuilder = XBuilder(self.registry)
        for name, fn in gnn.extra_shell_kernels().items():
            self.registry.register_op(name, SHELL_DEVICE, fn)
        self._register_batchpre()
        self.engine = Engine(self.registry, mesh=mesh,
                             jit_cache_size=jit_cache_size)
        self.pad_to = pad_to
        self._programs: dict[str, object] = {}   # markup -> ServiceProgram
        self._weight_store: dict[str, dict] = {} # weights_ref -> feed dict
        self.qos_provider = None                 # set by ServingRuntime
        self.firehose = None                     # set by open_firehose

    def _tensor(self, v) -> torch.Tensor:
        """A feed or weight as a tensor on the service's device."""
        if isinstance(v, torch.Tensor):
            return v.to(self.device)
        return torch.tensor(np.asarray(v), device=self.device)

    # ------------------------------------------------------------- GraphStore
    def update_graph(self, edge_array, embeddings=None,
                     already_undirected=False, chunked=False,
                     chunk_edges=None, emb_chunk_rows=None):
        """Bulk UpdateGraph RPC.

        ``already_undirected=True`` skips the [G-2] mirror pass for
        pre-symmetrized datasets.  ``chunked=True`` routes a sharded
        array through the distributed device-side ingest
        (``update_graph_chunked``: raw chunk streaming + shard-local
        bucket/sort/pack, bit-identical result); single-device stores
        fall back to the monolithic path — there is no array to spread
        the preprocessing over."""
        edges = np.asarray(edge_array)
        emb = None if embeddings is None else np.asarray(embeddings)
        und = bool(already_undirected)
        if chunked and hasattr(self.store, "update_graph_chunked"):
            kw = {}
            if chunk_edges is not None:
                kw["chunk_edges"] = int(chunk_edges)
            if emb_chunk_rows is not None:
                kw["emb_chunk_rows"] = int(emb_chunk_rows)
            tl = self.store.update_graph_chunked(
                edges, emb, already_undirected=und, **kw)
        else:
            tl = self.store.update_graph(edges, emb, already_undirected=und)
        return {"total_s": tl.total, "user_visible_s": tl.user_visible}

    # Unit mutations route through the firehose while one is open (writes
    # become windowed device-side batches; a full log sheds typed
    # BackpressureError — the write-side admission control).
    def _mutator(self):
        return self.firehose if self.firehose is not None else self.store

    def add_vertex(self, vid, embed=None):
        """Unit AddVertex RPC: insert ``vid`` (optional embedding row)."""
        self._mutator().add_vertex(int(vid), embed)

    def delete_vertex(self, vid):
        """Unit DeleteVertex RPC: remove ``vid`` and every incident edge."""
        self._mutator().delete_vertex(int(vid))

    def add_edge(self, dst, src):
        """Unit AddEdge RPC: undirected edge insert (both directions)."""
        self._mutator().add_edge(int(dst), int(src))

    def delete_edge(self, dst, src):
        """Unit DeleteEdge RPC: undirected edge delete (both directions)."""
        self._mutator().delete_edge(int(dst), int(src))

    def update_embed(self, vid, embed):
        """Unit UpdateEmbed RPC: overwrite ``vid``'s embedding row."""
        self._mutator().update_embed(int(vid), np.asarray(embed))

    # -------------------------------------------------------------- firehose
    def open_firehose(self, window_s=0.05, max_window_ops=4096,
                      max_log_ops=65536):
        """Open a mutation firehose: from now on the unit-mutation RPCs
        accumulate in a windowed log and each window applies as ONE
        device-side command per shard (store/ingest.py).  Reads keep
        flowing between windows, bit-identical to serial application."""
        from ..store.ingest import MutationFirehose
        if self.firehose is not None:
            raise RuntimeError("firehose already open")
        self.firehose = MutationFirehose(
            self.store, window_s=float(window_s),
            max_window_ops=int(max_window_ops),
            max_log_ops=int(max_log_ops)).start()
        return self.firehose.snapshot()

    def flush_firehose(self):
        """Explicitly apply everything logged (window boundary on demand)."""
        if self.firehose is None:
            raise RuntimeError("no firehose open")
        applied = self.firehose.flush()
        return {"applied_now": applied, **self.firehose.snapshot()}

    def close_firehose(self):
        """Drain the log, stop the window timer, return final counters;
        unit mutations apply immediately again afterwards."""
        if self.firehose is None:
            raise RuntimeError("no firehose open")
        fh, self.firehose = self.firehose, None
        return fh.close()

    def get_embed(self, vid):
        """Point read of one vertex embedding (test/admin RPC — serving
        reads go through the batched sampler plan/fetch path)."""
        return self.store.get_embed(int(vid))

    def get_neighbors(self, vid):
        """Point read of one vertex's sorted neighbor list."""
        return self.store.get_neighbors(int(vid))

    # ---------------------------------------------------------- fault admin
    def _replicated(self):
        if not hasattr(self.store, "fail_shard"):
            raise RuntimeError("shard fault RPCs need a replicated array "
                               "(construct with replication >= 2)")
        return self.store

    def fail_shard(self, shard):
        """Fault-injection / drain RPC: drop one device out of the array.
        Serving continues from the surviving replicas, bit-identically."""
        return self._replicated().fail_shard(int(shard))

    def rebuild_shard(self, shard, pacing_s=None):
        """Re-materialise a failed shard from its surviving replicas,
        restoring R-way redundancy.  ``pacing_s`` sleeps that long between
        peer-link chunk pulls so the rebuild yields device bandwidth to
        concurrent serving reads."""
        return self._replicated().rebuild_shard(
            int(shard), pacing_s=pacing_s)

    def probe_shards(self):
        """Zero-traffic health probe: one ``counters`` round over every
        shard endpoint (including failed ones — errors are reported, not
        raised).  The autonomic supervisor polls this."""
        if not hasattr(self.store, "probe_shards"):
            raise RuntimeError("probe_shards needs a sharded array")
        return self.store.probe_shards()

    # ------------------------------------------------------- elastic reshard
    def reshard(self, add=None, remove=None, rebalance=False,
                refine=4, chunk_pages=None, pace_s=None):
        """Elastic online reshard RPC (see ``ShardedGraphStore.reshard``).

        Exactly one mode per call:

        * ``add=k`` (int) — grow the array by ``k`` shards.  The service
          builds the new endpoints itself, matched to the array's
          transport: in-process arrays get ``LocalShardEndpoint``s,
          RoP-linked arrays get fresh ``ShardHost`` + ``RopShardEndpoint``
          pairs; each new device clones shard 0's performance profile.
          ``add=[...]`` passes pre-built ``ShardEndpoint``s instead.
        * ``remove=[ids]`` — shrink: migrate those shards' classes to the
          survivors, detach and close them.
        * ``rebalance=True`` — keep N, refine the placement map by
          ``refine`` and move the hottest classes off the most-loaded
          shards (heat = the gossiped read counters).

        ``chunk_pages`` bounds each peer-link migration pull;
        ``pace_s`` sleeps that long between pulls so migration yields
        device bandwidth to serving reads (supervisor-style pacing).
        Serving stays up throughout: reads route to the old owner until
        each class atomically flips, writes gate only during their own
        class's copy window.

        Returns the migration report (classes/copies/bytes/epochs —
        see the store docstring).  Raises ``RuntimeError`` on a
        single-device store and whatever the store raises (mode errors,
        reshard/rebuild already in progress, failed shards present).
        """
        store = self.store
        if not hasattr(store, "reshard"):
            raise RuntimeError("reshard needs a sharded array "
                               "(construct with n_shards > 1)")
        kw = {"rebalance": bool(rebalance), "refine": int(refine)}
        if chunk_pages is not None:
            kw["chunk_pages"] = int(chunk_pages)
        if pace_s is not None:
            kw["pace_s"] = float(pace_s)
        if remove is not None:
            kw["remove"] = [int(s) for s in remove]
        if isinstance(add, (int, np.integer)):
            kw["add"] = self._build_endpoints(int(add))
        elif add is not None:
            kw["add"] = list(add)
        return store.reshard(**kw)

    def _build_endpoints(self, k: int) -> list:
        """``k`` fresh shard endpoints matching the array's transport,
        devices cloned from shard 0's performance profile."""
        from ..store.endpoint import (LocalShardEndpoint, RopShardEndpoint,
                                      ShardHost, clone_dev_profile)
        store = self.store
        template = store.endpoints[0]
        ht = store.h_threshold
        d = store.feature_dim
        eps = []
        for _ in range(k):
            dev = None
            old_dev = getattr(getattr(template, "service", None), "store",
                              None)
            old_dev = getattr(old_dev, "dev", None)
            if old_dev is None:
                old_dev = getattr(getattr(getattr(template, "host", None),
                                          "service", None), "store", None)
                old_dev = getattr(old_dev, "dev", None)
            if old_dev is not None:
                dev = clone_dev_profile(old_dev)
            if isinstance(template, RopShardEndpoint):
                host = ShardHost(dev, h_threshold=ht, feature_dim=d)
                eps.append(RopShardEndpoint(host))
            else:
                eps.append(LocalShardEndpoint(dev=dev, h_threshold=ht,
                                              feature_dim=d))
        return eps

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

    @staticmethod
    def _device_counters(dev_stats) -> dict:
        return {"read_pages": dev_stats.read_pages,
                "written_pages": dev_stats.written_pages,
                "read_bytes": dev_stats.read_bytes,
                "written_bytes": dev_stats.written_bytes}

    def stats(self):
        """QoS / store / cache / device counters (the `stats` RPC).

        The RPC dispatcher injects its own rolling per-method stats under
        ``rpc``; the serving runtime contributes scheduler + transport QoS
        under ``qos`` via ``qos_provider``.  Against a sharded store every
        per-shard figure comes from ONE endpoint ``stats`` snapshot per
        shard — never from poking shard internals — so the report is
        byte-for-byte the same shape whether the shards are in-process
        (``LocalShardEndpoint``) or behind their own RoP links
        (``RopShardEndpoint``); each shard entry also carries the
        endpoint's device-side per-method RPC stats under ``rpc``.  The
        ``device``/``embcache`` sections aggregate the array and
        ``shards`` breaks out per-shard cache hit rates and page
        counters, so operators (and fig23/fig24/fig25) can read shard
        balance without reaching into the array.  Against a replicated
        array the write-side aggregates (``written_pages``,
        ``unit_updates``) count per-replica applications — a logical
        mutation really does cost R device writes — so compare them
        across replication factors accordingly.
        """
        dev_keys = ("read_pages", "written_pages",
                    "read_bytes", "written_bytes")
        if hasattr(self.store, "shard_stats"):
            snaps = self.store.shard_stats()
            out = {
                "store": {
                    "pages_h": sum(s["store"]["pages_h"] for s in snaps),
                    "pages_l": sum(s["store"]["pages_l"] for s in snaps),
                    "unit_updates": sum(s["store"]["unit_updates"]
                                        for s in snaps),
                    "l_evictions": sum(s["store"]["l_evictions"]
                                       for s in snaps),
                    "num_vertices": self.store.num_vertices,
                    "n_shards": len(snaps),
                    "io_wait_us": self.store.io_wait_us},
                "device": {k: sum(s["device"][k] for s in snaps)
                           for k in dev_keys},
                "shards": [
                    {"device": s["device"],
                     "pages_l": s["store"]["pages_l"],
                     "pages_h": s["store"]["pages_h"],
                     "failed": s["failed"],
                     "embcache": s["cache"],
                     "rpc": s.get("rpc")}
                    for s in snaps],
            }
            if any(s["cache"] is not None for s in snaps):
                from ..store.sharded import aggregate_cache_snapshots
                out["embcache"] = aggregate_cache_snapshots(
                    s["cache"] for s in snaps)
        else:
            st = self.store.stats
            out = {
                "store": {"pages_h": st.pages_h,
                          "pages_l": st.pages_l,
                          "unit_updates": st.unit_updates,
                          "l_evictions": st.l_evictions,
                          "num_vertices": self.store.num_vertices,
                          "n_shards": 1,
                          "io_wait_us": 0.0},
                "device": self._device_counters(self.store.dev.stats),
            }
            if self.store.cache is not None:
                out["embcache"] = self.store.cache.stats.snapshot()
        repl = getattr(self.store, "replication", None)
        if repl is not None:
            out["replication"] = {
                "r": repl,
                "failed_shards": [i for i, f in
                                  enumerate(self.store.failed_shards) if f]}
        if hasattr(self.store, "placement_stats"):
            out["placement"] = self.store.placement_stats()
        sup = getattr(self.store, "health", None)
        if sup is not None:
            out["health"] = sup.snapshot()
        if hasattr(self.store, "backpressure_events"):
            out["flow"] = {
                "backpressure_events": self.store.backpressure_events,
                "backpressure_retries": self.store.backpressure_retries,
                "max_inflight_per_shard":
                    self.store.flow.max_inflight_per_shard,
                "submit_retries": self.store.flow.submit_retries}
        if self.firehose is not None:
            out["firehose"] = self.firehose.snapshot()
        out["engine"] = self.engine_stats()
        if self.qos_provider is not None:
            out["qos"] = self.qos_provider()
        return out

    def engine_stats(self) -> dict:
        """Engine execution-plane counters: mesh placement (None when the
        compute plane is unsharded) + the bounded plan cache."""
        mesh = self.engine.mesh
        desc = None if mesh is None else dict(mesh_descriptor(mesh))
        return {"mesh": desc, "jit_cache": self.engine.cache_stats()}

    def close(self) -> None:
        """Release array resources (remote shard hosts stop their poll
        threads); a no-op for single-device services."""
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
