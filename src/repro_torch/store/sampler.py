"""Batch preprocessing — node sampling, reindexing, embedding lookup (paper §2.2).

Copy of ``repro/store/sampler.py`` for the PyTorch port, verbatim:
its relative imports resolve inside ``repro_torch``, which
keeps the reference's module layout.

Reproduces the paper's B-1..B-5 pipeline directly against GraphStore (no host
storage stack):

  [B-1] read neighbors of the batch targets and sample ``fanout`` of them,
        per hop, producing per-layer subgraphs;
  [B-2] allocate new (local) VIDs in sampled order and reindex the subgraphs;
  [B-3/4] gather the embeddings of all sampled nodes from the store;
  [B-5] emit device-ready padded arrays.

The subgraph layout is the *page-shaped* padded-neighbor block: a fixed-width
``(num_dst, fanout)`` neighbor-index matrix plus mask.  This mirrors
GraphStore's fixed-capacity page chunks and is exactly the ELL layout our
Pallas SpMM kernel consumes — the near-storage format IS the accelerator
format, which is the paper's end-to-end point.

Two implementations share the exact sampling semantics:

  * ``sample_batch``      — the vectorized fast path: one batched neighbor
    fetch per frontier (``get_neighbors_batch`` when the store provides it),
    NumPy scatter into the padded block, and a ``np.unique``/``searchsorted``
    first-seen reindex instead of the per-neighbor dict walk;
  * ``sample_batch_ref``  — the original per-vertex loop, kept as the oracle.

Each hop is an explicit plan -> fetch -> build pipeline: the store's fused
``sample_neighbors_batch`` plans the frontier from its in-DRAM mapping
tables, fetches every needed page (ONE queued scatter-read on a single
device; one PER SHARD, issued concurrently, on a ``ShardedGraphStore``
array) and Floyd-selects by index; ``_build_level`` then recomposes the
global frontier for the next hop.  The store keeps the fanout draws in
per-vertex frontier order, so single-device, sharded, and reference
samplers are bit-identical under the same seed.

With the same rng both produce bit-identical blocks/vids/embeddings (the
fast path draws the per-vertex fanout subsamples in the same order), which
the fast-path tests assert.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class LayerBlock:
    """One GNN layer's sampled bipartite block.

    ``nbr[i, k]`` indexes into the *next* level's node list (local ids);
    ``mask[i, k]`` is 1.0 for valid slots.  Row ``i`` aggregates into local
    node ``i`` of this level (levels are prefix-ordered, see sample_batch).
    """
    nbr: np.ndarray        # (num_dst, fanout) int32
    mask: np.ndarray       # (num_dst, fanout) float32
    num_dst: int


@dataclass
class SampledBatch:
    layers: list[LayerBlock]        # [layer_1 .. layer_L]: layer_L nearest targets
    node_vids: np.ndarray           # (num_nodes,) global VIDs, sampled order
    embeddings: np.ndarray | None   # (num_nodes, D) float32
    num_targets: int

    @property
    def num_nodes(self) -> int:
        return len(self.node_vids)


def _gather_neighbors(store, frontier: np.ndarray) -> list[np.ndarray]:
    """[B-1] one batched near-storage read per frontier when available."""
    if hasattr(store, "get_neighbors_batch"):
        return store.get_neighbors_batch(frontier)
    return [np.asarray(store.get_neighbors(int(v))) for v in frontier]


def _floyd_select(u: np.ndarray, m: int, k: int) -> np.ndarray:
    """Floyd's uniform sampling without replacement: k indices out of m
    using exactly k uniforms — O(k) regardless of the neighbor count, which
    matters for power-law hubs with tens of thousands of neighbors."""
    seen: set[int] = set()
    out = np.empty(k, dtype=np.int64)
    for j in range(k):
        t = int(u[j] * (m - k + j + 1))
        if t in seen:
            t = m - k + j
        seen.add(t)
        out[j] = t
    return out


def _subsample(rng: np.random.Generator, vid: int, neigh: np.ndarray,
               fanout: int) -> np.ndarray:
    """Fanout subsampling for one vertex (Floyd, uniform w/o replacement).

    Shared scheme with the vectorized fast path: each over-full row consumes
    exactly ``fanout`` uniforms, and ``rng.random`` fills from the bit
    stream sequentially, so per-row draws here match one batched draw there
    — both implementations produce the same sample from the same seed."""
    if len(neigh) == 0:
        return np.array([int(vid)], dtype=np.int32)     # degenerate self-loop
    if len(neigh) > fanout:
        u = rng.random(fanout)
        return neigh[_floyd_select(u, len(neigh), fanout)]
    return neigh


def _subsample_batch(rng: np.random.Generator, frontier: np.ndarray,
                     neigh: list[np.ndarray], fanout: int):
    """Vectorized fanout subsampling for a whole frontier.

    One ``rng.random`` call covers every over-full row (``fanout`` uniforms
    each — same stream as the reference's per-row draws), Floyd-selected
    per row in O(fanout).  Returns the selected neighbors flattened
    row-major plus per-row lengths.
    """
    counts = np.fromiter((len(nb) for nb in neigh), dtype=np.int64,
                         count=len(neigh))
    flat_all = np.concatenate(
        [nb if len(nb) else np.array([int(v)], dtype=np.int32)
         for v, nb in zip(frontier, neigh)])
    counts = np.maximum(counts, 1)                   # empty -> [self-loop]
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])

    over = counts > fanout
    lens = np.where(over, fanout, counts)
    out_offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    sel = np.empty(int(lens.sum()), dtype=flat_all.dtype)

    # under-full rows: copy through (their flat positions, row-major)
    row_of = np.repeat(np.arange(len(counts)), counts)
    keep = ~over[row_of]
    sel[np.repeat(out_offs[~over], lens[~over])
        + _ramp(lens[~over])] = flat_all[keep]

    if over.any():
        over_idx = np.nonzero(over)[0]
        over_lens = counts[over_idx]
        u = rng.random(len(over_idx) * fanout).reshape(-1, fanout)
        idx = np.concatenate(
            [_floyd_select(u[r], int(m), fanout)
             for r, m in enumerate(over_lens)])      # (n_over * fanout,)
        r_of = np.repeat(np.arange(len(over_idx)), fanout)
        src = starts[over_idx[r_of]] + idx
        sel[np.repeat(out_offs[over], fanout) + _ramp(
            np.full(len(over_idx), fanout, np.int64))] = flat_all[src]
    return sel, lens


def _ramp(lens: np.ndarray) -> np.ndarray:
    """[0..l0), [0..l1), ... concatenated (per-segment aranges)."""
    total = int(lens.sum())
    if not total:
        return np.empty(0, dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    return np.arange(total) - np.repeat(starts, lens)


def _build_level(frontier: np.ndarray, flat: np.ndarray, lens: np.ndarray,
                 fanout: int) -> tuple[LayerBlock, np.ndarray]:
    """[B-2/B-5] reindex one frontier's selected neighbors and scatter them
    into the page-shaped padded block.  (The serving batcher's fused
    multi-request sampler performs the same construction group-wide with a
    request-tagged reindex — ``repro.serve.batcher.sample_group``.)
    """
    flat = flat.astype(np.int64, copy=False)
    local, next_nodes = _reindex(frontier, flat)
    rows = np.repeat(np.arange(len(frontier)), lens)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    cols = np.arange(len(flat)) - np.repeat(offs, lens)
    nbr = np.zeros((len(frontier), fanout), dtype=np.int32)
    mask = np.zeros((len(frontier), fanout), dtype=np.float32)
    nbr[rows, cols] = local
    mask[rows, cols] = 1.0
    return (LayerBlock(nbr=nbr, mask=mask, num_dst=len(frontier)),
            next_nodes)


def _reindex(frontier: np.ndarray, flat: np.ndarray):
    """[B-2] vectorized first-seen reindex.

    ``frontier`` holds local ids 0..F-1; every other VID in ``flat`` gets a
    fresh id F, F+1, ... in order of first appearance — the paper's
    "allocate new VIDs in the order of sampled nodes" rule, computed with
    sorted-search instead of a per-neighbor dict probe.
    """
    fsize = len(frontier)
    order = np.argsort(frontier, kind="stable")
    sorted_front = frontier[order]
    # rightmost match: a duplicated frontier vid maps to its LAST index,
    # matching the reference's dict-overwrite semantics
    pos = np.clip(np.searchsorted(sorted_front, flat, side="right") - 1,
                  0, fsize - 1)
    in_front = sorted_front[pos] == flat
    local = np.empty(len(flat), dtype=np.int64)
    local[in_front] = order[pos[in_front]]
    new_flat = flat[~in_front]
    uniq, first = np.unique(new_flat, return_index=True)
    rank = np.empty(len(uniq), dtype=np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(len(uniq))
    local[~in_front] = fsize + rank[np.searchsorted(uniq, new_flat)]
    new_vids = np.empty(len(uniq), dtype=np.int64)
    new_vids[rank] = uniq
    return local, np.concatenate([frontier, new_vids])


def sample_batch(store, targets, fanouts, *, rng: np.random.Generator | None = None,
                 fetch_embeddings: bool = True, pad_to: int | None = None) -> SampledBatch:
    """Unique-neighbor sampling (GraphSAGE-style) with ``len(fanouts)`` hops.

    ``fanouts[0]`` is the fanout of the hop nearest the targets (GNN layer L).
    Level lists are prefix-ordered: level k+1's node list begins with level
    k's nodes, so destination *i* of a block is node *i* of the deeper list.

    Vectorized fast path: batched neighbor fetch + NumPy reindex/scatter;
    equivalent to ``sample_batch_ref`` under the same rng.
    """
    rng = rng or np.random.default_rng(0)
    targets = np.asarray(targets, dtype=np.int64)
    levels: list[np.ndarray] = [targets]
    blocks_rev: list[LayerBlock] = []

    for fanout in fanouts:
        frontier = levels[-1]
        if not len(frontier):
            blocks_rev.append(LayerBlock(
                nbr=np.zeros((0, fanout), dtype=np.int32),
                mask=np.zeros((0, fanout), dtype=np.float32), num_dst=0))
            levels.append(frontier)
            continue
        if hasattr(store, "sample_neighbors_batch"):
            # fused near-storage fetch+subsample (hubs sampled by index,
            # never materialised)
            flat, lens = store.sample_neighbors_batch(frontier, fanout, rng)
        else:
            neigh = _gather_neighbors(store, frontier)
            flat, lens = _subsample_batch(rng, frontier, neigh, fanout)
        block, next_nodes = _build_level(frontier, flat, lens, fanout)
        blocks_rev.append(block)
        levels.append(next_nodes)

    node_vids = levels[-1]
    emb = None
    if fetch_embeddings and store.feature_dim:
        emb = store.get_embeds(node_vids)                   # [B-3/4] gather

    batch = SampledBatch(layers=list(reversed(blocks_rev)), node_vids=node_vids,
                         embeddings=emb, num_targets=len(targets))
    if pad_to is not None:
        batch = pad_batch(batch, pad_to)
    return batch


def sample_batch_ref(store, targets, fanouts, *,
                     rng: np.random.Generator | None = None,
                     fetch_embeddings: bool = True,
                     pad_to: int | None = None) -> SampledBatch:
    """Reference sampler: the per-vertex/per-neighbor loop implementation.

    Kept as the equivalence oracle for ``sample_batch`` (same rng -> same
    batch) and as the "before" side of the fast-path benchmarks.
    """
    rng = rng or np.random.default_rng(0)
    targets = np.asarray(targets, dtype=np.int64)
    levels: list[np.ndarray] = [targets]
    blocks_rev: list[LayerBlock] = []

    for fanout in fanouts:
        frontier = levels[-1]
        vid_to_local: dict[int, int] = {int(v): i for i, v in enumerate(frontier)}
        next_nodes = list(frontier)
        nbr = np.zeros((len(frontier), fanout), dtype=np.int32)
        mask = np.zeros((len(frontier), fanout), dtype=np.float32)
        for i, v in enumerate(frontier):
            neigh = store.get_neighbors(int(v))            # [B-1] per-vid read
            neigh = _subsample(rng, int(v), np.asarray(neigh), fanout)
            for k, u in enumerate(neigh):
                u = int(u)
                loc = vid_to_local.get(u)
                if loc is None:                             # [B-2] reindex
                    loc = len(next_nodes)
                    vid_to_local[u] = loc
                    next_nodes.append(u)
                nbr[i, k] = loc
                mask[i, k] = 1.0
        blocks_rev.append(LayerBlock(nbr=nbr, mask=mask, num_dst=len(frontier)))
        levels.append(np.asarray(next_nodes, dtype=np.int64))

    node_vids = levels[-1]
    emb = None
    if fetch_embeddings and store.feature_dim:
        emb = np.stack([store.get_embed(int(v)) for v in node_vids]) \
            if hasattr(store, "get_embed") else store.get_embeds(node_vids)

    batch = SampledBatch(layers=list(reversed(blocks_rev)), node_vids=node_vids,
                         embeddings=emb, num_targets=len(targets))
    if pad_to is not None:
        batch = pad_batch(batch, pad_to)
    return batch


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pad_batch(batch: SampledBatch, multiple: int) -> SampledBatch:
    """Pad node count and per-block dst counts to a multiple (shape stability
    for jit: a handful of bucketed shapes instead of one per batch). [B-5]"""
    n_pad = _round_up(batch.num_nodes, multiple)
    layers = []
    for blk in batch.layers:
        d_pad = _round_up(blk.num_dst, multiple)
        nbr = np.zeros((d_pad, blk.nbr.shape[1]), dtype=np.int32)
        mask = np.zeros((d_pad, blk.nbr.shape[1]), dtype=np.float32)
        nbr[: blk.num_dst] = blk.nbr
        mask[: blk.num_dst] = blk.mask
        layers.append(LayerBlock(nbr=nbr, mask=mask, num_dst=blk.num_dst))
    emb = None
    if batch.embeddings is not None:
        emb = np.zeros((n_pad, batch.embeddings.shape[1]), dtype=np.float32)
        emb[: batch.num_nodes] = batch.embeddings
    vids = np.full(n_pad, -1, dtype=np.int64)
    vids[: batch.num_nodes] = batch.node_vids
    return SampledBatch(layers=layers, node_vids=vids, embeddings=emb,
                        num_targets=batch.num_targets)
