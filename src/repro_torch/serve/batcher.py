"""Continuous-batching composition layer — fuse concurrent Run(DFG, batch)
requests against the same service DFG into ONE near-storage sampling pass
and ONE cached-jit engine execution, bit-identically to serial runs.

Pieces:

  * ``split_service_dfg`` — a service DFG (paper Fig. 10a: leading BatchPre)
    is split into its sampling spec (fanouts) and a model-only DFG whose
    inputs are the BatchPre output refs, so the scheduler can feed a fused
    super-batch straight into the model portion;
  * ``sample_group`` — the fused multi-request sampler: per hop, every
    request's frontier joins one concatenated near-storage
    ``sample_neighbors_batch`` call (a single queued scatter-read serves the
    whole group — one PER SHARD, fanned out concurrently, when the store is
    a ``ShardedGraphStore`` array) with *per-request rng segments*, so each
    request's sample is bit-identical to a solo run; reindexing stays
    request-local (no cross-request dedup — that would change sampling
    semantics);
  * prefix-preserving composition — per-request blocks are merged into one
    block-diagonal super-batch whose level lists keep the engine's
    prefix-ordering invariant (level k is a prefix of level k+1), so
    Prefix-consuming models (GIN, NGCF) stay correct;
  * ``pad_group`` — geometric shape bucketing (base * 2^k per tensor) so
    varying group sizes map to a bounded set of jit signatures.

Why fused == serial, bitwise: every model op computes each destination row
independently (SpMM/GEMM/activations are row-local), the port's kernels and
plain versions sum in an order and with a launch shape that do not depend on
the number of rows (``kernels/ref.py``, ``kernels/csrc``), and masked
padding slots contribute exact zeros.  ``tests/test_torch_service.py``
asserts bit-equality.

Counterpart of ``repro/serve/batcher.py`` (its composition layer only: the
scheduler, runtime and supervisor are later work).  The sampling code is
the reference's, verbatim; ``fingerprint_weights`` also hashes tensors.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from ..core.dfg import DFG
from ..rpc.queues import BackpressureError
from ..store.sampler import (LayerBlock, SampledBatch, _gather_neighbors,
                             _reindex, _subsample_batch)

# request tag multiplier for the group-wide reindex: vids from different
# requests must never dedup against each other (that would change sampling
# semantics), so each request's vids are lifted into a disjoint range
_REQ_TAG = 1 << 42

BATCHPRE_OP = "BatchPre"


@dataclass
class ServiceProgram:
    """A service DFG split around its leading BatchPre node."""
    model: DFG               # BatchPre stripped; its outputs became inputs
    fanouts: list[int]
    feed_refs: list[str]     # BatchPre output refs: [H, nbr0, mask0, ...]


def split_service_dfg(dfg: DFG) -> ServiceProgram | None:
    """Split a service-style DFG; None when there is no BatchPre prefix."""
    bp = next((n for n in dfg._nodes if n.op == BATCHPRE_OP), None)
    if bp is None or "Batch" not in dfg._ins:
        return None
    model = DFG()
    consumed = set(bp.inputs)                 # Batch (+ Seed on newer DFGs)
    model._ins = [i for i in dfg._ins if i not in consumed] + list(bp.outputs)
    model._nodes = [n for n in dfg._nodes if n.seq != bp.seq]
    model._outs = dict(dfg._outs)
    return ServiceProgram(model=model, fanouts=list(bp.attrs["fanouts"]),
                          feed_refs=list(bp.outputs))


def fingerprint_weights(weights: dict | None) -> str:
    """Content hash of a feed dict — the coalescing compatibility key."""
    h = hashlib.sha1()
    for k in sorted(weights or {}):
        v = weights[k]
        arr = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
               else np.asarray(v))
        h.update(k.encode())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def _bucket(n: int, base: int) -> int:
    """Round up to a half-octave bucket (base * 2^k or base * 3 * 2^(k-1)):
    bounded signature count across group sizes, <= 33% padding waste."""
    b = max(base, 1)
    while True:
        if n <= b:
            return b
        if n <= b + b // 2:
            return b + b // 2
        b *= 2


def sample_group(store, targets_list, seeds, fanouts,
                 *, fetch_embeddings: bool = True
                 ) -> tuple[SampledBatch, list[tuple[int, int]]]:
    """Fused multi-request sampling + prefix-preserving composition.

    One near-storage ``sample_neighbors_batch`` per hop serves every
    request's frontier (per-request rng segments keep each sample
    bit-identical to a solo run), and ONE group-wide reindex per hop builds
    the composed block directly — no per-request Python.  The global
    reindex is exact because each request's vids are lifted into a disjoint
    tagged range (no cross-request dedup) and the flattened selection is
    request-major, so global first-seen order equals per-request first-seen
    order with per-request rank bases.

    The composed level lists keep the engine's prefix-ordering invariant:
    composed level k+1 = [composed level k, then each request's new nodes],
    tracked by ``comp_of`` — the composed index of each concat-order node.

    Returns ``(batch, slices)``: the composed super-batch and, per request,
    the ``(row_offset, n_targets)`` slice of the output's leading axis that
    carries that request's rows.
    """
    n_req = len(targets_list)
    rngs = [np.random.default_rng(s) for s in seeds]
    fronts = [np.asarray(t, dtype=np.int64).reshape(-1)
              for t in targets_list]
    seg = np.array([len(f) for f in fronts], dtype=np.int64)
    off0 = np.concatenate([[0], np.cumsum(seg)]).astype(np.int64)
    slices = [(int(off0[r]), int(seg[r])) for r in range(n_req)]
    # composed index of concat-order node p (level 0 is request-grouped)
    comp_of = np.arange(int(seg.sum()), dtype=np.int64)
    comp_rev: list[LayerBlock] = []

    for fanout in fanouts:
        concat = (np.concatenate(fronts) if seg.sum()
                  else np.empty(0, np.int64))
        total_k = len(concat)
        if not total_k:                        # every request is empty
            comp_rev.append(LayerBlock(
                nbr=np.zeros((0, fanout), np.int32),
                mask=np.zeros((0, fanout), np.float32), num_dst=0))
            continue
        segs = seg.tolist()
        if hasattr(store, "sample_neighbors_batch"):
            try:
                sel, lens = store.sample_neighbors_batch(
                    concat, fanout, segments=segs, rngs=rngs)
            except BackpressureError as e:
                # a shed fused fetch names the group it refused
                e.reason.setdefault("stage", "sample")
                e.reason.setdefault("group_requests", n_req)
                raise
        else:                              # host-side store: per-request path
            sel_parts, len_parts = [], []
            for r in range(n_req):
                if not segs[r]:
                    continue
                neigh = _gather_neighbors(store, fronts[r])
                s, l = _subsample_batch(rngs[r], fronts[r], neigh, fanout)
                sel_parts.append(s)
                len_parts.append(l)
            sel = np.concatenate(sel_parts)
            lens = np.concatenate(len_parts).astype(np.int64)

        # ---- group-wide reindex over request-tagged vids
        req_of_row = np.repeat(np.arange(n_req), seg)
        row_of_flat = np.repeat(np.arange(total_k), lens)
        tag_front = concat + req_of_row * _REQ_TAG
        tag_sel = sel.astype(np.int64) + req_of_row[row_of_flat] * _REQ_TAG
        local, next_tagged = _reindex(tag_front, tag_sel)
        new_tagged = next_tagged[total_k:]
        new_counts = np.bincount(new_tagged // _REQ_TAG, minlength=n_req)
        new_off = np.concatenate([[0], np.cumsum(new_counts)]).astype(np.int64)

        # composed nbr values: frontier locals map through comp_of, new
        # nodes append after every level-k node in request-rank order
        remap = np.concatenate([comp_of,
                                total_k + np.arange(len(new_tagged))])
        nbr = np.zeros((total_k, fanout), np.int32)
        mask = np.zeros((total_k, fanout), np.float32)
        rows = comp_of[row_of_flat]
        offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
        cols = np.arange(len(sel)) - np.repeat(offs, lens)
        nbr[rows, cols] = remap[local]
        mask[rows, cols] = 1.0
        comp_rev.append(LayerBlock(nbr=nbr, mask=mask, num_dst=total_k))

        # ---- next level: per-request lists grow by their new nodes
        new_vids = new_tagged % _REQ_TAG
        fronts = [np.concatenate([fronts[r],
                                  new_vids[new_off[r]: new_off[r + 1]]])
                  for r in range(n_req)]
        old_off = np.concatenate([[0], np.cumsum(seg)])
        comp_of = np.concatenate(
            [np.concatenate([comp_of[old_off[r]: old_off[r + 1]],
                             total_k + np.arange(new_off[r], new_off[r + 1])])
             for r in range(n_req)])
        seg = seg + new_counts

    total_nodes = int(seg.sum())
    vids = np.empty(total_nodes, np.int64)
    if total_nodes:
        vids[comp_of] = np.concatenate(fronts)
    emb = None
    if fetch_embeddings and getattr(store, "feature_dim", 0):
        try:
            emb = store.get_embeds(vids)       # ONE coalesced (cached) gather
        except BackpressureError as e:
            e.reason.setdefault("stage", "fetch_embeds")
            e.reason.setdefault("group_requests", n_req)
            raise
    batch = SampledBatch(layers=list(reversed(comp_rev)), node_vids=vids,
                         embeddings=emb,
                         num_targets=int(off0[-1]))
    return batch, slices


def pad_group(batch: SampledBatch, base: int) -> SampledBatch:
    """Bucket-pad a composed super-batch: each tensor's leading dim rounds
    up to a half-octave bucket, so the jit signature set stays bounded
    while the padding overhead stays proportional at any group size."""
    n_pad = _bucket(max(batch.num_nodes, 1), base)
    layers = []
    for blk in batch.layers:
        d_pad = _bucket(max(blk.num_dst, 1), base)
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
