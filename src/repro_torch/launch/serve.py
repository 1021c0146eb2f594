"""Paged-KV serving engine: continuous batching over a page-pooled KV cache
(the paper's GraphStore paging as the serving memory manager), on the
card.

Counterpart of ``repro/launch/serve.py``.  Requests arrive with prompts;
the scheduler prefills new sequences and steps the running batch, KV
pages are chained per sequence by ``PagedKVManager``, and attention
reads through the page table.  On CUDA tensors every norm and attention
call launches its kernel: rmsnorm in each layer and before the logits,
flash_attention at prefill, decode_attention at every decode step.
There is no switch to the plain versions; they run only where the
engine's device is the CPU.  The projections are plain products
(``torch.einsum``, fp32 without TF32), as the reference leaves them to
XLA.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \\
      --requests 8 [--full] [--device cpu]

:class:`MeshServe` is the dense-cache step (``ModelAPI.prefill`` /
``decode``) on a ``launch/mesh.py`` mesh, the counterpart of the
reference's ``prefill_step`` / ``serve_step`` jitted with shardings
(``repro/launch/dryrun.py``).  ``PagedLM`` never runs on a mesh, in
the reference as here.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..configs import ARCHS, SMOKES
from ..device import resolve_device
from ..kernels import ops as K
from ..models import build, layers as L
from ..store.pagedkv import PagePool, PagedKVManager, Sequence
from ..train import sharded as S


class PagedLM:
    """Decoder LM over paged KV (attention-only archs).  The layer loop is
    unrolled (serving-scale depth); projections use the model params,
    which must lie on the pool's device."""

    def __init__(self, cfg, params, pool: PagePool):
        if not all(k in ("attn", "local") for k in cfg.period_pattern):
            raise ValueError("paged serving supports attention archs, got "
                             f"{cfg.period_pattern}")
        self.cfg, self.params, self.pool = cfg, params, pool
        self.mgr = PagedKVManager(pool)
        self.device = pool.k.device
        self.layers = [self._layer_params(i) for i in range(cfg.num_layers)]

    # --------------------------------------------------------- layer params
    def _layer_params(self, idx: int):
        """(params, kind) of layer ``idx``: views into the stacked tree."""
        period = len(self.cfg.period_pattern)
        if idx < self.cfg.n_periods * period:
            pos, per = idx % period, idx // period
            return L.take_layer(self.params["stack"][pos], per), \
                self.cfg.period_pattern[pos]
        pos = idx - self.cfg.n_periods * period
        return self.params["rem"][pos], self.cfg.remainder_kinds[pos]

    def _qkv(self, pm, x, cos, sin):
        xn = L.rms_norm(x, pm["ln"], self.cfg.norm_eps)
        q = L.einsum("btd,dhk->bthk", xn, pm["wq"])
        k = L.einsum("btd,dhk->bthk", xn, pm["wk"])
        v = L.einsum("btd,dhk->bthk", xn, pm["wv"])
        return L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin), v

    # -------------------------------------------------------------- prefill
    def prefill_logits(self, seq: Sequence) -> torch.Tensor:
        """Run the prompt, write its KV, return the last position's
        logits (V,)."""
        cfg, dev = self.cfg, self.device
        toks = torch.tensor([seq.tokens], dtype=torch.long, device=dev)
        x = L.embed_apply(self.params["embed"], toks, cfg)
        t = toks.shape[1]
        cos, sin = L.rope_tables(torch.arange(t, device=dev),
                                 cfg.resolved_head_dim, cfg.rope_theta)
        for li, (p, kind) in enumerate(self.layers):
            pm = p["mixer"]
            q, k, v = self._qkv(pm, x, cos, sin)
            self.mgr.write_kv(seq, li, k[0], v[0], 0)
            b, _, h, hd = q.shape
            g = h // cfg.num_kv_heads
            out = L._sdpa(q.reshape(b, t, cfg.num_kv_heads, g, hd), k, v,
                          causal=True,
                          window=cfg.window_size if kind == "local" else 0)
            x = x + L.einsum("bthk,hkd->btd", out.reshape(b, t, h, hd),
                             pm["wo"])
            if "ffn" in p:
                x = L.mlp_apply(p["ffn"], x, cfg)
        seq.length = t
        return L.logits_apply(self.params["embed"], x[:, -1:], cfg)[0, -1]

    def prefill(self, seq: Sequence) -> int:
        return int(torch.argmax(self.prefill_logits(seq)))

    # --------------------------------------------------------------- decode
    def decode_logits(self, seqs: list[Sequence]) -> torch.Tensor:
        """One token for each sequence: write its KV, return logits (B,V)."""
        cfg, dev = self.cfg, self.device
        b = len(seqs)
        toks = torch.tensor([[s.tokens[-1] if not s.generated
                              else s.generated[-1]] for s in seqs],
                            dtype=torch.long, device=dev)
        lengths = np.asarray([s.length for s in seqs], np.int32)
        for s in seqs:                        # grow page chains (H-type)
            self.mgr.ensure_capacity(s, s.length + 1)
        max_pages = max(len(s.pages) for s in seqs)
        pt = torch.from_numpy(self.mgr.page_table(seqs, max_pages)).to(dev)
        visible = torch.from_numpy(lengths + 1).to(dev)
        slots = self.mgr.slots(seqs, lengths.tolist(), [1] * b)

        x = L.embed_apply(self.params["embed"], toks, cfg)
        cos, sin = L.rope_tables(torch.from_numpy(lengths).to(dev)[:, None],
                                 cfg.resolved_head_dim, cfg.rope_theta)
        for li, (p, _) in enumerate(self.layers):
            pm = p["mixer"]
            q, k, v = self._qkv(pm, x, cos, sin)
            self.mgr.write_slots(li, slots, k[:, 0], v[:, 0])
            out = K.decode_attention(q[:, 0], self.pool.k[li],
                                     self.pool.v[li], pt, visible)
            x = x + L.einsum("bhk,hkd->bd", out, pm["wo"])[:, None]
            if "ffn" in p:
                x = L.mlp_apply(p["ffn"], x, cfg)
        for s in seqs:
            s.length += 1
        return L.logits_apply(self.params["embed"], x, cfg)[:, 0]

    def decode_step(self, seqs: list[Sequence]) -> list[int]:
        return torch.argmax(self.decode_logits(seqs), dim=-1).tolist()


@dataclass(frozen=True)
class Geometry:
    """A cache leaf's batch dim (``lead``) and whether it is a KV cache
    laid out by positions and heads (``kv``: ``k``/``v``, MLA's
    compressed ``ckv``/``krope``) or a recurrent mixer's state (Mamba's,
    mLSTM's, sLSTM's)."""
    lead: int
    kv: bool


def cache_geometry(api) -> object:
    """A tree of each cache leaf's :class:`Geometry`, its batch dim the
    one its normal-mode spec gives the data axes (the ``DP`` entry;
    ``cache_defs``' shapes are the same in long mode, whose specs
    replicate the batch), never guessed from its rank."""
    def keys(tree, key=None):
        if isinstance(tree, dict):
            return {k: keys(v, k) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(keys(t, key) for t in tree)
        return key

    defs = api.cache_defs(1, 1)
    return L.tree_map(lambda d, key: Geometry(
        list(d.pspec).index(L.DP), key in ("k", "v", "ckv", "krope")),
        defs, keys(defs))


def cache_spans(layout: S.Layout, shape, coords, i: int, *, lead: int,
                heads: bool = True):
    """(blocks' spans, (S, KVH)) of a KV cache leaf of ``shape`` whose
    batch dim is ``lead`` (:func:`cache_geometry`), its positions and KV
    heads the two dims after it ((..., B, S, KVH, hd), or with ``heads``
    false MLA's compressed (..., B, S, r)), laid out by ``layout``, as
    data row ``i`` (its first slot's flat index) sees it: each slot's
    ((p0, p1), (h0, h1)) where its block holds the rows of slot ``i``'s
    block, else None; a compressed cache has one "head", (0, 1) of 1."""
    mine = layout.block_slices(shape, coords[i])[lead]
    spans = []
    for c in coords:
        sl = layout.block_slices(shape, c)
        hs = (sl[lead + 2].start, sl[lead + 2].stop) if heads else (0, 1)
        spans.append(((sl[lead + 1].start, sl[lead + 1].stop), hs)
                     if sl[lead] == mine else None)
    return tuple(spans), (shape[lead + 1], shape[lead + 2] if heads else 1)


def row_holders(layout: S.Layout, shape, coords, i: int, lead: int) -> list:
    """(slot, slices of the whole) for each slot whose block of a cache
    leaf of ``shape`` (batch dim ``lead``) holds data row ``i``'s rows of
    the batch (slot ``i``'s), in slot order."""
    mine = layout.block_slices(shape, coords[i])[lead]
    return [(j, sl) for j, sl in ((j, layout.block_slices(shape, c))
                                  for j, c in enumerate(coords))
            if sl[lead] == mine]


def state_replicas(layout: S.Layout, shape, coords, slots) -> tuple:
    """For each model slot m of a data row (``slots``, flat indices), the
    slots outside the row whose block of a recurrent state leaf of
    ``shape`` laid out by ``layout`` is the same as slot m's and whose
    model coordinate is m (in long mode, the other data rows' slot m:
    the state's batch is replicated over them), in slot order."""
    names = layout.mesh.axis_names
    ax = names.index("model") if "model" in names else None
    keys = [S._key(layout.block_slices(shape, c)) for c in coords]
    return tuple(tuple(j for j, c in enumerate(coords)
                       if j not in slots and keys[j] == keys[s]
                       and (ax is None or c[ax] == m))
                 for m, s in enumerate(slots))


def _within_row(sl: tuple, lead: int) -> tuple:
    """A block's slices of the whole, as an index of the row's part (its
    batch rows, every other dim whole)."""
    return sl[:lead] + (slice(None),) + sl[lead + 1:]


class MeshServe:
    """The meshed serving step: ``api``'s prefill and decode on ``mesh``,
    the parameters laid out by ``param_pspecs``, the caches by
    ``cache_pspecs(..., long_mode=)``, the inputs by the input specs
    (batch over the data axes; replicated in long mode) and the logits
    returned at the reference's ``logits_spec`` (B, 1, V): batch over the
    data axes, vocabulary over ``"model"`` where the model degree divides
    it, else replicated over ``"model"``.

    * Split (``split``), where ``api.model_split()`` (every
      architecture) and the model axis is wider than one: each data
      row's model slots run the step as the
      reference's GSPMD step does, each on its own heads, MLP columns or
      experts, Mamba channels or rows of mLSTM's C, and vocabulary block
      (or ``d_model`` columns of the embedding and logits) and its own
      block of every KV cache and Mamba state (``models/layers.py``'s,
      ``mamba.py``'s and ``xlstm.py``'s split forms); a state the spec
      replicates over ``"model"`` (mLSTM's, sLSTM's) is written whole,
      the same bytes, on every model slot's replica; the logits
      stay on the slots, a vocabulary block each, never gathered, or,
      row-parallel, summed on the row's first slot and sent whole to its
      other model slots.  An encoder-decoder's prefill sends the
      encoder's output to each model slot once (its slots' replicas,
      where the cross-attention's ``wk``/``wv`` split, are the copies it
      returns), and its decode reads each model slot's own copy of the
      ``enc_out`` input, so a decode step moves no byte of it.  No slot
      holds the whole parameters or a whole cache.  An MLA decode in
      long mode raises ``NotImplementedError``.
    * Gathered, on a model axis of one: the
      whole parameters and the row's part of each cache (its rows of the
      batch: the batch dim from the cache's spec, :func:`cache_geometry`)
      gathered onto the row's first slot, the step run there, the caches
      written back into every block that holds them, replicas too.

    In normal mode each data row runs its own rows of the batch.  In
    long mode (``long_mode``, decode at batch 1) the batch is replicated
    over the data rows, and the first row runs it: the sequence's blocks
    of a global cache lie on every row's slots, which run their partials
    for it, and a ring replicated over the data rows is written on every
    row's replica (so the replicas stay equal, as the reference's GSPMD
    keeps them) and read on the first row's, as is each block of a
    recurrent state (whose batch is replicated over the data rows); the
    other rows' logits blocks are sent from the first row's.

    Decoding, the host reads each sequence's write offset from the
    ``lengths`` input once a step (:meth:`row_offsets`), the one source
    of the offsets that the attention reads on the device: the new k/v
    rows go only to the slots that hold their positions.  Every move
    between slots goes through :meth:`send`, every slot's work through
    the row's ``run``."""

    def __init__(self, api, mesh, *, dp_axes=("data",),
                 long_mode: bool = False):
        self.api, self.mesh = api, mesh
        self.dp_axes = tuple(dp_axes)
        self.long_mode = long_mode
        self.active = () if long_mode else self.dp_axes
        self.coords = list(np.ndindex(*mesh.devices.shape))
        self.tp = tp = int(mesh.shape.get("model", 1))
        self.split = tp > 1 and api.model_split()
        # MLA's caches are compressed, (B, S, r): no heads dim
        self.heads = api.cfg.mla is None
        self.geometry = cache_geometry(api)
        vocab_ok = api.cfg.vocab_size % tp == 0
        with L.use_mesh(mesh, self.active):
            self.p_specs = api.param_pspecs()
            self.logits_spec = L.resolve_pspec(
                (L.DP, None, "model" if vocab_ok else None))
        self.slots = S.data_slots(mesh, self.dp_axes)
        self.rows = S.model_rows(mesh, self.dp_axes)
        # the rows that run: each data row, or in long mode the first
        self.running = self.slots[:1] if long_mode else self.slots

    # ------------------------------------------------------------ layouts
    def send(self, t, src: int, dst: int, out=None):
        return S.send(t, self.mesh, src, dst, out=out)

    def model_row(self, i: int) -> S.ModelRow:
        return S.ModelRow(self.rows[i], self.send)

    def lay_out_params(self, params):
        return S.lay_out_tree(params, S.layouts(self.mesh, self.p_specs))

    def cache_specs(self, batch: int, seq: int):
        """``cache_pspecs(..., long_mode=)`` with DP the data axes in both
        modes: in long mode a global cache's sequence goes over them (and
        over ``"model"`` where the KV heads do not divide), as
        ``attn_cache_defs`` says, and the batch of every cache (the local
        layers' rings take the normal mode's defs) is replicated.  (The
        reference's dry run resolves long mode's specs with no data axes,
        so its long_500k caches do not split over them; so does
        ``launch/dryrun.py``, whose bytes a slot are the reference's.)"""
        with L.use_mesh(self.mesh, self.dp_axes):
            specs = self.api.cache_pspecs(batch, seq,
                                          long_mode=self.long_mode)
        if not self.long_mode:
            return specs

        def replicated_batch(spec, geom):
            return L.PSpec(*(None if i == geom.lead else e
                             for i, e in enumerate(spec)))
        return L.tree_map(replicated_batch, specs, self.geometry)

    def init_caches(self, batch: int, seq: int, specs=None):
        """Zero caches laid out by :meth:`cache_specs` (or ``specs``):
        each slot's block a contiguous tensor of its own, one for the
        slots of a device that hold the same slice (as
        ``sharded.lay_out`` holds one)."""
        defs = self.api.cache_defs(batch, seq, long_mode=self.long_mode)
        specs = self.cache_specs(batch, seq) if specs is None else specs

        def leaf(d, spec):
            lay = S.Layout(self.mesh, spec)
            seen, blocks = {}, []
            for c, dev in zip(self.coords, self.mesh.devices.flat):
                sl = lay.block_slices(d.shape, c)
                k = (S._key(sl), str(dev))
                if k not in seen:
                    seen[k] = torch.zeros([x.stop - x.start for x in sl],
                                          dtype=getattr(torch, d.dtype),
                                          device=dev)
                blocks.append(seen[k])
            return S.Laid(lay, tuple(d.shape), blocks)

        return L.tree_map(leaf, defs, specs)

    def input_layout(self, ndim: int) -> S.Layout:
        """An input's layout: the batch over the data axes (replicated in
        long mode), as ``ModelAPI.input_pspecs``."""
        with L.use_mesh(self.mesh, self.active):
            return S.Layout(self.mesh, L.resolve_pspec(
                ((L.DP if self.active else ()),) + (None,) * (ndim - 1)))

    def input_layouts(self, batch: dict) -> dict:
        return {k: self.input_layout(v.dim()) for k, v in batch.items()}

    def lay_out_inputs(self, batch: dict) -> dict:
        lays = self.input_layouts(batch)
        return {k: S.lay_out(v, lays[k]) for k, v in batch.items()}

    # ------------------------------------------------------------ the step
    def prefill(self, params, batch, caches):
        """(logits, caches): the logits (B, 1, V) a ``sharded.Laid`` at
        the logits spec; the caches written in place.  An
        encoder-decoder's (seamless) returns (logits, caches, enc_out),
        its encoder's output a ``sharded.Laid`` at the inputs' spec (a
        copy on each slot of a row), which :meth:`decode` takes among its
        inputs (``enc_out``), as ``ModelAPI.decode`` takes
        ``batch["enc_out"]``."""
        return self._step(self.api.prefill, params, batch, caches, False)

    def decode(self, params, batch, caches):
        """One step: (logits, caches), as :meth:`prefill`."""
        return self._step(self.api.decode, params, batch, caches, True)

    def _step(self, fn, params, batch, caches, decode: bool):
        v = self.api.cfg.vocab_size
        b = next(iter(batch.values())).shape[0]
        lay = S.Layout(self.mesh, self.logits_spec)
        blocks = [None] * self.mesh.devices.size
        enc = [None] * self.mesh.devices.size
        for i in self.running:
            out, enc_out = self.row_step(i, fn, params, batch, caches,
                                         decode)
            for j, blk in out.items():
                blocks[j] = blk
            for j, blk in (enc_out or {}).items():
                enc[j] = blk
        logits = S.Laid(lay, (b, 1, v), self._replicas(lay, (b, 1, v),
                                                       blocks))
        if enc[self.running[0]] is None:
            return logits, caches
        shape = (b,) + tuple(enc[self.running[0]].shape[1:])
        e_lay = self.input_layout(len(shape))
        return logits, caches, S.Laid(e_lay, shape,
                                      self._replicas(e_lay, shape, enc))

    def _replicas(self, lay, shape, blocks) -> list:
        """``blocks`` with each slot left out (long mode: the other data
        rows') sent its block from a slot of the running row that holds
        it."""
        for j, c in enumerate(self.coords):
            if blocks[j] is None:
                src = self._holder(lay, shape, c, blocks)
                blocks[j] = self.send(blocks[src], src, j)
        return blocks

    def _holder(self, lay, shape, coord, blocks) -> int:
        want = S._key(lay.block_slices(shape, coord))
        return next(j for j, c in enumerate(self.coords)
                    if blocks[j] is not None
                    and S._key(lay.block_slices(shape, c)) == want)

    def row_caches(self, caches, row: S.ModelRow, offsets):
        """Data row ``row``'s view of the caches: ``layers.CacheBlocks``
        of the blocks that hold its sequences (:func:`cache_spans`) for a
        KV cache, ``layers.StateBlocks`` of its model slots' blocks (and
        their replicas outside the row) for a recurrent state."""
        def leaf(laid, geom):
            if not geom.kv:
                return self._state_blocks(laid, row)
            spans, size = cache_spans(laid.layout, laid.shape, self.coords,
                                      row.slots[0], lead=geom.lead,
                                      heads=self.heads)
            return L.CacheBlocks(
                tuple(laid.blocks[j] if sp is not None else None
                      for j, sp in enumerate(spans)), spans, size, row,
                offsets)
        return L.tree_map(leaf, caches, self.geometry)

    def _state_blocks(self, laid, row: S.ModelRow):
        """A recurrent state leaf as data row ``row`` sees it: its model
        slots' blocks, split by channels where the spec splits it over
        ``"model"``, and each one's replicas outside the row
        (:func:`state_replicas`)."""
        reps = state_replicas(laid.layout, laid.shape, self.coords,
                              row.slots)
        return L.StateBlocks(
            tuple(laid.blocks[j] for j in row.slots), row,
            S.model_dim(laid.layout.spec),
            tuple(tuple((j, laid.blocks[j]) for j in r) for r in reps))

    def row_offsets(self, i: int, batch) -> tuple:
        """The write offsets of data row ``i``'s sequences on the host:
        its block of ``lengths``, read."""
        return tuple(int(o) for o in batch["lengths"].blocks[i].tolist())

    def row_step(self, i: int, fn, params, batch, caches, decode: bool):
        """Data row ``i``'s step on its rows of the batch (its first
        slot's blocks of the inputs; split, the encoder's output as each
        model slot's own copy): ({slot: its block of the logits}, {slot:
        its copy of the encoder's output} or None)."""
        rows = {k: v.blocks[i] for k, v in batch.items()}
        row = self.model_row(i)
        if self.split:
            if "enc_out" in batch:
                rows["enc_out"] = L.Replicas(tuple(
                    batch["enc_out"].blocks[j] for j in row.slots))
            offs = self.row_offsets(i, batch) if decode else None
            out = fn(S.row_blocks(params, row), rows,
                     self.row_caches(caches, row, offs))
            logits, enc = out[0], None
            if len(out) > 2:
                enc = out[2].blocks
                if len(enc) == 1:          # on the first slot alone
                    enc = [self.send(enc[0], row.slots[0], j)
                           for j in row.slots]
                enc = dict(zip(row.slots, enc))
            if logits.dim is None:         # row-parallel: replicated
                return {j: self.send(logits.blocks[0], row.slots[0], j)
                        for j in row.slots}, enc
            return dict(zip(row.slots, logits.blocks)), enc
        whole = S.gather_tree(params, i)
        views = L.tree_map(lambda laid, geom: self._row_cache(laid, i, geom),
                           caches, self.geometry)
        out = fn(whole, rows, views)
        logits = out[0]
        L.tree_map(lambda laid, geom, view: self._write_back(laid, i, geom,
                                                             view),
                   caches, self.geometry, views)
        lay = S.Layout(self.mesh, self.logits_spec)
        shape = (next(iter(batch.values())).shape[0], 1, logits.shape[-1])
        enc = None if len(out) < 3 else {j: self.send(out[2], i, j)
                                          for j in row.slots}
        return {j: self.send(
            logits[:, :, lay.block_slices(shape, self.coords[j])[2]], i, j)
            for j in row.slots}, enc

    def _row_cache(self, laid, i: int, geom) -> torch.Tensor:
        """Data row ``i``'s part of a cache leaf (its rows of the batch,
        every other dim whole) on its first slot: the slot's own block
        where that is the whole part, else gathered from the blocks that
        hold its rows (:func:`row_holders`), the slot's own first."""
        held = row_holders(laid.layout, laid.shape, self.coords, i,
                           geom.lead)
        own = laid.blocks[i]
        mine = dict(held)[i]
        if all(s.stop - s.start == n for k, (s, n) in
               enumerate(zip(mine, laid.shape)) if k != geom.lead):
            return own
        shape = list(laid.shape)
        shape[geom.lead] = own.shape[geom.lead]
        whole = torch.empty(shape, dtype=own.dtype, device=own.device)
        done = set()
        for j, sl in [(i, mine)] + held:
            if S._key(sl) in done:
                continue
            done.add(S._key(sl))
            self.send(laid.blocks[j], j, i,
                      out=whole[_within_row(sl, geom.lead)])
        return whole

    def _write_back(self, laid, i: int, geom, whole: torch.Tensor) -> None:
        """The row's part, written by its step, back into every block that
        holds some of it (a replica too)."""
        for j, sl in row_holders(laid.layout, laid.shape, self.coords, i,
                                 geom.lead):
            if laid.blocks[j] is not whole:
                self.send(whole[_within_row(sl, geom.lead)], i, j,
                          out=laid.blocks[j])


def serve(cfg, *, num_requests=8, prompt_len=12, max_new=16, seed=0,
          page_size=16, num_pages=512, params=None, device=None, log=print):
    """Continuous batching of ``num_requests`` random prompts, at most 4
    running at once.  ``params`` defaults to ``init_params(seed)`` on
    ``device`` (default: the card).  Returns the finished sequences and
    stats, with the host seconds of each prefill and decode step (each
    ends in a host read of its tokens)."""
    dev = resolve_device(device)
    if params is None:
        params = build(cfg, tp=1).init_params(seed, dev)
    pool = PagePool(num_pages=num_pages, page_size=page_size,
                    num_layers=cfg.num_layers,
                    num_kv_heads=cfg.num_kv_heads,
                    head_dim=cfg.resolved_head_dim, device=dev)
    engine = PagedLM(cfg, params, pool)
    rng = np.random.default_rng(seed)

    pending = [list(rng.integers(0, cfg.vocab_size, prompt_len))
               for _ in range(num_requests)]
    running: list[Sequence] = []
    done: list[Sequence] = []
    prefill_s: list[float] = []
    step_s: list[float] = []
    t0 = time.perf_counter()
    max_batch = 4
    while pending or running:
        while pending and len(running) < max_batch:
            sid = len(done) + len(running)
            seq = engine.mgr.add_sequence(sid, pending.pop(0))
            t1 = time.perf_counter()
            seq.generated.append(engine.prefill(seq))
            prefill_s.append(time.perf_counter() - t1)
            running.append(seq)
        t1 = time.perf_counter()
        toks = engine.decode_step(running)
        step_s.append(time.perf_counter() - t1)
        for s, t in zip(list(running), toks):
            s.generated.append(t)
            if len(s.generated) >= max_new:
                s.done = True
                running.remove(s)
                engine.mgr.release(s)
                done.append(s)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(s.generated) for s in done)
    log(f"served {len(done)} requests, {total_tokens} tokens in {dt:.2f}s "
        f"({total_tokens/dt:.1f} tok/s), page pool peak alloc "
        f"{pool.alloc_count} pages, util {engine.mgr.utilization():.2%}")
    return done, {"tokens": total_tokens, "seconds": dt,
                  "decode_steps": len(step_s),
                  "pages_alloc": pool.alloc_count,
                  "prefill_s": prefill_s, "step_s": step_s}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--full", action="store_true",
                    help="full config (default: smoke-scale)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    cfg = (ARCHS if args.full else SMOKES)[args.arch]
    serve(cfg, num_requests=args.requests, max_new=args.max_new,
          device=args.device)


if __name__ == "__main__":
    main()
