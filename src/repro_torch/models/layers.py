"""Model substrate for the LM paths: ParamDef-driven parameters, the
sharding specs, and the attention / MLA / MLP / MoE / embedding building
blocks, on tensors.

Counterpart of ``repro/models/layers.py``.  Parameters are declared as
``ParamDef`` trees (nested dicts and tuples, as in the reference); from
one declaration come (a) tensors materialised on a device, (b) abstract
tensors on the ``meta`` device (:func:`abstract_tree`), and (c) the
PartitionSpecs (:func:`pspec_tree`), each a :class:`PSpec`: a tuple of
``None``, an axis name or a tuple of axis names, entry for entry the
reference's ``PartitionSpec``.  ``use_mesh`` / ``active_tp`` /
``active_dp`` / ``resolve_pspec`` and the ``DP`` / ``DPM`` sentinels are
the reference's; ``tp`` stays an argument of the defs because it decides
head padding and which dims shard over ``"model"``.

The specs lay out *state*: ``train/sharded.py`` splits the parameters
and optimizer moments into one block per slot of a ``launch/mesh.py``
mesh as the reference's ``NamedSharding`` does.  The compute follows
them where the reference's GSPMD step splits it, in a meshed train or
serving step of every architecture (``ModelAPI.model_split``:
llama3.2-3b, gemma3-12b/27b, internvl2-76b, phi3.5-moe, llama4-scout,
minicpm3-4b, jamba-v0.1-52b and xlstm-125m, whose Mamba and mLSTM
layers split by inner channels in ``mamba.py`` and ``xlstm.py``, and
seamless-m4t-large-v2, whose encoder's output every decoder layer's
cross-attention reads: ``encdec.py``) on a mesh whose model axis is
wider than one.  There each
parameter is a :class:`Blocks` leaf, the data row's blocks on its model
slots, and the split forms run what the reference's constraints
(``shard()``) split on each slot's own blocks: its query heads and
``wo``'s matching rows (``attn_apply``, cross-attention's from the
encoder's output as a :class:`Replicas`, a copy on each model slot that
projects its own KV heads from it; ``mla_apply``: its heads'
``wuq``/``wukv``/``wo`` blocks on the latents the first slot sends),
its MLP columns and ``w_out``'s rows (``mlp_apply``), its experts
(``moe_apply``: the row's first slot routes and dispatches, each slot
runs its experts' MLPs on their rows of the buffer, and the combine
runs on the first slot), its vocabulary rows (``embed_apply``) and its
block of the logits (:func:`xent_terms`), or, where the vocabulary does
not divide the model degree (the reference's row-parallel fallback, the
table and an untied head split along ``d_model``), its columns of the
embedding and its partial product of the logits over its columns; the
partials meet on the row's first slot, summed in slot order, at the
reference's constraint points, and the expert outputs and embedding
columns concatenated in slot order (``train/sharded.py``'s
``to_model_slots``, ``sum_model_slots`` and ``from_model_slots``).
What the reference does not split runs once, on the row's first slot:
the norms, residual adds, MLA's down-projections, their norms and its
shared rope key, the MoE's router, dispatch and combine, the experts
where the model degree does not divide them, and the k/v projections
and their rope where it does not divide the KV heads.  Serving
(``launch/serve.py::MeshServe``) adds the caches: each is a
:class:`CacheBlocks` leaf, each slot's block as ``cache_pspecs`` lays it
out (by KV heads, or by positions where the model degree does not divide
them, MLA's compressed caches always by positions, and in long mode
over the data rows' slots too); a step's new k/v (or compressed) rows
go to the slots whose blocks hold their positions and heads
(:func:`write_plan`); a decode over a cache split by positions runs the
decode_attention kernel's partial entry on each block for the query
heads its KV heads serve (gathered onto it, :func:`query_plan`), merged
in slot order on the row's first slot (``merge_partials``), and an MLA
decode gathers the layer's compressed blocks onto each model slot for
its heads; the logits stay split, each slot's vocabulary block
(:func:`logits_apply`), or row-parallel, whole on every slot.  In long
mode the local layers' rings are replicated over the data rows: every
replica receives each write (the reference's GSPMD keeps them equal),
and the computing row reads its own.  A recurrent mixer's state is a
:class:`StateBlocks` leaf, each model slot's block (its channels, or a
replica of the whole), written by the slot that holds it
(:func:`put_state`) and sent to its replicas, so that they stay equal
bit for bit.  A meshed step on a model axis of one runs on whole
tensors, the compute left unsplit: a data shard's rows on whole
gathered parameters (``train/trainer.py``, ``MeshServe``).  Either way ``moe_apply`` routes
as the reference's no-mesh branch over the tokens it is given: run on
one data shard's rows, that is the reference's per-shard capacity
under ``shard_map``.

Where the reference reaches a Pallas kernel or computes one's function,
the port calls the kernel's wrapper through ``kernels.ops``: ``rms_norm``
is the rmsnorm kernel, and on a CUDA tensor ``_sdpa`` is the
flash_attention kernel (prefill, encoder, cross-attention; causal, full
or windowed) or the decode_attention kernel over the dense cache viewed
as pages (decode, and the local layers' ring), and raises for anything
else.  On CPU tensors both are their plain versions.  A tensor on the
``meta`` device takes the card's route (:func:`on_card`): the dry run
(``launch/dryrun.py``) traces a step through the kernels' argument
checks and raises where the card would.  MLA's attention
(two score products summed, a rope key shared by the heads, a value dim
unlike the qk dim) and MoE's dispatch and combine match neither kernel;
the reference computes them in ``jnp`` outside any Pallas kernel, so
they stay plain torch on the card, like the projections.

The dense caches are written in place: ``attn_apply`` and ``mla_apply``
put the new KV rows into the cache tensors they are given (a scatter for
per-sequence offsets, ``copy_`` for a prefill or the ring's roll) and
return the same tree, where the reference returns an updated copy.

The dense path casts each weight to the activation's dtype before its
product, as the reference does (bf16 products for a bf16 model).
``PagedLM`` promotes instead, as JAX promotes a bf16 activation times an
fp32 weight to fp32: :func:`einsum` casts both operands to the promoted
type first.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, replace
from math import gcd

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ops as K
from ..kernels.ref import NEG_INF


# ---------------------------------------------------------------- mesh state
# DP is a sentinel resolved to the data-parallel axes of the active mesh;
# DPM additionally folds in the model axis (long-context cache sharding)
DP = "__dp__"
DPM = "__dp_model__"

_ACTIVE = {"mesh": None, "dp_axes": ("data",), "tp": 1}


def _entry(e):
    if isinstance(e, tuple) and len(e) < 2:
        return e[0] if e else None
    return e


class PSpec(tuple):
    """A PartitionSpec: one entry per leading dim of a tensor, each
    ``None`` (replicated), an axis name, or a tuple of axis names (major
    first; as JAX holds them, one name is held bare and none as
    ``None``); dims past the last entry are replicated.  A leaf of the
    port's trees, not a sequence of leaves."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"P({', '.join(map(repr, self))})"


@contextlib.contextmanager
def use_mesh(mesh, dp_axes=("data",)):
    prev = dict(_ACTIVE)
    _ACTIVE["mesh"] = mesh
    _ACTIVE["dp_axes"] = tuple(dp_axes)
    _ACTIVE["tp"] = int(mesh.shape.get("model", 1)) if mesh is not None else 1
    try:
        yield
    finally:
        _ACTIVE.update(prev)


def active_tp() -> int:
    return _ACTIVE["tp"]


def active_dp() -> int:
    mesh = _ACTIVE["mesh"]
    if mesh is None:
        return 1
    out = 1
    for a in _ACTIVE["dp_axes"]:
        out *= int(mesh.shape.get(a, 1))
    return out


def resolve_pspec(spec) -> PSpec:
    out = []
    for s in spec:
        if s == DP:
            out.append(_ACTIVE["dp_axes"])
        elif s == DPM:
            out.append(tuple(_ACTIVE["dp_axes"]) + ("model",))
        else:
            out.append(s)
    return PSpec(*out)


# ----------------------------------------------------------------- ParamDef
@dataclass(frozen=True)
class ParamDef:
    shape: tuple
    pspec: tuple = ()
    init: str = "normal"          # normal | zeros | ones
    scale: float = 0.02
    dtype: str = "float32"

    def materialize(self, gen: torch.Generator,
                    device: torch.device) -> torch.Tensor:
        dt = getattr(torch, self.dtype)
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dt, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dt, device=device)
        x = torch.randn(self.shape, generator=gen, dtype=torch.float32,
                        device=device)
        return x.mul_(self.scale).to(dt)


def _is_node(tree) -> bool:
    return isinstance(tree, (tuple, list)) and not isinstance(tree, PSpec)


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the leaves of nested dicts, tuples and lists (dict
    keys in sorted order, JAX's leaf order), zipped with trees of the
    same structure in ``rest``; raises ``ValueError`` where they differ.
    A :class:`PSpec` is a leaf."""
    if isinstance(tree, dict):
        if any(not isinstance(r, dict) or sorted(r) != sorted(tree)
               for r in rest):
            raise ValueError(f"tree structures differ at keys {sorted(tree)}")
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if _is_node(tree):
        if any(not _is_node(r) or len(r) != len(tree) for r in rest):
            raise ValueError(f"tree structures differ at a sequence of "
                             f"{len(tree)}")
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_items(tree, path: tuple = ()):
    """(path, leaf) pairs in JAX's leaf order: dict keys sorted, then
    sequence indices; a None is an empty subtree, as in JAX."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in tree_items(tree[k], path + (k,))]
    if _is_node(tree):
        return [item for i, t in enumerate(tree)
                for item in tree_items(t, path + (i,))]
    return [] if tree is None else [(path, tree)]


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in JAX's leaf order."""
    return [leaf for _, leaf in tree_items(tree)]


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure whose leaves are ``leaves``, taken in
    JAX's leaf order."""
    it = iter(leaves)
    out = tree_map(lambda a: a if a is None else next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def init_tree(defs, seed: int, device: torch.device):
    """Materialise every ParamDef of ``defs`` on ``device`` from one
    ``torch.Generator`` seeded with ``seed``, in leaf order.  Same shapes,
    inits, scales and dtypes as the reference; not jax.random's values."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return tree_map(lambda d: d.materialize(gen, device), defs)


def abstract_tree(defs):
    """Each ParamDef as an empty tensor of its shape and dtype on the
    ``meta`` device (no allocation)."""
    return tree_map(lambda d: torch.empty(
        d.shape, dtype=getattr(torch, d.dtype), device="meta"), defs)


def pspec_tree(defs):
    """Each ParamDef's spec, resolved against the active mesh."""
    return tree_map(lambda d: resolve_pspec(d.pspec), defs)


def stack_defs(defs, n: int):
    """Prepend a layer-stack dimension (the reference scans over it),
    replicated."""
    return tree_map(lambda d: replace(d, shape=(n,) + tuple(d.shape),
                                      pspec=(None,) + tuple(d.pspec)), defs)


def _div(n: int, tp: int) -> bool:
    return tp > 0 and n % tp == 0


def take_layer(tree, i: int):
    """Layer ``i`` of a stacked tree: a view of each leaf, so a cache
    written through it is written in the stack."""
    return tree_map(lambda a: a[i], tree)


@dataclass(frozen=True, eq=False)
class Blocks:
    """A parameter of a meshed train step's data row on the model axis:
    ``blocks[m]`` is the row's model slot m's block, split along ``dim``
    as the spec splits it over ``"model"``, or, where the spec does not
    split it (``dim`` None), one block, the whole tensor, on the row's
    first slot.  ``row`` (``train/sharded.py::ModelRow``) runs each
    slot's work and moves activations between the row's slots.  A leaf
    of the port's trees.  Indexing (``take_layer``) is recorded in
    ``index`` and done by the slot that uses the block, inside its own
    work (:meth:`part`), so its gradient's scatter into the stacked
    block is that slot's work too."""
    blocks: tuple
    row: object
    dim: int | None = None
    index: tuple = ()

    def __getitem__(self, i) -> "Blocks":
        return Blocks(self.blocks, self.row,
                      None if self.dim is None else self.dim - 1,
                      self.index + (i,))

    def part(self, block: torch.Tensor) -> torch.Tensor:
        """``block`` (one of ``blocks``) at ``index``."""
        return block[self.index] if self.index else block

    @property
    def whole(self) -> torch.Tensor:
        """The tensor, where the spec does not split it."""
        if self.dim is not None:
            raise ValueError("a parameter split over the model axis has no "
                             "whole tensor on one slot")
        return self.part(self.blocks[0])


@dataclass(frozen=True, eq=False)
class CacheBlocks:
    """A KV cache leaf (``k`` or ``v``: (B, S, KVH, hd) at a layer) of a
    serving step split over the model axis, as one data row sees it:
    ``blocks[j]`` is mesh slot j's block (flat order) where that slot
    holds the row's sequences, else None, and ``spans[j]`` its positions
    and KV heads, ((lo, hi), (lo, hi)) of the row's tensor, whose batch
    every block covers whole; ``size`` is (S, KVH).  ``row``
    (``train/sharded.py::ModelRow``) runs any slot's work (``run_at``)
    and moves tensors between any two slots: in long mode a sequence's
    blocks lie on other data rows' slots too.  ``offsets``, to decode,
    holds each of the row's sequences' write offset as the host knows it
    (None to prefill).  Indexing as :class:`Blocks`."""
    blocks: tuple
    spans: tuple
    size: tuple
    row: object
    offsets: tuple | None = None
    index: tuple = ()

    def __getitem__(self, i) -> "CacheBlocks":
        return replace(self, index=self.index + (i,))

    def part(self, block: torch.Tensor) -> torch.Tensor:
        return block[self.index] if self.index else block

    def readers(self) -> list:
        """(slot, span) for each distinct span, in slot order: the row's
        own slot where one of them holds it, else the first that does
        (every slot holding a block is written the rows of its span, a
        replica too: :func:`write_plan`)."""
        first = {}
        for j, sp in enumerate(self.spans):
            if sp is None:
                continue
            if sp not in first or (j in self.row.slots
                                   and first[sp] not in self.row.slots):
                first[sp] = j
        return sorted((j, sp) for sp, j in first.items())


@dataclass(frozen=True, eq=False)
class StateBlocks:
    """A recurrent cache leaf (Mamba's ``conv``/``ssm``, mLSTM's
    ``C``/``n``/``m``, sLSTM's ``c``/``h``/``n``/``m``) of a split serving
    step, as one data row sees it: ``blocks[m]`` is the row's model slot
    m's block of its sequences, split along ``dim`` (the inner channels)
    where the spec splits it over ``"model"``, else (``dim`` None) each a
    replica of the whole; ``replicas[m]`` the (slot, block) pairs outside
    the row that hold the same block as model slot m (in long mode, the
    other data rows'), each written what slot m's block is after every
    step (:func:`put_state`).  ``row`` as :class:`CacheBlocks`; indexing as
    :class:`Blocks`."""
    blocks: tuple
    row: object
    dim: int | None = None
    replicas: tuple = ()
    index: tuple = ()

    def __getitem__(self, i) -> "StateBlocks":
        return replace(self, dim=None if self.dim is None else self.dim - 1,
                       index=self.index + (i,))

    def part(self, block: torch.Tensor) -> torch.Tensor:
        return block[self.index] if self.index else block

    def at(self, m: int) -> torch.Tensor:
        """Model slot m's block at ``index``."""
        return self.part(self.blocks[m])


@dataclass(frozen=True, eq=False)
class Replicas:
    """An activation of a split step on a data row's model slots:
    ``blocks[m]`` model slot m's copy of the whole tensor, or one block,
    the row's first slot's alone.  The encoder's output as a split
    cross-attention reads it (:func:`_cross_split`)."""
    blocks: tuple


def _put_state(block, new):
    """A slot's own block of a recurrent cache written ``new``."""
    return block.copy_(new)


def put_state(c: StateBlocks, m: int, new) -> None:
    """``new``, on model slot m, written into its block of ``c`` by that
    slot, and sent to each replica of the block, which writes it too."""
    row = c.row
    src = row.slots[m]
    row.run_at(src, _put_state, c.at(m), new)
    for j, block in c.replicas[m] if c.replicas else ():
        row.run_at(j, _put_state, c.part(block), row.send(new, src, j))


def columns_slot(x, w, *, at):
    """A slot's columns of a projection split by output columns (Mamba's
    ``in_proj``, mLSTM's ``up_proj``): ``x @`` its block."""
    return x @ at(w).to(x.dtype)


def whole_on_first(apply, p, x, cfg, cache=None):
    """A recurrent mixer that the spec leaves unsplit (sLSTM, or a ``di``
    the model degree does not divide) on a row's model slots: ``apply``
    on the whole parameters and, with a cache (a dict of
    :class:`StateBlocks` replicated over the model axis), the first
    slot's blocks, written in place there, then sent to every other
    model slot and to each replica, which write them
    (:func:`put_state`), so that every replica is the first slot's bit
    for bit.  Returns the output."""
    first = None if cache is None else {k: c.at(0) for k, c in cache.items()}
    y, _ = apply({k: v.whole for k, v in p.items()}, x, cfg, cache=first)
    for c in (cache or {}).values():
        row, new = c.row, c.at(0)
        for j, block in c.replicas[0] if c.replicas else ():
            row.run_at(j, _put_state, c.part(block),
                       row.send(new, row.slots[0], j))
        for m in range(1, len(c.blocks)):
            put_state(c, m, row.send_to(new, m))
    return y


def is_split(tree) -> bool:
    """Whether ``tree``'s leaves are :class:`Blocks` (a split step)."""
    return any(isinstance(a, Blocks) for a in tree_leaves(tree))


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum`` with JAX's dtype promotion (bf16 x fp32 -> fp32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


# ------------------------------------------------------------------ norms
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * w in fp32, in x's dtype: the rmsnorm
    kernel on the card (over a contiguous copy of a strided x)."""
    return K.rmsnorm(x.contiguous(), w, eps=eps)


def norm_def(d: int) -> ParamDef:
    return ParamDef((d,), (None,), init="ones")


# ------------------------------------------------------------------- rope
def rope_tables(positions: torch.Tensor, dim: int, theta: float):
    """positions (...,) int -> (..., dim/2) cos/sin tables."""
    half = dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., T, H, D); cos/sin = positions-shaped + (D/2,): (T,D/2) or
    (B,T,D/2).  One head axis is inserted; leading dims broadcast."""
    half = x.shape[-1] // 2
    cos = cos[..., None, :]                        # (..., T, 1, D/2)
    sin = sin[..., None, :]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * cos - x2 * sin,
                      x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def _act(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


# ================================================================ attention
def padded_heads(h: int, kvh: int, tp: int) -> int:
    """Pad the query-head dim to the TP degree when not divisible (Megatron
    head padding), keeping it divisible by the KV heads."""
    if tp <= 1 or _div(h, tp):
        return h
    hp = -(-h // tp) * tp
    while hp % kvh != 0:
        hp += tp
    return hp


def attn_defs(cfg, tp: int) -> dict:
    d, h, kvh, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                     cfg.resolved_head_dim)
    hp = padded_heads(h, kvh, tp)
    h_ax = "model" if _div(hp, tp) else None
    kv_ax = "model" if _div(kvh, tp) else None
    return {
        "wq": ParamDef((d, hp, hd), (None, h_ax, None)),
        "wk": ParamDef((d, kvh, hd), (None, kv_ax, None)),
        "wv": ParamDef((d, kvh, hd), (None, kv_ax, None)),
        "wo": ParamDef((hp, hd, d), (h_ax, None, None)),
        "ln": norm_def(d),
    }


def _head_mask(out: torch.Tensor, h_real: int, kvh: int = 1) -> torch.Tensor:
    """Zero the padded heads of (..., H_pad, hd) attention output: real
    head i occupies slot (i // g) * g_pad + (i % g)."""
    hp = out.shape[-2]
    if hp == h_real:
        return out
    g, gp = h_real // kvh, hp // kvh
    mask = ((torch.arange(hp, device=out.device) % gp) < g).to(out.dtype)
    return out * mask[:, None]


def _is_scalar(q_pos0) -> bool:
    return not isinstance(q_pos0, torch.Tensor) or q_pos0.dim() == 0


def _attn_mask(b, t, s, *, causal, window, q_pos0, kv_len, device):
    """(B, t, s) boolean visibility mask; q_pos0 scalar or (B,)."""
    ar = torch.arange(t, device=device)
    if _is_scalar(q_pos0):
        q_pos = (q_pos0 + ar).expand(b, t)
    else:
        q_pos = q_pos0[:, None] + ar[None, :]
    k_pos = torch.arange(s, device=device)
    mask = torch.ones((b, t, s), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos[..., None] >= k_pos
    if window and window > 0:
        mask &= (q_pos[..., None] - k_pos) < window
    if kv_len is not None:
        mask &= k_pos[None, None, :] < kv_len[:, None, None]
    return mask


_CHUNK_Q_ABOVE = 1024       # stream softmax over q chunks beyond this T
_CHUNK_Q = 512


def _masked_softmax_pv(q, k, v, mask, dtype):
    """The plain attention under a (B, t, s) visibility mask: scores and
    the PV product in fp32 over the operands' own values (bf16 operands
    widen exactly), the probabilities rounded to v's dtype first, as the
    reference's bf16-native einsums do."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    scores = torch.einsum("btkgd,bskd->bkgts", q.float(), k.float()) * scale
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", p.to(v.dtype).float(), v.float())
    return out.to(dtype or q.dtype)


def _sdpa_core(q, k, v, *, causal, window, q_pos0, kv_len, dtype):
    b, t = q.shape[:2]
    mask = _attn_mask(b, t, k.shape[1], causal=causal, window=window,
                      q_pos0=q_pos0, kv_len=kv_len, device=q.device)
    return _masked_softmax_pv(q, k, v, mask, dtype)


def _cache_as_pages(q, kc, vc, lengths, dtype):
    """decode_attention over a dense cache: q (B,1,KVH,G,hd) against kc/vc
    (B,S,KVH,hd), positions >= lengths[b] (B,) masked.  The cache, viewed
    as (B*S/ps, ps, KVH, hd) with ps = gcd(S, 16), is a page pool in which
    sequence b owns pages b*S/ps .. (b+1)*S/ps - 1 in order; the page
    table is built on the card, so nothing is read back to the host."""
    b, t, kvh, g, hd = q.shape
    out = K.decode_attention(q.reshape(b, kvh * g, hd),
                             *_page_view(kc, vc), lengths.to(torch.int32))
    return out.reshape(b, 1, kvh, g, hd).to(dtype or q.dtype)


def _page_view(kc, vc):
    """(K pages, V pages, page table) of a dense cache (B,S,KVH,hd): the
    (B*S/ps, ps, KVH, hd) view with ps = gcd(S, 16), sequence b owning
    pages b*S/ps .. (b+1)*S/ps - 1 in order, the table built on the
    cache's device."""
    b, s, kvh, hd = kc.shape
    for name, c in (("k", kc), ("v", vc)):
        if not c.is_contiguous():
            raise ValueError(f"attention over a dense cache: the {name} "
                             f"cache {tuple(c.shape)} with strides "
                             f"{c.stride()} is not contiguous, so it has no "
                             "page view")
    ps = gcd(s, 16)
    n = s // ps
    ar = torch.arange(n, dtype=torch.int32, device=kc.device)
    table = torch.arange(b, dtype=torch.int32, device=kc.device)[:, None] \
        * n + ar[None, :]
    return (kc.view(b * n, ps, kvh, hd), vc.view(b * n, ps, kvh, hd),
            table)


def on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` takes the card's route: a CUDA tensor, or a ``meta``
    one (the dry run's shapes, checked as the card would check them)."""
    return t.device.type in ("cuda", "meta")


def _sdpa_on_card(q, k, v, *, causal, window, q_pos0, kv_len, dtype):
    """``_sdpa`` on the card, routed by its arguments:

    * no ``kv_len`` and ``q_pos0 == 0`` (prefill, a full forward, the
      encoder, cross-attention): the flash_attention kernel over the
      (B,T,KVH,G,hd) activations in place (head h = kvh*G + g reads KV
      head h // G), causal or full, with the window;
    * one query with ``kv_len`` and no window (decode over a dense
      cache): the decode_attention kernel over the cache viewed as
      pages, lengths = kv_len, or min(kv_len, q_pos0 + 1) when causal;
    * anything else raises ``NotImplementedError``: neither kernel
      computes it, and nothing falls back to the plain version."""
    b, t, kvh, g, hd = q.shape
    if kv_len is None:
        if not _is_scalar(q_pos0) or int(q_pos0) != 0:
            raise NotImplementedError(
                "attention on the card at a query offset q_pos0 without "
                "kv_len: neither attention kernel computes it")
        qh = q.reshape(b, t, kvh * g, hd).permute(0, 2, 1, 3)  # (B,H,T,hd)
        out = K.flash_attention(qh, k.permute(0, 2, 1, 3),
                                v.permute(0, 2, 1, 3), causal=causal,
                                window=window or 0)
        return out.permute(0, 2, 1, 3).reshape(b, t, kvh, g, hd).to(
            dtype or q.dtype)
    if t != 1:
        raise NotImplementedError(
            f"attention on the card over a cache (kv_len) at {t} query "
            "positions: the decode_attention kernel takes one")
    if window and window > 0:
        raise NotImplementedError(
            f"decode attention on the card with a window ({window}) over "
            "a dense cache: the local layers' ring takes no window")
    lengths = kv_len
    if causal:
        lengths = torch.minimum(kv_len, torch.as_tensor(
            q_pos0, device=q.device) + 1)
    return _cache_as_pages(q, k, v, lengths, dtype)


def _sdpa(q, k, v, *, causal, window, q_pos0=0, kv_len=None, dtype=None):
    """q (B,T,KVH,G,hd), k/v (B,S,KVH,hd): masked attention, fp32 softmax.

    ``window > 0``: sliding-window (local) causal attention.
    ``kv_len`` (B,) masks cache positions >= length (decode).
    On a CUDA tensor this is a kernel (see :func:`_sdpa_on_card`) or a
    ``NotImplementedError``.  On the CPU, long sequences stream over q
    chunks as in the reference, so the score matrix peak is (cq, S), not
    (T, S).
    """
    if on_card(q):
        return _sdpa_on_card(q, k, v, causal=causal, window=window,
                             q_pos0=q_pos0, kv_len=kv_len, dtype=dtype)
    b, t, kvh, g, hd = q.shape
    if t <= _CHUNK_Q_ABOVE or t % _CHUNK_Q != 0 or not _is_scalar(q_pos0):
        return _sdpa_core(q, k, v, causal=causal, window=window,
                          q_pos0=q_pos0, kv_len=kv_len, dtype=dtype)
    outs = [_sdpa_core(q[:, i:i + _CHUNK_Q], k, v, causal=causal,
                       window=window, q_pos0=q_pos0 + i, kv_len=kv_len,
                       dtype=dtype)
            for i in range(0, t, _CHUNK_Q)]
    return torch.cat(outs, dim=1)


def _sdpa_mask(q, k, v, mask, dtype=None):
    """Attention with an explicit (B, t, s) visibility mask (bf16-native);
    the plain version only: on the card the ring's decode is
    :func:`_ring_attention`'s page view."""
    if on_card(q):
        raise NotImplementedError(
            "attention under an explicit mask on the card: neither "
            "attention kernel computes it")
    return _masked_softmax_pv(q, k, v, mask, dtype)


def _ring_attention(q, kc, vc, off):
    """A local layer's decode: the one query of each sequence, at position
    ``off`` (B,), against its ring of w slots after that position's write.
    The reference's visibility (``_sdpa_mask`` over each slot's absolute
    position) reduces to "slot j was written", that is j < min(off + 1,
    w), and softmax ignores the order of the slots: on the card this is
    the decode_attention kernel over the ring viewed as pages."""
    w = kc.shape[1]
    if on_card(q):
        return _cache_as_pages(q, kc, vc, torch.clamp(off + 1, max=w), None)
    n = off + 1                                   # tokens now cached
    j = torch.arange(w, device=q.device)[None, :]  # ring slots
    abs_pos = j + torch.div(n[:, None] - 1 - j, w, rounding_mode="floor") * w
    q_pos = off[:, None]
    visible = (abs_pos >= 0) & (abs_pos < n[:, None]) \
        & (abs_pos <= q_pos) & (q_pos - abs_pos < w)
    return _sdpa_mask(q, kc, vc, visible[:, None, :])


def _batched_update(cache, new, offsets):
    """Per-sequence write offsets (decode with ragged lengths), in place:
    new (B,t,...) into cache (B,S,...) from offsets (B,), each start
    clamped so that the write fits, as ``dynamic_update_slice`` clamps.
    Returns ``cache``."""
    b, t = new.shape[:2]
    start = torch.clamp(offsets.long(), 0, cache.shape[1] - t)
    pos = start[:, None] + torch.arange(t, device=cache.device)[None, :]
    rows = torch.arange(b, device=cache.device)[:, None]
    cache[rows, pos] = new.to(cache.dtype)
    return cache


def attn_decode_pos(cache_len, b, *, device=None):
    """Each sequence's write offset (B,) int32: ``cache_len`` itself, or a
    scalar broadcast (a Python int needs ``device``)."""
    if isinstance(cache_len, torch.Tensor):
        if cache_len.dim() == 0:
            return cache_len.to(torch.int32).expand(b)
        return cache_len
    return torch.full((b,), int(cache_len), dtype=torch.int32, device=device)


def attn_cache_defs(cfg, batch: int, seq: int, *, tp: int,
                    long_mode: bool = False) -> dict:
    """Decode KV-cache defs.  Normal mode: batch over DP, seq over "model"
    when KV heads cannot shard.  long_mode (batch < DP degree): batch
    replicated, seq over DP(+model)."""
    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    kv_ax = "model" if _div(kvh, tp) else None
    if long_mode:
        pspec = (None, DP if kv_ax else DPM, kv_ax, None)
    else:
        pspec = (DP, None if kv_ax else "model", kv_ax, None)
    return {"k": ParamDef((batch, seq, kvh, hd), pspec, init="zeros",
                          dtype=cfg.dtype),
            "v": ParamDef((batch, seq, kvh, hd), pspec, init="zeros",
                          dtype=cfg.dtype)}


def attn_apply(p, x, cfg, *, kind="attn", causal=True, positions=None,
               cache=None, cache_len=None, kv_override=None, kv_len=None):
    """GQA attention.  Returns (y, cache).

    Modes: plain (cache=None), prefill (cache + t>1, fills from offset 0),
    decode (cache + t==1, per-sequence offsets ``cache_len`` (B,)).
    ``local`` layers keep a **ring cache** of size window.
    kv_override: precomputed (k, v) for cross-attention (with ``kv_len``);
    on :class:`Blocks` leaves, the encoder's output as a :class:`Replicas`,
    from which each model slot projects its own k/v (:func:`_cross_split`).
    The cache's tensors are written in place and returned.
    """
    if isinstance(p["wq"], Blocks):
        if kv_override is not None:
            return _cross_split(p, x, cfg, kv_override, kv_len=kv_len), cache
        if cache is None:
            if positions is not None:
                raise NotImplementedError(
                    "attention split over the model axis at given positions "
                    "without a cache: the split step takes positions only "
                    "to decode")
            return _attn_split(p, x, cfg, kind=kind, causal=causal), cache
        return _attn_split_serve(p, x, cfg, kind=kind, causal=causal,
                                 positions=positions, cache=cache,
                                 cache_len=cache_len), cache
    b, t, d = x.shape
    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    h = p["wq"].shape[1]                  # padded head count (>= cfg heads)
    g = h // kvh
    window = cfg.window_size if kind == "local" else 0
    xn = rms_norm(x, p["ln"], cfg.norm_eps)
    q = torch.einsum("btd,dhk->bthk", xn, p["wq"].to(xn.dtype))

    if kv_override is not None:                      # ---- cross-attention
        k, v = kv_override
        qg = q.reshape(b, t, kvh, g, hd)
        out = _sdpa(qg, k, v, causal=False, window=0, kv_len=kv_len)
        out = _head_mask(out.reshape(b, t, h, hd), cfg.num_heads, kvh)
        y = torch.einsum("bthk,hkd->btd", out, p["wo"].to(out.dtype))
        return x + y, cache

    k = torch.einsum("btd,dhk->bthk", xn, p["wk"].to(xn.dtype))
    v = torch.einsum("btd,dhk->bthk", xn, p["wv"].to(xn.dtype))
    if positions is None:
        positions = torch.arange(t, device=x.device)
    cos, sin = rope_tables(positions, hd, cfg.rope_theta)
    if kind != "nope":
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    qg = q.reshape(b, t, kvh, g, hd)

    if cache is None:                                # ---- plain (train)
        out = _sdpa(qg, k, v, causal=causal, window=window)
    elif t > 1:                                      # ---- prefill
        out = _sdpa(qg, k, v, causal=causal, window=window)
        w = cache["k"].shape[1]
        if kind == "local" and t >= w:               # the ring's layout
            shift = (t - w) % w
            cache["k"].copy_(torch.roll(k[:, -w:], shifts=shift, dims=1))
            cache["v"].copy_(torch.roll(v[:, -w:], shifts=shift, dims=1))
        else:
            cache["k"][:, :t].copy_(k)
            cache["v"][:, :t].copy_(v)
    else:                                            # ---- decode (t == 1)
        off = attn_decode_pos(cache_len, b, device=x.device)
        if kind == "local":
            w = cache["k"].shape[1]
            kc = _batched_update(cache["k"], k, off % w)
            vc = _batched_update(cache["v"], v, off % w)
            out = _ring_attention(qg, kc, vc, off)
        else:
            kc = _batched_update(cache["k"], k, off)
            vc = _batched_update(cache["v"], v, off)
            out = _sdpa(qg, kc, vc, causal=True, window=0,
                        q_pos0=off, kv_len=off + 1)
    out = _head_mask(out.reshape(b, t, h, hd), cfg.num_heads, kvh)
    y = torch.einsum("bthk,hkd->btd", out, p["wo"].to(out.dtype))
    return x + y, cache


# ===================================================================== MLA
def mla_defs(cfg, tp: int) -> dict:
    m = cfg.mla
    d = cfg.d_model
    h = padded_heads(cfg.num_heads, 1, tp)
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
    h_ax = "model" if _div(h, tp) else None
    return {
        "wdq": ParamDef((d, m.q_lora_rank), (None, None)),
        "q_ln": norm_def(m.q_lora_rank),
        "wuq": ParamDef((m.q_lora_rank, h, qd), (None, h_ax, None)),
        "wdkv": ParamDef((d, m.kv_lora_rank + m.qk_rope_head_dim),
                         (None, None)),
        "kv_ln": norm_def(m.kv_lora_rank),
        "wukv": ParamDef((m.kv_lora_rank, h,
                          m.qk_nope_head_dim + m.v_head_dim),
                         (None, h_ax, None)),
        "wo": ParamDef((h, m.v_head_dim, d), (h_ax, None, None)),
        "ln": norm_def(d),
    }


def _write_rows(cache, new, off):
    """``new`` (B,t,...) into ``cache`` from offset ``off``: a scalar for
    every sequence, or (B,) each its own."""
    if _is_scalar(off):
        off = int(off)
        cache[:, off:off + new.shape[1]].copy_(new)
        return cache
    return _batched_update(cache, new, off)


def _mla_latent(x, ln, wdq, q_ln, wdkv, kv_ln, cfg, rope):
    """The part of MLA the reference does not split over the model axis:
    the norm, the two down-projections and their norms, and the rope key
    shared by the heads, roped by ``rope`` (cos, sin): (cq (B,T,r_q),
    ckv (B,T,r_kv), k_rope (B,T,rope_d))."""
    m = cfg.mla
    xn = rms_norm(x, ln, cfg.norm_eps)
    cq = rms_norm(torch.einsum("btd,dr->btr", xn, wdq.to(xn.dtype)),
                  q_ln, cfg.norm_eps)
    dkv = torch.einsum("btd,dr->btr", xn, wdkv.to(xn.dtype))
    ckv = rms_norm(dkv[..., :m.kv_lora_rank], kv_ln, cfg.norm_eps)
    k_rope = dkv[..., m.kv_lora_rank:]                 # (B,T,rope_d) shared
    k_rope = apply_rope(k_rope[:, :, None, :], *rope)[:, :, 0]
    return cq, ckv, k_rope


def _mla_heads(cq, ckv, k_rope, wuq, wukv, wo, *, cfg, rope, q_pos0, kv_len,
               lo: int, dtype):
    """MLA's attention on the heads of ``wuq``/``wukv``/``wo`` (global
    indices [lo, lo + h)): the queries from ``cq`` with their rope part
    roped by ``rope``, the keys and values from ``ckv`` over its S
    positions, both score products and P·V in fp32, the padded heads
    (index >= ``cfg.num_heads``) zeroed and ``wo``'s rows: (B,T,D)."""
    m = cfg.mla
    b, t, _ = cq.shape
    nope, rope_d = m.qk_nope_head_dim, m.qk_rope_head_dim
    q = torch.einsum("btr,rhk->bthk", cq, wuq.to(cq.dtype))
    q_nope, q_rope = q[..., :nope], apply_rope(q[..., nope:], *rope)
    kv = torch.einsum("bsr,rhk->bshk", ckv.to(dtype), wukv.to(dtype))
    k_nope, v = kv[..., :nope], kv[..., nope:]
    scale = 1.0 / np.sqrt(nope + rope_d)
    scores = (torch.einsum("bthk,bshk->bhts", q_nope.float(), k_nope.float())
              + torch.einsum("bthk,bsk->bhts", q_rope.float(),
                             k_rope.float())) * scale
    mask = _attn_mask(b, t, k_nope.shape[1], causal=True, window=0,
                      q_pos0=q_pos0, kv_len=kv_len, device=cq.device)
    scores = torch.where(mask[:, None], scores, NEG_INF)
    pr = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhts,bshk->bthk", pr.to(v.dtype).float(),
                       v.float()).to(dtype)
    h = out.shape[2]
    if lo + h > cfg.num_heads:                # padded heads, by global index
        j = lo + torch.arange(h, device=out.device)
        out = out * (j < cfg.num_heads).to(dtype)[:, None]
    return torch.einsum("bthk,hkd->btd", out, wo.to(dtype))


def mla_apply(p, x, cfg, *, positions=None, cache=None, cache_len=None):
    """Multi-head latent attention; the cache stores the *compressed* KV
    (c_kv + shared k_rope), written in place.  Plain torch on the card
    apart from its three norms (see the module docstring).  On a row's
    model slots (``Blocks`` leaves) it takes the split forms
    (:func:`_mla_split`, :func:`_mla_split_serve`)."""
    if isinstance(p["wuq"], Blocks):
        if cache is None:
            if positions is not None:
                raise NotImplementedError(
                    "MLA split over the model axis at given positions "
                    "without a cache: the split step takes positions only "
                    "to decode")
            return _mla_split(p, x, cfg), cache
        return _mla_split_serve(p, x, cfg, positions=positions, cache=cache,
                                cache_len=cache_len), cache
    b, t, d = x.shape
    if positions is None:
        positions = torch.arange(t, device=x.device)
    rope = rope_tables(positions, cfg.mla.qk_rope_head_dim, cfg.rope_theta)
    cq, ckv, k_rope = _mla_latent(x, p["ln"], p["wdq"], p["q_ln"], p["wdkv"],
                                  p["kv_ln"], cfg, rope)
    q_pos0, kv_len = 0, None
    if cache is not None:
        off = cache_len if cache_len is not None else 0
        ckv = _write_rows(cache["ckv"], ckv, off)
        k_rope = _write_rows(cache["krope"], k_rope, off)
        q_pos0 = off
        kv_len = off + t
        if _is_scalar(kv_len):
            kv_len = torch.full((b,), int(kv_len), dtype=torch.int32,
                                device=x.device)
    y = _mla_heads(cq, ckv, k_rope, p["wuq"], p["wukv"], p["wo"], cfg=cfg,
                   rope=rope, q_pos0=q_pos0, kv_len=kv_len, lo=0,
                   dtype=x.dtype)
    return x + y, cache


def mla_cache_defs(cfg, batch: int, seq: int, *, tp: int,
                   long_mode: bool = False) -> dict:
    m = cfg.mla
    pspec = (None, DPM, None) if long_mode else (DP, "model", None)
    return {"ckv": ParamDef((batch, seq, m.kv_lora_rank), pspec,
                            init="zeros", dtype=cfg.dtype),
            "krope": ParamDef((batch, seq, m.qk_rope_head_dim), pspec,
                              init="zeros", dtype=cfg.dtype)}


# ===================================================================== MLP
def mlp_defs(cfg, tp: int, d_ff: int = 0) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    f_ax = "model" if _div(f, tp) else None
    return {
        "w_gate": ParamDef((d, f), (None, f_ax)),
        "w_in": ParamDef((d, f), (None, f_ax)),
        "w_out": ParamDef((f, d), (f_ax, None)),
        "ln": norm_def(d),
    }


def mlp_apply(p, x, cfg):
    if isinstance(p["w_in"], Blocks):
        return _mlp_split(p, x, cfg)
    xn = rms_norm(x, p["ln"], cfg.norm_eps)
    a = _act(cfg.act)(torch.einsum("btd,df->btf", xn,
                                   p["w_gate"].to(xn.dtype)))
    u = torch.einsum("btd,df->btf", xn, p["w_in"].to(xn.dtype))
    h = a * u
    y = torch.einsum("btf,fd->btd", h, p["w_out"].to(h.dtype))
    return x + y


# ===================================================================== MoE
def moe_defs(cfg, tp: int) -> dict:
    mc = cfg.moe
    d = cfg.d_model
    f = mc.d_ff or cfg.d_ff
    e = mc.num_experts
    e_ax = "model" if _div(e, tp) else None
    f_ax = "model" if _div(f, tp) else None
    defs = {
        "router": ParamDef((d, e), (None, None)),
        "w_gate": ParamDef((e, d, f), (e_ax, None, None)),
        "w_in": ParamDef((e, d, f), (e_ax, None, None)),
        "w_out": ParamDef((e, f, d), (e_ax, None, None)),
        "ln": norm_def(d),
    }
    if mc.num_shared:
        defs["shared"] = {
            "w_gate": ParamDef((d, mc.num_shared * f), (None, f_ax)),
            "w_in": ParamDef((d, mc.num_shared * f), (None, f_ax)),
            "w_out": ParamDef((mc.num_shared * f, d), (f_ax, None)),
        }
    return defs


def _top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, a tie to the
    lower index (a stable descending sort; ``torch.topk`` promises no
    order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _moe_dispatch(xl, router, *, cfg):
    """The router over the tokens of ``xl`` (B,T,D): the top-k experts,
    their gates, the aux loss, each route's rank at its expert and
    whether it is kept (within the expert's capacity), and the (E, cap,
    D) buffer of each expert's tokens.  Returns (eb, route, aux),
    ``route`` = (idx, gates, keep, slot), each (N, k), ``slot`` a kept
    route's row of the buffer flattened to (E * cap, D).  A token past
    an expert's capacity is dropped: its row goes to a spare last row of
    the buffer, which is cut off, where the reference's scatter drops
    the write."""
    mc = cfg.moe
    bl, t, d = xl.shape
    nl = bl * t
    e, k = mc.num_experts, mc.top_k
    cap = max(8, int(mc.capacity_factor * nl * k / e))
    xn = xl.reshape(nl, d)
    probs = torch.softmax(xn.float() @ router.float(), dim=-1)
    gates, idx = _top_k(probs, k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    flat = idx.reshape(nl * k)
    oh = F.one_hot(flat, e)
    me = probs.mean(dim=0)
    ce = oh.sum(dim=0).float() / (nl * k)    # each expert's count, exact
    aux = e * torch.sum(me * ce)

    ranks = torch.cumsum(oh, dim=0) - oh
    rank = ranks.gather(1, flat[:, None])[:, 0].reshape(nl, k)
    keep = rank < cap
    slot = idx * cap + rank
    buf = xn.new_zeros((e * cap + 1, d))
    for j in range(k):
        dest = torch.where(keep[:, j], slot[:, j], e * cap)
        buf[dest] = xn * keep[:, j, None].to(xn.dtype)
    return buf[:e * cap].reshape(e, cap, d), (idx, gates, keep, slot), aux


def _moe_experts(eb, wg, wi, wo, *, act, at=lambda w: w):
    """The expert MLPs on their buffers: eb (E', cap, D) through the
    stacks ``wg``/``wi`` (E', D, F) and ``wo`` (E', F, D), each taken
    to the layer's by ``at`` (``Blocks.part``): (E', cap, D)."""
    wg, wi, wo = at(wg), at(wi), at(wo)
    hg = _act(act)(torch.einsum("ecd,edf->ecf", eb, wg.to(eb.dtype)))
    hu = torch.einsum("ecd,edf->ecf", eb, wi.to(eb.dtype))
    return torch.einsum("ecf,efd->ecd", hg * hu, wo.to(eb.dtype))


def _moe_combine(ob, route, xl):
    """Each token of ``xl`` (B,T,D): its kept routes' expert outputs
    (``ob`` (E, cap, D)) weighted by their gates, summed over j in
    order."""
    _, gates, keep, slot = route
    ob = ob.reshape(-1, ob.shape[-1])
    y = torch.zeros_like(xl.reshape(-1, xl.shape[-1]))
    for j in range(slot.shape[1]):
        src = torch.where(keep[:, j], slot[:, j], 0)
        y = y + ob[src] * (gates[:, j] * keep[:, j])[:, None].to(y.dtype)
    return y.reshape(xl.shape)


def _moe_local(xl, router, wg, wi, wo, *, cfg):
    """Capacity-based top-k dispatch, expert MLPs and combine over the
    tokens of ``xl`` (B,T,D); returns (y, aux)."""
    eb, route, aux = _moe_dispatch(xl, router, cfg=cfg)
    ob = _moe_experts(eb, wg, wi, wo, act=cfg.act)
    return _moe_combine(ob, route, xl), aux


def moe_apply(p, x, cfg):
    """Capacity-based top-k MoE (GShard-style) over the tokens of ``x``,
    the reference's no-mesh branch; returns (y, aux).  A meshed step
    calls it on one data shard's rows, which is the reference's
    per-shard capacity on a mesh; on a row's model slots (``Blocks``
    leaves) it takes the split form (:func:`_moe_split`)."""
    if isinstance(p["w_in"], Blocks):
        return _moe_split(p, x, cfg)
    xn = rms_norm(x, p["ln"], cfg.norm_eps)
    y, aux = _moe_local(xn, p["router"], p["w_gate"], p["w_in"],
                        p["w_out"], cfg=cfg)
    if cfg.moe.num_shared:
        sp = p["shared"]
        y = y + _mlp_slot(xn, sp["w_gate"], sp["w_in"], sp["w_out"],
                          act=cfg.act, at=lambda w: w)
    return x + y, aux


# ================================================================ embedding
def embed_defs(cfg, tp: int) -> dict:
    v, d = cfg.vocab_size, cfg.d_model
    if _div(v, tp):
        emb_spec = ("model", None)
    else:
        emb_spec = (None, "model")           # row-parallel logits fallback
    defs = {"tokens": ParamDef((v, d), emb_spec, scale=1.0 / np.sqrt(d)),
            "final_ln": norm_def(d)}
    if not cfg.tie_embeddings:
        defs["head"] = ParamDef((d, v),
                                (None, "model") if _div(v, tp)
                                else ("model", None))
    return defs


def embed_apply(p, tokens, cfg):
    """Rows of the table in ``cfg.dtype``: gathered first, then rounded
    (round to nearest even, as JAX's cast of the whole table)."""
    if isinstance(p["tokens"], Blocks):
        x = _embed_split(p["tokens"], tokens, cfg)
    else:
        x = p["tokens"][tokens.long()].to(getattr(torch, cfg.dtype))
    if cfg.name.startswith("gemma3"):
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def logits_apply(p, x, cfg):
    """The logits (B,T,V) in x's dtype, a tensor; split over the model
    axis, a :class:`Blocks`: of each model slot's vocabulary block
    (B,T,V/tp), which no slot gathers, or, row-parallel, of the whole
    (B,T,V) on the row's first slot (``dim`` None;
    :func:`_logits_split`)."""
    if isinstance(p["final_ln"], Blocks):
        return _logits_split(p, x, cfg)
    xn = rms_norm(x, p["final_ln"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return torch.einsum("btd,vd->btv", xn, p["tokens"].to(xn.dtype))
    return torch.einsum("btd,dv->btv", xn, p["head"].to(xn.dtype))


# ========================================================= the model axis
# The split forms of a meshed train step (see the module docstring):
# each takes Blocks leaves, whose row runs slot m's work with
# ``row.run(m, fn, *args)`` and moves activations with ``row.send``,
# ``row.scatter`` (sharded.to_model_slots), ``row.reduce``
# (sharded.sum_model_slots) and ``row.concat``
# (sharded.from_model_slots).
def _slot_kv_heads(m: int, hm: int, gp: int) -> tuple[int, int]:
    """The KV heads [lo, hi) that slot m's query heads [m hm, (m+1) hm)
    read, where KV head j serves padded heads [j gp, (j+1) gp)."""
    if gp % hm and hm % gp:
        raise NotImplementedError(
            f"{hm} query heads a slot in groups of {gp}: a slot's heads "
            "would read its KV heads unevenly")
    lo = m * hm // gp
    return lo, lo + max(hm // gp, 1)


def _attn_slot(m, xn, wq, wo, k, v, wk, wv, *, cfg, kind, causal, gp, at,
               keep_kv=False):
    """Slot m's part of split attention: its query heads against its KV
    heads (``k``/``v`` sent to it, or projected here from its ``wk``/
    ``wv`` blocks), the padded heads zeroed by their global index, and
    ``wo``'s matching rows: a partial output (B,T,D), and with
    ``keep_kv`` the k and v it attended.  ``at`` takes a stacked block to
    the layer's (``Blocks.part``)."""
    wq = at(wq)
    b, t, _ = xn.shape
    hm, hd = wq.shape[1], wq.shape[2]
    q = torch.einsum("btd,dhk->bthk", xn, wq.to(xn.dtype))
    cos, sin = rope_tables(torch.arange(t, device=xn.device), hd,
                           cfg.rope_theta)
    if k is None:
        k = torch.einsum("btd,dhk->bthk", xn, at(wk).to(xn.dtype))
        v = torch.einsum("btd,dhk->bthk", xn, at(wv).to(xn.dtype))
        if kind != "nope":
            k = apply_rope(k, cos, sin)
    if kind != "nope":
        q = apply_rope(q, cos, sin)
    kvh = k.shape[2]
    window = cfg.window_size if kind == "local" else 0
    out = _sdpa(q.reshape(b, t, kvh, hm // kvh, hd), k, v, causal=causal,
                window=window).reshape(b, t, hm, hd)
    y = _slot_out(m, out, wo, cfg=cfg, gp=gp, at=at)
    return (y, k, v) if keep_kv else y


def _slot_out(m, out, wo, *, cfg, gp, at):
    """Slot m's attention output (B,T,hm,hd), its padded heads zeroed by
    their global index, through ``wo``'s matching rows: (B,T,D)."""
    hm = out.shape[2]
    g = cfg.num_heads // cfg.num_kv_heads
    if gp != g:                               # padded heads, by global index
        j = m * hm + torch.arange(hm, device=out.device)
        out = out * ((j % gp) < g).to(out.dtype)[:, None]
    return torch.einsum("bthk,hkd->btd", out, at(wo).to(out.dtype))


def _attn_split(p, x, cfg, *, kind, causal, keep_kv=False):
    """``attn_apply`` without a cache on a row's model slots: the norm
    once on the first slot; where ``wk``/``wv`` are split each slot
    projects its own KV heads, else k and v are projected and roped once
    and each slot is sent only the KV heads its query heads read.  With
    ``keep_kv`` also the producers of the k and v it made, (slot, KV
    heads (lo, hi), k, v): each model slot, or the first slot alone
    where ``wk``/``wv`` are replicated."""
    row = p["wq"].row
    tp = len(p["wq"].blocks)
    hm = p["wq"].blocks[0].shape[-2]
    kvh = cfg.num_kv_heads
    gp = hm * tp // kvh
    xn = rms_norm(x, p["ln"].whole, cfg.norm_eps)
    xs = row.scatter(xn)
    ks = vs = wks = wvs = (None,) * tp
    split_kv = p["wk"].dim is not None
    if not split_kv:
        wk, wv = p["wk"].whole, p["wv"].whole
        k = torch.einsum("btd,dhk->bthk", xn, wk.to(xn.dtype))
        v = torch.einsum("btd,dhk->bthk", xn, wv.to(xn.dtype))
        if kind != "nope":
            cos, sin = rope_tables(torch.arange(x.shape[1], device=x.device),
                                   k.shape[-1], cfg.rope_theta)
            k = apply_rope(k, cos, sin)
        ranges = [_slot_kv_heads(m, hm, gp) for m in range(tp)]
        ks = row.scatter(k, dim=2, ranges=ranges)
        vs = row.scatter(v, dim=2, ranges=ranges)
        producers = [(row.slots[0], (0, kvh), k, v)]
    else:
        wks, wvs = p["wk"].blocks, p["wv"].blocks
    parts = [row.run(m, _attn_slot, m, xs[m], p["wq"].blocks[m],
                     p["wo"].blocks[m], ks[m], vs[m], wks[m], wvs[m],
                     cfg=cfg, kind=kind, causal=causal, gp=gp,
                     at=p["wq"].part, keep_kv=keep_kv and split_kv)
             for m in range(tp)]
    if keep_kv and split_kv:
        kvm = kvh // tp
        producers = [(row.slots[m], (m * kvm, (m + 1) * kvm), *parts[m][1:])
                     for m in range(tp)]
        parts = [o[0] for o in parts]
    y = x + row.reduce(parts)
    return (y, producers) if keep_kv else y


def _cross_slot(m, xn, wq, wo, k, v, enc, wk, wv, kv_len, *, cfg, gp, at):
    """Slot m's part of split cross-attention: its query heads, unroped,
    against its KV heads (``k``/``v`` sent to it, or projected here from
    its replica ``enc`` of the encoder's output through its ``wk``/``wv``
    blocks), non-causal, then ``wo``'s matching rows: a partial (B,T,D)."""
    wq = at(wq)
    b, t, _ = xn.shape
    hm, hd = wq.shape[1], wq.shape[2]
    q = torch.einsum("btd,dhk->bthk", xn, wq.to(xn.dtype))
    if k is None:
        k = torch.einsum("bsd,dhk->bshk", enc, at(wk).to(enc.dtype))
        v = torch.einsum("bsd,dhk->bshk", enc, at(wv).to(enc.dtype))
    kvh = k.shape[2]
    out = _sdpa(q.reshape(b, t, kvh, hm // kvh, hd), k, v, causal=False,
                window=0, kv_len=kv_len).reshape(b, t, hm, hd)
    return _slot_out(m, out, wo, cfg=cfg, gp=gp, at=at)


def _cross_split(p, x, cfg, enc: Replicas, *, kv_len=None):
    """Cross-attention (``attn_apply`` with ``kv_override``) on a row's
    model slots, from the encoder's output ``enc``: the norm once on the
    first slot, each slot on its query heads with no rope.  Where
    ``wk``/``wv`` are split each slot projects its own KV heads from its
    own replica of ``enc`` (one a model slot); else k and v are projected
    once from the first slot's and each slot is sent only the KV heads its
    query heads read.  The partials are summed in slot order on the first
    slot."""
    row = p["wq"].row
    tp = len(p["wq"].blocks)
    hm = p["wq"].blocks[0].shape[-2]
    gp = hm * tp // cfg.num_kv_heads
    none = (None,) * tp
    xn = rms_norm(x, p["ln"].whole, cfg.norm_eps)
    xs = row.scatter(xn)
    if p["wk"].dim is not None:
        if len(enc.blocks) != tp:
            raise ValueError(f"cross-attention with wk/wv split over {tp} "
                             f"model slots reads a replica of the "
                             f"encoder's output on each, got "
                             f"{len(enc.blocks)}")
        ks = vs = none
        encs, wks, wvs = enc.blocks, p["wk"].blocks, p["wv"].blocks
    else:
        e = enc.blocks[0]
        k = torch.einsum("bsd,dhk->bshk", e, p["wk"].whole.to(e.dtype))
        v = torch.einsum("bsd,dhk->bshk", e, p["wv"].whole.to(e.dtype))
        ranges = [_slot_kv_heads(m, hm, gp) for m in range(tp)]
        ks = row.scatter(k, dim=2, ranges=ranges)
        vs = row.scatter(v, dim=2, ranges=ranges)
        encs = wks = wvs = none
    lens = none if kv_len is None \
        else tuple(row.send_to(kv_len, m) for m in range(tp))
    parts = [row.run(m, _cross_slot, m, xs[m], p["wq"].blocks[m],
                     p["wo"].blocks[m], ks[m], vs[m], encs[m], wks[m],
                     wvs[m], lens[m], cfg=cfg, gp=gp, at=p["wq"].part)
             for m in range(tp)]
    return x + row.reduce(parts)


# ------------------------------------------------ serving on the model axis
def write_plan(spans, heads, *, rows=None, pos=None) -> list:
    """Where a step's new cache rows go, for a cache whose slots hold the
    blocks ``spans`` (per slot, ((p0, p1), (h0, h1)) or None) and whose
    new k/v lie with producers holding the KV heads ``heads`` (a list of
    (lo, hi)): (slot j, producer, what j receives) for each slot with a
    block, in slot order, where the producer is the one whose heads are
    the block's.  To prefill (``rows``: every sequence's rows [0, rows)),
    what it receives is the positions (lo, hi) of its span; to decode
    (``pos``: each sequence's write position), the (sequence, position)
    pairs in its span.  Slots receiving nothing are left out."""
    out = []
    for j, sp in enumerate(spans):
        if sp is None:
            continue
        (p0, p1), hs = sp
        k = heads.index(hs)
        if rows is not None:
            lo, hi = p0, min(p1, rows)
            if lo < hi:
                out.append((j, k, (lo, hi)))
            continue
        got = [(i, q) for i, q in enumerate(pos) if p0 <= q < p1]
        if got:
            out.append((j, k, got))
    return out


def query_plan(span_heads, hm: int, gp: int, tp: int) -> list:
    """The query heads a block of KV heads [h0, h1) serves, [h0 gp,
    h1 gp), as pieces (model slot m, lo, hi) of the slots' own heads
    [m hm, (m + 1) hm), in slot order."""
    lo, hi = span_heads[0] * gp, span_heads[1] * gp
    return [(m, max(lo, m * hm), min(hi, (m + 1) * hm)) for m in range(tp)
            if max(lo, m * hm) < min(hi, (m + 1) * hm)]


def _put_rows(block, piece, at: int):
    """Prefill: ``piece`` (B,n,...) into ``block`` from position ``at``."""
    block[:, at:at + piece.shape[1]].copy_(piece)
    return block


def _put_tokens(block, piece, seqs: list, cols: list):
    """Decode: ``piece`` (n,1,...) into ``block`` at (seqs[i], cols[i])."""
    dev = block.device
    if seqs == list(range(seqs[0], seqs[-1] + 1)) and len(set(cols)) == 1:
        block[seqs[0]:seqs[-1] + 1, cols[0]].copy_(piece[:, 0])
    else:
        block[torch.tensor(seqs, device=dev), torch.tensor(cols, device=dev)] \
            = piece[:, 0].to(block.dtype)
    return block


def _pick(t, seqs: list):
    """The rows ``seqs`` of ``t``: a slice where they are consecutive."""
    if seqs == list(range(seqs[0], seqs[-1] + 1)):
        return t[seqs[0]:seqs[-1] + 1]
    return t[torch.tensor(seqs, device=t.device)]


def _write_cache(cache, producers, *, keys=("k", "v"), rows=None,
                 pos=None):
    """The new rows into every block of ``cache`` (its leaves ``keys`` of
    :class:`CacheBlocks`: {"k", "v"}, or MLA's {"ckv", "krope"}) that
    holds them, each sent from its producer (slot, heads, one new tensor
    for each key) and written by the slot that holds the block
    (:func:`write_plan`)."""
    ck = cache[keys[0]]
    row = ck.row
    plan = write_plan(ck.spans, [pr[1] for pr in producers], rows=rows,
                      pos=pos)
    for j, k, got in plan:
        src = producers[k][0]
        for new, c in zip(producers[k][2:], (cache[key] for key in keys)):
            block = c.part(c.blocks[j])
            p0 = c.spans[j][0][0]
            if rows is not None:
                lo, hi = got
                row.run_at(j, _put_rows, block,
                           row.send(new[:, lo:hi], src, j), lo - p0)
            else:
                seqs = [i for i, _ in got]
                row.run_at(j, _put_tokens, block,
                           row.send(_pick(new, seqs), src, j), seqs,
                           [q - p0 for _, q in got])


def _ring_rows(k, w: int):
    """A prefill's rows of a ring of ``w`` slots: k itself below w, else
    its last w rows rolled so that position p sits in slot p % w."""
    t = k.shape[1]
    if t < w:
        return k
    return torch.roll(k[:, -w:], shifts=(t - w) % w, dims=1)


def _rope_at(x, positions, cfg, kind):
    if kind == "nope":
        return x
    cos, sin = rope_tables(positions, x.shape[-1], cfg.rope_theta)
    return apply_rope(x, cos, sin)


def _decode_slot_qkv(xn, wq, wk, wv, off, *, cfg, kind, at):
    """Slot's new token: its query heads, and where it holds ``wk``/
    ``wv`` blocks its KV heads, roped at positions ``off`` (B,)."""
    pos = off[:, None]
    q = _rope_at(torch.einsum("btd,dhk->bthk", xn, at(wq).to(xn.dtype)), pos,
                 cfg, kind)
    if wk is None:
        return q, None, None
    k = _rope_at(torch.einsum("btd,dhk->bthk", xn, at(wk).to(xn.dtype)), pos,
                 cfg, kind)
    return q, k, torch.einsum("btd,dhk->bthk", xn, at(wv).to(xn.dtype))


def _decode_slot_heads(m, q, wo, kc, vc, off, *, cfg, kind, gp, at):
    """Slot m's decode over its own KV heads' whole cache (a cache split by
    KV heads): its query heads through the decode_attention route of the
    unsplit step, then ``wo``'s rows."""
    b, _, hm, hd = q.shape
    kvh = kc.shape[2]
    qg = q.reshape(b, 1, kvh, hm // kvh, hd)
    if kind == "local":
        out = _ring_attention(qg, kc, vc, off)
    else:
        out = _sdpa(qg, kc, vc, causal=True, window=0, q_pos0=off,
                    kv_len=off + 1)
    return _slot_out(m, out.reshape(b, 1, hm, hd), wo, cfg=cfg, gp=gp, at=at)


def _decode_slot_partial(qs, kc, vc, off, *, p0: int, cap: int):
    """A slot's decode over its block of a sequence-split cache, the
    positions [p0, p0 + n) of a cache of ``cap`` (a ring's w): the query
    heads its KV heads serve (pieces ``qs`` (B,1,*,hd), in head order)
    against the positions written so far, min(off + 1, cap) of them:
    (out, lse) of decode_attention_partial."""
    q = qs[0] if len(qs) == 1 else torch.cat(qs, dim=2)
    n = kc.shape[1]
    lengths = torch.clamp(torch.clamp(off + 1, max=cap) - p0, min=0, max=n)
    return K.decode_attention_partial(q[:, 0], *_page_view(kc, vc),
                                      lengths.to(torch.int32))


def _wo_slot(out, wo, *, at):
    return torch.einsum("bthk,hkd->btd", out, at(wo).to(out.dtype))


def _attn_split_serve(p, x, cfg, *, kind, causal, positions, cache,
                      cache_len):
    """``attn_apply`` with a cache (prefill, t > 1, or decode) on a row's
    model slots, each on its query heads; the norm, and the k/v
    projections and rope where ``wk``/``wv`` are replicated, once on the
    row's first slot.  The new k/v rows go to the slots whose blocks
    hold their positions and heads (:func:`_write_cache`).  Prefill
    attends the prompt at each slot's heads, as training does.  Decode
    over a cache split by KV heads: each slot over its own heads' cache;
    split by positions: each slot holding a block runs
    decode_attention_partial for the query heads its KV heads serve
    (gathered onto it), the partials merged in slot order on the first
    slot (``merge_partials``), each model slot sent its heads for
    ``wo``; the partial outputs summed in slot order."""
    from ..kernels.decode_attention import merge_partials

    row = p["wq"].row
    b, t, _ = x.shape
    ck = cache["k"]
    cap = ck.size[0]
    if t > 1:                                        # ---- prefill
        if positions is not None:
            raise NotImplementedError(
                "a split prefill at given positions: it fills from 0")
        y, producers = _attn_split(p, x, cfg, kind=kind, causal=causal,
                                   keep_kv=True)
        if kind == "local":                          # the ring's layout
            producers = [(j, hs, *(row.run_at(j, _ring_rows, c, cap)
                                   for c in kv))
                         for j, hs, *kv in producers]
        _write_cache(cache, producers, rows=producers[0][2].shape[1])
        return y

    # ---- decode (t == 1): positions are the write offsets, off[:, None]
    tp = len(p["wq"].blocks)
    hm = p["wq"].blocks[0].shape[-2]
    kvh = cfg.num_kv_heads
    gp = hm * tp // kvh
    at = p["wq"].part
    first = row.slots[0]
    split_kv = p["wk"].dim is not None
    kvm = kvh // tp if split_kv else kvh
    heads = [(m * kvm, (m + 1) * kvm) for m in range(tp)] if split_kv \
        else [(0, kvh)]
    xn = rms_norm(x, p["ln"].whole, cfg.norm_eps)
    xs = row.scatter(xn)
    wq, wo = p["wq"].blocks, p["wo"].blocks
    wks, wvs = (p["wk"].blocks, p["wv"].blocks) if split_kv \
        else ((None,) * tp, (None,) * tp)
    off = attn_decode_pos(cache_len, b, device=x.device)
    offs = {first: off}

    def off_at(j):
        if j not in offs:
            offs[j] = row.send(off, first, j)
        return offs[j]

    qkv = [row.run(m, _decode_slot_qkv, xs[m], wq[m], wks[m], wvs[m],
                   off_at(row.slots[m]), cfg=cfg, kind=kind, at=at)
           for m in range(tp)]
    if split_kv:
        producers = [(row.slots[m], heads[m], qkv[m][1], qkv[m][2])
                     for m in range(tp)]
    else:
        wk, wv = p["wk"].whole, p["wv"].whole
        k = _rope_at(torch.einsum("btd,dhk->bthk", xn, wk.to(xn.dtype)),
                     off[:, None], cfg, kind)
        v = torch.einsum("btd,dhk->bthk", xn, wv.to(xn.dtype))
        producers = [(first, heads[0], k, v)]
    if kind == "local":
        pos = [o % cap for o in ck.offsets]
    else:
        pos = [min(max(o, 0), cap - 1) for o in ck.offsets]
    _write_cache(cache, producers, pos=pos)

    def blocks_at(j):
        return tuple(c.part(c.blocks[j]) for c in (cache["k"], cache["v"]))

    readers = ck.readers()
    if all(sp[0] == (0, cap) for _, sp in readers):  # ---- by KV heads
        if [j for j, _ in readers] != list(row.slots):
            raise ValueError("a cache split by KV heads whose blocks are "
                             "not on the row's model slots")
        parts = [row.run(m, _decode_slot_heads, m, qkv[m][0], wo[m],
                         *blocks_at(row.slots[m]), off_at(row.slots[m]),
                         cfg=cfg, kind=kind, gp=gp, at=at)
                 for m in range(tp)]
        return x + row.reduce(parts)

    by_heads = {}                                    # ---- by positions
    for j, ((p0, _), hs) in readers:
        qs = [row.send(qkv[m][0][:, :, lo - m * hm:hi - m * hm],
                       row.slots[m], j)
              for m, lo, hi in query_plan(hs, hm, gp, tp)]
        o, lse = row.run_at(j, _decode_slot_partial, qs, *blocks_at(j),
                            off_at(j), p0=p0, cap=cap)
        by_heads.setdefault(hs, []).append((row.send(o, j, first),
                                            row.send(lse, j, first)))
    out = torch.cat([merge_partials([o for o, _ in by_heads[hs]],
                                    [s for _, s in by_heads[hs]],
                                    dtype=x.dtype)
                     for hs in sorted(by_heads)], dim=1)
    out = _head_mask(out[:, None], cfg.num_heads, kvh)
    outs = row.scatter(out, dim=2, ranges=[(m * hm, (m + 1) * hm)
                                           for m in range(tp)])
    parts = [row.run(m, _wo_slot, outs[m], wo[m], at=at) for m in range(tp)]
    return x + row.reduce(parts)


def _mla_slot(cq, ckv, k_rope, wuq, wukv, wo, off, *, cfg, lo: int, dtype,
              at):
    """Slot's MLA heads, its blocks of ``wuq``/``wukv``/``wo`` (global
    heads [lo, lo + hm)) taken to the layer's by ``at``
    (:func:`_mla_heads`): causal over the t positions of ``ckv``/
    ``k_rope`` (``off`` None: training and prefill), or to decode, the
    query at each sequence's position ``off`` (B,) over the compressed
    cache's blocks (lists, in position order), concatenated here on the
    slot and dropped when it returns."""
    if isinstance(ckv, list):
        ckv, k_rope = (c[0] if len(c) == 1 else torch.cat(c, dim=1)
                       for c in (ckv, k_rope))
    if off is None:
        positions = torch.arange(cq.shape[1], device=cq.device)
        q_pos0, kv_len = 0, None
    else:
        positions, q_pos0, kv_len = off[:, None], off, off + 1
    rope = rope_tables(positions, cfg.mla.qk_rope_head_dim, cfg.rope_theta)
    return _mla_heads(cq, ckv, k_rope, at(wuq), at(wukv), at(wo), cfg=cfg,
                      rope=rope, q_pos0=q_pos0, kv_len=kv_len, lo=lo,
                      dtype=dtype)


def _mla_latent_split(p, x, cfg, positions):
    """:func:`_mla_latent` on the row's first slot, roped at
    ``positions``."""
    rope = rope_tables(positions, cfg.mla.qk_rope_head_dim, cfg.rope_theta)
    return _mla_latent(x, *(p[k].whole for k in ("ln", "wdq", "q_ln",
                                                 "wdkv", "kv_ln")), cfg, rope)


def _mla_split(p, x, cfg, *, keep=False):
    """``mla_apply`` without a cache on a row's model slots: what the
    reference does not split (the norm, ``wdq`` with ``q_ln``, ``wdkv``
    with ``kv_ln``, the shared rope key) once on the first slot, which
    sends ``cq``, ``ckv`` and ``k_rope`` to each model slot; each slot
    runs its own heads' ``wuq``/``wukv``/``wo`` blocks
    (:func:`_mla_slot`), and the partial outputs are summed in slot
    order on the first slot, the reference's ``shard(y, DP, None,
    None)``.  With ``keep`` also (ckv, k_rope), for the cache."""
    row = p["wuq"].row
    hm = p["wuq"].blocks[0].shape[-2]
    lat = _mla_latent_split(p, x, cfg,
                            torch.arange(x.shape[1], device=x.device))
    cqs, ckvs, krs = (row.scatter(a) for a in lat)
    parts = [row.run(m, _mla_slot, cqs[m], ckvs[m], krs[m],
                     p["wuq"].blocks[m], p["wukv"].blocks[m],
                     p["wo"].blocks[m], None, cfg=cfg, lo=m * hm,
                     dtype=x.dtype, at=p["wuq"].part)
             for m in range(len(cqs))]
    y = x + row.reduce(parts)
    return (y, lat[1:]) if keep else y


def _mla_split_serve(p, x, cfg, *, positions, cache, cache_len):
    """``mla_apply`` with a cache (prefill, t > 1, or decode) on a row's
    model slots; the compressed caches ``ckv``/``krope`` split by
    positions over the model axis (:class:`CacheBlocks` with one "head",
    span (0, 1)).  Prefill runs :func:`_mla_split` and writes each new
    row to the slot whose block holds its position (:func:`_write_cache`
    from the first slot).  Decode computes the token's latents on the
    first slot and writes them the same way; then each model slot is
    sent every block of the layer's compressed caches, in position order,
    and runs its heads over the whole of them exactly as the unsplit
    step does (:func:`_mla_slot`), the partial outputs summed in slot
    order.  The gathered copy lives for that slot's work only: the
    caches stay split."""
    row = p["wuq"].row
    b, t, _ = x.shape
    first = row.slots[0]
    keys = ("ckv", "krope")
    cc = cache["ckv"]
    if t > 1:                                        # ---- prefill
        if positions is not None:
            raise NotImplementedError(
                "a split prefill at given positions: it fills from 0")
        y, (ckv, k_rope) = _mla_split(p, x, cfg, keep=True)
        _write_cache(cache, [(first, (0, 1), ckv, k_rope)], keys=keys,
                     rows=t)
        return y
    # ---- decode (t == 1)
    hm = p["wuq"].blocks[0].shape[-2]
    off = attn_decode_pos(cache_len, b, device=x.device)
    cq, ckv, k_rope = _mla_latent_split(p, x, cfg, off[:, None])
    cap = cc.size[0]
    _write_cache(cache, [(first, (0, 1), ckv, k_rope)], keys=keys,
                 pos=[min(max(o, 0), cap - 1) for o in cc.offsets])
    held = sorted(cc.readers(), key=lambda r: r[1][0][0])
    if any(j not in row.slots for j, _ in held):
        raise NotImplementedError(
            "MLA split over the model axis with its compressed caches' "
            "positions on other data rows' slots (long mode, decode at "
            "batch 1): no configuration serves MLA so")
    cqs = row.scatter(cq)

    def slot(m):
        j = row.slots[m]
        blocks = [[row.send(c.part(c.blocks[i]), i, j) for i, _ in held]
                  for c in (cache["ckv"], cache["krope"])]
        return row.run(m, _mla_slot, cqs[m], *blocks, p["wuq"].blocks[m],
                       p["wukv"].blocks[m], p["wo"].blocks[m],
                       off if j == first else row.send(off, first, j),
                       cfg=cfg, lo=m * hm, dtype=x.dtype, at=p["wuq"].part)

    return x + row.reduce([slot(m) for m in range(len(cqs))])


def _mlp_slot(xn, wg, wi, wo, *, act, at):
    wg, wi, wo = at(wg), at(wi), at(wo)
    a = _act(act)(torch.einsum("btd,df->btf", xn, wg.to(xn.dtype)))
    u = torch.einsum("btd,df->btf", xn, wi.to(xn.dtype))
    h = a * u
    return torch.einsum("btf,fd->btd", h, wo.to(h.dtype))


def _mlp_split(p, x, cfg):
    """``mlp_apply`` on a row's model slots: each slot's columns of
    ``w_gate``/``w_in`` and rows of ``w_out``, the partials summed; on
    the first slot whole where the spec does not split ``d_ff``."""
    if p["w_in"].dim is None:
        return mlp_apply({k: v.whole for k, v in p.items()}, x, cfg)
    row = p["w_in"].row
    xn = rms_norm(x, p["ln"].whole, cfg.norm_eps)
    xs = row.scatter(xn)
    parts = [row.run(m, _mlp_slot, xs[m], p["w_gate"].blocks[m],
                     p["w_in"].blocks[m], p["w_out"].blocks[m], act=cfg.act,
                     at=p["w_in"].part)
             for m in range(len(xs))]
    return x + row.reduce(parts)


def _moe_split(p, x, cfg):
    """``moe_apply`` on a row's model slots.  The row's first slot runs
    the norm, the router and the dispatch over the row's tokens (the
    capacity a data shard's, as under the reference's ``shard_map``);
    where the spec splits the experts (``w_in`` along its dim 0), each
    slot is sent its experts' rows of the buffer, runs their MLPs on its
    blocks, and the outputs come back to the first slot concatenated in
    slot order (``sharded.from_model_slots``), where the combine runs as
    unsplit; where it does not, the whole of it runs on the first slot.
    A shared expert runs as :func:`_mlp_split`: each slot on its
    columns, the partials summed in slot order."""
    row = p["router"].row
    xn = rms_norm(x, p["ln"].whole, cfg.norm_eps)
    if p["w_in"].dim is None:
        y, aux = _moe_local(xn, p["router"].whole, p["w_gate"].whole,
                            p["w_in"].whole, p["w_out"].whole, cfg=cfg)
    else:
        eb, route, aux = _moe_dispatch(xn, p["router"].whole, cfg=cfg)
        tp = len(p["w_in"].blocks)
        em = eb.shape[0] // tp
        ebs = row.scatter(eb, dim=0, ranges=[(m * em, (m + 1) * em)
                                             for m in range(tp)])
        obs = [row.run(m, _moe_experts, ebs[m], p["w_gate"].blocks[m],
                       p["w_in"].blocks[m], p["w_out"].blocks[m],
                       act=cfg.act, at=p["w_in"].part)
               for m in range(tp)]
        y = _moe_combine(row.concat(obs, dim=0), route, xn)
    if cfg.moe.num_shared:
        sp = p["shared"]
        if sp["w_in"].dim is None:
            y = y + _mlp_slot(xn, sp["w_gate"].whole, sp["w_in"].whole,
                              sp["w_out"].whole, act=cfg.act,
                              at=lambda w: w)
        else:
            xs = row.scatter(xn)
            y = y + row.reduce([row.run(m, _mlp_slot, xs[m],
                                        sp["w_gate"].blocks[m],
                                        sp["w_in"].blocks[m],
                                        sp["w_out"].blocks[m], act=cfg.act,
                                        at=sp["w_in"].part)
                                for m in range(len(xs))])
    return x + y, aux


def _embed_slot(tokens, table, lo: int, *, dtype, at):
    """Slot's rows of the embedding: the rows of its vocabulary block
    [lo, lo + V/tp) in ``dtype``, zeros for tokens outside it."""
    table = at(table)
    local = tokens.long() - lo
    inside = (local >= 0) & (local < table.shape[0])
    x = table[local.clamp(0, table.shape[0] - 1)].to(dtype)
    return x * inside[..., None].to(dtype)


def _embed_cols(tokens, table, *, dtype, at):
    """Slot's ``d_model`` columns of every token's row, in ``dtype``."""
    return at(table)[tokens.long()].to(dtype)


def _embed_split(tab: Blocks, tokens, cfg):
    """The lookup on a row's model slots.  Where the spec splits the
    table by vocabulary rows, each slot looks up the tokens in its rows
    and the rows are summed: one slot's row is non-zero for each token,
    so the sum is the row itself, exactly.  Where the vocabulary does not
    divide the model degree (the reference's row-parallel fallback, the
    table split along ``d_model``), each slot looks up its columns of
    every token's row, concatenated in slot order on the first slot:
    exact too."""
    row = tab.row
    dt = getattr(torch, cfg.dtype)
    if tab.dim == 1:
        return row.concat([row.run(m, _embed_cols, row.send_to(tokens, m),
                                   blk, dtype=dt, at=tab.part)
                           for m, blk in enumerate(tab.blocks)], dim=2)
    vb = tab.blocks[0].shape[len(tab.index)]
    parts = [row.run(m, _embed_slot, row.send_to(tokens, m), blk, m * vb,
                     dtype=dt, at=tab.part)
             for m, blk in enumerate(tab.blocks)]
    return row.reduce(parts)


def _logits_slot(xn, w, *, tied: bool, at):
    """Slot's block of the logits (B,T,V/tp) in fp32 and its maximum
    (B,T), which takes no gradient."""
    lg = _logits_block(xn, w, tied=tied, at=at, f32=True)
    return lg, _top(lg)


def _logits_block(xn, w, *, tied: bool, at, f32: bool = False):
    """Slot's product of ``xn`` with its block of the logits' weight, in
    xn's dtype (``f32``: then widened to fp32): its vocabulary block of
    the logits (B,T,V/tp), or, from its ``d_model`` columns of ``xn``, its
    partial sum of all of them (B,T,V)."""
    w = at(w)
    if tied:
        lg = torch.einsum("btd,vd->btv", xn, w.to(xn.dtype))
    else:
        lg = torch.einsum("btd,dv->btv", xn, w.to(xn.dtype))
    return lg.float() if f32 else lg


def vocab_rows(dim, tied: bool) -> bool:
    """Whether the logits' weight (the table where ``tied``, else the
    head), split over the model axis along ``dim``, is split by
    vocabulary rows (else along ``d_model``: the row-parallel
    fallback)."""
    return dim == (0 if tied else 1)


def _row_parallel(w: Blocks, xn, cfg, *, f32: bool = False) -> list:
    """Each model slot's partial product (B,T,V), on that slot, of ``xn``
    (B,T,D) on the row's first slot, the logits' weight split along
    ``d_model``: each slot sent its columns of ``xn``."""
    row = w.row
    tp = len(w.blocks)
    dm = xn.shape[-1] // tp
    xs = row.scatter(xn, dim=2, ranges=[(m * dm, (m + 1) * dm)
                                        for m in range(tp)])
    return [row.run(m, _logits_block, xs[m], w.blocks[m],
                    tied=cfg.tie_embeddings, at=w.part, f32=f32)
            for m in range(tp)]


def vocab_blocks(v: int, tp: int) -> list:
    """The row-parallel loss's vocabulary blocks, [lo, hi) for each model
    slot: ceil(v / tp) each and the last the rest, as GSPMD pads an
    uneven split."""
    vb = -(-v // tp)
    return [(min(m * vb, v), min((m + 1) * vb, v)) for m in range(tp)]


def _logits_split(p, x, cfg) -> Blocks:
    """``logits_apply`` on a row's model slots, the norm on the first
    slot.  Split by vocabulary rows: each slot's vocabulary block of the
    logits kept on that slot, a :class:`Blocks` split along the
    vocabulary (dim 2), as the reference's logits spec lays them out.
    Split along ``d_model`` (the row-parallel fallback, the vocabulary
    not divisible by the model degree): the slots' partials
    (:func:`_row_parallel`) summed in slot order on the first slot, a
    :class:`Blocks` of that one whole tensor (``dim`` None), which the
    reference's logits spec replicates over the model axis."""
    w = p["tokens"] if cfg.tie_embeddings else p["head"]
    row = w.row
    xn = rms_norm(x, p["final_ln"].whole, cfg.norm_eps)
    if not vocab_rows(w.dim, cfg.tie_embeddings):
        return Blocks((row.reduce(_row_parallel(w, xn, cfg)),), row)
    xs = row.scatter(xn)
    return Blocks(tuple(row.run(m, _logits_block, xs[m], w.blocks[m],
                                tied=cfg.tie_embeddings, at=w.part)
                        for m in range(len(w.blocks))), row, 2)


def _xent_slot(lg, top, labels, lo: int):
    """Slot's sum of exp(logit - top) over its vocabulary block and the
    gold logit where the label falls in it (else 0), stacked (2,B,T)."""
    local = labels.long() - lo
    inside = (local >= 0) & (local < lg.shape[-1])
    gold = torch.gather(lg, -1, local.clamp(0, lg.shape[-1] - 1)[..., None])
    return torch.stack([torch.exp(lg - top[..., None]).sum(dim=-1),
                        gold[..., 0] * inside])


def _top(lg):
    """A block of the logits' maximum (B,T), which takes no gradient."""
    return lg.detach().amax(dim=-1)


def xent_terms(p, x, labels, cfg):
    """(lse, gold), each (B,T) fp32 on the row's first slot: the
    log-sum-exp of the logits of ``x`` (B,T,D) and the logit of each
    label, from each model slot's block of the vocabulary, where no slot
    holds the whole (B,T,V): the maximum is each slot's, taken over the
    slots; the sums of exp and the gold logits (one slot's is non-zero)
    are summed in slot order.  Split by vocabulary rows, a slot's block
    is its product with its rows of the weight.  Split along ``d_model``
    (the row-parallel fallback), it is the slot-order sum of every
    slot's fp32 partial (:func:`_row_parallel`) over the slot's block of
    :func:`vocab_blocks`, summed on that slot (``ModelRow.
    reduce_scatter``), as the reference's logits constraint (DP, None,
    "model") has GSPMD split the partial sum."""
    w = p["tokens"] if cfg.tie_embeddings else p["head"]
    row = w.row
    tp = len(w.blocks)
    xn = rms_norm(x, p["final_ln"].whole, cfg.norm_eps)
    if vocab_rows(w.dim, cfg.tie_embeddings):
        xs = row.scatter(xn)
        out = [row.run(m, _logits_slot, xs[m], w.blocks[m],
                       tied=cfg.tie_embeddings, at=w.part)
               for m in range(tp)]
        vb = out[0][0].shape[-1]
        los = [m * vb for m in range(tp)]
    else:
        ranges = vocab_blocks(cfg.vocab_size, tp)
        lgs = row.reduce_scatter(_row_parallel(w, xn, cfg, f32=True), ranges)
        out = [(lg, row.run(m, _top, lg)) for m, lg in enumerate(lgs)]
        los = [lo for lo, _ in ranges]
    top = out[0][1]
    for m in range(1, tp):
        top = torch.maximum(top, row.send_from(out[m][1], m))
    terms = row.reduce([row.run(m, _xent_slot, out[m][0],
                                row.send_to(top, m),
                                row.send_to(labels, m), los[m])
                        for m in range(tp)])
    return top + torch.log(terms[0]), terms[1]
