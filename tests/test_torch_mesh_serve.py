"""Serving on the model axis (``launch/serve.py::MeshServe``) on 8 CPU
slots: the split prefill and decode steps of the ten architectures,
every one of which splits (llama3.2-3b, gemma3-12b/27b, internvl2-76b,
phi3.5-moe, llama4-scout, minicpm3-4b, jamba-v0.1-52b, xlstm-125m and
seamless-m4t-large-v2, whose prefill returns the encoder's output with
a copy on each slot and whose decode reads each slot's own, and the
vocabulary-500 variants of minicpm3-4b, llama3.2-3b, phi3.5-moe and
seamless, which degree 8 does not divide, and the inner-dim-132
variants of jamba and xlstm, whose Mamba and mLSTM layers run whole at
degree 8: each data row's model slots on their own heads, MLP columns
or experts, Mamba channels or rows of mLSTM's C, vocabulary block or
``d_model`` columns and block of every cache) against the gathered
step (the whole
parameters and the row's caches on its first slot) and against the
reference's
``api.prefill`` / ``api.decode`` jitted with the same shardings under
its host mesh of 8 forced devices, at (1, 8), (2, 4) and (4, 2), and in
long mode (decode at batch 1: a global cache's sequence over the data
axes; not MLA) at (2, 4) and (4, 2); the moves of a recorded step (no slot is
written a cache row outside its block, no slot is sent a whole split
parameter); the gathered step itself for the families whose caches
are not (B, S, KVH, hd) (jamba's and xlstm's recurrent states) and the
encoder-decoder (seamless, whose prefill also returns the encoder's
output, which its decode steps take) at (8, 1) and (2, 4), and the two
recurrent families in long mode, against the unmeshed step run on each
data shard's rows and against the reference's sharded jit; and the
decode_attention_partial plain version, merged over any split of the
positions, against ``decode_attention_ref``.

The smokes run in fp32, a prefill of 8 x 16 tokens (after a VLM's
patches; seamless's encoder reads 8 frames) into caches of 32, then 3
decode steps.  Tolerance: each
step's logits and every cache leaf within 1e-5 of their largest
element."""
import collections
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

from repro.configs import SMOKES as J_SMOKES
from repro.launch.mesh import make_host_mesh as j_make_host_mesh
from repro.models import build as jbuild, layers as JL
from repro_torch.configs import SMOKES
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import merge_partials
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import MeshServe, cache_geometry
from repro_torch.models import build, layers as L
from repro_torch.train import sharded as S
from _model_axis import INNER_WHOLE, ROW_PARALLEL, smoke as _smoke
from _torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"
SPLIT = ("llama3.2-3b", "gemma3-12b", "gemma3-27b", "internvl2-76b",
         "phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e", "jamba-v0.1-52b",
         "xlstm-125m", "seamless-m4t-large-v2")
CASES = [(m, False) for m in ((1, 8), (2, 4), (4, 2))] \
    + [(m, True) for m in ((2, 4), (4, 2))]
# MLA (not in long mode, which it does not split), and with a vocabulary
# of 500, which degree 8 does not divide: the row-parallel embedding and
# logits, tied (minicpm3-4b, llama3.2-3b) and untied (phi3.5-moe's head)
MLA = ("minicpm3-4b",) + ROW_PARALLEL
TOL = 1e-5
BATCH, PROMPT, SEQ, STEPS, FRAMES = 8, 16, 32, 3, 8


def _ids(case):
    (d, m), long_mode = case
    return f"{d}x{m}" + ("-long" if long_mode else "")


@functools.lru_cache(maxsize=None)
def _setup(name, tp):
    """The reference's seed-0 parameters at model degree ``tp`` (its
    tree, in numpy) and the inputs: tokens (B, PROMPT + STEPS) and a
    VLM's patches, from a numpy seed."""
    jcfg = _smoke(J_SMOKES, name)
    jp = jax.tree.map(np.asarray, jbuild(jcfg, tp=tp).init_params(0))
    rng = np.random.default_rng(0)
    inp = {"tokens": rng.integers(0, jcfg.vocab_size,
                                  (BATCH, PROMPT + STEPS)).astype(np.int32)}
    if jcfg.num_patches:
        inp["patches"] = rng.standard_normal(
            (BATCH, jcfg.num_patches, jcfg.d_model)).astype(np.float32)
    if jcfg.family == "encdec":
        inp["frames"] = rng.standard_normal(
            (BATCH, FRAMES, jcfg.d_model)).astype(np.float32)
    return jp, inp


def _steps(name, long_mode):
    """(batch of the prefill, list of decode batches) in numpy: batch 1
    in long mode."""
    _, inp = _setup(name, 1)
    b = 1 if long_mode else BATCH
    pre = _smoke(SMOKES, name).num_patches
    first = {"tokens": inp["tokens"][:b, :PROMPT]}
    for k in ("patches", "frames"):
        if k in inp:
            first[k] = inp[k][:b]
    steps = [{"tokens": inp["tokens"][:b, i:i + 1],
              "lengths": np.full((b,), i + pre, np.int32)}
             for i in range(PROMPT, PROMPT + STEPS)]
    return first, steps


def _serve(name, mesh_shape, long_mode, split=True, monkeypatch=None,
           sends=None):
    """The port's MeshServe on 8 CPU slots: (each step's logits, the
    caches after the last step), gathered, in numpy, the serve, the
    caches as laid out, and each step's logits blocks' shapes; ``sends``,
    where given, collects (src, dst, storage) of every move between
    slots."""
    d, m = mesh_shape
    jp, _ = _setup(name, m)
    cfg = _smoke(SMOKES, name)
    api = build(cfg, tp=m)
    mesh = make_host_mesh(devices=[CPU] * (d * m), shape=mesh_shape)
    serve = MeshServe(api, mesh, long_mode=long_mode)
    assert serve.split or not split
    serve.split = split
    first, steps = _steps(name, long_mode)
    b = first["tokens"].shape[0]
    params = serve.params = serve.lay_out_params(
        api.params_from_numpy(jp, CPU))
    caches = serve.init_caches(b, SEQ + cfg.num_patches)
    if sends is not None:
        send = S.send

        def recording(t, mesh_, src, dst, out=None):
            if src is not None and src != dst:
                sends.append((src, dst, t.untyped_storage().data_ptr()))
            return send(t, mesh_, src, dst, out=out)
        monkeypatch.setattr(S, "send", recording)
    logits, shapes = [], []
    with torch.no_grad():
        lg, caches, *enc = serve.prefill(params, serve.lay_out_inputs(
            {k: torch.from_numpy(v) for k, v in first.items()}), caches)
        for batch in [None] + steps:
            if batch is not None:
                inputs = serve.lay_out_inputs(
                    {k: torch.from_numpy(v) for k, v in batch.items()})
                if enc:                     # the encoder's output, laid out
                    inputs["enc_out"] = enc[0]
                lg, caches = serve.decode(params, inputs, caches)
            logits.append(S.gather(lg).numpy().copy())
            shapes.append({tuple(b.shape) for b in lg.blocks})
    if sends is not None:
        monkeypatch.undo()
    return logits, [t.numpy().copy() for t in
                    L.tree_leaves(S.gather_tree(caches))], serve, caches, \
        shapes


@functools.lru_cache(maxsize=None)
def _outputs(name, mesh_shape, long_mode, split=True):
    """:func:`_serve`'s logits, caches, serve and logits blocks' shapes,
    once for each case."""
    out = _serve(name, mesh_shape, long_mode, split=split)
    return out[:3] + out[4:]


@functools.lru_cache(maxsize=None)
def _reference(name, mesh_shape, long_mode):
    """The reference's prefill and decode steps jitted with the port's
    layouts as NamedShardings on its (d, m) host mesh, under its
    ``use_mesh`` (DP resolved to no axes in long mode, as its dry run
    does): each step's logits and the final caches, in numpy."""
    d, m = mesh_shape
    jp, _ = _setup(name, m)
    jcfg = _smoke(J_SMOKES, name)
    api = jbuild(jcfg, tp=m)
    port = MeshServe(build(_smoke(SMOKES, name), tp=m),
                     make_host_mesh(devices=[CPU] * (d * m),
                                    shape=mesh_shape), long_mode=long_mode)
    jmesh = j_make_host_mesh(d * m, shape=mesh_shape)
    first, steps = _steps(name, long_mode)
    b = first["tokens"].shape[0]
    seq = SEQ + jcfg.num_patches

    def ns(spec):
        return NamedSharding(jmesh, JP(*spec))

    c_sh = L.tree_map(lambda p: ns(p), port.cache_specs(b, seq))
    c_sh = jax.tree.unflatten(jax.tree.structure(
        api.cache_defs(b, seq, long_mode=long_mode),
        is_leaf=lambda x: isinstance(x, JL.ParamDef)), L.tree_leaves(c_sh))
    caches = JL.init_tree(api.cache_defs(b, seq, long_mode=long_mode))
    lg_sh = ns(port.logits_spec)

    def in_sh(batch):
        return {k: ns(lay.spec) for k, lay in port.input_layouts(
            {k: torch.from_numpy(v) for k, v in batch.items()}).items()}

    encdec = jcfg.family == "encdec"
    enc_sh = ns(port.input_layout(3).spec)
    with JL.use_mesh(jmesh, () if long_mode else ("data",)):
        p_sh = jax.tree.map(ns, api.param_pspecs(),
                            is_leaf=lambda x: isinstance(x, JP))
        prefill = jax.jit(api.prefill, in_shardings=(p_sh, in_sh(first),
                                                     c_sh),
                          out_shardings=(lg_sh, c_sh) + ((enc_sh,)
                                                         if encdec else ()))
        lg, caches, *enc = prefill(jp, first, caches)
        logits = [np.asarray(lg)]
        extra = {"enc_out": enc[0]} if encdec else {}
        d_sh = {**in_sh(steps[0]), **{k: enc_sh for k in extra}}
        decode = jax.jit(api.decode, in_shardings=(p_sh, d_sh, c_sh),
                         out_shardings=(lg_sh, c_sh))
        for batch in steps:
            lg, caches = decode(jp, {**batch, **extra}, caches)
            logits.append(np.asarray(lg))
    return logits, [np.asarray(a) for a in jax.tree.leaves(caches)]


def _unmeshed(name, mesh_shape, long_mode):
    """The port's unmeshed ``api.prefill`` / ``api.decode`` on each data
    shard's rows of the batch (the meshed step's MoE capacity is a
    shard's, as the reference's under ``shard_map``; the whole batch in
    long mode), the shards' logits and caches concatenated along the
    batch: (each step's logits, the final caches), in numpy."""
    d, m = mesh_shape
    jp, _ = _setup(name, m)
    cfg = _smoke(SMOKES, name)
    api = build(cfg, tp=m)
    params = api.params_from_numpy(jp, CPU)
    first, steps = _steps(name, long_mode)
    b = first["tokens"].shape[0]
    shards = 1 if long_mode else d
    seq = SEQ + cfg.num_patches
    logits, caches = [], []
    with torch.no_grad():
        for r in range(shards):
            rows = slice(r * b // shards, (r + 1) * b // shards)
            c = L.init_tree(api.cache_defs(b // shards, seq), 0, CPU)
            lg, c, *enc = api.prefill(params, {
                k: torch.from_numpy(v[rows]) for k, v in first.items()}, c)
            out = [lg]
            for batch in steps:
                inputs = {k: torch.from_numpy(v[rows])
                          for k, v in batch.items()}
                if enc:
                    inputs["enc_out"] = enc[0]
                lg, c = api.decode(params, inputs, c)
                out.append(lg)
            logits.append(out)
            caches.append(L.tree_leaves(c))
    leads = [g.lead for g in L.tree_leaves(cache_geometry(api))]
    return ([torch.cat(step).numpy() for step in zip(*logits)],
            [torch.cat(leaf, dim=lead).numpy()
             for leaf, lead in zip(zip(*caches), leads)])


def _hold(got, want, what):
    for i, (a, w) in enumerate(zip(got, want)):
        assert a.shape == w.shape, (what, i, a.shape, w.shape)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(a - w).max())
        assert err <= TOL * scale, (what, i, err, scale)


@pytest.mark.parametrize("case", CASES, ids=_ids)
@pytest.mark.parametrize("name", SPLIT)
def test_split_serving_equals_the_gathered_step(name, case):
    """Each step's logits (gathered from the slots' vocabulary blocks)
    and the caches (gathered from the slots' blocks) of the split step
    against the gathered step's on the same layouts."""
    mesh_shape, long_mode = case
    lg, caches, _, _ = _outputs(name, mesh_shape, long_mode)
    lg_g, caches_g, _, _ = _outputs(name, mesh_shape, long_mode,
                                    split=False)
    _hold(lg, lg_g, (name, case, "logits"))
    _hold(caches, caches_g, (name, case, "caches"))


@pytest.mark.parametrize("case", CASES, ids=_ids)
@pytest.mark.parametrize("name", SPLIT)
def test_split_serving_equals_the_references_sharded_jit(spmd_devices, name,
                                                         case):
    mesh_shape, long_mode = case
    lg, caches, _, _ = _outputs(name, mesh_shape, long_mode)
    want_lg, want_caches = _reference(name, mesh_shape, long_mode)
    _hold(lg, want_lg, (name, case, "logits"))
    _hold(caches, want_caches, (name, case, "caches"))


@pytest.mark.parametrize("case", CASES[:3], ids=_ids)
@pytest.mark.parametrize("name", MLA)
def test_mla_split_serving_equals_the_gathered_step(name, case):
    """minicpm3-4b's MLA heads a slot, its compressed caches by
    positions; with a vocabulary of 500 at (1, 8) the row-parallel
    embedding and logits, laid out at the reference's replicated logits
    spec (each model slot a copy of the whole logits), else each slot's
    vocabulary block."""
    test_split_serving_equals_the_gathered_step(name, case)
    (d, m), _ = case
    _, _, serve, shapes = _outputs(name, *case)
    v = serve.api.cfg.vocab_size
    rows = v % m == 0
    assert tuple(serve.logits_spec) == ("data", None,
                                        "model" if rows else None)
    assert shapes == [{(BATCH // d, 1, v // m if rows else v)}] * (1 + STEPS)


# the reference's jit for every case of minicpm3-4b and its vocabulary-500
# variant, and for the other two vocabulary-500 variants where they take
# the row-parallel form
MLA_REF = [(n, c) for n in MLA[:2] for c in CASES[:3]] \
    + [(n, CASES[0]) for n in MLA[2:]]


@pytest.mark.parametrize("name,case", MLA_REF,
                         ids=[f"{n}-{_ids(c)}" for n, c in MLA_REF])
def test_mla_split_serving_equals_the_references_sharded_jit(
        spmd_devices, name, case):
    """The reference's jit at the replicated logits spec (DP, None,
    None) where the vocabulary does not divide the model degree."""
    test_split_serving_equals_the_references_sharded_jit(spmd_devices,
                                                         name, case)


@pytest.mark.parametrize("case", CASES, ids=_ids)
@pytest.mark.parametrize("name", ["gemma3-12b", "internvl2-76b",
                                  "seamless-m4t-large-v2"])
def test_no_slot_is_written_a_row_outside_its_block(monkeypatch, name, case):
    """Every cache write of the split step is a slot writing its own
    block (one of the cache's blocks, the slot's) inside its positions;
    the rows written a step add up to the rows the step's blocks own:
    a prefill's positions in each block (every replica too), a decode
    step's one position a sequence in the blocks that hold it."""
    mesh_shape, long_mode = case
    writes = []
    put_rows, put_tokens = L._put_rows, L._put_tokens

    def rows(block, piece, at):
        assert 0 <= at and at + piece.shape[1] <= block.shape[1]
        writes.append((block.untyped_storage().data_ptr(),
                       piece.shape[0] * piece.shape[1]))
        return put_rows(block, piece, at)

    def tokens(block, piece, seqs, cols):
        assert all(0 <= c < block.shape[1] for c in cols)
        assert len(seqs) == piece.shape[0]
        writes.append((block.untyped_storage().data_ptr(), len(seqs)))
        return put_tokens(block, piece, seqs, cols)

    run_at = S.ModelRow.run_at
    owner = {}

    def noted(self, slot, fn, *args, **kwargs):
        if fn in (rows, tokens):
            owner.setdefault(args[0].untyped_storage().data_ptr(),
                             set()).add(slot)
        return run_at(self, slot, fn, *args, **kwargs)

    monkeypatch.setattr(L, "_put_rows", rows)
    monkeypatch.setattr(L, "_put_tokens", tokens)
    monkeypatch.setattr(S.ModelRow, "run_at", noted)
    _, _, serve, caches, _ = _serve(name, mesh_shape, long_mode)
    monkeypatch.undo()
    held = {}
    for laid in L.tree_leaves(caches):
        for j, blk in enumerate(laid.blocks):
            held.setdefault(blk.untyped_storage().data_ptr(), set()).add(j)
    for ptr, slots in owner.items():
        assert slots <= held[ptr], (ptr, slots, held.get(ptr))
    assert writes


@pytest.mark.parametrize("case", CASES[:3], ids=_ids)
def test_mla_no_slot_is_written_a_row_outside_its_block(monkeypatch, case):
    """minicpm3-4b's compressed rows, each written by the slot whose
    block of positions holds it."""
    test_no_slot_is_written_a_row_outside_its_block(monkeypatch,
                                                    "minicpm3-4b", case)


@pytest.mark.parametrize("name", SPLIT)
def test_no_slot_is_sent_a_whole_split_parameter(monkeypatch, name,
                                                 mesh_shape=(2, 4)):
    """At (2, 4) no move of the split step reads a parameter's storage:
    each slot computes on its own blocks (an MoE's on its own experts)
    and only activations, k/v rows, queries, partials, dispatch rows and
    expert outputs move, no expert stack; the gathered step's moves read
    them (it gathers the whole parameters onto each data row's first
    slot)."""
    for split in (True, False):
        sends = []
        _, _, serve, _, _ = _serve(name, mesh_shape, False, split=split,
                                   monkeypatch=monkeypatch, sends=sends)
        held = {b.untyped_storage().data_ptr()
                for laid in L.tree_leaves(serve.params) for b in laid.blocks}
        assert sends
        assert any(ptr in held for _, _, ptr in sends) != split


@pytest.mark.parametrize("name", MLA)
def test_mla_no_slot_is_sent_a_whole_split_parameter(monkeypatch, name):
    """MLA's latents, partials, compressed rows and the decode's blocks of
    the compressed caches move, no ``wuq``/``wukv``/``wo`` block (at
    (2, 4)); with a vocabulary of 500 at (1, 8) the row-parallel
    columns and partials, no block of the table or head split along
    d_model."""
    test_no_slot_is_sent_a_whole_split_parameter(
        monkeypatch, name, mesh_shape=(1, 8) if "@v" in name else (2, 4))


# the gathered step (a data row's caches on its first slot, the whole
# parameters there) of the families whose caches are recurrent states or
# that return the encoder's output, on a model axis of one and of four,
# and the recurrent two in long mode
GATHERED = [(n, c) for n in ("jamba-v0.1-52b", "xlstm-125m")
            for c in (((8, 1), False), ((2, 4), False), ((2, 4), True))] \
    + [("seamless-m4t-large-v2", c) for c in (((8, 1), False),
                                              ((2, 4), False))]


@pytest.mark.parametrize("name,case", GATHERED,
                         ids=[f"{n}-{_ids(c)}" for n, c in GATHERED])
def test_the_gathered_step_serves_states_and_the_encoder(spmd_devices, name,
                                                          case):
    """Each cache leaf's batch dim read from its spec, not its rank: the
    recurrent states ((P, B, dc-1, di), (P, B, di, N), mLSTM's (P, B, nh,
    hd, hd) ...) gathered and written back whole for each data row, the
    encoder's output returned laid out at the inputs' spec and taken back
    by decode.  Each step's logits and every cache leaf against the
    unmeshed step on each data shard's rows and against the reference's
    sharded jit."""
    mesh_shape, long_mode = case
    lg, caches, _, _ = _outputs(name, mesh_shape, long_mode, split=False)
    want_lg, want_caches = _unmeshed(name, mesh_shape, long_mode)
    _hold(lg, want_lg, (name, case, "logits"))
    _hold(caches, want_caches, (name, case, "caches"))
    want_lg, want_caches = _reference(name, mesh_shape, long_mode)
    _hold(lg, want_lg, (name, case, "logits"))
    _hold(caches, want_caches, (name, case, "caches"))


@pytest.mark.parametrize("case", CASES[:3], ids=_ids)
@pytest.mark.parametrize("name", INNER_WHOLE)
def test_an_inner_dim_the_degree_does_not_divide_runs_whole(name, case):
    """jamba's and xlstm's smokes with an inner dim of 132: at (1, 8) the
    spec leaves ``di`` whole and the Mamba and mLSTM layers run on each
    data row's first slot, their states replicated over the model slots;
    at (2, 4) and (4, 2) they split.  Split against gathered."""
    test_split_serving_equals_the_gathered_step(name, case)
    _, _, serve, _ = _outputs(name, *case)
    mixer = serve.p_specs["stack"][0]["mixer"]
    w = mixer["in_proj" if "in_proj" in mixer else "up_proj"]
    assert (S.model_dim(w) is None) == (case[0][1] == 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cuts", [(32,), (16, 16), (8, 8, 8, 8), (5, 11, 16),
                                  (1,) * 32, (31, 1)])
def test_partials_merged_over_any_split_equal_the_whole(cuts, dtype):
    """decode_attention_partial's plain version over each block of a
    split of 32 positions, merged in block order (fp32, rounded once),
    against decode_attention_ref over all of them, at lengths 0 (zeros
    everywhere, every block's lse -inf), 1, inside a block, on a block's
    edge and 32; each block at length 0 gives zeros and -inf."""
    g = torch.Generator().manual_seed(5)
    b, s, hkv, gq, d = 6, 32, 2, 3, 16
    kc, vc = (torch.randn(b, s, hkv, d, generator=g).to(dtype)
              for _ in range(2))
    q = torch.randn(b, hkv * gq, d, generator=g).to(dtype)
    lengths = torch.tensor([0, 1, 7, 16, 21, 32], dtype=torch.int32)
    whole = ref.decode_attention_ref(q, *L._page_view(kc, vc), lengths)
    assert torch.equal(whole[0], torch.zeros_like(whole[0]))
    outs, lses, lo = [], [], 0
    for n in cuts:
        blk = [c[:, lo:lo + n].contiguous() for c in (kc, vc)]
        o, lse = ref.decode_attention_partial_ref(
            q, *L._page_view(*blk), torch.clamp(lengths - lo, 0, n).to(
                torch.int32))
        empty = (lengths - lo) <= 0
        assert bool(torch.isneginf(lse[empty]).all())
        assert torch.equal(o[empty], torch.zeros_like(o[empty]))
        outs.append(o)
        lses.append(lse)
        lo += n
    got = merge_partials(outs, lses, dtype=dtype)
    assert got.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), whole.float(), rtol=tol, atol=tol)
    assert torch.equal(got[0], torch.zeros_like(got[0]))


def test_split_forms_still_refuse_what_is_not_ported():
    """Cross-attention split over the model axis (the encoder-decoder),
    which raised until it was ported, equals the plain one on two slots:
    ``attn_apply`` on the layer's heads split by slot, from the encoder's
    output on each slot (``layers.Replicas``).  A vocabulary the model
    degree does not divide takes the row-parallel logits:
    ``logits_apply`` with an untied head, or a tied table, split along
    ``d_model`` on two slots, equals the whole product of the plain norm
    and the weight."""
    mesh = make_host_mesh(devices=[CPU] * 2, shape=(1, 2))
    row = S.ModelRow((0, 1), lambda t, src, dst: S.send(t, mesh, src, dst))
    cfg = SMOKES["llama3.2-3b"].replace(dtype="float32")
    enc_cfg = SMOKES["seamless-m4t-large-v2"].replace(dtype="float32")
    p = L.init_tree(L.attn_defs(enc_cfg, 2), 1, torch.device(CPU))
    split = {k: L.Blocks((p[k],), row) if k == "ln" else L.Blocks(
        tuple(torch.chunk(p[k], 2, dim=0 if k == "wo" else 1)), row,
        0 if k == "wo" else 1) for k in p}
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 64, generator=g)
    enc = torch.randn(2, 5, 64, generator=g)
    k, v = (torch.einsum("bsd,dhk->bshk", enc, p[w]) for w in ("wk", "wv"))
    want, _ = L.attn_apply(p, x, enc_cfg, kv_override=(k, v))
    got, _ = L.attn_apply(split, x, enc_cfg,
                          kv_override=L.Replicas((enc, enc)))
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    head = torch.randn(64, 255, generator=g)
    ln = torch.rand(64, generator=g) + 0.5
    x = torch.randn(2, 3, 64, generator=g)
    want = ref.rmsnorm_ref(x, ln, eps=cfg.norm_eps) @ head
    for tied in (False, True):
        p = {"final_ln": L.Blocks((ln,), row)}
        if tied:
            p["tokens"] = L.Blocks((head.T[:, :32], head.T[:, 32:]), row, 1)
        else:
            p["head"] = L.Blocks((head[:32], head[32:]), row, 0)
        got = L.logits_apply(p, x, cfg.replace(tie_embeddings=tied,
                                               vocab_size=255))
        assert got.dim is None and len(got.blocks) == 1
        torch.testing.assert_close(got.blocks[0], want, rtol=TOL, atol=TOL)
