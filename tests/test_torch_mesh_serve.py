"""Serving on the model axis (``launch/serve.py::MeshServe``) on 8 CPU
slots (this module and ``test_torch_mesh_serve_mixers.py``, which holds
the MoEs', the recurrent families' and the encoder-decoder's runs
against the gathered step and the reference, and the gathered step's
own; the helpers both use are in ``_mesh_serve.py``): the split prefill
and decode steps of the ten architectures,
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
import pytest
import torch

from repro_torch.configs import SMOKES
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import merge_partials
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import layers as L
from repro_torch.train import sharded as S
from _mesh_serve import (BATCH, CASES, CPU, MLA, SPLIT, STEPS, TOL, _ids,
                         _outputs, _serve, hold_split_against_gathered,
                         hold_split_against_reference)
from _torch_threads import one_torch_thread  # noqa: F401

# the attention families' runs against the gathered step and the
# reference (the others' are in test_torch_mesh_serve_mixers.py)
ATTENTION = SPLIT[:4]


@pytest.mark.parametrize("case", CASES, ids=_ids)
@pytest.mark.parametrize("name", ATTENTION)
def test_split_serving_equals_the_gathered_step(name, case):
    """Each step's logits (gathered from the slots' vocabulary blocks)
    and the caches (gathered from the slots' blocks) of the split step
    against the gathered step's on the same layouts."""
    hold_split_against_gathered(name, case)


@pytest.mark.parametrize("case", CASES, ids=_ids)
@pytest.mark.parametrize("name", ATTENTION)
def test_split_serving_equals_the_references_sharded_jit(spmd_devices, name,
                                                         case):
    hold_split_against_reference(name, case)


@pytest.mark.parametrize("case", CASES[:3], ids=_ids)
@pytest.mark.parametrize("name", MLA)
def test_mla_split_serving_equals_the_gathered_step(name, case):
    """minicpm3-4b's MLA heads a slot, its compressed caches by
    positions; with a vocabulary of 500 at (1, 8) the row-parallel
    embedding and logits, laid out at the reference's replicated logits
    spec (each model slot a copy of the whole logits), else each slot's
    vocabulary block."""
    hold_split_against_gathered(name, case)
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
    hold_split_against_reference(name, case)


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
