"""MLA and row-parallel logits on the model axis, on 8 CPU slots.

minicpm3-4b's smoke (MLA: 4 heads, 2, 1 and 1 a slot at model degree 2,
4 and 8, padded to 8 at degree 8; ``models/layers.py::_mla_split`` and
``_mla_split_serve``) at (1, 8), (2, 4) and (4, 2): which slot runs each
MLA head's blocks, what each slot's compressed cache holds, and long
mode, which MLA does not split; and the specs the row-parallel forms
read for the vocabulary-500 variants (``_model_axis.ROW_PARALLEL``).
The split steps against the gathered ones are
``tests/test_torch_model_axis.py``'s and
``tests/test_torch_mesh_serve.py``'s, which hold them to the reference
too, as ``tests/test_torch_mesh_train.py`` does; the dry run's
transfers against their sends, ``tests/test_torch_dryrun_analysis.py``'s.

The smokes run in fp32.  Tolerance: every cache leaf within 1e-5 of its
largest element."""
import collections

import numpy as np
import pytest
import torch

from repro_torch.configs import SMOKES
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import MeshServe
from repro_torch.models import build, layers as L
from repro_torch.train import sharded as S
from _model_axis import CPU, ROW_PARALLEL, mesh_step, smoke
from _torch_threads import one_torch_thread  # noqa: F401

MLA = "minicpm3-4b"
MESHES = [(1, 8), (2, 4), (4, 2)]
TOL = 1e-5
SEQ, BATCH = 16, 8                     # training
PROMPT, CACHE, STEPS = 16, 32, 3       # serving


def _mesh_id(s):
    return f"{s[0]}x{s[1]}"


def _mesh(mesh_shape):
    d, m = mesh_shape
    return make_host_mesh(devices=[CPU] * (d * m), shape=mesh_shape)


def _tokens():
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.integers(0, 500, (BATCH, PROMPT + STEPS))
                            .astype(np.int32))


def _serve(mesh_shape, split=True):
    """minicpm3-4b's caches, as laid out, after MeshServe's prefill and
    decode steps."""
    api = build(smoke(SMOKES, MLA), tp=mesh_shape[1])
    serve = MeshServe(api, _mesh(mesh_shape))
    assert serve.split
    serve.split = split
    params = serve.lay_out_params(api.init_params(0, CPU))
    caches = serve.init_caches(BATCH, CACHE)
    tokens = _tokens()
    with torch.no_grad():
        _, caches = serve.prefill(params, serve.lay_out_inputs(
            {"tokens": tokens[:, :PROMPT]}), caches)
        for i in range(PROMPT, PROMPT + STEPS):
            _, caches = serve.decode(params, serve.lay_out_inputs(
                {"tokens": tokens[:, i:i + 1].contiguous(),
                 "lengths": torch.full((BATCH,), i, dtype=torch.int32)}),
                caches)
    return caches


@pytest.mark.parametrize("name", ROW_PARALLEL)
def test_a_vocabulary_the_degree_does_not_divide_splits_along_d_model(name):
    """The specs the split forms read: at degree 8 the table (and an
    untied head) split along ``d_model``, at 4 by vocabulary rows."""
    cfg = smoke(SMOKES, name)
    for m in (8, 4):
        mesh = _mesh((8 // m, m))
        with L.use_mesh(mesh):
            specs = build(cfg, tp=m).param_pspecs()["embed"]
        assert S.model_dim(specs["tokens"]) == (1 if m == 8 else 0)
        if not cfg.tie_embeddings:
            assert S.model_dim(specs["head"]) == (0 if m == 8 else 1)


def _slot_calls(monkeypatch):
    """Each run of an MLA slot's heads as (slot, storage of the ``wuq``,
    ``wukv`` and ``wo`` blocks it is given), through
    ``ModelRow.run_at``."""
    calls = []
    run_at = S.ModelRow.run_at

    def noted(self, slot, fn, *args, **kwargs):
        if fn is L._mla_slot:
            calls.append((slot, tuple(a.untyped_storage().data_ptr()
                                      for a in args[3:6])))
        return run_at(self, slot, fn, *args, **kwargs)

    monkeypatch.setattr(S.ModelRow, "run_at", noted)
    return calls


@pytest.mark.parametrize("mesh_shape", MESHES, ids=_mesh_id)
def test_each_slot_runs_only_its_own_heads(monkeypatch, mesh_shape):
    """A train step, a prefill and a decode step: every MLA head block
    runs on the slot that holds it, each of the rows' model slots alike,
    once a layer a step (twice in training: remat's recompute)."""
    _, parts, params, _, batch = mesh_step(MLA, mesh_shape, SEQ, BATCH)
    owner = {}
    for blk in params["stack"]:
        for key in ("wuq", "wukv", "wo"):
            for j, b in enumerate(blk["mixer"][key].blocks):
                owner[b.untyped_storage().data_ptr()] = j
    calls = _slot_calls(monkeypatch)
    with L.use_mesh(parts.mesh):
        parts.grads(params, batch)
    serve = MeshServe(parts.api, parts.mesh)
    caches = serve.init_caches(BATCH, CACHE)
    with torch.no_grad():
        _, caches = serve.prefill(params, serve.lay_out_inputs(
            {"tokens": batch["tokens"]}), caches)
        serve.decode(params, serve.lay_out_inputs(
            {"tokens": batch["tokens"][:, :1].contiguous(),
             "lengths": torch.full((BATCH,), SEQ, dtype=torch.int32)}),
            caches)
    monkeypatch.undo()
    assert calls
    for slot, ptrs in calls:
        assert {owner[p] for p in ptrs} == {slot}, (slot, ptrs)
    runs = collections.Counter(s for s, _ in calls)
    firsts = S.data_slots(parts.mesh, ("data",))
    assert set(runs) == {s for i in firsts for s in parts.rows[i]}
    assert set(runs.values()) == {4 * parts.api.cfg.num_layers}


@pytest.mark.parametrize("mesh_shape", MESHES, ids=_mesh_id)
def test_each_slot_holds_only_its_own_cache_positions(mesh_shape):
    """Between steps each slot's block of ``ckv`` and ``krope`` is its
    own slice of positions, S/m of them of its data row's sequences, and
    equals that slice of the gathered step's caches; the positions not
    yet written are zeros."""
    d, m = mesh_shape
    caches = _serve(mesh_shape)
    want = _serve(mesh_shape, split=False)
    written = PROMPT + STEPS
    for laid, whole in zip(L.tree_leaves(caches),
                           L.tree_leaves(S.gather_tree(want))):
        coords = laid.layout.coords()
        for j, blk in enumerate(laid.blocks):
            sl = laid.layout.block_slices(laid.shape, coords[j])
            p0, p1 = sl[-2].start, sl[-2].stop
            assert tuple(blk.shape) == laid.shape[:-3] + (
                BATCH // d, CACHE // m, laid.shape[-1])
            assert (p0, p1) == (coords[j][1] * CACHE // m,
                                (coords[j][1] + 1) * CACHE // m)
            scale = float(whole.abs().max())
            assert float((blk - whole[sl]).abs().max()) <= TOL * scale
            if p0 >= written:
                assert not blk.any()


def test_long_mode_and_positions_without_a_cache_refuse_mla():
    """Long mode (decode at batch 1, the compressed caches' positions
    over the data rows too) and a split call at given positions without
    a cache raise ``NotImplementedError``."""
    cfg = smoke(SMOKES, MLA)
    api = build(cfg, tp=4)
    serve = MeshServe(api, _mesh((2, 4)), long_mode=True)
    assert serve.split
    params = serve.lay_out_params(api.init_params(0, CPU))
    caches = serve.init_caches(1, CACHE)
    with torch.no_grad(), pytest.raises(NotImplementedError,
                                        match="long mode"):
        serve.decode(params, serve.lay_out_inputs(
            {"tokens": torch.zeros((1, 1), dtype=torch.int32),
             "lengths": torch.zeros((1,), dtype=torch.int32)}), caches)
    row = serve.model_row(0)
    p = S.row_blocks(params, row)["stack"][0]["mixer"]
    with pytest.raises(NotImplementedError, match="given positions"):
        L.mla_apply(L.take_layer(p, 0), torch.zeros(1, 2, cfg.d_model),
                    cfg, positions=torch.arange(2))
