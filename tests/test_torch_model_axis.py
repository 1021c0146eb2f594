"""The model axis of a meshed train step, on 8 CPU slots: the split step
(each data row's model slots on their own heads, MLP columns or experts,
Mamba channels or rows of mLSTM's C and vocabulary block,
``models/layers.py``'s, ``mamba.py``'s and ``xlstm.py``'s split forms)
against the gathered one (the whole parameters on each row's first
slot) for the ten architectures, every one of which splits, at (1, 8),
(2, 4) and (4, 2) (the MoE smokes' 4 experts 2 and 1 a slot, and whole
at degree 8; minicpm3-4b's MLA heads 1 or 2 a slot; xlstm's mLSTM half
a head, one or two heads a slot; seamless's encoder, self- and
cross-attention by heads, its 4 KV heads replicated at (1, 8)), for
four smokes with a vocabulary of 500
(``_model_axis.ROW_PARALLEL``: row-parallel at (1, 8)) and for jamba
and xlstm with an inner dim of 132 (``_model_axis.INNER_WHOLE``: their
Mamba and mLSTM layers whole on each row's first slot at (1, 8)); the four
collectives of ``train/sharded.py`` under ``gradcheck`` in float64;
the moves of a recorded step, none of which takes a block of a split
leaf to a slot that does not hold it; and the dry run's record of a
split cell.  The meshed ``Trainer`` against the reference's is
``tests/test_torch_mesh_train.py``'s; the dry run's transfers against
a real step's sends, ``tests/test_torch_dryrun_analysis.py``'s.

The smokes run in fp32.  Tolerance: the loss, cross-entropy and each
gradient leaf within 1e-5 of its largest element."""
import collections

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, SMOKES
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build, layers as L
from repro_torch.train import sharded as S
from repro_torch.train import trainer as T
from _model_axis import INNER_WHOLE, ROW_PARALLEL, mesh_step, whole
from _torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"
SPLIT = ("llama3.2-3b", "gemma3-12b", "internvl2-76b", "gemma3-27b",
         "phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e", "minicpm3-4b",
         "jamba-v0.1-52b", "xlstm-125m", "seamless-m4t-large-v2")
MESHES = [(1, 8), (2, 4), (4, 2)]
TOL = 1e-5
SEQ, BATCH = 16, 8


def _setup(name, mesh_shape, zero1=False):
    return mesh_step(name, mesh_shape, SEQ, BATCH, zero1=zero1)


@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", SPLIT + ROW_PARALLEL + INNER_WHOLE)
def test_split_step_equals_the_gathered_step(name, mesh_shape):
    """Forward (loss, cross-entropy) and every gradient leaf of one
    micro-batch; (1, 8) pads the smokes' 4 heads to 8 and replicates
    their 2 KV heads, (4, 2) splits both; the vocabulary-500 variants
    take the row-parallel embedding and loss at (1, 8), the inner-dim-132
    ones their recurrent mixers whole on the first slot."""
    _, parts, params, _, batch = _setup(name, mesh_shape)
    assert parts.split
    mesh = parts.mesh
    with L.use_mesh(mesh):
        loss, met, grads = parts.grads(params, batch)
        parts.split = False
        want_loss, want_met, want = parts.grads(params, batch)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=TOL)
    np.testing.assert_allclose(float(met["xent"]), float(want_met["xent"]),
                               rtol=TOL)
    for (path, got), ref in zip(L.tree_items(grads), L.tree_leaves(want)):
        scale = max(float(ref.abs().max()), 1e-30)
        err = float((whole(got) - ref).abs().max())
        assert err <= TOL * scale, (path, err, scale)


def _row(n):
    mesh = make_host_mesh(devices=[CPU] * n, shape=(1, n))
    moved = []

    def send(t, src, dst):
        if src != dst:
            moved.append((src, dst))
        return S.send(t, mesh, src, dst)

    return S.ModelRow(range(n), send), moved


def test_the_collectives_pass_gradcheck_in_float64():
    """to_model_slots (whole and by ranges), sum_model_slots,
    from_model_slots (an MoE's expert outputs, concatenated in slot
    order) and sum_to_model_slots (the row-parallel loss's reduce-scatter
    over uneven vocabulary blocks), and the moves each makes forward and
    backward."""
    row, moved = _row(3)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 4, dtype=torch.float64, generator=g,
                    requires_grad=True)
    assert torch.autograd.gradcheck(lambda a: S.to_model_slots(row, a), (x,))
    ranges = [(0, 2), (1, 3), (3, 5)]                # slices may overlap
    assert torch.autograd.gradcheck(
        lambda a: S.to_model_slots(row, a, dim=1, ranges=ranges), (x,))
    parts = tuple(torch.randn(2, 4, dtype=torch.float64, generator=g,
                              requires_grad=True) for _ in range(3))
    assert torch.autograd.gradcheck(
        lambda *p: S.sum_model_slots(row, p), parts)
    blocks = tuple(torch.randn(n, 3, dtype=torch.float64, generator=g,
                               requires_grad=True) for n in (2, 1, 3))
    assert torch.autograd.gradcheck(
        lambda *p: S.from_model_slots(row, p, 0), blocks)
    assert torch.autograd.gradcheck(
        lambda *p: S.from_model_slots(row, [b.T for b in p], 1), blocks)
    moved.clear()
    out = S.from_model_slots(row, [b * 1 for b in blocks], 0)
    assert torch.equal(out, torch.cat(blocks))
    assert moved == [(1, 0), (2, 0)]
    out.sum().backward()
    assert moved == [(1, 0), (2, 0), (0, 1), (0, 2)]
    assert all(torch.equal(b.grad, torch.ones_like(b)) for b in blocks)
    moved.clear()
    out = S.to_model_slots(row, x)
    assert moved == [(0, 1), (0, 2)]
    sum(o.sum() for o in out).backward()
    assert moved == [(0, 1), (0, 2), (1, 0), (2, 0)]
    assert torch.equal(x.grad, torch.full_like(x, 3.0))
    moved.clear()
    y = S.sum_model_slots(row, [p * 1 for p in parts])
    assert torch.equal(y, parts[0] + parts[1] + parts[2])
    y.sum().backward()
    assert moved == [(1, 0), (2, 0), (0, 1), (0, 2)]
    ranges = L.vocab_blocks(7, 3)
    assert ranges == [(0, 3), (3, 6), (6, 7)]
    full = tuple(torch.randn(2, 4, 7, dtype=torch.float64, generator=g,
                             requires_grad=True) for _ in range(3))
    assert torch.autograd.gradcheck(
        lambda *p: S.sum_to_model_slots(row, p, ranges), full)
    moved.clear()
    out = S.sum_to_model_slots(row, [p * 1 for p in full], ranges)
    for (lo, hi), o in zip(ranges, out):
        assert torch.equal(o, full[0][..., lo:hi] + full[1][..., lo:hi]
                           + full[2][..., lo:hi])
    others = sorted((a, c) for a in range(3) for c in range(3) if a != c)
    assert sorted(moved) == others
    moved.clear()
    sum(o.sum() for o in out).backward()
    assert sorted(moved) == others
    assert all(torch.equal(p.grad, torch.ones_like(p)) for p in full)


def _recorded_step(monkeypatch, name, mesh_shape, split):
    """One step at ZeRO-1 with every send recorded as (storage of what
    it moves, destination), and each split leaf's block storages (the
    parameters' blocks, each data row's gradient blocks, their sums and
    the updated slices) mapped to their model coordinate."""
    _, parts, params, opt, batch = _setup(name, mesh_shape, zero1=True)
    parts.split = split
    ax = parts.mesh.axis_names.index("model")
    block, alive = {}, []

    def note(laid, blocks):
        if S.model_dim(laid.layout.spec) is None:
            return
        for j, b in blocks:
            alive.append(b)                 # no other tensor takes its address
            block[b.untyped_storage().data_ptr()] = parts.coords[j][ax]

    for laid in L.tree_leaves(params):
        note(laid, enumerate(laid.blocks))
    moves = []
    send = S.send

    def recording(t, mesh, src, dst, out=None):
        k = t.untyped_storage().data_ptr()
        if src is not None and src != dst and k in block:
            moves.append((block[k], dst))
        return send(t, mesh, src, dst, out=out)

    lag = T.loss_and_grads

    def grads_noted(*args, **kwargs):
        out = lag(*args, **kwargs)
        first = parts.rows[parts.slots[0]]
        L.tree_map(lambda laid, g: note(laid, zip(first, g))
                   if isinstance(g, tuple) else None, params, out[2])
        return out

    update = parts.update

    def update_noted(p, g, state):
        for laid in L.tree_leaves(g):
            if isinstance(laid, S.Laid):        # the gathered step's are whole
                note(laid, [(j, b) for j, b in enumerate(laid.blocks)
                            if b is not None])
        return update(p, g, state)

    slot_update = parts.slot_update

    def slot_noted(i, p, g, state, gnorm):
        out = slot_update(i, p, g, state, gnorm)
        for laid, b in zip(L.tree_leaves(p), L.tree_leaves(out[0])):
            note(laid, [(i, b)])
        return out

    monkeypatch.setattr(S, "send", recording)
    monkeypatch.setattr(T, "loss_and_grads", grads_noted)
    monkeypatch.setattr(parts, "update", update_noted)
    monkeypatch.setattr(parts, "slot_update", slot_noted)
    step = T.make_train_step(parts.api, parts.opt_cfg, grads_fn=parts.grads,
                             update_fn=parts.update)
    with L.use_mesh(parts.mesh):
        step(params, opt, batch)
    return [(m, parts.coords[dst][ax]) for m, dst in moves]


@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", SPLIT + ROW_PARALLEL)
def test_no_block_of_a_split_leaf_goes_to_a_slot_without_it(
        monkeypatch, name, mesh_shape):
    """Gradient blocks go to the first row's slot of their block, and
    under ZeRO-1 the updated slices come back along their model column;
    no block goes anywhere else."""
    moved = _recorded_step(monkeypatch, name, mesh_shape, split=True)
    assert all(m == dst for m, dst in moved), collections.Counter(moved)
    if mesh_shape[0] > 1:
        assert moved


def test_the_gathered_step_fails_that_check(monkeypatch):
    moved = _recorded_step(monkeypatch, "llama3.2-3b", (2, 4), split=False)
    assert any(m != dst for m, dst in moved)


def test_the_dry_run_records_which_steps_split():
    """Every family splits its train and serving steps (the serving one
    ``launch/serve.py::MeshServe``) on a model axis wider than one,
    minicpm3-4b's MLA, jamba's Mamba, xlstm's mLSTM and sLSTM and the
    encoder-decoder's cross-attention among them; none does on a model
    axis of one."""
    mesh = D.make_mesh(multi_pod=False, dev=True)
    train = ShapeConfig("s", "train", 2048, 8)
    for name, cfg in ARCHS.items():
        cell, _ = D.lower_cell(cfg, train, mesh)
        assert D.model_split(cell) == (name in SPLIT), name
        cell, _ = D.lower_cell(cfg, ShapeConfig("s", "decode", 2048, 8),
                               mesh)
        assert D.model_split(cell) == (name in SPLIT), name
    cell, _ = D.lower_cell(ARCHS["llama3.2-3b"], train,
                           D.meta_mesh((8, 1), ("data", "model")))
    assert not D.model_split(cell)


def test_a_split_cell_holds_less_a_slot_than_gathered(monkeypatch):
    """llama3.2-3b's smoke at (2, 4): the split trace's peak below the
    gathered one's, with the kernels called on slot 0's heads alone."""
    mesh = D.meta_mesh((2, 4), ("data", "model"))
    shape = ShapeConfig("s", "train", 64, 8)
    _, split = D.analyze_cell(SMOKES["llama3.2-3b"], shape, mesh)
    monkeypatch.setattr(type(build(SMOKES["llama3.2-3b"])), "model_split",
                        lambda self: False)
    _, gathered = D.analyze_cell(SMOKES["llama3.2-3b"], shape, mesh)
    assert split["model_split"] and not gathered["model_split"]
    assert split["memory"]["peak_bytes"] < gathered["memory"]["peak_bytes"]
    assert split["kernel_calls"] == gathered["kernel_calls"]
    assert split["flops"] < gathered["flops"]
    assert "gather" in gathered["collectives"]["bytes_by_kind"]
    assert "gather" not in split["collectives"]["bytes_by_kind"]
