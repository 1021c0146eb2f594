"""The recurrent mixers on the model axis, on 8 CPU slots: Mamba split by
inner channels (``models/mamba.py::_mamba_split``), mLSTM by rows of C
(``models/xlstm.py::_mlstm_split``) and sLSTM whole on the row's first
slot, each against its unsplit form at (1, 8), (2, 4) and (4, 2)
(forward and every gradient leaf); the rows of C a slot holds at each
degree (half an xlstm smoke head at 8, one at 4, two at 2); the
reshuffles and the float64-clean slot pieces under ``gradcheck``; and,
serving jamba and xlstm through ``launch/serve.py::MeshServe``, the
replicas of every recurrent state bit for bit equal after each step,
each slot writing only its own block, a Mamba block's state never sent
between the row's slots, and no send inside a loop over time.

The step against the gathered one and the reference, the meshed
Trainer, and the dry run's moves against the recorded sends are
``test_torch_model_axis.py``'s, ``test_torch_mesh_serve.py``'s,
``test_torch_mesh_train.py``'s and ``test_torch_dryrun_analysis.py``'s.

The smokes run in fp32.  Tolerance: the output and each gradient leaf
within 1e-5 of its largest element; ``gradcheck``'s defaults in
float64.  The scans themselves are fp32 as in the reference, so they
are held by the comparisons, not by ``gradcheck``."""
import numpy as np
import pytest
import torch

from repro_torch.configs import SMOKES
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import MeshServe
from repro_torch.models import build, layers as L, mamba as M, xlstm as X
from repro_torch.train import sharded as S
from _torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"
MESHES = [(1, 8), (2, 4), (4, 2)]
TOL = 1e-5
B, T = 4, 12
MIXERS = {"mamba": ("jamba-v0.1-52b", M.mamba_defs, M.mamba_apply),
          "mlstm": ("xlstm-125m", X.mlstm_defs, X.mlstm_apply),
          "slstm": ("xlstm-125m", X.slstm_defs, X.slstm_apply)}
FAMILIES = ("jamba-v0.1-52b", "xlstm-125m")
SERVE_CASES = [((2, 4), False), ((1, 8), False), ((4, 2), False),
               ((2, 4), True)]
PROMPT, SEQ, STEPS = 8, 16, 2


def _mesh_id(s):
    return f"{s[0]}x{s[1]}"


def _case_id(case):
    return _mesh_id(case[0]) + ("-long" if case[1] else "")


def _row(mesh):
    """The first data row's slots on the model axis."""
    rows = S.model_rows(mesh, ("data",))
    return S.ModelRow(rows[min(rows)],
                      lambda t, src, dst: S.send(t, mesh, src, dst))


@pytest.mark.parametrize("mesh_shape", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("kind", list(MIXERS))
def test_mixer_split_equals_the_unsplit_mixer(kind, mesh_shape):
    """One layer's output and the gradients of the input and of every
    parameter leaf: the split form on the first data row's model slots,
    each slot's gradient block against its slice of the whole one."""
    name, defs_fn, apply = MIXERS[kind]
    cfg = SMOKES[name].replace(dtype="float32")
    d, m = mesh_shape
    mesh = make_host_mesh(devices=[CPU] * (d * m), shape=mesh_shape)
    defs = defs_fn(cfg, m)
    with L.use_mesh(mesh):
        specs = L.pspec_tree(defs)
    g = torch.Generator().manual_seed(1)
    params = L.tree_map(lambda t: (t + 0.05 * torch.randn(
        t.shape, generator=g)).requires_grad_(), L.init_tree(defs, 0, CPU))
    laid = L.tree_map(lambda a: S.Laid(a.layout, a.shape, [
        b.detach().clone().requires_grad_() for b in a.blocks]),
        S.lay_out_tree(L.tree_map(torch.Tensor.detach, params),
                       S.layouts(mesh, specs)))
    row = _row(mesh)
    x = torch.randn(B, T, cfg.d_model, generator=g, requires_grad=True)
    w = torch.randn(B, T, cfg.d_model, generator=g)
    want, _ = apply(params, x, cfg)
    xs = x.detach().clone().requires_grad_()
    got, _ = apply(S.row_blocks(laid, row), xs, cfg)
    scale = float(want.detach().abs().max())
    assert float((got - want).detach().abs().max()) <= TOL * scale
    (want * w).sum().backward()
    (got * w).sum().backward()
    scale = float(x.grad.abs().max())
    assert float((xs.grad - x.grad).abs().max()) <= TOL * scale
    split = 0
    for (path, p), a, spec in zip(L.tree_items(params), L.tree_leaves(laid),
                                  L.tree_leaves(specs)):
        dim = S.model_dim(spec)
        mine = [a.blocks[j] for j in row.slots] if dim is not None \
            else [a.blocks[row.slots[0]]]
        assert all(b.grad is not None for b in mine), path
        grad = torch.cat([b.grad for b in mine], dim) if dim is not None \
            else mine[0].grad
        scale = max(float(p.grad.abs().max()), 1e-30)
        assert float((grad - p.grad).abs().max()) <= TOL * scale, path
        split += dim is not None
    assert (split > 0) == (kind != "slstm")


def test_a_slots_rows_of_c_at_each_degree():
    """xlstm's smoke (inner dim 128, 4 heads of 32): half a head a slot at
    degree 8, one at 4, two at 2; production (1,536, 4 heads of 384) 96
    rows of one head at 16; a block that would cross a head unevenly
    raises."""
    assert [X.slot_rows(128, 4, 8, m) for m in (0, 1, 7)] == \
        [(0, 1, 0, 16), (0, 1, 16, 16), (3, 1, 16, 16)]
    assert [X.slot_rows(128, 4, 4, m) for m in range(4)] == \
        [(h, 1, 0, 32) for h in range(4)]
    assert [X.slot_rows(128, 4, 2, m) for m in range(2)] == \
        [(0, 2, 0, 32), (2, 2, 0, 32)]
    assert X.slot_rows(1536, 4, 16, 5) == (1, 1, 96, 96)
    with pytest.raises(NotImplementedError, match="unevenly"):
        X.slot_rows(96, 3, 2, 1)


def test_the_reshuffles_and_slot_pieces_pass_gradcheck_in_float64():
    """Through ``sharded``'s Functions on 3 slots, with the ranges the
    split forms compute: Mamba's [x | z] reshuffle (each slot's 4
    ``in_proj`` columns back, concatenated, then its 2 channels of x and
    of z out: the x/z boundary falls inside slot 1's block), mLSTM's
    [u | z] (u whole to each slot) and its q columns gathered by heads
    (half a head a slot); and the float64-clean pieces a slot runs:
    ``in_proj``'s columns, the causal conv with its ``x_proj`` partial
    (train and decode), and q/k/v's columns."""
    mesh = make_host_mesh(devices=[CPU] * 3, shape=(1, 3))
    row = _row(mesh)
    g = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, dtype=torch.float64, generator=g,
                           requires_grad=True)

    di, tp = 6, 3
    c = di // tp
    xr = [(m * c, (m + 1) * c) for m in range(tp)]
    zr = [(di + lo, di + hi) for lo, hi in xr]
    parts = tuple(rand(2, 3, 2 * di // tp) for _ in range(tp))

    def reshuffle(ranges):
        return lambda *p: row.scatter(row.concat(p, dim=2), dim=2,
                                      ranges=ranges)
    for ranges in (xr, zr, [(0, di)] * tp):
        assert torch.autograd.gradcheck(reshuffle(ranges), parts)
    row4 = _row(make_host_mesh(devices=[CPU] * 4, shape=(1, 4)))
    q = tuple(rand(2, 3, 4) for _ in range(4))       # 2 heads of 8 columns
    heads = [(h0 * 8, (h0 + n) * 8) for h0, n, _, _ in
             (X.slot_rows(16, 2, 4, m) for m in range(4))]
    assert heads == [(0, 8), (0, 8), (8, 16), (8, 16)]
    assert torch.autograd.gradcheck(
        lambda *p: row4.scatter(row4.concat(p, dim=2), dim=2, ranges=heads),
        q)
    cfg = SMOKES["jamba-v0.1-52b"].replace(dtype="float64")
    dc, xdb = cfg.ssm.d_conv, 5
    xn, w = rand(2, 3, 4), rand(4, 6)
    assert torch.autograd.gradcheck(
        lambda a, b: L.columns_slot(a, b, at=lambda t: t), (xn, w))
    cw, cb, xp = rand(dc, c), rand(c), rand(c, xdb)
    for xin, conv in ((rand(2, 3, c), None),
                      (rand(2, 1, c), rand(2, dc - 1, c))):
        assert torch.autograd.gradcheck(
            lambda *a: M._conv_slot(*a[:4], cfg=cfg, at=lambda t: t,
                                    conv=a[4] if len(a) > 4 else None),
            (xin, cw, cb, xp) + (() if conv is None else (conv,)))
    u, ws = rand(2, 3, 6), [rand(6, 2) for _ in range(3)]
    assert torch.autograd.gradcheck(
        lambda a, *b: X._mlstm_qkv(a, *b, at=lambda t: t), (u, *ws))


def _serve(name, mesh_shape, long_mode, prompt=PROMPT):
    """jamba's or xlstm's fp32 smoke served split by MeshServe on 8 CPU
    slots, each cache block its own tensor (so that replicas can
    differ): (serve, params, caches, the prefill's and decode steps'
    inputs)."""
    d, m = mesh_shape
    cfg = SMOKES[name].replace(dtype="float32")
    api = build(cfg, tp=m)
    mesh = make_host_mesh(devices=[CPU] * (d * m), shape=mesh_shape)
    serve = MeshServe(api, mesh, long_mode=long_mode)
    assert serve.split
    b = 1 if long_mode else 8
    params = serve.lay_out_params(api.init_params(0, CPU))
    caches = L.tree_map(lambda a: S.Laid(a.layout, a.shape, [
        t.clone() for t in a.blocks]), serve.init_caches(b, SEQ))
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (b, prompt + STEPS)).astype(np.int32))
    first = serve.lay_out_inputs({"tokens": toks[:, :prompt]})
    steps = [serve.lay_out_inputs({
        "tokens": toks[:, i:i + 1],
        "lengths": torch.full((b,), i, dtype=torch.int32)})
        for i in range(prompt, prompt + STEPS)]
    return serve, params, caches, first, steps


def _state_leaves(serve, caches):
    """(mixer kind, leaf) of each of the caches' recurrent leaves."""
    cfg = serve.api.cfg
    return [(cfg.period_pattern[path[1]], laid) for (path, laid), geom in
            zip(L.tree_items(caches), L.tree_leaves(serve.geometry))
            if not geom.kv]


@pytest.mark.parametrize("case", SERVE_CASES, ids=_case_id)
@pytest.mark.parametrize("name", FAMILIES)
def test_state_replicas_are_equal_bit_for_bit_after_every_step(name, case):
    """After the prefill and after each decode step, every slot holding
    the same block of a recurrent state (mLSTM's and sLSTM's replicas on
    each model slot, and in long mode every data row's, Mamba's blocks
    too) holds the same bytes."""
    serve, params, caches, first, steps = _serve(name, *case)
    states = _state_leaves(serve, caches)
    assert states
    with torch.no_grad():
        for i, batch in enumerate([first] + steps):
            step = serve.decode if i else serve.prefill
            step(params, batch, caches)
            replicated = 0
            for _, laid in states:
                held = {}
                for j, c in enumerate(laid.layout.coords()):
                    key = S._key(laid.layout.block_slices(laid.shape, c))
                    held.setdefault(key, []).append(laid.blocks[j])
                for blocks in held.values():
                    assert all(torch.equal(b, blocks[0]) for b in blocks)
                    assert all(b.data_ptr() != blocks[0].data_ptr()
                               for b in blocks[1:])
                    replicated += len(blocks) > 1
            # jamba's Mamba states split by channels: replicas only in
            # long mode, over the data rows
            assert (replicated > 0) == (name == "xlstm-125m" or case[1])
            assert any(bool(laid.blocks[0].abs().sum() > 0)
                       for _, laid in states)


@pytest.mark.parametrize("case", SERVE_CASES, ids=_case_id)
@pytest.mark.parametrize("name", FAMILIES)
def test_each_slot_writes_only_its_own_block_of_a_state(monkeypatch, name,
                                                        case):
    """Every write of a recurrent state is a slot writing a block it
    holds, the whole block (a Mamba block its channels); a Mamba block's
    new state is never sent between the row's slots (in normal mode: no
    state byte moves; in long mode only to the other data rows'
    replicas); and the Mamba and mLSTM layers' sends do not depend on
    the prompt's length (no send inside the loop over time)."""
    serve, params, caches, first, steps = _serve(name, *case)
    owners = {}
    for kind, laid in _state_leaves(serve, caches):
        for j, b in enumerate(laid.blocks):
            owners.setdefault(b.untyped_storage().data_ptr(),
                              (set(), tuple(b.shape[1:]),
                               kind == "mamba"))[0].add(j)
    sent, writes = [], []          # the sent tensors kept: no address reuse
    send, put, run_at = S.send, L._put_state, S.ModelRow.run_at

    def recording(t, mesh, src, dst, out=None):
        if src is not None and src != dst:
            sent.append(t)
        return send(t, mesh, src, dst, out=out)

    def noted(self, slot, fn, *args, **kwargs):
        if fn is put:
            block, new = args
            writes.append((slot, block.untyped_storage().data_ptr(),
                           tuple(block.shape), new.untyped_storage()
                           .data_ptr(), {t.untyped_storage().data_ptr()
                                         for t in sent}))
        return run_at(self, slot, fn, *args, **kwargs)

    monkeypatch.setattr(S, "send", recording)
    monkeypatch.setattr(S.ModelRow, "run_at", noted)
    mamba_moves = 0
    with torch.no_grad():
        for i, batch in enumerate([first] + steps):
            sent.clear()
            writes.clear()
            (serve.decode if i else serve.prefill)(params, batch, caches)
            assert writes
            row = serve.rows[serve.running[0]]
            for slot, ptr, shape, new, moved in writes:
                held, whole, mamba = owners[ptr]
                assert slot in held and shape[-len(whole):] == whole
                if mamba and new in moved:
                    assert slot not in row
                    mamba_moves += 1
    assert (mamba_moves > 0) == (case[1] and name.startswith("jamba"))
    monkeypatch.undo()
    counts = []
    inside = [0]

    def counting(t, mesh, src, dst, out=None):
        n[0] += inside[0] and src is not None and src != dst
        return send(t, mesh, src, dst, out=out)

    def within(fn):
        def run(*args, **kwargs):
            inside[0] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                inside[0] -= 1
        return run
    for prompt in (PROMPT, 2 * PROMPT):
        serve, params, caches, first, _ = _serve(name, *case, prompt=prompt)
        n = [0]
        monkeypatch.setattr(S, "send", counting)
        monkeypatch.setattr(M, "_mamba_split", within(M._mamba_split))
        monkeypatch.setattr(X, "_mlstm_split", within(X._mlstm_split))
        with torch.no_grad():
            serve.prefill(params, first, caches)
        monkeypatch.undo()
        counts.append(n[0])
    assert counts[0] == counts[1] > 0
