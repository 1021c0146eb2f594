"""The encoder-decoder on the model axis, on 8 CPU slots: the split form
of cross-attention (``models/layers.py::_cross_split``, the encoder's
output handed in as a ``layers.Replicas``) against the plain one on 2, 4
and 8 slots, with ``wk``/``wv`` split (seamless's smoke: 4 KV heads, 2
and 1 a slot) and replicated (degree 8: the 4 heads padded to 8, one a
slot, each sent the KV head it reads); its collectives under
``gradcheck`` in float64, the encoder output's gradient included; and
the moves of seamless's split steps: a train step sends the encoder's
output to each model slot once, whatever the decoder's depth, and a
decode step (``launch/serve.py::MeshServe``, each slot reading its own
copy) sends no byte of it; the gathered step's transfers still equal
its sends.  The split steps against the gathered ones and the reference
are ``tests/test_torch_model_axis.py``'s, ``test_torch_mesh_serve.py``'s
and ``test_torch_mesh_train.py``'s.

Tolerance: the split cross-attention's output and gradients within 1e-5
of their largest element (fp32)."""
import collections
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import SMOKES
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import MeshServe
from repro_torch.models import build, encdec as E, layers as L
from repro_torch.train import Trainer, optimizer as O, sharded as S
from _model_axis import CPU, mesh_step
from _torch_threads import one_torch_thread  # noqa: F401

ARCH = "seamless-m4t-large-v2"
TOL = 1e-5
SEQ, FRAMES, BATCH = 16, 12, 8


def _row(n):
    """A (1, n) mesh's one row, every send recorded as (src, dst,
    storage of what it moves)."""
    mesh = make_host_mesh(devices=[CPU] * n, shape=(1, n))
    moved = []

    def send(t, src, dst):
        if src != dst:
            moved.append((src, dst, t.untyped_storage().data_ptr()))
        return S.send(t, mesh, src, dst)

    return mesh, S.ModelRow(range(n), send), moved


def _cross_params(cfg, n, dtype=torch.float32):
    """A cross-attention layer's parameters at model degree n (heads
    padded as ``attn_defs`` pads them), whole, and as ``Blocks`` of the
    one row's slots, each block a leaf of its own that asks for a
    gradient; the row, and its recorded sends."""
    mesh, row, moved = _row(n)
    with L.use_mesh(mesh):
        defs = L.attn_defs(cfg, n)
        specs = L.pspec_tree(defs)
    p = L.tree_map(lambda a: a.to(dtype),
                   L.init_tree(defs, 3, torch.device(CPU)))
    laid = S.lay_out_tree(p, S.layouts(mesh, specs))
    blocks = L.tree_map(lambda b: dataclasses.replace(b, blocks=tuple(
        t.detach().clone().requires_grad_(True) for t in b.blocks)),
        S.row_blocks(laid, row))
    return p, blocks, row, moved


def _inputs(cfg, dtype=torch.float32, b=2, t=5, s=7):
    g = torch.Generator().manual_seed(1)
    return (torch.randn(b, t, cfg.d_model, generator=g).to(dtype),
            torch.randn(b, s, cfg.d_model, generator=g).to(dtype))


@pytest.mark.parametrize("n,kv_len", [(2, None), (4, None), (8, None),
                                      (2, (7, 4))])
def test_the_split_cross_attention_equals_the_plain_one(n, kv_len):
    """Output, and the gradients of the query input, the encoder's output
    and every parameter, on n slots against ``attn_apply`` on the whole
    layer with ``encdec._cross_kv``: ``wk``/``wv`` split at 2 and 4,
    replicated at 8 (4 heads padded to 8); and with ``kv_len`` masking
    the encoder's positions of each sequence, sent to every slot."""
    kv_len = None if kv_len is None else torch.tensor(kv_len)
    cfg = SMOKES[ARCH].replace(dtype="float32")
    p, blocks, row, _ = _cross_params(cfg, n)
    split = n < 8
    assert (blocks["wk"].dim is not None) == split
    assert p["wq"].shape[1] == (4 if split else 8)
    x, enc = _inputs(cfg)
    xs, encs = (t.clone().requires_grad_(True) for t in (x, enc))
    leaves = [b for k in sorted(blocks) for b in blocks[k].blocks]
    got, _ = L.attn_apply(blocks, xs, cfg,
                          kv_override=E.cross_input(
                              {"dec": {"cross": blocks}}, encs),
                          kv_len=kv_len)
    x0, enc0 = (t.clone().requires_grad_(True) for t in (x, enc))
    whole = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    want, _ = L.attn_apply(whole, x0, cfg,
                           kv_override=E._cross_kv(whole, enc0, cfg),
                           kv_len=kv_len)
    scale = float(want.detach().abs().max())
    assert float((got - want).detach().abs().max()) <= TOL * scale
    g = torch.randn_like(want)
    got_g = torch.autograd.grad(got, [xs, encs] + leaves, g)
    want_g = torch.autograd.grad(want, [x0, enc0] + [
        whole[k] for k in sorted(blocks)], g)
    for a, w in zip(got_g[:2], want_g[:2]):
        assert float((a - w).abs().max()) <= TOL * float(w.abs().max())
    at = 2
    for k in sorted(blocks):
        bl = blocks[k]
        parts = got_g[at:at + len(bl.blocks)]
        at += len(bl.blocks)
        a = torch.cat(parts, dim=bl.dim) if bl.dim is not None else parts[0]
        w = want_g[2 + sorted(blocks).index(k)]
        assert float((a - w).abs().max()) <= TOL * float(w.abs().max()), k


def _sdpa64(q, k, v, *, causal, window, q_pos0=0, kv_len=None, dtype=None):
    """Full attention in q's dtype throughout (the plain version's
    scores are fp32), so that float64 gradcheck sees the collectives."""
    s = torch.einsum("btkgd,bskd->bkgts", q, k) / np.sqrt(q.shape[-1])
    return torch.einsum("bkgts,bskd->btkgd", torch.softmax(s, dim=-1), v)


@pytest.mark.parametrize("n", [2, 4])
def test_the_cross_paths_collectives_pass_gradcheck(monkeypatch, n):
    """The query input, the encoder's output (sent to each slot once by
    ``cross_input`` where ``wk``/``wv`` split: 2 KV heads over 2 slots;
    projected on the first slot and sent by KV-head ranges where they are
    replicated: 2 over 4) and a ``wq`` block, in float64 through the
    split form's scatters and slot-order sum."""
    monkeypatch.setattr(L, "_sdpa", _sdpa64)
    cfg = SMOKES[ARCH].replace(dtype="float64", d_model=8, num_heads=4,
                               num_kv_heads=2, head_dim=2)
    p, blocks, row, moved = _cross_params(cfg, n, torch.float64)
    assert (blocks["wk"].dim is not None) == (n == 2)
    x, enc = (t.requires_grad_(True)
              for t in _inputs(cfg, torch.float64, b=1, t=2, s=3))
    wq = blocks["wq"].blocks[1].clone().requires_grad_(True)

    def fn(x, enc, wq):
        bl = dict(blocks, wq=dataclasses.replace(
            blocks["wq"], blocks=(blocks["wq"].blocks[0], wq)
            + blocks["wq"].blocks[2:]))
        y, _ = L.attn_apply(bl, x, cfg, kv_override=E.cross_input(
            {"dec": {"cross": bl}}, enc))
        return y

    assert torch.autograd.gradcheck(fn, (x, enc, wq))
    moved.clear()
    fn(x, enc, wq).sum().backward()
    enc_ptr = enc.untyped_storage().data_ptr()
    # the encoder's output itself goes out only where wk/wv split
    assert sum(ptr == enc_ptr for *_, ptr in moved) == (n - 1) * (n == 2)
    assert enc.grad is not None and float(enc.grad.abs().max()) > 0


def _sends(monkeypatch):
    """Every send between slots from here on: (src, dst, shape,
    storage, bytes); each tensor sent is kept, so that no later tensor
    takes its storage's address."""
    sends, alive = [], []
    send = S.send

    def recording(t, mesh, src, dst, out=None):
        if src is not None and src != dst:
            alive.append(t)
            sends.append((src, dst, tuple(t.shape),
                          t.untyped_storage().data_ptr(),
                          t.numel() * t.element_size()))
        return send(t, mesh, src, dst, out=out)

    monkeypatch.setattr(S, "send", recording)
    return sends


@pytest.mark.parametrize("mesh_shape", [(2, 4), (1, 8)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_a_train_step_sends_the_encoder_output_once(monkeypatch,
                                                    mesh_shape):
    """A split train step's sends of the encoder's output (its storage)
    to the model slots, and of every tensor of its shape (the encoder
    layers' activations and partials, the output's gradient back), with
    a decoder of 1 and of 3 layers: the output goes to each model slot
    once a data row where ``wk``/``wv`` split ((2, 4)), never where they
    are replicated ((1, 8): k/v sent by KV heads, a layer at a time), and
    no decoder layer moves a tensor of its shape."""
    d, m = mesh_shape
    counts = []
    for layers in (1, 3):
        monkeypatch.setitem(SMOKES, ARCH,
                            SMOKES[ARCH].replace(num_layers=layers))
        _, parts, params, _, batch = mesh_step(ARCH, mesh_shape, SEQ, BATCH)
        monkeypatch.undo()
        assert parts.split and parts.api.cfg.num_layers == layers
        batch["frames"] = torch.randn(
            BATCH, FRAMES, 64, generator=torch.Generator().manual_seed(2))
        outs = []
        encode = E.encode

        def noted(*args, **kwargs):
            outs.append(encode(*args, **kwargs))
            return outs[-1]

        monkeypatch.setattr(E, "encode", noted)
        sends = _sends(monkeypatch)
        with L.use_mesh(parts.mesh):
            parts.grads(params, batch)
        monkeypatch.undo()
        mine = {o.untyped_storage().data_ptr() for o in outs}
        assert len(outs) == d
        out = [(s, t) for s, t, _, ptr, _ in sends if ptr in mine]
        rows = BATCH // d
        shaped = sum(shape == (rows, FRAMES, 64) for _, _, shape, _, _ in sends)
        counts.append((sorted(out), shaped))
        want = sorted((r, r + j) for r in range(0, d * m, m)
                      for j in range(1, m)) if m < 8 else []
        assert sorted(out) == want
    assert counts[0] == counts[1]


@pytest.mark.parametrize("mesh_shape", [(2, 4), (1, 8)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_a_decode_step_sends_no_encoder_byte(monkeypatch, mesh_shape):
    """After a split prefill, whose encoder output comes back laid out
    with a copy on each slot of the row, a decode step reads each model
    slot's own copy (each a tensor of its own here) where ``wk``/``wv``
    split ((2, 4)): every slot's cross-attention is handed its own, and
    no send reads a copy or moves a tensor over the encoder's positions.
    Where they are replicated ((1, 8)) the first slot projects k/v from
    its copy, and only the KV head each other slot reads goes out, a
    layer at a time."""
    d, m = mesh_shape
    cfg = SMOKES[ARCH].replace(dtype="float32")
    api = build(cfg, tp=m)
    mesh = make_host_mesh(devices=[CPU] * (d * m), shape=mesh_shape)
    serve = MeshServe(api, mesh)
    assert serve.split
    params = serve.lay_out_params(api.init_params(0, CPU))
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, SEQ + 1), generator=g,
                           dtype=torch.int32)
    frames = torch.randn(BATCH, FRAMES, cfg.d_model, generator=g)
    caches = serve.init_caches(BATCH, 2 * SEQ)
    with torch.no_grad():
        _, caches, enc = serve.prefill(params, serve.lay_out_inputs(
            {"tokens": tokens[:, :SEQ], "frames": frames}), caches)
    rows = BATCH // d
    assert [tuple(b.shape) for b in enc.blocks] == \
        [(rows, FRAMES, cfg.d_model)] * (d * m)
    enc = S.Laid(enc.layout, enc.shape, [b.clone() for b in enc.blocks])
    copies = [b.untyped_storage().data_ptr() for b in enc.blocks]
    inputs = serve.lay_out_inputs(
        {"tokens": tokens[:, SEQ:],
         "lengths": torch.full((BATCH,), SEQ, dtype=torch.int32)})
    inputs["enc_out"] = enc
    read = []
    run_at = S.ModelRow.run_at

    def noted(self, slot, fn, *args, **kwargs):
        if fn is L._cross_slot:
            read.append((slot, None if args[6] is None
                         else args[6].untyped_storage().data_ptr()))
        return run_at(self, slot, fn, *args, **kwargs)

    monkeypatch.setattr(S.ModelRow, "run_at", noted)
    sends = _sends(monkeypatch)
    with torch.no_grad():
        serve.decode(params, inputs, caches)
    monkeypatch.undo()
    every = [(j, copies[j] if m < 8 else None) for j in range(d * m)]
    assert sorted(read) == sorted(every * cfg.num_layers)
    assert sends and not any(ptr in copies for _, _, _, ptr, _ in sends)
    over_frames = [s for s in sends if len(s[2]) > 1 and s[2][1] == FRAMES]
    if m < 8:
        assert not over_frames
    else:                       # k and v, one KV head, every other slot
        assert len(over_frames) == 2 * (m - 1) * cfg.num_layers
        assert all(shape[2] == 1 for _, _, shape, _, _ in over_frames)


def test_the_gathered_steps_transfers_equal_its_sends(monkeypatch):
    """With ``model_split`` off, seamless's meshed train step gathers the
    parameters onto each data row's first slot again: ``transfers``
    (kind "gather", no "encoder") against the bytes it sends on (2, 4)
    with ZeRO-1."""
    monkeypatch.setattr(type(build(SMOKES[ARCH])), "model_split",
                        lambda self: False)
    cfg = SMOKES[ARCH]
    shape = ShapeConfig("s", "train", SEQ, BATCH)
    mesh = make_host_mesh(devices=[CPU] * 8, shape=(2, 4))
    api = build(cfg, tp=4)
    tr = Trainer(api, shape, mesh=mesh, zero1=True)
    params, opt, _ = tr.init_or_restore()
    g = torch.Generator().manual_seed(0)
    batch = {k: (torch.randint(0, cfg.vocab_size, v.shape, generator=g,
                               dtype=v.dtype)
                 if not v.dtype.is_floating_point else
                 torch.randn(v.shape, generator=g).to(v.dtype))
             for k, v in api.input_specs(shape).items()}
    sends = _sends(monkeypatch)
    with L.use_mesh(mesh):
        tr.step_fn(params, opt, batch)
    moved = collections.Counter()
    for src, dst, _, _, n in sends:
        moved[src, dst] += n
    cell, _ = D.lower_cell(cfg, shape, mesh)
    assert not D.model_split(cell)
    with L.use_mesh(mesh):
        specs = O.opt_pspecs(api.param_defs(), zero1=True,
                             dp_axes=("data",), dp_size=2)
    cell = dataclasses.replace(cell, trees={
        **cell.trees, "opt": (cell.trees["opt"][0], specs)})
    kinds = D.transfers(cell)
    assert "gather" in kinds and "encoder" not in kinds
    counted = collections.Counter()
    for kind in kinds.values():
        counted.update(kind)
    assert dict(counted) == dict(moved)
