"""The dry run's analysis half (``repro_torch/launch/dryrun.py``,
``launch/memtrace.py``, ``kernels/cost.py``) on the CPU:

(a) the storage tracker's live bytes: views and in-place ops add
    nothing, frees leave, autograd's saved tensors leave at backward, a
    checkpointed region's recomputed activations leave as backward uses
    them; the same figures on CPU and ``meta`` tensors;
(b) a real CPU step's peak, traced, equals the dry run's ``meta`` trace
    of the same cell at a (1, 1) mesh at the byte, on the plain route
    (``layers.on_card`` and the rmsnorm kernel's branch patched to the
    plain versions on both): a train, a prefill and a decode smoke cell;
    the (2, 1) trace of a train cell is the (1, 1) trace at the same
    shard batch plus the other shard's rows and the gradient sum on slot
    0, in closed form; a cell traced at a smaller shape than its own
    judges ``fits`` on a lower bound;
(c) ``dot_flops`` against the reference's loop-expanded HLO dots
    (``benchmarks/hlo_analysis.py::expanded_analysis`` of the jitted
    step, compiled on the CPU off any mesh), train and decode for each
    family and prefill for three, within 1 %, or within 1 % of the ratio
    measured where the port does other products by design (ROADMAP §C);
(d) ``transfers`` against every byte that ``Trainer(mesh=...)``'s real
    step sends between slots on 8 CPU slots, recorded by wrapping
    ``train/sharded.py::send``, at the byte, on (2, 4) and (4, 2) meshes
    with and without ZeRO-1 (the split steps of llama3.2-3b, the two
    MoE families, jamba, xlstm and seamless, an MoE's dispatch and
    combine, the recurrent mixers' reshuffles and the encoder's output
    to each model slot among them), and ``serve_transfers`` against ``MeshServe``'s split prefill
    and decode steps the same way (the recurrent states' copies among
    them);
(e) the kernels' cost functions: flash's closed form of the visible
    pairs against the loop it replaced, the bounds ``chip_smoke.py``
    computed before against the package's, decode's count on ``meta``,
    and decode_attention's scratch on ``meta``.
"""
import collections
import dataclasses
import inspect

import jax
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from benchmarks.hlo_analysis import expanded_analysis
from repro.configs import SMOKES as J_SMOKES
from repro.configs.base import ShapeConfig as JShape
from repro.models import build as jbuild
from repro.train import optimizer as JO
from repro.train.trainer import make_train_step as j_make_train_step
from repro_torch import kernels
from repro_torch.configs import SMOKES
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import cost
from repro_torch.launch import dryrun as D
from repro_torch.launch.memtrace import StepTrace
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build, layers as L
from repro_torch.train import Trainer, optimizer as O, sharded as S
from repro_torch.train.trainer import make_mesh_train_step
from _model_axis import ROW_PARALLEL, smoke
from _torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
META = torch.device("meta")
DEVICES = (CPU, META)
DA = kernels._module("decode_attention")
RN = kernels._module("rmsnorm")


# ------------------------------------------------------------ (a) tracker
@pytest.mark.parametrize("dev", DEVICES)
def test_views_and_in_place_ops_add_nothing_and_frees_leave(dev):
    with StepTrace() as tr:
        x = torch.ones(256, device=dev)
        assert tr.live_bytes == 1024
        v = x.view(16, 16)
        x.add_(1)
        v[3:5].mul_(2)
        assert tr.live_bytes == tr.peak_bytes == 1024
        y = x * 2
        assert tr.live_bytes == tr.peak_bytes == 2048
        del y
        assert tr.live_bytes == 1024 and tr.peak_bytes == 2048


@pytest.mark.parametrize("dev", DEVICES)
def test_unheld_inputs_and_paused_ops_count_nothing(dev):
    """A tensor from before the trace counts only once held; a view or an
    in-place op on one the trace does not hold adds nothing; what is
    made under ``paused`` is not held."""
    a = torch.empty(64, device=dev)
    with StepTrace() as tr:
        a[:8].zero_()
        assert tr.live_bytes == 0
        with tr.paused():
            b = torch.empty(64, device=dev) + 1
        assert tr.live_bytes == 0 and tr.flops == 0
        assert tr.hold((a, [a])) == 256 and tr.held_bytes == 256
        c = a + b
        assert tr.live_bytes == 512
        del c


def _mlp(w, x):
    return torch.tanh(torch.tanh(x @ w) @ w)


@pytest.mark.parametrize("remat", [False, True])
def test_saved_tensors_leave_at_backward_the_same_on_cpu_and_meta(remat):
    """Autograd's saved activations count until backward releases them;
    under ``torch.utils.checkpoint`` the forward saves none and the
    recomputed ones leave as backward uses them.  CPU and ``meta`` give
    the same figures, byte for byte."""
    got = {}
    for dev in DEVICES:
        w = torch.empty(64, 64, device=dev, requires_grad=True)
        x = torch.empty(32, 64, device=dev)
        with StepTrace() as tr:
            tr.hold((w, x))
            y = checkpoint(_mlp, w, x, use_reentrant=False) if remat \
                else _mlp(w, x)
            loss = y.sum()
            del y
            saved = tr.live_bytes - tr.held_bytes - loss.nbytes
            g, = torch.autograd.grad(loss, (w,))
            after = tr.live_bytes
        assert after == tr.held_bytes + g.nbytes + loss.nbytes, dev
        # two products forward, three backward (x needs no gradient), and
        # the forward's two again under remat
        assert tr.flops == tr.dot_flops == (5 + 2 * remat) * 2 * 32 * 64 * 64

        got[dev.type] = (saved, tr.peak_bytes)
    assert got["cpu"] == got["meta"]
    saved, peak = got["cpu"]
    # tanh saves its output, mm its inputs: two (32, 64) fp32 activations
    assert saved == (0 if remat else 2 * 32 * 64 * 4)


# --------------------------------- (b) a real CPU step against the trace
@pytest.fixture
def plain_route(monkeypatch):
    """The plain versions on CPU and meta tensors alike: the card's
    attention routes and the rmsnorm kernel's branch replaced."""
    monkeypatch.setattr(L, "on_card", lambda t: False)
    monkeypatch.setattr(RN, "_rmsnorm", lambda x, w, eps:
                        kernels.ref.rmsnorm_ref(x, w, eps=eps))


def _inputs(api, shape):
    """The step's inputs on the CPU at their specs' shapes: small integers
    (tokens, labels, lengths below the sequence), normal floats."""
    g = torch.Generator().manual_seed(0)
    return {k: (torch.randint(0, 8, v.shape, generator=g, dtype=v.dtype)
                if not v.dtype.is_floating_point else
                torch.randn(v.shape, generator=g).to(v.dtype))
            for k, v in api.input_specs(shape).items()}


def _cpu_peak(cfg, shape):
    """(held, peak) bytes of the real step on the CPU at a (1, 1) mesh:
    train through ``make_mesh_train_step``, serving through the step on
    bf16 parameters and zero caches."""
    api = build(cfg, tp=1)
    params = api.init_params(0, CPU)
    batch = _inputs(api, shape)
    tr = StepTrace()
    if shape.kind == "train":
        mesh = make_host_mesh(devices=[CPU], shape=(1, 1))
        with L.use_mesh(mesh):
            specs = (api.param_pspecs(), O.opt_pspecs(api.param_defs()),
                     api.input_pspecs(shape))
        p = S.lay_out_tree(params, S.layouts(mesh, specs[0]))
        o = S.lay_out_tree(O.init_state(params), S.layouts(mesh, specs[1]))
        step = make_mesh_train_step(api, O.AdamWConfig(), mesh,
                                    param_specs=specs[0], opt_specs=specs[1],
                                    batch_specs=specs[2])
        tr.hold(([b for a in L.tree_leaves((p, o)) for b in a.blocks],
                 batch))
        with tr, L.use_mesh(mesh):
            step(p, o, batch)
        return tr.held_bytes, tr.peak_bytes
    params = L.tree_map(lambda t: t.to(torch.bfloat16)
                        if t.is_floating_point() else t, params)
    caches = L.init_tree(api.cache_defs(shape.global_batch, shape.seq_len),
                         0, CPU)
    tr.hold((params, caches, batch))
    step = api.prefill if shape.kind == "prefill" else api.decode
    with tr, torch.no_grad():
        step(params, batch, caches)
    return tr.held_bytes, tr.peak_bytes


def _grads_sum_traced(cell, shape, monkeypatch):
    """(trace, live bytes just after slot 0's own ``shard_grads``, the
    most live from then until ``grads`` returns): the dry run's trace of
    ``cell``'s train step."""
    seen = {}
    own, grads = D.SlotStep.shard_grads, D.SlotStep.grads

    def spied(self, params, batch, cnt, i):
        out = own(self, params, batch, cnt, i)
        if i == 0:
            tr = self.trace
            seen.update(after=tr.live_bytes, before=tr.peak_bytes)
            tr.peak_bytes = tr.live_bytes
        return out

    def summed(self, params, batch):
        out = grads(self, params, batch)
        tr = self.trace
        seen["sum"] = tr.peak_bytes
        tr.peak_bytes = max(seen["before"], tr.peak_bytes)
        return out

    monkeypatch.setattr(D.SlotStep, "shard_grads", spied)
    monkeypatch.setattr(D.SlotStep, "grads", summed)
    tr = StepTrace()
    D.trace_cell(cell, shape, tr)
    monkeypatch.undo()
    return tr, seen["after"], seen["sum"]


def test_data_parallel_trace_adds_the_other_rows_and_the_gradient_sum(
        monkeypatch):
    """At (2, 1) slot 0 runs the (1, 1) program at the same shard batch,
    holding the other shard's rows beside its own (bytes beyond the
    arguments), and then sums the other shard's gradients: each leaf
    arrives in a buffer of its own and is added to slot 0's, leaf by leaf
    in tree order, with slot 0's own leaves, the sums so far, and the
    other shard's weighted cross-entropy and share of the aux loss (4
    bytes each, arrived first) live.  At (1, 1) nothing arrives: the aux
    loss over dp beside the aux (4 bytes) is all.  The rest of the step
    is the (1, 1) step's."""
    cfg, b, seq = SMOKES["llama3.2-3b"], 2, 32
    runs = {}
    for dp in (1, 2):
        shape = ShapeConfig("s", "train", seq, b * dp)
        cell, _ = D.lower_cell(cfg, shape,
                               D.meta_mesh((dp, 1), ("data", "model")))
        tr, after, most = _grads_sum_traced(cell, shape, monkeypatch)
        assert tr.held_bytes == D.memory(cell)["argument_size_in_bytes"]
        runs[dp] = (tr, after - tr.held_bytes, most - after)
    (one, l1, sum1), (two, l2, sum2) = runs[1], runs[2]
    rows = sum(v.nbytes for v in cell.api.input_specs(
        ShapeConfig("s", "train", seq, b)).values())
    sums, transient = 0, 0
    for g in L.tree_leaves(cell.trees["params"][0]):
        sums += g.nbytes
        transient = max(transient, sums + g.nbytes)
    assert two.held_bytes == one.held_bytes
    assert l2 == l1 + rows
    assert (sum1, sum2) == (4, 8 + transient)
    assert two.peak_bytes - two.held_bytes == rows + max(
        one.peak_bytes - one.held_bytes, l1 + sum2)


def test_a_smaller_trace_shape_gives_a_lower_bound():
    """A cell traced below its own shape: ``fits`` is None while the
    bound fits, False once it passes the card; at its own shape a
    bool."""
    cfg = SMOKES["llama3.2-3b"]
    mesh = D.meta_mesh((1, 1), ("data", "model"))
    shape = ShapeConfig("s", "train", 64, 4)
    _, whole = D.analyze_cell(cfg, shape, mesh)
    _, part = D.analyze_cell(cfg, shape, mesh,
                             trace_shape=ShapeConfig("s", "train", 32, 2))
    assert whole["fits"] is True and not whole["memory"]["peak_is_lower_bound"]
    assert part["fits"] is None and part["memory"]["peak_is_lower_bound"]
    assert part["memory"]["peak_bytes"] < whole["memory"]["peak_bytes"]
    trace = StepTrace()
    trace.peak_bytes = D.CARD_BYTES + 1
    mem = {"argument_size_in_bytes": 0}
    assert D.step_record(mem, trace, lower_bound=True)["fits"] is False
    assert D.step_record(mem, trace)["fits"] is False
    trace.peak_bytes = D.CARD_BYTES
    assert D.step_record(mem, trace, lower_bound=True)["fits"] is None
    assert D.step_record(mem, trace)["fits"] is True


@pytest.mark.parametrize("arch,kind", [("llama3.2-3b", "train"),
                                       ("gemma3-12b", "prefill"),
                                       ("llama3.2-3b", "decode")])
def test_meta_peak_equals_a_real_cpu_steps(arch, kind, plain_route):
    shape = ShapeConfig("s", kind, 32, 2)
    cell, _ = D.lower_cell(SMOKES[arch], shape,
                           D.meta_mesh((1, 1), ("data", "model")))
    tr = StepTrace()
    D.trace_cell(cell, shape, tr)
    held, peak = _cpu_peak(SMOKES[arch], shape)
    assert (tr.held_bytes, tr.peak_bytes) == (held, peak)
    assert tr.held_bytes == D.memory(cell)["argument_size_in_bytes"]
    assert peak > held


# ------------------------------------- (c) dot flops against the HLO's
# the port's dot_flops over the reference's HLO dots where the port does
# other products by design (ROADMAP §C): the flash Function's backward
# rebuilds P from q and k, one QK^T a layer more than XLA's autodiff,
# which keeps P; mLSTM's outer products (a contraction of size 1) are
# bmm's in torch and multiplies in the optimised HLO.  Measured here.
TRAIN_RATIO = {"llama3.2-3b": 1.0185, "gemma3-12b": 1.0210,
               "internvl2-76b": 1.0196, "phi3.5-moe-42b-a6.6b": 1.0108,
               "seamless-m4t-large-v2": 1.0129, "xlstm-125m": 1.0122}
FLOPS_SHAPE = {"seq": 64, "batch": 2}
FLOPS_CELLS = [(a, "train") for a in ("llama3.2-3b", "gemma3-12b",
                                      "minicpm3-4b", "phi3.5-moe-42b-a6.6b",
                                      "jamba-v0.1-52b", "xlstm-125m",
                                      "seamless-m4t-large-v2",
                                      "internvl2-76b")] + \
    [(a, "decode") for a in ("llama3.2-3b", "gemma3-12b", "minicpm3-4b",
                             "phi3.5-moe-42b-a6.6b", "jamba-v0.1-52b",
                             "xlstm-125m", "seamless-m4t-large-v2",
                             "internvl2-76b")] + \
    [(a, "prefill") for a in ("llama3.2-3b", "gemma3-12b",
                              "phi3.5-moe-42b-a6.6b")]


def _hlo_dot_flops(arch, kind, seq, b) -> float:
    api = jbuild(J_SMOKES[arch], tp=1)
    batch = api.input_specs(JShape("s", kind, seq, b))
    if kind == "train":
        params = api.abstract_params()
        lowered = jax.jit(j_make_train_step(api, JO.AdamWConfig())).lower(
            params, JO.abstract_state(params), batch)
    else:
        params = api.abstract_params(dtype="bfloat16")
        step = api.prefill if kind == "prefill" else api.decode
        lowered = jax.jit(step).lower(params, batch,
                                      api.abstract_cache(b, seq))
    ea = expanded_analysis(lowered.compile().as_text())
    assert ea["unknown_loops"] == 0
    return ea["flops"]


@pytest.mark.parametrize("arch,kind", FLOPS_CELLS)
def test_dot_flops_match_the_references_hlo(arch, kind):
    seq, b = FLOPS_SHAPE["seq"], FLOPS_SHAPE["batch"]
    shape = ShapeConfig("s", kind, seq, b)
    _, rec = D.analyze_cell(SMOKES[arch], shape,
                            D.meta_mesh((1, 1), ("data", "model")))
    ratio = rec["dot_flops"] / _hlo_dot_flops(arch, kind, seq, b)
    want = TRAIN_RATIO.get(arch, 1.0) if kind == "train" else 1.0
    assert abs(ratio / want - 1) <= 0.01, (arch, kind, ratio, want)
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0


# -------------------------------- (d) transfers against the real step's
def _recorded_sends(monkeypatch):
    moved = collections.Counter()
    send = S.send

    def recording(t, mesh, src, dst, out=None):
        if src is not None and src != dst:
            moved[src, dst] += t.numel() * t.element_size()
        return send(t, mesh, src, dst, out=out)

    monkeypatch.setattr(S, "send", recording)
    return moved


# the steps that split over the model axis: jamba's and xlstm's recurrent
# mixers and the encoder-decoder's cross-attention among them
SPLIT_TRAIN = ("llama3.2-3b", "phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e",
               "jamba-v0.1-52b", "xlstm-125m")
ENCDEC = "seamless-m4t-large-v2"


@pytest.mark.parametrize("zero1", [False, True])
@pytest.mark.parametrize("mesh_shape", [(2, 4), (4, 2)])
@pytest.mark.parametrize("arch", SPLIT_TRAIN + (ENCDEC,))
def test_transfers_equal_the_bytes_a_meshed_step_sends(arch, mesh_shape,
                                                       zero1, monkeypatch):
    """llama3.2-3b's, phi3.5-moe's, llama4-scout's, jamba's, xlstm's and
    seamless's steps split over the model axis (their layers' forward,
    backward and remat-recompute sends, an MoE's dispatch rows and expert
    outputs, the Mamba and mLSTM reshuffles and seamless's encoder output
    to each model slot and its gradient back ("encoder") among them, the
    embedding's and the loss's combines, the gradient summed block by
    block).  The gathered step's (the parameters gathered onto each data
    row's first slot) is ``tests/test_torch_encdec_axis.py``'s."""
    cfg = SMOKES[arch]
    shape = ShapeConfig("s", "train", 16, 8)
    mesh = make_host_mesh(devices=[CPU] * 8, shape=mesh_shape)
    api = build(cfg, tp=mesh_shape[1])
    tr = Trainer(api, shape, mesh=mesh, zero1=zero1)
    params, opt, _ = tr.init_or_restore()
    batch = _inputs(api, shape)
    batch["labels"][0, :3] = -1                 # labels that do not count
    moved = _recorded_sends(monkeypatch)
    with L.use_mesh(mesh):
        tr.step_fn(params, opt, batch)
    cell, _ = D.lower_cell(cfg, shape, mesh)
    if zero1:
        with L.use_mesh(mesh):
            specs = O.opt_pspecs(api.param_defs(), zero1=True,
                                 dp_axes=("data",), dp_size=mesh_shape[0])
        cell = dataclasses.replace(cell, trees={
            **cell.trees, "opt": (cell.trees["opt"][0], specs)})
    counted = collections.Counter()
    kinds = D.transfers(cell)
    for m in kinds.values():
        counted.update(m)
    assert dict(counted) == dict(moved)
    split = D.model_split(cell)
    assert split
    assert ("encoder" in kinds) == (arch == ENCDEC)
    assert ("layback" in kinds) == zero1
    # a split step's slots read their moments' slices from their own blocks
    assert ("relayout" in kinds) == (zero1 and not split)
    assert ("gather" in kinds) != split
    assert all(k in kinds for k in ("forward", "backward", "recompute",
                                    "embed", "loss")) == split
    rec = D.collectives(cell)
    per = np.zeros(8, dtype=np.int64)
    for (src, dst), n in moved.items():
        per[src] += n
        per[dst] += n
    assert rec["total_bytes"] == per.max() and rec["slot"] == 0
    assert rec["mesh_total_bytes"] == sum(moved.values())


def test_serving_cells_record_no_collectives():
    """A gathered serving step moves nothing between slots: on a model
    axis of one (every family splits on a wider one), the
    encoder-decoder's and a decoder's."""
    mesh = D.meta_mesh((8, 1), ("data", "model"))
    for arch in (ENCDEC,):
        for kind in ("prefill", "decode"):
            cell, _ = D.lower_cell(SMOKES[arch],
                                   ShapeConfig("s", kind, 32, 8), mesh)
            assert not D.model_split(cell)
            assert D.collectives(cell) is None
    cell, _ = D.lower_cell(SMOKES["llama3.2-3b"],
                           ShapeConfig("s", "decode", 32, 8),
                           D.meta_mesh((8, 1), ("data", "model")))
    assert D.collectives(cell) is None


def _serve_inputs(api, shape, cell):
    batch = _inputs(api, shape)
    if "lengths" in batch:              # at the dry run's offsets
        batch["lengths"] = torch.tensor(
            D.decode_offsets(shape), dtype=torch.int32)
    return batch


@pytest.mark.parametrize("kind,batch", [("prefill", 8), ("decode", 8),
                                        ("decode", 1)])
@pytest.mark.parametrize("mesh_shape", [(2, 4), (4, 2)])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "gemma3-12b",
                                  "internvl2-76b", "phi3.5-moe-42b-a6.6b",
                                  "llama4-scout-17b-a16e", "jamba-v0.1-52b",
                                  "xlstm-125m", ENCDEC])
def test_serve_transfers_equal_the_bytes_a_meshed_serving_step_sends(
        arch, mesh_shape, kind, batch, monkeypatch):
    """``transfers``'s serving counterpart (``serve_transfers``) against
    every byte that ``MeshServe``'s split step sends between slots on 8
    CPU slots, at the byte: a prefill, a decode step in normal mode and
    in long mode (batch 1), on the cell's own layouts, the decode at the
    dry run's offsets; ``collectives`` reads them as for a train cell."""
    from repro_torch.launch.serve import MeshServe
    cfg = SMOKES[arch]
    shape = ShapeConfig("s", kind, 32, batch)
    mesh = make_host_mesh(devices=[CPU] * 8, shape=mesh_shape)
    cell, _ = D.lower_cell(cfg, shape, mesh)
    api = cell.api
    serve = MeshServe(api, mesh, long_mode=D._is_long_mode(shape))
    params = serve.lay_out_params(L.tree_map(
        lambda t: t.to(torch.bfloat16), api.init_params(0, CPU)))
    caches = serve.init_caches(batch, 32, specs=cell.trees["caches"][1])
    inputs = {k: S.lay_out(v, S.Layout(mesh, cell.trees["inputs"][1][k]))
              for k, v in _serve_inputs(api, shape, cell).items()}
    moved = _recorded_sends(monkeypatch)
    with torch.no_grad():
        (serve.decode if kind == "decode" else serve.prefill)(
            params, inputs, caches)
    kinds = D.serve_transfers(cell)
    counted = collections.Counter()
    for m in kinds.values():
        counted.update(m)
    assert dict(counted) == dict(moved)
    assert D.model_split(cell)
    assert "embed" in kinds and "activations" in kinds
    attention = any(k in ("attn", "local", "nope")
                    for k in cfg.period_pattern)
    assert ("positions" in kinds) == (kind == "decode" and attention)
    moe = cfg.moe is not None
    assert ("dispatch" in kinds) == ("combine" in kinds) == moe
    # the recurrent mixers' reshuffles; mLSTM's and sLSTM's replicated
    # states copied every step, Mamba's split states only to long mode's
    # replicas on the other data rows
    recurrent = cfg.ssm is not None or "mlstm" in cfg.period_pattern
    assert ("reshuffle" in kinds) == ("whole" in kinds) == recurrent
    assert ("state" in kinds) == ("mlstm" in cfg.period_pattern
                                  or (recurrent and batch == 1))
    # the encoder's output to each model slot, once, by a prefill
    assert ("encoder" in kinds) == (arch == ENCDEC and kind == "prefill")
    rec = D.collectives(cell)
    per = np.zeros(8, dtype=np.int64)
    for (src, dst), n in moved.items():
        per[src] += n
        per[dst] += n
    assert rec["total_bytes"] == per.max()
    assert rec["mesh_total_bytes"] == sum(moved.values())


# minicpm3-4b's MLA, and the row-parallel fallback: a vocabulary of 500,
# which the model degree 8 divides no more than 73,448 divides 16, splits
# the embedding table (and an untied head) along d_model
MLA_AXIS = [("minicpm3-4b", (2, 4)), ("minicpm3-4b", (4, 2)),
            ("minicpm3-4b", (1, 8))] + [(n, (1, 8)) for n in ROW_PARALLEL]


@pytest.mark.parametrize("name,mesh_shape", MLA_AXIS,
                         ids=[f"{n}-{m[0]}x{m[1]}" for n, m in MLA_AXIS])
def test_mla_and_row_parallel_transfers_equal_the_sends(name, mesh_shape,
                                                        monkeypatch):
    """``transfers`` of a train step (ZeRO-1 where data > 1) and
    ``serve_transfers`` of a prefill and a decode step at the dry run's
    offsets, against every byte the split steps send on 8 CPU slots:
    an MLA layer's latents out and partials back, its compressed rows to
    the slots holding their positions and, to decode, every block of a
    layer to each model slot ("latent"); the row-parallel embedding's
    columns, loss partials and logits ("logits")."""
    from repro_torch.launch.serve import MeshServe
    cfg = smoke(SMOKES, name, dtype=None)
    mesh = make_host_mesh(devices=[CPU] * 8, shape=mesh_shape)
    rows = cfg.vocab_size % mesh_shape[1] == 0
    zero1 = mesh_shape[0] > 1
    shape = ShapeConfig("s", "train", 16, 8)
    api = build(cfg, tp=mesh_shape[1])
    tr = Trainer(api, shape, mesh=mesh, zero1=zero1)
    params, opt, _ = tr.init_or_restore()
    batch = _inputs(api, shape)
    batch["labels"][0, :3] = -1
    moved = _recorded_sends(monkeypatch)
    with L.use_mesh(mesh):
        tr.step_fn(params, opt, batch)
    monkeypatch.undo()
    cell, _ = D.lower_cell(cfg, shape, mesh)
    if zero1:
        with L.use_mesh(mesh):
            specs = O.opt_pspecs(api.param_defs(), zero1=True,
                                 dp_axes=("data",), dp_size=mesh_shape[0])
        cell = dataclasses.replace(cell, trees={
            **cell.trees, "opt": (cell.trees["opt"][0], specs)})
    counted = collections.Counter()
    for m in D.transfers(cell).values():
        counted.update(m)
    assert D.model_split(cell)
    assert dict(counted) == dict(moved)
    for kind in ("prefill", "decode"):
        shape = ShapeConfig("s", kind, 32, 8)
        cell, _ = D.lower_cell(cfg, shape, mesh)
        serve = MeshServe(cell.api, mesh)
        laid = serve.lay_out_params(L.tree_map(
            lambda t: t.to(torch.bfloat16), cell.api.init_params(0, CPU)))
        caches = serve.init_caches(8, 32, specs=cell.trees["caches"][1])
        inputs = {k: S.lay_out(v, S.Layout(mesh, cell.trees["inputs"][1][k]))
                  for k, v in _serve_inputs(cell.api, shape, cell).items()}
        moved = _recorded_sends(monkeypatch)
        with torch.no_grad():
            (serve.decode if kind == "decode" else serve.prefill)(
                laid, inputs, caches)
        monkeypatch.undo()
        kinds = D.serve_transfers(cell)
        counted = collections.Counter()
        for m in kinds.values():
            counted.update(m)
        assert dict(counted) == dict(moved), kind
        assert ("latent" in kinds) == (kind == "decode"
                                       and cfg.mla is not None)
        assert ("logits" in kinds) != rows


# ------------------------------------------------- (e) the cost functions
def _pairs_loop(t, s, causal, window):
    """The loop ``chip_smoke.py`` counted the visible pairs with."""
    pairs = 0
    for i in range(t):
        hi = min(i, s - 1) if causal else s - 1
        lo = max(0, i - window + 1) if window > 0 else 0
        pairs += max(0, hi - lo + 1)
    return pairs


def test_visible_pairs_closed_form_equals_the_loop():
    for t in (0, 1, 2, 5, 16, 33, 64, 100):
        for s in (0, 1, 3, 16, 40, 64, 130):
            for causal in (False, True):
                for window in (0, 1, 2, 7, 16, 64, 200):
                    assert cost.visible_pairs(
                        t, s, causal=causal, window=window) == \
                        _pairs_loop(t, s, causal, window), \
                        (t, s, causal, window)


def _old_lm_call_cost(name, args, kwargs):
    """``chip_smoke.py``'s ``lm_call_cost`` before it moved here."""
    if name == "rmsnorm":
        x, w = args
        return 2 * x.numel() * x.element_size() + w.numel() * 4, \
            4.0 * x.numel()
    if name == "flash_attention":
        q, k, v = args
        b, hq, t, d = q.shape
        s = k.shape[2]
        pairs = _pairs_loop(t, s, kwargs.get("causal", True),
                            kwargs.get("window", 0))
        return ((2 * q.numel() + k.numel() + v.numel()) * q.element_size(),
                4.0 * b * hq * pairs * d)
    q, k_pages, _, pt, lengths = args
    hkv, d = k_pages.shape[2], k_pages.shape[3]
    cap = pt.shape[1] * k_pages.shape[1]
    n = int(lengths.clamp(min=0, max=cap).sum())
    return ((2 * n * hkv * d + 2 * q.numel()) * q.element_size()
            + (pt.numel() + lengths.numel()) * 4, 4.0 * n * q.shape[1] * d)


def _lm_calls():
    g = torch.Generator().manual_seed(0)
    out = []
    for dt in (torch.float32, torch.bfloat16):
        out.append(("rmsnorm", (torch.empty(500, 3072, dtype=dt),
                                torch.empty(3072)), {}))
        for causal, window in ((True, 0), (True, 1024), (False, 0)):
            out.append(("flash_attention",
                        (torch.empty(4, 16, 1536, 256, dtype=dt),
                         torch.empty(4, 8, 1536, 256, dtype=dt),
                         torch.empty(4, 8, 1536, 256, dtype=dt)),
                        {"causal": causal, "window": window}))
        out.append(("decode_attention",
                    (torch.empty(4, 24, 128, dtype=dt),
                     torch.empty(512, 16, 8, 128, dtype=dt),
                     torch.empty(512, 16, 8, 128, dtype=dt),
                     torch.zeros(4, 40, dtype=torch.int32),
                     torch.randint(-3, 700, (4,), generator=g,
                                   dtype=torch.int32)), {}))
    return out


def test_lm_bounds_are_unchanged():
    for name, args, kw in _lm_calls():
        assert cost.lm_call_cost(name, args, kw) == \
            _old_lm_call_cost(name, args, kw), name


def test_gnn_call_cost_is_chip_smokes():
    g = torch.Generator().manual_seed(0)
    h = torch.randn(50, 8, generator=g)
    nbr = torch.randint(0, 50, (20, 5), generator=g, dtype=torch.int32)
    mask = (torch.rand(20, 5, generator=g) > 0.3).float()
    rows = int(torch.unique(nbr[mask != 0].long()).numel())
    both = int(torch.unique(torch.cat([nbr[mask != 0].long(),
                                       torch.arange(20)])).numel())
    nnz = int((mask != 0).sum())
    ell = 100 * 4 + 100 * 4
    w, bias = torch.randn(8, 6, generator=g), torch.randn(6, generator=g)
    assert cost.call_cost("spmm", (h, nbr, mask)) == \
        (rows * 32 + ell + 20 * 32, 2.0 * nnz * 8)
    assert cost.call_cost("sddmm", (h, nbr, mask)) == \
        (both * 32 + ell + 20 * 5 * 32, 2.0 * nnz * 8)
    assert cost.call_cost("agg_combine", (h, nbr, mask, w, bias)) == \
        (rows * 32 + ell + 8 * 6 * 4 + 24 + 20 * 24,
         2.0 * nnz * 8 + 2.0 * 20 * 8 * 6)
    assert cost.call_cost("gemm", (h, w)) == \
        ((400 + 48 + 300) * 4, 2.0 * 50 * 6 * 8)


def test_decode_counts_the_page_tables_capacity_on_meta():
    name, args, kw = _lm_calls()[-1]
    meta = tuple(torch.empty_like(a, device=META) for a in args)
    nbytes, flops = cost.lm_call_cost(name, meta, kw)
    assert flops == 4.0 * 4 * 40 * 16 * 24 * 128
    assert cost.lm_dot_flops(name, meta, kw) == \
        cost.lm_dot_flops(name, args, kw) == flops
    full = torch.full((4,), 640, dtype=torch.int32)
    assert cost.lm_call_cost(name, args[:4] + (full,), kw) == (nbytes, flops)


def test_decode_scratch_is_allocated_on_meta():
    """The ``meta`` branch allocates the launch's scratch through the
    same :func:`workspace` call the CUDA branch passes to the launch, so
    a trace holds it: B*Hq*n_split*(D+2) fp32 beside the output."""
    src = inspect.getsource(DA.decode_attention)
    assert src.index("workspace(q, k_pages, page_table)") < \
        src.index('q.device.type == "meta"') < src.index("ws.data_ptr()")
    q = torch.empty(3, 8, 64, device=META)
    pages = torch.empty(10, 16, 2, 64, device=META)
    table = torch.empty(3, 9, dtype=torch.int32, device=META)
    lengths = torch.empty(3, dtype=torch.int32, device=META)
    ws, pps = DA.workspace(q, pages, table)
    n_split = -(-9 // DA.pages_per_split(16, 64, 4))
    assert pps == DA.pages_per_split(16, 64, 4)
    assert ws.shape == (3 * 8 * n_split * 66,) and ws.dtype == torch.float32
    with StepTrace() as tr:
        tr.hold((q, pages, table, lengths))
        with torch.no_grad():
            out = kernels.ops.decode_attention(q, pages, pages, table,
                                               lengths)
    assert tr.peak_bytes - tr.held_bytes == out.nbytes + ws.nbytes
    assert tr.kernel_calls == {"decode_attention": 1}


def test_split_decode_trace_is_the_unsplit_one_a_slot_at_a_time():
    """A (1, 2) decode trace against the (1, 1) one in closed form: slot
    0 holds its share of the arguments (half of every split leaf and
    cache, the replicated ones whole), does half of every product (its
    heads, MLP columns, vocabulary block and KV heads), calls the same
    kernels as often (the norms once a row, decode over its own KV
    heads; the norms, whole on the row's first slot, are rmsnorm's
    flops), and holds beyond its arguments at least a partial that
    arrives from slot 1 and at most the (1, 1) step's temporaries plus
    every byte that arrives."""
    cfg = SMOKES["gemma3-27b"]
    shape = ShapeConfig("s", "decode", 32, 2)
    runs = {}
    for m in (1, 2):
        cell, _ = D.lower_cell(cfg, shape,
                               D.meta_mesh((1, m), ("data", "model")))
        tr = StepTrace()
        D.trace_cell(cell, shape, tr)
        runs[m] = (cell, tr)
    (c1, one), (c2, two) = runs[1], runs[2]
    assert D.model_split(c2) and not D.model_split(c1)
    assert two.held_bytes == D.memory(c2)["argument_size_in_bytes"]
    split = replicated = 0
    for tree, specs in (c2.trees["params"], c2.trees["caches"]):
        for leaf, spec in zip(L.tree_leaves(tree), L.tree_leaves(specs)):
            if "model" in spec:
                split += leaf.nbytes
            else:
                replicated += leaf.nbytes
    inputs = sum(t.nbytes for t in L.tree_leaves(c2.trees["inputs"][0]))
    assert two.held_bytes == split // 2 + replicated + inputs
    assert one.held_bytes == split + replicated + inputs
    assert two.kernel_calls == one.kernel_calls
    norms = 4.0 * shape.global_batch * cfg.d_model \
        * one.kernel_calls["rmsnorm"]          # whole on slot 0 either way
    assert two.dot_flops == one.dot_flops / 2
    assert two.flops == (one.flops - norms) / 2 + norms
    arrived = sum(n for moves in D.serve_transfers(c2).values()
                  for (_, dst), n in moves.items() if dst == 0)
    partial = shape.global_batch * cfg.d_model * 2      # (B, 1, D) bf16
    temp1 = one.peak_bytes - one.held_bytes
    temp2 = two.peak_bytes - two.held_bytes
    assert partial <= temp2 <= temp1 + arrived
