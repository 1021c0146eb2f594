"""The port's dry run (``repro_torch/launch/dryrun.py``) against the JAX
reference, on the CPU:

(a) ``--all``'s cells are the reference's ``ARCHS x shapes_for``;
(b) every ``memory`` figure of every production cell, on both production
    meshes, equals the same sum built from the reference's abstract and
    spec trees with ``NamedSharding(AbstractMesh(...), spec).shard_shape``
    (exact integers, metadata only, nothing compiled);
(c) the ``meta`` trace of every smoke cell at ``--dev`` on both dev
    meshes returns what ``jax.eval_shape`` of the reference's step returns
    at the same shard batch, leaf for leaf in shape and dtype;
(d) the three LM kernel wrappers' ``meta`` branches: the plain version's
    shape, dtype and strides, the CUDA branch's refusals, no launch and no
    call of the plain version;
(e) the command line at ``--all --dev --smoke --both-meshes``, in
    ``tests/test_torch_dryrun_cli.py`` (a file of its own, so that its
    three minutes run beside this file's two);
(f) the MoE aux's expert counts from the one-hot equal ``bincount``'s.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as JP

from repro.configs import (ARCHS as J_ARCHS, SMOKES as J_SMOKES,
                           SHAPES as J_SHAPES, shapes_for as j_shapes_for)
from repro.configs.base import ShapeConfig as JShape
from repro.models import build as jbuild, layers as JL
from repro.train import optimizer as JO
from repro.train.trainer import make_train_step as j_make_train_step
from repro_torch import kernels
from repro_torch.configs import ARCHS, SHAPES, SMOKES, shapes_for
from repro_torch.kernels import _build
from repro_torch.launch import dryrun as D
from repro_torch.models import layers as L
from _torch_threads import one_torch_thread  # noqa: F401

RECURRENT = ("jamba-v0.1-52b", "xlstm-125m")
# the recurrent families' train and prefill cells trace at this sequence
# length in (c): the port loops over time in Python and a meta op costs a
# few hundred microseconds, so at --dev's 512 steps xlstm's train cell
# traces in ~60 s, jamba's in ~25 s and xlstm's prefill in ~10 s
RECURRENT_SEQ = 32
FA = kernels._module("flash_attention")
DA = kernels._module("decode_attention")
RN = kernels._module("rmsnorm")
META = torch.device("meta")


def _is_p(x):
    return isinstance(x, JP)


def _j_mesh(multi_pod: bool, dev: bool):
    mesh = D.make_mesh(multi_pod=multi_pod, dev=dev)
    return AbstractMesh(tuple(mesh.devices.shape), mesh.axis_names), mesh


# ------------------------------------------------------------ (a) cells
def test_all_cells_are_the_references():
    want = [(a, s.name) for a in J_ARCHS for s in j_shapes_for(a)]
    assert D.cells(None, None, True) == want
    assert len(want) == 34
    assert [(a, s.name) for a in ARCHS for s in shapes_for(a)] == want


# ----------------------------------------------------- (b) bytes a slot
def _j_bytes(tree, specs, mesh) -> int:
    """Bytes a device holds of ``tree`` by ``specs``: JAX's shard shape of
    each leaf (one shape for every device of an evenly split array)."""
    leaves = jax.tree.leaves(tree)
    sp = jax.tree.leaves(specs, is_leaf=_is_p)
    assert len(leaves) == len(sp)
    return sum(int(np.prod(NamedSharding(mesh, s).shard_shape(a.shape),
                           dtype=np.int64)) * np.dtype(a.dtype).itemsize
               for a, s in zip(leaves, sp))


def _j_memory(jcfg, shape, jmesh) -> dict:
    """The reference's trees of ``repro/launch/dryrun.py::lower_cell``,
    summed as the port's ``memory`` sums them (the logits a
    ShapeDtypeStruct of (B, 1, V) in the config's dtype)."""
    dp = tuple(a for a in jmesh.axis_names if a in ("pod", "data"))
    long_mode = shape.kind == "decode" and shape.global_batch == 1
    tp = int(jmesh.shape["model"])
    with JL.use_mesh(jmesh, dp_axes=() if long_mode else dp):
        api = jbuild(jcfg, tp=tp)
        params = api.abstract_params(
            dtype=None if shape.kind == "train" else "bfloat16")
        p = _j_bytes(params, api.param_pspecs(), jmesh)
        ins = _j_bytes(api.input_specs(shape), api.input_pspecs(shape), jmesh)
        if shape.kind == "train":
            opt = _j_bytes(JO.abstract_state(params), JO.opt_pspecs(
                api.param_defs(), dp_axes=dp,
                dp_size=int(np.prod([jmesh.shape[a] for a in dp]))), jmesh)
            return {"argument_size_in_bytes": p + opt + ins,
                    "output_size_in_bytes": p + opt,
                    "alias_size_in_bytes": p + opt}
        kw = {"long_mode": long_mode} if shape.kind == "decode" else {}
        b, s = shape.global_batch, shape.seq_len
        caches = _j_bytes(api.abstract_cache(b, s, **kw),
                          api.cache_pspecs(b, s, **kw), jmesh)
        spec = JL.resolve_pspec((() if long_mode else JL.DP, None,
                                 "model" if jcfg.vocab_size % tp == 0
                                 else None))
        logits = jax.ShapeDtypeStruct((b, 1, jcfg.vocab_size), jcfg.dtype)
        outs = caches + _j_bytes(logits, spec, jmesh)
        if shape.kind == "prefill" and jcfg.family == "encdec":
            outs += _j_bytes(api.input_specs(shape)["frames"],
                             api.input_pspecs(shape)["frames"], jmesh)
        return {"argument_size_in_bytes": p + ins + caches,
                "output_size_in_bytes": outs,
                "alias_size_in_bytes": caches}


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_memory_equals_the_reference_trees(arch, multi_pod):
    """Every production cell of ``arch`` on the (16, 16) or (2, 16, 16)
    mesh: argument, output and alias bytes of the largest slot, equal to
    the reference's trees' shard shapes, and equal on every slot."""
    jmesh, mesh = _j_mesh(multi_pod, dev=False)
    for shape in shapes_for(arch):
        cell, aux = D.lower_cell(ARCHS[arch], shape, mesh)
        got = D.memory(cell)
        want = _j_memory(J_ARCHS[arch], J_SHAPES[shape.name], jmesh)
        assert {k: got[k] for k in want} == want, (arch, shape.name)
        assert got["memory_slots_differ"] is False
        assert aux == dict(zip(("params_total", "params_active"),
                               J_ARCHS[arch].param_count()))


def test_memory_counts_every_slot():
    """``slot_bytes`` sums each slot's own block: a spec that splits a
    dim over "data" only gives each slot its data row's block, and a
    tree's slots differ only where its blocks do."""
    mesh = D.make_mesh(multi_pod=False, dev=True)          # (2, 4)
    tree = {"a": torch.empty((4, 8), device=META),
            "b": torch.empty((6,), dtype=torch.bfloat16, device=META)}
    specs = {"a": L.PSpec("data", "model"), "b": L.PSpec()}
    per = D.slot_bytes(tree, specs, mesh)
    assert per.tolist() == [2 * 2 * 4 + 12] * 8


# ------------------------------------------------------ (c) the trace
def _trace_shape(arch, name, mesh):
    shape = D.dev_shape(SHAPES[name], mesh)
    if arch in RECURRENT and shape.kind in ("train", "prefill"):
        shape = dataclasses.replace(shape, seq_len=RECURRENT_SEQ)
    return shape


def _j_step(jcfg, tp, shape, b):
    """``jax.eval_shape`` of the reference's step at ``b`` rows, off any
    mesh: its outputs, as :func:`dryrun.run_step` gives the port's."""
    api = jbuild(jcfg, tp=tp)
    jshape = JShape("shard", shape.kind, shape.seq_len, b)
    batch = api.input_specs(jshape)
    if shape.kind == "train":
        params = api.abstract_params()
        opt = JO.abstract_state(params)
        return jax.eval_shape(j_make_train_step(api, JO.AdamWConfig()),
                              params, opt, batch)
    params = api.abstract_params(dtype="bfloat16")
    long_mode = shape.kind == "decode" and shape.global_batch == 1
    kw = {"long_mode": long_mode} if shape.kind == "decode" else {}
    caches = api.abstract_cache(b, shape.seq_len, **kw)
    step = api.prefill if shape.kind == "prefill" else api.decode
    return jax.eval_shape(step, params, batch, caches)


def _same_leaves(got, want, what):
    g = L.tree_leaves(got)
    w = jax.tree.leaves(want)
    assert len(g) == len(w), (what, len(g), len(w))
    for a, b in zip(g, w):
        assert a.device.type == "meta", what
        assert tuple(a.shape) == tuple(b.shape), (what, a.shape, b.shape)
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype), \
            (what, a.dtype, b.dtype)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", list(SMOKES))
def test_trace_outputs_equal_the_references_eval_shape(arch, multi_pod):
    """Each of the arch's cells at ``--dev --smoke``: the port's step on
    ``meta`` trees at one data shard's batch returns the reference's
    ``eval_shape`` outputs (train: parameters, optimizer state and the
    loss; serving: logits, caches and an encoder's output), and passes
    ``trace_cell``'s checks."""
    _, mesh = _j_mesh(multi_pod, dev=True)
    for s in shapes_for(arch):
        shape = _trace_shape(arch, s.name, mesh)
        cell, _ = D.lower_cell(SMOKES[arch], D.dev_shape(SHAPES[s.name],
                                                         mesh), mesh)
        out, _, batch = D.run_step(cell, shape)
        b = D.shard_batch(cell, shape)
        assert batch["tokens"].shape[0] == b
        want = _j_step(J_SMOKES[arch], int(mesh.shape["model"]), shape, b)
        what = (arch, s.name, multi_pod)
        if shape.kind == "train":
            _same_leaves(out[0], want[0], what + ("params",))
            _same_leaves(out[1], want[1], what + ("opt",))
            _same_leaves(out[2]["loss"], want[2]["loss"], what + ("loss",))
        else:
            assert len(out) == len(want), what
            for i, (g, w) in enumerate(zip(out, want)):
                _same_leaves(g, w, what + (i,))
        D.trace_cell(cell, shape)


def test_trace_batch_is_one_data_shard():
    """A (2, 2, 4) mesh's train cell traces at a quarter of the batch;
    long mode at the whole batch of one."""
    mesh = D.make_mesh(multi_pod=True, dev=True)
    cell, _ = D.lower_cell(SMOKES["llama3.2-3b"],
                           D.dev_shape(SHAPES["train_4k"], mesh), mesh)
    assert cell.shape.global_batch == 8 and D.shard_batch(cell) == 2
    mesh = D.make_mesh(multi_pod=False, dev=False)
    cell, _ = D.lower_cell(ARCHS["gemma3-12b"], SHAPES["long_500k"], mesh)
    assert cell.dp_axes == () and D.shard_batch(cell) == 1


def test_a_refused_cell_fails_the_run(monkeypatch, capsys):
    """A cell whose trace raises is printed with its exception and the
    command exits 1 (here: decode_attention refusing a head dim)."""
    monkeypatch.setattr(DA, "MAX_HEAD_DIM", 8)
    with pytest.raises(SystemExit) as e:
        D.main(["--arch", "llama3.2-3b", "--shape", "decode_32k", "--dev",
                "--smoke", "--out", ""])
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert "FAILED 1 cells" in out and "> 8" in out


# ------------------------------------------- (d) the wrappers on meta
@pytest.fixture
def no_plain_no_launch(monkeypatch):
    """The plain versions and the library raise if called; the launch
    counts must not move."""
    def boom(*a, **k):
        raise AssertionError("called on a meta tensor")
    for mod, name in ((RN, "rmsnorm_ref"), (FA, "attention_ref"),
                      (DA, "decode_attention_ref")):
        monkeypatch.setattr(mod, name, boom)
    monkeypatch.setattr(_build, "library", boom)
    before = kernels.launch_counts()
    yield
    assert kernels.launch_counts() == before


def _layout(t):
    return tuple(t.shape), t.dtype, t.stride()


def _like(t, device):
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                               device=device)


def _args(dtype):
    g = torch.Generator().manual_seed(0)

    def r(*s):
        return torch.randn(*s, generator=g).to(dtype)
    table = torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32)
    return {
        "rmsnorm": ((r(3, 5, 64), r(64)), {}),
        "flash_attention": ((r(2, 4, 40, 32), r(2, 2, 40, 32),
                             r(2, 2, 40, 32)), {"causal": True, "window": 8}),
        "decode_attention": ((r(2, 4, 32), r(6, 16, 2, 32), r(6, 16, 2, 32),
                              table, torch.tensor([40, 17],
                                                  dtype=torch.int32)), {}),
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["rmsnorm", "flash_attention",
                                  "decode_attention"])
def test_meta_branch_gives_the_plain_versions_layout(name, dtype,
                                                     no_plain_no_launch):
    args, kw = _args(dtype)[name]
    fn = getattr(kernels, name)
    want = {"rmsnorm": kernels.ref.rmsnorm_ref,
            "flash_attention": kernels.ref.attention_ref,
            "decode_attention": kernels.ref.decode_attention_ref}[name](
                *args, **kw)
    got = fn(*[_like(a, META) for a in args], **kw)
    assert got.device.type == "meta"
    assert _layout(got) == _layout(want)


def test_meta_flash_keeps_a_strided_q_layout(no_plain_no_launch):
    """The model's (B,T,H,D) activations go in permuted; the output keeps
    q's layout, as the CUDA branch's ``empty_like`` does."""
    q = torch.empty(2, 40, 4, 32, device=META).permute(0, 2, 1, 3)
    k = torch.empty(2, 40, 2, 32, device=META).permute(0, 2, 1, 3)
    out = kernels.flash_attention(q, k, k, causal=True)
    assert out.stride() == q.stride() and not out.is_contiguous()


def test_meta_autograd_functions_pass_meta(no_plain_no_launch):
    """The Functions' forwards take the meta branch; the plain-torch
    backwards trace on meta."""
    x = torch.empty(4, 64, device=META, requires_grad=True)
    w = torch.empty(64, device=META, requires_grad=True)
    q = torch.empty(1, 2, 16, 32, device=META, requires_grad=True)
    y = kernels.rmsnorm(x, w).sum() + \
        kernels.flash_attention(q, q, q, causal=True).sum()
    gx, gw, gq = torch.autograd.grad(y, (x, w, q))
    assert gx.shape == x.shape and gw.shape == w.shape \
        and gq.shape == q.shape and gq.device.type == "meta"


def _refusals():
    m = META
    big = 2**31
    return [
        ("rmsnorm", (torch.empty(4, 64, dtype=torch.float16, device=m),
                     torch.empty(64, device=m)), {}, TypeError, "dtype"),
        ("rmsnorm", (torch.empty(4, 16385, device=m),
                     torch.empty(16385, device=m)), {}, ValueError,
         "more than the kernel holds"),
        ("rmsnorm", (torch.empty(big, 64, device=m),
                     torch.empty(64, device=m)), {}, ValueError, "32-bit"),
        ("flash_attention", (torch.empty(1, 2, 64, 80, device=m),) * 3,
         {}, ValueError, "head dim 80"),
        ("flash_attention", (torch.empty(1, 2, 128 * 65536, 64,
                                         dtype=torch.bfloat16, device=m),) * 3,
         {}, ValueError, "65535 tiles"),
        ("flash_attention", (torch.empty(1, 2, 16 * 65536, 64, device=m),) * 3,
         {}, ValueError, "65535 tiles"),
        ("flash_attention", (torch.empty(big, 1, 1, 64, device=m),) * 3,
         {}, ValueError, "32-bit"),
        ("flash_attention", (torch.empty(1, 2, 8, 64, device=m),
                             torch.empty(1, 2, 8, 64, dtype=torch.bfloat16,
                                         device=m),
                             torch.empty(1, 2, 8, 64, device=m)),
         {}, TypeError, "differ"),
        ("decode_attention", (torch.empty(2, 4, 640, device=m),
                              torch.empty(4, 16, 2, 640, device=m),
                              torch.empty(4, 16, 2, 640, device=m),
                              torch.empty(2, 2, dtype=torch.int32, device=m),
                              torch.empty(2, dtype=torch.int32, device=m)),
         {}, ValueError, "head dim 640 > 512"),
        ("decode_attention", (torch.empty(2, 4, 64, device=m),
                              torch.empty(big // 16, 16, 2, 64, device=m),
                              torch.empty(big // 16, 16, 2, 64, device=m),
                              torch.empty(2, 2, dtype=torch.int32, device=m),
                              torch.empty(2, dtype=torch.int32, device=m)),
         {}, ValueError, "32-bit"),
        ("decode_attention", (torch.empty(2, 4, 64, device=m),
                              torch.empty(4, 16, 2, 64, device=m),
                              torch.empty(4, 16, 2, 64, device=m),
                              torch.empty(2, 2, dtype=torch.int64, device=m),
                              torch.empty(2, dtype=torch.int32, device=m)),
         {}, TypeError, "page_table"),
    ]


@pytest.mark.parametrize("case", range(len(_refusals())))
def test_meta_branch_refuses_what_the_card_refuses(case, no_plain_no_launch):
    """Each refusal comes from the wrapper's one check function, which
    the CUDA branch runs before its launch too."""
    name, args, kw, exc, text = _refusals()[case]
    checked = {"rmsnorm": RN._checked, "flash_attention": FA._checked,
               "decode_attention": DA._checked}[name]
    with pytest.raises(exc, match=text):
        getattr(kernels, name)(*args, **kw)
    with pytest.raises(exc, match=text):
        checked(*args)


def test_card_routes_take_meta():
    """``on_card`` sends meta tensors down the card's routes: the
    attention kernels, or the ``NotImplementedError`` where neither
    computes what is asked."""
    assert L.on_card(torch.empty(1, device=META))
    assert not L.on_card(torch.empty(1))
    q = torch.empty(1, 3, 2, 2, 16, device=META)
    k = torch.empty(1, 3, 2, 16, device=META)
    with pytest.raises(NotImplementedError, match="q_pos0"):
        L._sdpa(q, k, k, causal=True, window=0, q_pos0=2)
    with pytest.raises(NotImplementedError, match="explicit mask"):
        L._sdpa_mask(q, k, k, torch.ones(1, 3, 3, dtype=torch.bool,
                                         device=META))
    before = kernels.launch_counts()
    out = L._sdpa(q, k, k, causal=True, window=0)
    assert out.shape == q.shape and kernels.launch_counts() == before


# -------------------------------------------- (f) the MoE's expert counts
@pytest.mark.parametrize("ties", [False, True])
def test_moe_aux_counts_equal_bincount(ties):
    """``_moe_local``'s aux with the counts from the one-hot equals the
    aux with ``torch.bincount``'s counts bit for bit; with ``ties`` the
    router is zero, so every token's probabilities tie."""
    cfg = SMOKES["phi3.5-moe-42b-a6.6b"]
    mc = cfg.moe
    g = torch.Generator().manual_seed(1)
    d, e = cfg.d_model, mc.num_experts
    x = torch.randn(3, 7, d, generator=g)
    router = torch.zeros(d, e) if ties else torch.randn(d, e, generator=g)
    f = mc.d_ff or cfg.d_ff
    w = [torch.randn(e, d, f, generator=g) * 0.02,
         torch.randn(e, d, f, generator=g) * 0.02,
         torch.randn(e, f, d, generator=g) * 0.02]
    _, aux = L._moe_local(x, router, *w, cfg=cfg)
    nl, k = 21, mc.top_k
    probs = torch.softmax(x.reshape(nl, d).float() @ router.float(), dim=-1)
    _, idx = L._top_k(probs, k)
    ce = torch.bincount(idx.reshape(-1), minlength=e).float() / (nl * k)
    want = e * torch.sum(probs.mean(dim=0) * ce)
    assert torch.equal(aux, want)
    if ties:
        assert torch.equal(idx, torch.arange(k).expand(nl, k))
