"""The port's sharding specs and training on a mesh against the JAX
reference, on the CPU: the PartitionSpec and abstract trees of
``ModelAPI`` and ``opt_pspecs`` leaf for leaf, for every arch at tp 1,
2, 4 and 8, with and without ``use_mesh``; 3 steps of ``Trainer(mesh=,
zero1=)`` on 8 CPU slots against the reference's meshed ``Trainer`` on
its 8 forced host devices, for a dense arch and for an MoE whose tokens
drop per data shard; the loss weighting with labels masked unevenly
over the data shards; checkpoints across meshes and packages; and the
launcher's ``--mesh`` / ``--zero1``.

The smokes run in fp32: their configs' bf16 activations round the
gradient at 1e-3 of its scale, and the reference's own meshed and
unmeshed steps part by that much.  Both trainers start from one
checkpoint of the port's seed-0 parameters (step 0), written by the
port and restored by each package, so they train the same weights on
the same synthetic batches.  Tolerances: loss
and grad_norm within rtol 1e-5 per step; the first moment after step 1
(``(1 - b1) * g * scale``: the gradient) and the parameters after step 3
within 1e-4 of each leaf's largest element, the reference's fp32
tolerance for model outputs; each slot's block is the slice the
reference's ``addressable_shards`` hold on the matching device."""
import contextlib
import dataclasses
import shutil

import numpy as np
import pytest
import torch
import jax
from jax.sharding import NamedSharding, PartitionSpec as JP

from repro.configs import ARCHS as J_ARCHS, SMOKES as J_SMOKES
from repro.configs.base import ShapeConfig as JShape
from repro.launch.mesh import make_host_mesh as j_make_host_mesh
from repro.models import build as jbuild, layers as JL
from repro.train import optimizer as JO
from repro.train.trainer import Trainer as JTrainer
from repro_torch.configs import ARCHS, SMOKES
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build, layers as L
from repro_torch.train import optimizer as O
from repro_torch.train import sharded as S
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.trainer import MeshStep, Trainer
from _model_axis import smoke, whole
from _torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"
SLOTS = 8
DENSE, MOE = "llama3.2-3b", "phi3.5-moe-42b-a6.6b"
# split over the model axis too (DENSE and MOE do as well): llama4-scout
# is the other MoE (top 1 and a shared expert)
SPLIT = ("gemma3-12b", "internvl2-76b", "gemma3-27b",
         "llama4-scout-17b-a16e")
MLA = "minicpm3-4b"
# the recurrent families: jamba's Mamba (and its MoE, GQA and MLP
# layers), xlstm's mLSTM by rows of C and sLSTM on the first slot
RECURRENT = ("jamba-v0.1-52b", "xlstm-125m")
# the encoder-decoder: its encoder's and decoder's attention by heads, the
# encoder's output sent to each model slot once a step where its 4 KV
# heads split (degrees 2 and 4), k/v sent by KV heads where they do not
ENCDEC = "seamless-m4t-large-v2"
MESHES = [(8, 1), (2, 4), (4, 2)]
# phi3.5-moe's smoke at a capacity that drops tokens: the reference's
# meshed run (capacity per data shard) leaves its unmeshed one by more
# than the test's tolerance, so a port with the global capacity fails
MOE_CAPACITY = 0.5
SEQ, BATCH, STEPS = 16, 8, 3
RTOL, LEAF_TOL = 1e-5, 1e-4


def _is_p(x):
    return isinstance(x, JP)


def _jleaves(tree):
    return jax.tree.leaves(tree, is_leaf=_is_p)


def _meshes(tp):
    """The reference's and the port's (8/tp, tp) meshes."""
    return (j_make_host_mesh(SLOTS, model=tp),
            make_host_mesh(devices=[CPU] * SLOTS, model=tp))


def _same_specs(jtree, ttree, what):
    js, ts = _jleaves(jtree), L.tree_leaves(ttree)
    assert len(js) == len(ts), what
    for a, b in zip(js, ts):
        assert isinstance(b, L.PSpec), (what, b)
        assert tuple(a) == tuple(b), (what, a, b)


def _same_abstract(jtree, ttree, what):
    js, ts = jax.tree.leaves(jtree), L.tree_leaves(ttree)
    assert len(js) == len(ts), what
    for a, b in zip(js, ts):
        assert b.device.type == "meta", what
        assert tuple(a.shape) == tuple(b.shape), (what, a.shape, b.shape)
        assert str(a.dtype) == str(b.dtype).removeprefix("torch."), \
            (what, a.dtype, b.dtype)


# ------------------------------------------------------------ (a) spec trees
@pytest.mark.parametrize("tp", [1, 2, 4, 8])
@pytest.mark.parametrize("which,name",
                         [("ARCHS", n) for n in ARCHS] +
                         [("SMOKES", n) for n in SMOKES])
def test_spec_and_abstract_trees_equal_the_reference(spmd_devices, which,
                                                     name, tp):
    """param/cache/input/opt specs and the abstract trees, leaf for leaf,
    off a mesh and under ``use_mesh`` of an (8/tp, tp) mesh."""
    jcfg, cfg = (J_ARCHS[name], ARCHS[name]) if which == "ARCHS" \
        else (J_SMOKES[name], SMOKES[name])
    ja, ta = jbuild(jcfg, tp=tp), build(cfg, tp=tp)
    jm, tm = _meshes(tp)
    shapes = [("train", 256, 4), ("prefill", 256, 4), ("decode", 256, 4),
              ("decode", 256, 1)]
    for meshed in (False, True):
        with (JL.use_mesh(jm) if meshed else contextlib.nullcontext()), \
                (L.use_mesh(tm) if meshed else contextlib.nullcontext()):
            assert L.active_tp() == JL.active_tp()
            assert L.active_dp() == JL.active_dp()
            _same_specs(ja.param_pspecs(), ta.param_pspecs(), "params")
            for long_mode in (False, True):
                _same_specs(ja.cache_pspecs(2, 64, long_mode=long_mode),
                            ta.cache_pspecs(2, 64, long_mode=long_mode),
                            f"cache long_mode={long_mode}")
                _same_abstract(ja.abstract_cache(2, 64, long_mode=long_mode),
                               ta.abstract_cache(2, 64, long_mode=long_mode),
                               "abstract cache")
            for kind, seq, b in shapes:
                if jcfg.family == "vlm":
                    seq += jcfg.num_patches
                jshape = JShape("s", kind, seq, b)
                shape = ShapeConfig("s", kind, seq, b)
                _same_specs(ja.input_pspecs(jshape), ta.input_pspecs(shape),
                            f"inputs {kind} b={b}")
                assert sorted(ja.input_specs(jshape)) == \
                    sorted(ta.input_specs(shape))
                _same_abstract(ja.input_specs(jshape), ta.input_specs(shape),
                               f"input specs {kind}")
            dp = JL.active_dp()
            for zero1 in (False, True):
                _same_specs(
                    JO.opt_pspecs(ja.param_defs(), zero1=zero1,
                                  dp_axes=("data",), dp_size=dp),
                    O.opt_pspecs(ta.param_defs(), zero1=zero1,
                                 dp_axes=("data",), dp_size=dp),
                    f"opt zero1={zero1}")
    for dtype in (None, "bfloat16"):
        _same_abstract(ja.abstract_params(dtype=dtype),
                       ta.abstract_params(dtype=dtype), f"params {dtype}")
    _same_abstract(JO.abstract_state(ja.abstract_params()),
                   O.abstract_state(ta.abstract_params()), "opt state")


def test_zero1_spec_adds_dp_axis():
    """``tests/test_sharding.py::test_zero1_spec_adds_dp_axis``, and the
    axis goes on the largest replicated, divisible dim."""
    api = build(SMOKES[DENSE], tp=4)
    specs = O.opt_pspecs(api.param_defs(), zero1=True, dp_axes=("data",),
                         dp_size=2)
    flat = L.tree_leaves(specs["m"])
    assert any("data" in s for s in flat)
    assert O._zero1_spec(L.PSpec("model", None), (512, 64), ("data",), 2) \
        == ("model", "data")
    assert O._zero1_spec(L.PSpec(None,), (6, 9), ("pod", "data"), 3) == \
        (None, ("pod", "data"))
    assert O._zero1_spec(L.PSpec(), (5,), ("data",), 2) == (None,)


def test_layout_splits_gathers_and_refuses_what_does_not_divide():
    mesh = make_host_mesh(devices=[CPU] * SLOTS, shape=(2, 4))
    x = torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16)
    for spec in [L.PSpec(), L.PSpec("data", "model"), L.PSpec("model"),
                 L.PSpec(None, ("data", "model")),
                 L.PSpec(("model", "data"))]:
        laid = S.lay_out(x, S.Layout(mesh, spec))
        assert len(laid.blocks) == SLOTS
        assert torch.equal(S.gather(laid), x)
        other = S.relayout(laid, S.Layout(mesh, L.PSpec(None, "data")))
        assert torch.equal(S.gather(other), x)
        assert other.blocks[4].shape == (8, 8)
    laid = S.lay_out(x, S.Layout(mesh, L.PSpec(("data", "model"))))
    assert torch.equal(laid.blocks[5], x[5:6])      # slot (1, 1): 1*4 + 1
    with pytest.raises(ValueError, match="does not divide"):
        S.lay_out(torch.zeros(6, 3), S.Layout(mesh, L.PSpec("model")))
    with pytest.raises(ValueError, match="more entries"):
        S.lay_out(torch.zeros(4), S.Layout(mesh, L.PSpec(None, None)))


# ------------------------------------------------------- (b) meshed training
def _smoke(table, name):
    """``name``'s smoke in ``table`` (the port's or the reference's), in
    fp32, an MoE's at MOE_CAPACITY; "<arch>@v500" with a vocabulary of
    500 (``_model_axis.smoke``)."""
    cfg = smoke(table, name)
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=MOE_CAPACITY))
    return cfg


def _jcfg(name):
    return _smoke(J_SMOKES, name)


def _cfg(name):
    return _smoke(SMOKES, name)


def _start(path, name, tp):
    """A step-0 checkpoint of the port's seed-0 parameters at ``tp``."""
    params = build(_cfg(name), tp=tp).init_params(0, CPU)
    Checkpointer(str(path)).save(0, {"params": params,
                                     "opt": O.init_state(params)},
                                 blocking=True)
    return path


def _restore_np(path, step, like):
    tree, _ = Checkpointer(str(path)).restore(like, step=step, device=CPU)
    return L.tree_map(lambda t: t.numpy(), tree)


def _seq(name=None):
    """SEQ text positions, after a VLM's patches."""
    return SEQ + (_cfg(name).num_patches if name else 0)


def _shape(name=None):
    return ShapeConfig("t", "train", seq_len=_seq(name), global_batch=BATCH)


def _ref_run(tmp_path, name, mesh_shape, zero1, tag):
    """The reference's Trainer, from the port's step-0 checkpoint; mesh
    None is its unmeshed run.  Returns (trainer, params, opt, ckpt dir)."""
    tp = mesh_shape[1] if mesh_shape else 1
    d = tmp_path / f"ref_{tag}"
    shutil.copytree(_start(tmp_path / f"start_{tag}", name, tp), d)
    mesh = j_make_host_mesh(SLOTS, shape=mesh_shape) if mesh_shape else None
    tr = JTrainer(jbuild(_jcfg(name), tp=tp), JShape("t", "train",
                                                     _seq(name), BATCH),
                  mesh=mesh, zero1=zero1, ckpt_dir=str(d), ckpt_every=1)
    params, opt, _ = tr.run(STEPS)
    return tr, params, opt, d


def _port_run(tmp_path, name, mesh_shape, zero1, tag):
    tp = mesh_shape[1]
    d = tmp_path / f"port_{tag}"
    shutil.copytree(_start(tmp_path / f"pstart_{tag}", name, tp), d)
    mesh = make_host_mesh(devices=[CPU] * SLOTS, shape=mesh_shape)
    tr = Trainer(build(_cfg(name), tp=tp), _shape(name), mesh=mesh,
                 zero1=zero1, ckpt_dir=str(d), ckpt_every=1)
    params, opt, _ = tr.run(STEPS)
    return tr, params, opt, d


def _hold_leaves(got, want, what):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        scale = max(float(np.abs(b).max()), 1e-30)
        err = float(np.abs(a - b).max())
        assert err <= LEAF_TOL * scale, (what, i, err, scale)


def _slot_of(jmesh):
    """Reference device id -> flat slot index."""
    return {dev.id: i for i, dev in enumerate(jmesh.devices.flat)}


def _norm(index, shape):
    return tuple(s.indices(n)[:2] for s, n in zip(index, shape))


def _hold_blocks(jtree, ttree, jmesh, what):
    """Each slot's block: the reference's shard on the matching device,
    its index and shape."""
    slot = _slot_of(jmesh)
    js, ts = jax.tree.leaves(jtree), L.tree_leaves(ttree)
    assert len(js) == len(ts)
    for a, laid in zip(js, ts):
        assert isinstance(laid, S.Laid)
        coords = laid.layout.coords()
        assert len(a.addressable_shards) == len(laid.blocks) == SLOTS
        for sh in a.addressable_shards:
            i = slot[sh.device.id]
            want = _norm(sh.index, a.shape)
            got = _norm(laid.layout.block_slices(a.shape, coords[i]),
                        a.shape)
            assert got == want, (what, i, got, want)
            assert tuple(laid.blocks[i].shape) == tuple(sh.data.shape)
            assert laid.blocks[i].device.type == CPU


@pytest.fixture(scope="module")
def moe_unmeshed_losses(tmp_path_factory):
    """The reference's unmeshed losses of the MoE (one global capacity)."""
    tr, *_ = _ref_run(tmp_path_factory.mktemp("flat"), MOE, None, False,
                      "flat")
    return [m["loss"] for m in tr.metrics_log]


def _runs():
    """(name, mesh, zero1) of the 3-step runs: the dense arch and the MoE
    on MESHES, gathered at (8, 1) and split over the model axis on the
    others (``ModelAPI.model_split``; the MoE with 2 and 1 of its 4
    experts a slot); the other architectures whose step splits on
    MESHES' meshes wider than one; the dense ones that split also on
    (1, 8), which pads the smokes' 4 heads to 8 and replicates their 2
    KV heads; gemma3-27b (8 layers) without ZeRO-1; minicpm3-4b (MLA)
    on MESHES' split meshes and (1, 8), and at (1, 8) with a vocabulary
    of 500, which 8 does not divide: the row-parallel embedding and
    loss; jamba, xlstm (``RECURRENT``) and seamless (``ENCDEC``) on the
    same three, ZeRO-1 where data > 1, and seamless at (1, 8) with a
    vocabulary of 500 too (its untied head split along ``d_model``).
    The MoEs' tokens drop per data shard (``MOE_CAPACITY``)."""
    runs = [(n, m) for n in (DENSE, MOE) for m in MESHES]
    runs += [(n, m) for n in SPLIT for m in MESHES[1:]]
    runs += [(n, (1, 8)) for n in (DENSE,) + SPLIT[:3]]
    runs += [(MLA, m) for m in MESHES[1:] + [(1, 8)]]
    runs += [(MLA + "@v500", (1, 8))]
    out = [(n, m, z) for n, m in runs for z in (False, True)
           if not (z and n == "gemma3-27b")]
    return out + [(n, m, m[0] > 1) for n in RECURRENT + (ENCDEC,)
                  for m in MESHES[1:] + [(1, 8)]] \
        + [(ENCDEC + "@v500", (1, 8), False)]


@pytest.mark.parametrize("name,mesh_shape,zero1", _runs(), ids=[
    f"{n}-{m[0]}x{m[1]}-{'zero1' if z else 'plain'}" for n, m, z in _runs()])
def test_meshed_training_matches_the_reference(spmd_devices, tmp_path,
                                               moe_unmeshed_losses, name,
                                               mesh_shape, zero1):
    jtr, jparams, jopt, jdir = _ref_run(tmp_path, name, mesh_shape, zero1,
                                        "m")
    ttr, tparams, topt, tdir = _port_run(tmp_path, name, mesh_shape, zero1,
                                         "m")
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose([m[key] for m in ttr.metrics_log],
                                   [m[key] for m in jtr.metrics_log],
                                   rtol=RTOL, err_msg=key)
    assert [m["step"] for m in ttr.metrics_log] == list(range(STEPS))
    defs = build(_cfg(name), tp=mesh_shape[1]).param_defs()
    like = {"params": defs, "opt": {"step": 0, "m": defs, "v": defs}}
    got1, want1 = _restore_np(tdir, 1, like), _restore_np(jdir, 1, like)
    _hold_leaves(L.tree_leaves(got1["opt"]["m"]),
                 L.tree_leaves(want1["opt"]["m"]), "m after step 1")
    got3, want3 = _restore_np(tdir, 3, like), _restore_np(jdir, 3, like)
    assert int(got3["opt"]["step"]) == int(want3["opt"]["step"]) == STEPS
    _hold_leaves(L.tree_leaves(got3), L.tree_leaves(want3),
                 "state after step 3")
    jm = jtr.mesh
    _hold_blocks(jparams, tparams, jm, "params")
    _hold_blocks(jopt["m"], topt["m"], jm, "m")
    _hold_blocks(jopt["v"], topt["v"], jm, "v")
    if name == MOE:          # the tokens dropped differ from a global capacity
        meshed = [m["loss"] for m in jtr.metrics_log]
        assert max(abs(a - b) for a, b in zip(moe_unmeshed_losses,
                                              meshed)) > 1e-4, \
            (moe_unmeshed_losses, meshed)


def test_the_untied_row_parallel_head_matches_the_references_forward(
        spmd_devices):
    """phi3.5-moe with a vocabulary of 500 at (1, 8): the embedding table
    and the untied head split along d_model, the loss row-parallel.  The
    reference's meshed step does not compile there on jax 0.9.0 (its
    SPMD partitioner refuses the MoE's shard_map beside the row-parallel
    head; ROADMAP), so the split step's loss and cross-entropy are held
    to the reference's forward jitted at the same shardings (rtol
    RTOL), and every gradient leaf to the reference's unmeshed
    ``jax.value_and_grad`` (within LEAF_TOL of its largest element),
    from the reference's seed-0 parameters."""
    name = MOE + "@v500"
    japi = jbuild(_jcfg(name), tp=SLOTS)
    jp = jax.tree.map(np.asarray, japi.init_params(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 500, (BATCH, SEQ + 1)).astype(np.int32)
    batch = {"tokens": tokens[:, :-1].copy(), "labels": tokens[:, 1:].copy()}
    batch["labels"][0, :3] = -1
    jmesh = j_make_host_mesh(SLOTS, shape=(1, SLOTS))
    with JL.use_mesh(jmesh, ("data",)):
        sh = lambda tree: jax.tree.map(  # noqa: E731
            lambda s: NamedSharding(jmesh, s), tree, is_leaf=_is_p)
        forward = jax.jit(japi.train_loss, in_shardings=(
            sh(japi.param_pspecs()), sh(japi.input_pspecs(_shape(name)))))
        want_loss, want_met = forward(jp, batch)
    (_, _), want = jax.value_and_grad(japi.train_loss, has_aux=True)(
        jp, batch)
    api = build(_cfg(name), tp=SLOTS)
    mesh = make_host_mesh(devices=[CPU] * SLOTS, shape=(1, SLOTS))
    with L.use_mesh(mesh):
        pspecs = api.param_pspecs()
        parts = MeshStep(api, O.AdamWConfig(), mesh, param_specs=pspecs,
                         opt_specs=O.opt_pspecs(api.param_defs(),
                                                zero1=False,
                                                dp_axes=("data",),
                                                dp_size=1),
                         batch_specs=api.input_pspecs(_shape(name)))
        assert parts.split and S.model_dim(pspecs["embed"]["head"]) == 0
        params = S.lay_out_tree(api.params_from_numpy(jp, CPU),
                                S.layouts(mesh, pspecs))
        loss, met, grads = parts.grads(params, {
            k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=RTOL)
    for key in ("xent", "aux"):
        np.testing.assert_allclose(float(met[key]), float(want_met[key]),
                                   rtol=RTOL, err_msg=key)
    _hold_leaves([whole(g).numpy() for g in L.tree_leaves(grads)],
                 [np.asarray(g) for g in jax.tree.leaves(want)], "grads")
