"""The port's sharding specs and training on a mesh against the JAX
reference, on the CPU: the PartitionSpec and abstract trees of
``ModelAPI`` and ``opt_pspecs`` leaf for leaf, for every arch at tp 1,
2, 4 and 8, with and without ``use_mesh``; 3 steps of ``Trainer(mesh=,
zero1=)`` on 8 CPU slots against the reference's meshed ``Trainer`` on
its 8 forced host devices, for the attention families (llama3.2-3b,
gemma3-12b and -27b, internvl2-76b); the MoE and MLA families' runs are
in ``test_torch_mesh_train_mixers.py``, the recurrent and
encoder-decoder families' in ``test_torch_mesh_train_recurrent.py``, the
helpers they share in ``_mesh_train.py``.

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

import pytest
import torch
import jax

from repro.configs import ARCHS as J_ARCHS, SMOKES as J_SMOKES
from repro.configs.base import ShapeConfig as JShape
from repro.launch.mesh import make_host_mesh as j_make_host_mesh
from repro.models import build as jbuild, layers as JL
from repro.train import optimizer as JO
from repro_torch.configs import ARCHS, SMOKES
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build, layers as L
from repro_torch.train import optimizer as O
from repro_torch.train import sharded as S
from _mesh_train import (CPU, DENSE, SLOTS, SPLIT, _is_p, hold_meshed_run,
                         run_id, runs)
from _torch_threads import one_torch_thread  # noqa: F401

# the attention families' runs (``_mesh_train.runs``)
RUNS = runs((DENSE,) + tuple(n for n in SPLIT if "scout" not in n))


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
@pytest.mark.parametrize("name,mesh_shape,zero1", RUNS,
                         ids=[run_id(r) for r in RUNS])
def test_meshed_training_matches_the_reference(spmd_devices, tmp_path, name,
                                               mesh_shape, zero1):
    hold_meshed_run(tmp_path, name, mesh_shape, zero1)
