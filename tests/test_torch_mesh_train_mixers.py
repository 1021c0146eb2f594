"""Training on a mesh against the JAX reference, on the CPU, for the
MoE and MLA families: 3 steps of ``Trainer(mesh=, zero1=)`` on 8 CPU
slots against the reference's meshed ``Trainer`` on its 8 forced host
devices (``_mesh_train.runs``: the MoEs phi3.5-moe, whose tokens drop
per data shard, and llama4-scout; minicpm3-4b's MLA, with a vocabulary
of 500 too), with the tolerances of ``test_torch_mesh_train.py``, which
holds the attention families (``test_torch_mesh_train_recurrent.py``
holds the recurrent and encoder-decoder ones); and phi3.5-moe's untied
row-parallel head against the reference's forward."""
import numpy as np
import pytest
import torch
import jax
from jax.sharding import NamedSharding

from repro.launch.mesh import make_host_mesh as j_make_host_mesh
from repro.models import build as jbuild, layers as JL
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build, layers as L
from repro_torch.train import optimizer as O
from repro_torch.train import sharded as S
from repro_torch.train.trainer import MeshStep
from _mesh_train import (BATCH, CPU, MLA, MOE, RTOL, SEQ, SLOTS, SPLIT,
                         _hold_leaves, _is_p, _jcfg, _cfg, _ref_run, _shape,
                         hold_meshed_run, run_id, runs)
from _model_axis import whole
from _torch_threads import one_torch_thread  # noqa: F401

# the MoE and MLA families' runs
RUNS = runs((MOE, MLA) + tuple(n for n in SPLIT if "scout" in n))


@pytest.fixture(scope="module")
def moe_unmeshed_losses(tmp_path_factory):
    """The reference's unmeshed losses of the MoE (one global capacity)."""
    tr, *_ = _ref_run(tmp_path_factory.mktemp("flat"), MOE, None, False,
                      "flat")
    return [m["loss"] for m in tr.metrics_log]


@pytest.mark.parametrize("name,mesh_shape,zero1", RUNS,
                         ids=[run_id(r) for r in RUNS])
def test_meshed_training_matches_the_reference(spmd_devices, tmp_path,
                                               moe_unmeshed_losses, name,
                                               mesh_shape, zero1):
    hold_meshed_run(tmp_path, name, mesh_shape, zero1, moe_unmeshed_losses)


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
