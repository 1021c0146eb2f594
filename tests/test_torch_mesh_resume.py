"""Training on a mesh, continued (``tests/test_torch_mesh_train.py`` has
the spec trees and the 3-step runs): the loss weighting with labels
masked unevenly over the data shards, gradient accumulation on a mesh,
the batches a mesh refuses, checkpoints that cross meshes and packages,
and the launcher's ``--mesh`` / ``--zero1`` on 8 CPU slots.

The reference runs on its 8 forced host devices, the port on 8 CPU
slots, both from one step-0 checkpoint of the port's seed-0 parameters
in fp32.  Losses and gradient norms within rtol 1e-5."""
import shutil

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs.base import ShapeConfig as JShape
from repro.data import pipeline as jpipe
from repro.launch.mesh import make_host_mesh as j_make_host_mesh
from repro.models import build as jbuild, layers as JL
from repro.train import optimizer as JO
from repro.train.trainer import Trainer as JTrainer
from repro_torch.launch import train as ltrain
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build, layers as L
from repro_torch.train import optimizer as O
from repro_torch.train import sharded as S
from repro_torch.train.trainer import Trainer

from _mesh_train import (BATCH, CPU, DENSE, MOE, RTOL, SEQ, SLOTS, _cfg,
                         _jcfg, _shape, _start)
from _torch_threads import one_torch_thread  # noqa: F401


def _jmesh(shape):
    return j_make_host_mesh(SLOTS, shape=shape)


def _mesh(shape):
    return make_host_mesh(devices=[CPU] * (shape[0] * shape[1]), shape=shape)


def _jstep(tr, params, batch):
    """One step of the reference trainer's jitted step from seed
    parameters and a zero state, under its mesh as ``run`` calls it (the
    MoE takes its per-shard branch only under ``use_mesh``)."""
    p = jax.tree.map(jnp.asarray, params)
    o = JO.init_state(p)
    if tr._in_sh is None:
        return tr.step_fn(p, o, jax.tree.map(jnp.asarray, batch))[2]
    with JL.use_mesh(tr.mesh, tr.dp_axes):
        return tr.step_fn(jax.device_put(p, tr._in_sh[0]),
                          jax.device_put(o, tr._in_sh[1]),
                          jax.tree.map(jnp.asarray, batch))[2]


def _masked_batch(name):
    """The step-0 synthetic batch with labels masked unevenly: data
    shards of two rows each hold 22, 4, 32 and 30 counted labels."""
    batch = jpipe.synth_batch(_jcfg(name), JShape("t", "train", SEQ, BATCH),
                              0)
    lab = batch["labels"]
    lab[0, :10] = -1
    lab[2] = -1
    lab[3, :12] = -1
    lab[7, 3:5] = -1
    return batch


# ------------------------------------------------------ (c) loss weighting
@pytest.mark.parametrize("name", [DENSE, MOE])
def test_loss_is_weighted_by_each_shards_label_count(spmd_devices, name):
    """On (4, 2) the port's step equals the reference's meshed step, and
    for the dense arch the reference's unmeshed one, where a mean of the
    shards' own losses would not."""
    batch = _masked_batch(name)
    counts = [(batch["labels"][2 * d:2 * d + 2] >= 0).sum() for d in range(4)]
    assert len(set(counts)) == 4, counts
    params = build(_cfg(name), tp=2).init_params(0, CPU)
    np_params = L.tree_map(lambda t: t.numpy(), params)
    jshape = JShape("t", "train", SEQ, BATCH)
    jtr = JTrainer(jbuild(_jcfg(name), tp=2), jshape, mesh=_jmesh((4, 2)))
    jm = _jstep(jtr, np_params, batch)
    tr = Trainer(build(_cfg(name), tp=2), _shape(), mesh=_mesh((4, 2)))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, _, m = tr.step_fn(S.lay_out_tree(params, tr.layouts["params"]),
                         S.lay_out_tree(O.init_state(params),
                                        tr.layouts["opt"]), tb)
    for key in ("loss", "grad_norm", "xent", "aux"):
        if key in jm:
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=RTOL, err_msg=key)
    shard_mean = np.mean([float(tr.api.train_loss(params, {
        k: v[2 * d:2 * d + 2] for k, v in tb.items()})[1]["xent"])
        for d in range(4)])
    assert abs(shard_mean - float(m["xent"])) > 10 * RTOL * float(m["xent"])
    if name == DENSE:
        flat = JTrainer(jbuild(_jcfg(name), tp=2), jshape)
        fm = _jstep(flat, np_params, batch)
        np.testing.assert_allclose(float(m["loss"]), float(fm["loss"]),
                                   rtol=RTOL)


def test_grad_accum_on_a_mesh_matches_the_reference(spmd_devices, tmp_path):
    """Micro-batch i is rows [i B/ga, (i+1) B/ga), split over the data
    shards; the MoE's capacity is each shard's own within it."""
    losses = []
    for pkg in ("ref", "port"):
        d = tmp_path / pkg
        shutil.copytree(_start(tmp_path / f"s_{pkg}", MOE, 2), d)
        if pkg == "ref":
            tr = JTrainer(jbuild(_jcfg(MOE), tp=2),
                          JShape("t", "train", SEQ, BATCH),
                          mesh=_jmesh((4, 2)), grad_accum=2, zero1=True,
                          ckpt_dir=str(d))
        else:
            tr = Trainer(build(_cfg(MOE), tp=2), _shape(), mesh=_mesh((4, 2)),
                         grad_accum=2, zero1=True, ckpt_dir=str(d))
        tr.run(2)
        losses.append([(m["loss"], m["grad_norm"]) for m in tr.metrics_log])
    np.testing.assert_allclose(losses[1], losses[0], rtol=RTOL)


def test_a_batch_that_does_not_split_over_the_shards_raises():
    params = build(_cfg(DENSE), tp=2).init_params(0, CPU)
    batch = {k: torch.from_numpy(v) for k, v in jpipe.synth_batch(
        _jcfg(DENSE), JShape("t", "train", SEQ, 6), 0).items()}
    for ga in (1, 2):
        tr = Trainer(build(_cfg(DENSE), tp=2), _shape(), mesh=_mesh((4, 2)),
                     grad_accum=ga)
        state = (S.lay_out_tree(params, tr.layouts["params"]),
                 S.lay_out_tree(O.init_state(params), tr.layouts["opt"]))
        with pytest.raises(ValueError, match="does not split"):
            tr.step_fn(*state, batch)
    with pytest.raises(ValueError, match="pass no device"):
        Trainer(build(_cfg(DENSE)), _shape(), mesh=_mesh((1, 1)),
                device=CPU)


def test_a_1x1_mesh_is_the_unmeshed_trainer_bit_for_bit():
    """One slot holds every block whole: the meshed step computes what
    the unmeshed one does, in the same order (the shard's weight is 1.0,
    an exact product), so loss, grad_norm and the state are equal."""
    cfg = _cfg(MOE)
    runs = []
    for mesh in (None, _mesh((1, 1))):
        tr = Trainer(build(cfg), _shape(), mesh=mesh,
                     device=None if mesh else CPU, grad_accum=2)
        params, opt, _ = tr.run(3)
        if mesh is not None:
            params, opt = S.gather_tree(params), S.gather_tree(opt)
        runs.append((tr.metrics_log, L.tree_leaves((params, opt))))
    (log0, state0), (log1, state1) = runs
    for key in ("loss", "grad_norm", "lr"):
        assert [m[key] for m in log0] == [m[key] for m in log1], key
    assert all(torch.equal(a, b) for a, b in zip(state0, state1))


# --------------------------------------------------- (d) mesh checkpoints
def _run(pkg, mesh_shape, zero1, ckpt, steps):
    tp = mesh_shape[1] if mesh_shape else 1
    if pkg == "ref":
        tr = JTrainer(jbuild(_jcfg(DENSE), tp=tp),
                      JShape("t", "train", SEQ, BATCH),
                      mesh=_jmesh(mesh_shape) if mesh_shape else None,
                      zero1=zero1, ckpt_dir=str(ckpt), ckpt_every=2)
    elif mesh_shape is None:
        tr = Trainer(build(_cfg(DENSE), tp=tp), _shape(), zero1=zero1,
                     ckpt_dir=str(ckpt), ckpt_every=2, device=CPU)
    else:
        tr = Trainer(build(_cfg(DENSE), tp=tp), _shape(),
                     mesh=_mesh(mesh_shape), zero1=zero1,
                     ckpt_dir=str(ckpt), ckpt_every=2)
    params, opt, step = tr.run(steps)
    return [m["loss"] for m in tr.metrics_log], params, opt


@pytest.mark.parametrize("first,then", [
    (("port", (2, 4), True), ("ref", (4, 2), False)),
    (("ref", (4, 2), True), ("port", (2, 4), True)),
    (("port", (2, 4), False), ("port", (8, 1), True)),
    (("port", (4, 2), True), ("port", None, False)),
    (("port", None, False), ("port", (2, 4), True)),
], ids=["port2x4-ref4x2", "ref4x2-port2x4", "port2x4-port8x1",
        "port4x2-flat", "flat-port2x4"])
def test_checkpoints_cross_meshes_and_packages(spmd_devices, tmp_path, first,
                                               then):
    """Two steps on one mesh, a checkpoint at step 2, the third step on
    another mesh (or none, or in the other package): its loss is the
    uninterrupted run's, and the restored state sits on the new mesh's
    slots."""
    shutil.copytree(_start(tmp_path / "s0", DENSE, 1), tmp_path / "whole")
    whole, *_ = _run(first[0], first[1], first[2], tmp_path / "whole", 3)
    shutil.copytree(_start(tmp_path / "s1", DENSE, 1), tmp_path / "ck")
    head, *_ = _run(*first, tmp_path / "ck", 2)
    tail, params, opt = _run(*then, tmp_path / "ck", 1)
    np.testing.assert_allclose(head + tail, whole, rtol=RTOL)
    if then[0] == "port" and then[1] is not None:
        leaves = L.tree_leaves(params) + L.tree_leaves(opt["m"])
        assert all(isinstance(a, S.Laid) and len(a.blocks) == SLOTS
                   and a.layout.mesh.devices.shape == then[1]
                   for a in leaves)


# ------------------------------------------------------------ (e) launcher
@pytest.mark.parametrize("flags", [["--mesh"], ["--mesh", "--zero1"]],
                         ids=["mesh", "mesh-zero1"])
def test_launcher_trains_on_a_mesh_of_cpu_slots(tmp_path, capsys, flags):
    """``--mesh`` builds ``make_host_mesh`` over the 8 CPU slots, (2, 4)
    at tp 4; ``--zero1`` splits the moments over the data axis."""
    tr = ltrain.main(["--smoke", "--device", "cpu", "--steps", "2",
                      "--seq", "32", "--batch", "4", "--ckpt",
                      str(tmp_path), "--ckpt-every", "1", *flags])
    assert tr.mesh.shape == {"data": 2, "model": 4} and tr.api.tp == 4
    assert [m["step"] for m in tr.metrics_log] == [0, 1]
    assert all(np.isfinite(m["loss"]) for m in tr.metrics_log)
    assert tr.ckpt.committed_steps() == [1, 2]
    specs = [lay.spec for lay in L.tree_leaves(tr.layouts["opt"]["m"])]
    assert any("data" in s for s in specs) == ("--zero1" in flags)
    assert "finished at step 2" in capsys.readouterr().out
    # the checkpoint resumes off the mesh, on one CPU device
    tr2 = ltrain.main(["--smoke", "--device", "cpu", "--steps", "1",
                       "--seq", "32", "--batch", "4", "--ckpt",
                       str(tmp_path)])
    assert tr2.mesh is None and [m["step"] for m in tr2.metrics_log] == [2]
