"""What the meshed-training test modules share
(``test_torch_mesh_train.py``, the attention families;
``test_torch_mesh_train_mixers.py``, the MoE and MLA families;
``test_torch_mesh_train_recurrent.py``, the recurrent and
encoder-decoder families): the smokes in fp32, the step-0 checkpoint
both trainers start from, the reference's and the port's 3-step runs on
8 CPU slots, and the checks of one run against the other (see
``test_torch_mesh_train.py``'s docstring for the tolerances)."""
import dataclasses
import shutil

import numpy as np
import jax
from jax.sharding import PartitionSpec as JP

from repro.configs import SMOKES as J_SMOKES
from repro.configs.base import ShapeConfig as JShape
from repro.launch.mesh import make_host_mesh as j_make_host_mesh
from repro.models import build as jbuild
from repro.train.trainer import Trainer as JTrainer
from repro_torch.configs import SMOKES
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build, layers as L
from repro_torch.train import optimizer as O
from repro_torch.train import sharded as S
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.trainer import Trainer
from _model_axis import smoke

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


def runs(names) -> list:
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
    The MoEs' tokens drop per data shard (``MOE_CAPACITY``).  Only the
    runs of ``names`` (architectures, "@v500" variants by their base)."""
    pairs = [(n, m) for n in (DENSE, MOE) for m in MESHES]
    pairs += [(n, m) for n in SPLIT for m in MESHES[1:]]
    pairs += [(n, (1, 8)) for n in (DENSE,) + SPLIT[:3]]
    pairs += [(MLA, m) for m in MESHES[1:] + [(1, 8)]]
    pairs += [(MLA + "@v500", (1, 8))]
    out = [(n, m, z) for n, m in pairs for z in (False, True)
           if not (z and n == "gemma3-27b")]
    out += [(n, m, m[0] > 1) for n in RECURRENT + (ENCDEC,)
            for m in MESHES[1:] + [(1, 8)]] \
        + [(ENCDEC + "@v500", (1, 8), False)]
    return [r for r in out if r[0].split("@")[0] in names]


def run_id(run) -> str:
    n, m, z = run
    return f"{n}-{m[0]}x{m[1]}-{'zero1' if z else 'plain'}"


def hold_meshed_run(tmp_path, name, mesh_shape, zero1, moe_unmeshed=None):
    """The port's 3-step run on ``mesh_shape`` against the reference's
    from one step-0 checkpoint: losses, grad norms and learning rates
    per step, the first moment after step 1 and the state after step 3,
    each slot's blocks; the MoE's losses must leave ``moe_unmeshed``
    (its tokens drop per data shard)."""
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
        assert max(abs(a - b) for a, b in zip(moe_unmeshed, meshed)) > 1e-4, \
            (moe_unmeshed, meshed)
