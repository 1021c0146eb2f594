"""The multi-host entry: the meshed trainer run by several processes
(``launch/procs.py``, ``launch/mesh.py``'s process meshes,
``train/trainer.py::ProcStep``).

One session of two processes (``tests/_multiprocess_train.py``), each
with 4 CPU slots, makes a (2, 4) mesh of the two and trains
llama3.2-3b's smoke in fp32: split with ZeRO-1 at (2, 4), gathered with
ZeRO-1 at (8, 1), split at (4, 2) over two micro-batches a step, and
split from one process's step-2 checkpoint.  Each
process's losses, grad norms, learning rates and every block of its
slots' parameters and moments equal the single-process ``Trainer``'s
on the same mesh bit for bit; the two-process step-2 checkpoint resumes in
one process bit for bit too; the split run holds to the reference's
meshed ``Trainer`` at (2, 4) (rtol 1e-5, each leaf 1e-4 of its max).
Beside it, the launcher runs under torchrun's environment in two
processes of 8 CPU slots each.  The processes are started once for the
module; the parametrised tests read what they saw."""
import os
import pickle
import shutil
import socket
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.launch.mesh import host_mesh_shape as j_host_mesh_shape
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import procs
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.models import build, layers as L
from repro_torch.train import sharded as S
from repro_torch.train.trainer import Trainer
from _mesh_train import (DENSE, RTOL, _hold_leaves, _ref_run, _restore_np,
                         _cfg)
from _multiprocess_train import (BATCH, LOCAL_SLOTS, RUNS, SENT, SEQ, STEPS,
                                 blocks, sent)
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
SESSION_TIMEOUT_S = 240
LAUNCHER_STEPS = 2


def _env(**extra) -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "JAX_COORDINATOR"):
        env.pop(name, None)
    env.update(extra)
    return env


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait(ps, deadline):
    """Every process's exit code; a process still running at
    ``deadline``, or left when another failed, is killed."""
    while any(p.poll() is None for p in ps):
        if time.monotonic() > deadline or any(
                p.poll() not in (None, 0) for p in ps):
            break
        time.sleep(0.1)
    for p in ps:
        if p.poll() is None:
            p.kill()
    return [p.wait() for p in ps]


def _one(d, mesh_shape, zero1, grad_accum, steps=STEPS):
    """A single-process run on 8 CPU slots: (metrics, {slot: blocks})."""
    mesh = make_host_mesh(devices=["cpu"] * (WORLD * LOCAL_SLOTS),
                          shape=mesh_shape)
    tr = Trainer(build(_cfg(DENSE), tp=mesh_shape[1]),
                 ShapeConfig("t", "train", SEQ, BATCH), mesh=mesh,
                 zero1=zero1, grad_accum=grad_accum,
                 ckpt_dir=None if d is None else str(d), ckpt_every=1)
    params, opt, _ = tr.run(steps)
    return tr.metrics_log, blocks(mesh, params, opt)


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("procs")
    one = {"split": _one(tmp / "one_split", *RUNS["split"])}
    (tmp / "from_one").mkdir()
    shutil.copytree(tmp / "one_split" / "step_2",
                    tmp / "from_one" / "step_2")
    script = os.path.join(ROOT, "tests", "_multiprocess_train.py")
    ranks = [subprocess.Popen(
        [sys.executable, script, str(r), str(WORLD), str(tmp / "init"),
         str(tmp)], env=_env(), cwd=ROOT) for r in range(WORLD)]
    port = _free_port()
    argv = ["--smoke", "--arch", DENSE, "--device", "cpu", "--mesh",
            "--zero1", "--batch", "4", "--seq", str(SEQ), "--steps",
            str(LAUNCHER_STEPS), "--ckpt", str(tmp / "launcher"),
            "--report", str(tmp / "report")]
    launcher = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train"] + argv,
        env=_env(RANK=str(r), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(r),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)),
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    deadline = time.monotonic() + SESSION_TIMEOUT_S
    try:
        one["gathered"] = _one(None, *RUNS["gathered"])
        one["accumulated"] = _one(None, *RUNS["accumulated"])
        ref = _ref_run(tmp, DENSE, (2, 4), True, "procs")
    finally:
        rcs = _wait(ranks, deadline)
        lrcs = _wait(launcher, deadline)
    outs = [p.stdout.read() for p in launcher]
    seen = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            seen.append(pickle.load(f))
    assert rcs == [0] * WORLD, (rcs, [s.get("error") for s in seen])
    # the two-process step-2 checkpoint, resumed in one process
    (tmp / "from_two").mkdir()
    shutil.copytree(tmp / "two_split" / "step_2", tmp / "from_two" / "step_2")
    back = _one(tmp / "from_two", *RUNS["split"], steps=STEPS - 2)
    return SimpleNamespace(tmp=tmp, one=one, seen=seen, ref=ref, back=back,
                           launcher=(lrcs, outs))


def _hold_equal(metrics, blocks_, want_metrics, want_blocks):
    keys = [k for k in want_metrics[0] if k not in ("dt", "straggler")]
    assert [{k: m[k] for k in keys} for m in metrics] == \
        [{k: m[k] for k in keys} for m in want_metrics]
    for i, got in blocks_.items():
        assert len(got) == len(want_blocks[i])
        for j, (a, b) in enumerate(zip(got, want_blocks[i])):
            assert a.dtype == b.dtype and a.shape == b.shape, (i, j)
            assert np.array_equal(a, b), (i, j, np.abs(a - b).max())


@pytest.mark.parametrize("rank", range(WORLD))
@pytest.mark.parametrize("case", ["split", "gathered", "accumulated",
                                  "resumed"])
def test_two_processes_train_as_one(session, case, rank):
    """Each rank's metrics (slot 0's, broadcast) and its 4 slots' blocks
    of the parameters and moments equal the single-process run's bit for
    bit; "accumulated" runs two data rows a process and two
    micro-batches a step; "resumed" restored one process's step-2
    checkpoint and ran step 3."""
    seen = session.seen[rank][case]
    metrics, want = session.one["split" if case == "resumed" else case]
    if case == "resumed":
        metrics = metrics[2:]
    assert sorted(seen["blocks"]) == list(range(rank * LOCAL_SLOTS,
                                                (rank + 1) * LOCAL_SLOTS))
    assert seen["step"] == STEPS
    _hold_equal(seen["metrics"], seen["blocks"], metrics, want)


def test_a_two_process_checkpoint_resumes_in_one_process(session):
    """Step 2 of the two-process split run, restored on one process's 8
    slots: step 3 equals the uninterrupted run bit for bit.  The
    checkpoint was written once, by slot 0's process."""
    metrics, want = session.one["split"]
    got_metrics, got = session.back
    _hold_equal(got_metrics, got, metrics[2:], want)
    two = session.tmp / "two_split"
    assert sorted(os.listdir(two)) == ["step_1", "step_2", "step_3"]


def test_two_processes_hold_to_the_reference(session):
    """The two-process split run (ZeRO-1) against the reference's meshed
    Trainer at (2, 4) from the same seed-0 parameters: losses, grad
    norms and learning rates within rtol 1e-5, the first moment after
    step 1 and the state after step 3 each leaf within 1e-4 of its max
    (``_mesh_train.py``'s tolerances)."""
    jtr, _, _, jdir = session.ref
    got = session.seen[0]["split"]["metrics"]
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose([m[key] for m in got],
                                   [m[key] for m in jtr.metrics_log],
                                   rtol=RTOL, err_msg=key)
    defs = build(_cfg(DENSE), tp=4).param_defs()
    like = {"params": defs, "opt": {"step": 0, "m": defs, "v": defs}}
    tdir = session.tmp / "two_split"
    _hold_leaves(L.tree_leaves(_restore_np(tdir, 1, like)["opt"]["m"]),
                 L.tree_leaves(_restore_np(jdir, 1, like)["opt"]["m"]),
                 "m after step 1")
    _hold_leaves(L.tree_leaves(_restore_np(tdir, STEPS, like)),
                 L.tree_leaves(_restore_np(jdir, STEPS, like)),
                 "state after step 3")


@pytest.mark.parametrize("rank", range(WORLD))
def test_the_process_mesh(session, rank):
    """Two pools of 4 slots give the reference's (2, 4): rank 0's slots
    first, each process one data row; (4, 2) is each process's (2, 2); a
    shape or model width whose model row would cross processes, or a
    submesh, raises NotImplementedError.  The pipeline's host defaults
    are the group's rank and size."""
    seen = session.seen[rank]["mesh"]
    assert seen["shape"] == j_host_mesh_shape(WORLD * LOCAL_SLOTS) == (2, 4)
    assert seen["4x2"] == (4, 2)
    assert seen["ranks"] == [[0] * 4, [1] * 4]
    assert seen["local"] == list(range(rank * 4, rank * 4 + 4))
    assert "model row of 8 slots across processes" in seen["1x8"]
    assert "model row of 8 slots across processes" in seen["model8"]
    assert "submesh" in seen["n4"]
    assert seen["pipeline"] == (rank, WORLD)


def test_the_transport_keeps_dtype_shape_and_bytes(session):
    """What rank 0 sent, rank 1 received: each dtype (bf16 and bool too),
    a 0-d and an empty tensor, bit for bit; each counted the bytes."""
    got = session.seen[1]["transport"]["got"]
    assert len(got) == len(SENT)
    for k, t in enumerate(got):
        want = sent(k)
        assert t.dtype == want.dtype and t.shape == want.shape
        assert torch.equal(t, want)
    nbytes = sum(sent(k).nbytes for k in range(len(SENT)))
    assert session.seen[0]["transport"]["moved"]["sent"] == nbytes
    assert session.seen[1]["transport"]["moved"]["received"] == nbytes
    assert session.seen[1]["transport"]["moved"]["sent"] == 0


def test_the_launcher_trains_over_processes(session):
    """``python -m repro_torch.launch.train --mesh`` under torchrun's
    environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/PORT) in two
    processes of 8 CPU slots: a (4, 4) mesh, both ranks report the same
    finite metrics, only rank 0 prints, and one committed checkpoint."""
    rcs, outs = session.launcher
    assert rcs == [0] * WORLD, outs
    assert "finished at step 2" in outs[0]
    assert "finished" not in outs[1]
    import json
    reports = [json.load(open(f"{session.tmp}/report.{r}"))
               for r in range(WORLD)]
    assert [r["rank"] for r in reports] == [0, 1]
    assert list(j_host_mesh_shape(16)) == [4, 4]
    assert all(r["mesh"] == [4, 4] and r["processes"] == WORLD
               and r["step"] == LAUNCHER_STEPS for r in reports)
    strip = [[{k: v for k, v in m.items() if k not in ("dt", "straggler")}
              for m in r["metrics"]] for r in reports]
    assert strip[0] == strip[1]
    assert all(np.isfinite(m["loss"]) for m in strip[0])
    assert os.listdir(session.tmp / "launcher") == [f"step_{LAUNCHER_STEPS}"]


@pytest.mark.parametrize("env,want", [
    ({"RANK": "1", "WORLD_SIZE": "4", "LOCAL_RANK": "1"},
     {"init_method": "env://", "rank": 1, "world_size": 4, "local_rank": 1}),
    ({"JAX_COORDINATOR": "10.0.0.1:1234", "RANK": "3", "WORLD_SIZE": "4"},
     {"init_method": "tcp://10.0.0.1:1234", "rank": 3, "world_size": 4,
      "local_rank": 3}),
])
def test_the_environment_a_group_reads(env, want):
    assert procs.requested(env)
    assert procs.settings(env) == want


def test_what_asks_for_no_group_or_is_missing():
    assert not procs.requested({})
    assert not procs.requested({"WORLD_SIZE": "1", "RANK": "0"})
    with pytest.raises(KeyError, match="RANK"):
        procs.settings({"JAX_COORDINATOR": "localhost:1"})
    if not torch.cuda.is_available():     # a CUDA process needs the card
        with pytest.raises(RuntimeError, match="no CUDA"):
            procs.init(None, rank=0, world_size=1,
                       init_method="file:///nonexistent")
    assert procs.current() is None


def test_remote_slots_are_never_run_here():
    """On a mesh whose slots 2 and 3 are rank 1's, rank 0 runs no work of
    theirs (``sharded.at``), places nothing on them (``lay_out`` from the
    host) and takes no part in a move between two of them."""
    group = SimpleNamespace(rank=0, send=None, recv=None)
    mesh = Mesh(np.array(["cpu"] * 4, dtype=object).reshape(2, 2),
                ("data", "model"), ranks=[0, 0, 1, 1], group=group)
    calls = []
    assert S.at(mesh, 2, calls.append, 1) is S.REMOTE and calls == []
    assert S.at(mesh, 1, calls.append, 1) is None and calls == [1]
    laid = S.lay_out(torch.arange(8.).reshape(2, 4),
                     S.Layout(mesh, L.PSpec("data", "model")))
    assert [isinstance(b, S.Remote) for b in laid.blocks] == \
        [False, False, True, True]
    assert torch.equal(laid.blocks[1], torch.tensor([[2., 3.]]))
    assert S.send(torch.ones(2), mesh, 2, 3) is S.REMOTE
    assert mesh.local_slots() == [0, 1]
    # a gather onto slot 3 reads a slice that slots 0 and 2 hold from
    # slot 2, of its own process
    assert S.sources(S.Layout(mesh, L.PSpec(None, "model")), (2, 4), 3) == \
        [(2, (slice(0, 2), slice(0, 2))), (3, (slice(0, 2), slice(2, 4)))]
