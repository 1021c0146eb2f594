"""One rank of ``test_torch_multiprocess_train.py``'s two-process session.

  python tests/_multiprocess_train.py RANK WORLD INIT_FILE DIR

Joins a gloo group of WORLD processes at ``file://INIT_FILE``, makes a
mesh of every process's 4 CPU slots (a (2, 4) mesh of the two) and runs
each case of ``CASES`` in turn; what each case saw goes, pickled, to
``DIR/rank<RANK>.pkl`` (a case's exception too).  It imports nothing of
JAX, so the ranks start in seconds."""
import os
import pickle
import sys
import time
import traceback

import torch

from repro_torch.configs import SMOKES
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import Pipeline
from repro_torch.launch import procs
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build, layers as L
from repro_torch.train.trainer import Trainer
from _model_axis import smoke

CPU = "cpu"
LOCAL_SLOTS = 4
DENSE = "llama3.2-3b"
SEQ, BATCH, STEPS = 16, 8, 3
# case: (mesh shape, zero1, grad_accum): the split step with ZeRO-1, the
# gathered step with ZeRO-1, two data rows a process accumulating two
# micro-batches, the split step resumed from one process's step 2
RUNS = {"split": ((2, 4), True, 1), "gathered": ((8, 1), True, 1),
        "accumulated": ((4, 2), False, 2), "resumed": ((2, 4), True, 1)}
# tensors the transport case sends rank 0 -> rank 1, as (dtype, shape)
SENT = ((torch.float32, (3, 5)), (torch.bfloat16, (7,)), (torch.int32, ()),
        (torch.float64, (0, 4)), (torch.bool, (2, 2, 2)))


def trainer(mesh_shape, zero1, grad_accum, **kw) -> Trainer:
    mesh = make_host_mesh(devices=[CPU] * LOCAL_SLOTS, shape=mesh_shape)
    return Trainer(build(smoke(SMOKES, DENSE), tp=mesh_shape[1]),
                   ShapeConfig("t", "train", SEQ, BATCH), mesh=mesh,
                   zero1=zero1, grad_accum=grad_accum, **kw)


def blocks(mesh, params, opt) -> dict:
    """{slot: every leaf's block of params, then of opt, as NumPy} for
    this process's slots."""
    leaves = L.tree_leaves(params) + L.tree_leaves(opt)
    return {i: [a.blocks[i].numpy().copy() for a in leaves]
            for i in mesh.local_slots()}


def sent(k: int) -> torch.Tensor:
    dtype, shape = SENT[k]
    g = torch.Generator().manual_seed(k)
    return (torch.randn(shape, generator=g) * 10).to(dtype)


def run_case(name: str, group, d: str) -> dict:
    if name == "transport":
        if group.rank == 0:
            for k in range(len(SENT)):
                group.send(sent(k), 1)
            return {"moved": dict(group.moved)}
        got = [group.recv(0, torch.device(CPU)) for _ in range(len(SENT))]
        return {"got": got, "moved": dict(group.moved)}
    if name == "mesh":
        mesh = make_host_mesh(devices=[CPU] * LOCAL_SLOTS)
        out = {"shape": tuple(mesh.devices.shape),
               "ranks": mesh.ranks.tolist(),
               "local": mesh.local_slots(),
               "4x2": tuple(make_host_mesh(devices=[CPU] * LOCAL_SLOTS,
                                           shape=(4, 2)).devices.shape)}
        for key, kw in (("1x8", {"shape": (1, 8)}), ("model8", {"model": 8}),
                        ("n4", {"n": 4})):
            try:
                make_host_mesh(devices=[CPU] * LOCAL_SLOTS, **kw)
                out[key] = None
            except NotImplementedError as e:
                out[key] = str(e)
        pipe = Pipeline(smoke(SMOKES, DENSE),
                        ShapeConfig("t", "train", SEQ, BATCH))
        out["pipeline"] = (pipe.host_index, pipe.host_count)
        pipe.close()
        return out
    ckpt = os.path.join(d, "from_one" if name == "resumed" else f"two_{name}")
    tr = trainer(*RUNS[name], ckpt_dir=ckpt, ckpt_every=1)
    t0 = time.perf_counter()
    params, opt, step = tr.run(STEPS - 2 if name == "resumed" else STEPS)
    return {"metrics": tr.metrics_log, "step": step,
            "blocks": blocks(tr.mesh, params, opt),
            "seconds": time.perf_counter() - t0}


CASES = ("transport", "mesh", "split", "gathered", "accumulated",
         "resumed")


def main(rank: int, world: int, init_file: str, d: str) -> None:
    torch.set_num_threads(1)
    group = procs.init(CPU, rank=rank, world_size=world,
                       init_method=f"file://{init_file}", timeout_s=120)
    out = {}
    try:
        for name in CASES:
            out[name] = run_case(name, group, d)
    except Exception:      # noqa: BLE001 - the test reads it
        out["error"] = traceback.format_exc()
        raise
    finally:
        with open(os.path.join(d, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        procs.close()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
