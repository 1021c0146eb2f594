"""Step-atomic, async checkpointing in the reference's layout.

Counterpart of ``repro/train/checkpoint.py``, file for file:

  <dir>/step_<N>/
    manifest.json   -- step; per leaf its file, shape, dtype and crc32
    <leaf_key>.npy  -- one file per tree leaf
    COMMIT          -- written last; restore only sees committed steps

Leaf keys are the tree's dict keys and sequence indices joined by "/", in
JAX's leaf order (dict keys sorted, a None an empty subtree); a file is
its key with "/" as "__".  So a checkpoint written by either package
restores in the other, leaf for leaf.

* **async**: ``save`` copies every leaf to host memory at once, then
  writes on a background thread; the train loop never waits on the
  filesystem.
* **atomic**: a step directory without COMMIT is ignored and garbage
  collected; a crash mid-write never corrupts a restore.
* **checked**: ``restore`` verifies each leaf's crc32.
* **elastic**: leaves are stored whole: ``save`` gathers a leaf laid
  out over a mesh's slots (``train/sharded.py``), as the reference's
  ``np.asarray`` does, and ``restore(..., layouts=)`` lays each leaf
  out onto the current mesh's slots, as the reference's ``shardings=``
  re-shards; so a checkpoint moves between meshes, and between meshed
  and unmeshed runs, in both packages.  On a mesh of a process group
  every process gathers (sending its slots' blocks to slot 0) and only
  slot 0's process writes (``save(write=)``); a restore lays out only
  this process's slots' blocks.

NumPy has no bfloat16 type on a host without ml_dtypes, which writes the
reference's bf16 leaves, so a bf16 leaf raises ``TypeError`` naming its
key, on save and on restore.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib

import numpy as np
import torch

from ..device import resolve_device
from ..models import layers as L
from . import sharded as S


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _to_numpy(key: str, leaf) -> np.ndarray:
    if isinstance(leaf, S.Laid):
        leaf = S.gather(leaf)
    if isinstance(leaf, S.Remote):          # slot 0 is another process's
        return None
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError(f"checkpoint leaf {key} is bfloat16, which NumPy "
                            "cannot hold; cast it to float32 first")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, *, blocking: bool = False,
             write: bool = True) -> None:
        """Commit ``tree`` as ``step``; ``write`` False gathers its laid
        leaves (this process's part of the moves) and writes nothing."""
        host = [(_key(path), _to_numpy(_key(path), leaf))  # device->host now
                for path, leaf in L.tree_items(tree)]
        if not write:
            return
        self.wait()                                          # one in flight

        def write():
            tmp = os.path.join(self.dir, f".tmp_step_{step}")
            final = os.path.join(self.dir, f"step_{step}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            manifest = {"step": step, "leaves": {}}
            for key, leaf in host:
                fn = key.replace("/", "__") + ".npy"
                np.save(os.path.join(tmp, fn), leaf)
                manifest["leaves"][key] = {
                    "file": fn, "shape": list(np.shape(leaf)),
                    "dtype": str(leaf.dtype),
                    "crc": zlib.crc32(np.ascontiguousarray(leaf).tobytes()),
                }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            with open(os.path.join(tmp, "COMMIT"), "w") as f:
                f.write("ok")
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write,
                                            name="checkpoint-writer")
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(self.committed_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)
        for d in os.listdir(self.dir):                 # orphaned tmp dirs
            if d.startswith(".tmp_step_"):
                shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def committed_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, d, "COMMIT")):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.committed_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like, step: int | None = None, *, device=None,
                layouts=None, verify: bool = True):
        """(tree, step): the leaves of ``step`` (default the latest
        committed) in the structure of ``tree_like``, whose leaves are only
        placeholders, as tensors on ``device`` (default: the card), or,
        given ``layouts`` (a tree of ``sharded.Layout`` of the same
        structure), each laid out over its mesh's slots.  Raises
        ``IOError`` on a crc mismatch."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError("no committed checkpoint")
        dev = torch.device("cpu") if layouts is not None \
            else resolve_device(device)
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = []
        for path, _ in L.tree_items(tree_like):
            key = _key(path)
            meta = manifest["leaves"][key]
            if meta["dtype"] == "bfloat16":
                raise TypeError(f"checkpoint leaf {key} is bfloat16, which "
                                "NumPy cannot load here")
            arr = np.load(os.path.join(d, meta["file"]))
            if verify:
                crc = zlib.crc32(np.ascontiguousarray(arr).tobytes())
                if crc != meta["crc"]:
                    raise IOError(f"checkpoint leaf {key} corrupt")
            leaves.append(torch.from_numpy(np.array(arr)).to(dev))
        tree = L.tree_unflatten(tree_like, leaves)
        if layouts is not None:
            tree = S.lay_out_tree(tree, layouts)
        return tree, step
