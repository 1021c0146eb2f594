"""The port stands alone: ``repro_torch``, ``chip_smoke.py`` and the
port's examples (``examples/torch_*.py``) import neither JAX nor the
reference package, the copied modules stay verbatim
copies of the reference's, and the smoke script refuses to run (and
prints no result) without CUDA or without the repository beside it."""
import ast
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
COPIES = ["concurrency.py", "store/blockdev.py", "store/sampler.py",
          "store/embcache.py", "store/graphstore.py", "store/placement.py",
          "store/endpoint.py", "store/sharded.py", "store/ingest.py",
          "serve/scheduler.py", "serve/runtime.py", "serve/supervisor.py",
          "rpc/transport.py",
          "rpc/server.py", "rpc/client.py", "rpc/queues.py", "core/registry.py",
          *sorted(f"configs/{p.name}" for p in
                  (REPO / "src" / "repro" / "configs").glob("*.py"))]
KERNEL_FNS = {"agg_combine": "_agg_combine_kernel", "spmm": "_spmm_kernel",
              "gemm": "_gemm_kernel", "sddmm": "_sddmm_kernel",
              "rmsnorm": "_rmsnorm_kernel", "flash_attention": "_flash_kernel",
              "decode_attention": "_decode_kernel"}


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return env


def test_importing_every_port_module_loads_no_jax_and_no_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]), "
        "bad)\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.split(" ", 1)
    assert int(n_modules) >= 50 and bad.strip() == "[]", out.stdout


def _imports(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [REPO / "chip_smoke.py"] +
                         sorted((REPO / "examples").glob("torch_*.py")),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_source_imports_jax_or_repro(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "benchmarks"), \
            f"{path} imports {name}"


def test_the_dense_path_modules_are_among_those_checked():
    """The dense-cache path's modules, the recurrent mixers and the
    training modules are port sources like any other: the import checks
    above cover them.  ``data/pipeline.py`` is not a verbatim copy
    (``Pipeline``'s host defaults differ), so it is not in ``COPIES``."""
    checked = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"models/vlm.py", "models/encdec.py", "models/transformer.py",
            "models/api.py", "models/layers.py", "models/mamba.py",
            "models/xlstm.py", "train/__init__.py", "train/optimizer.py",
            "train/collectives.py", "train/checkpoint.py",
            "train/trainer.py", "data/__init__.py", "data/pipeline.py",
            "launch/train.py"} <= checked
    assert "data/pipeline.py" not in COPIES


@pytest.mark.parametrize("rel", COPIES)
def test_copied_modules_stay_verbatim(rel):
    port = (PORT / rel).read_text()
    note = re.compile(r"\n\nCopy of ``repro/" + re.escape(rel) +
                      r"`` for the PyTorch port, verbatim:\n.*?layout\.",
                      re.S)
    assert note.search(port), f"{rel} lacks its copy note"
    assert note.sub("", port, count=1) == \
        (REPO / "src" / "repro" / rel).read_text()


@pytest.mark.parametrize("name", list(KERNEL_FNS))
def test_each_kernel_has_source_note_counter_and_cuda_source(name):
    fn = KERNEL_FNS[name]
    wrapper = (PORT / "kernels" / f"{name}.py").read_text()
    assert f"repro/kernels/{name}.py::{fn}" in wrapper.replace("::\n", "::")
    assert "Bound on the H100" in wrapper and "\nlaunches = 0\n" in wrapper
    cu = (PORT / "kernels" / "csrc" / f"{name}.cu").read_text()
    assert f"Replaces repro/kernels/{name}.py::{fn}" in cu
    assert "torch/extension.h" not in cu


def test_every_pallas_kernel_has_a_port():
    """Each ``pl.pallas_call`` of the reference has a wrapper and CUDA
    source in the port, and a launch count."""
    from repro_torch import kernels
    ref = REPO / "src" / "repro" / "kernels"
    with_pallas = sorted(p.stem for p in ref.glob("*.py")
                         if "pl.pallas_call(" in p.read_text())
    assert with_pallas == sorted(KERNEL_FNS) == sorted(kernels.KERNELS)


# reference modules the port has no counterpart of, each with its reason
NO_COUNTERPART = {
    "compat.py": "JAX version shims; the port imports no JAX",
    "kernels/config.py": "the Pallas interpret switch; the port's wrappers "
                         "take the plain version for CPU tensors instead",
}


def test_every_reference_module_has_a_counterpart():
    """Every module of ``src/repro/`` has one at the same relative path in
    ``src/repro_torch/``, apart from ``NO_COUNTERPART``'s: the port covers
    the package."""
    ref = REPO / "src" / "repro"
    modules = sorted(str(p.relative_to(ref)) for p in ref.rglob("*.py"))
    missing = [m for m in modules if not (PORT / m).is_file()]
    assert missing == sorted(NO_COUNTERPART)
    assert all(m in modules for m in NO_COUNTERPART)


def test_chip_smoke_refuses_without_cuda_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without CUDA")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         env=_env(), cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    assert "kernels" not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(alone)], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
