"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the reference package, the copied modules stay verbatim
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
          "store/embcache.py", "store/graphstore.py", "rpc/transport.py",
          "rpc/server.py", "rpc/client.py", "rpc/queues.py", "core/registry.py"]


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
    assert int(n_modules) >= 20 and bad.strip() == "[]", out.stdout


def _imports(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_source_imports_jax_or_repro(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "benchmarks"), \
            f"{path} imports {name}"


@pytest.mark.parametrize("rel", COPIES)
def test_copied_modules_stay_verbatim(rel):
    port = (PORT / rel).read_text()
    note = re.compile(r"\n\nCopy of ``repro/" + re.escape(rel) +
                      r"`` for the PyTorch port, verbatim:\n.*?layout\.",
                      re.S)
    assert note.search(port), f"{rel} lacks its copy note"
    assert note.sub("", port, count=1) == \
        (REPO / "src" / "repro" / rel).read_text()


@pytest.mark.parametrize("name", ["agg_combine", "spmm", "gemm", "sddmm"])
def test_each_kernel_has_source_note_counter_and_cuda_source(name):
    wrapper = (PORT / "kernels" / f"{name}.py").read_text()
    assert f"repro/kernels/{name}.py::_{name}_kernel" in \
        wrapper.replace("::\n", "::")
    assert "Bound on the H100" in wrapper and "\nlaunches = 0\n" in wrapper
    cu = (PORT / "kernels" / "csrc" / f"{name}.cu").read_text()
    assert f"Replaces repro/kernels/{name}.py::_{name}_kernel" in cu
    assert "torch/extension.h" not in cu


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
