"""The port's entry examples (``examples/torch_*.py``) on the CPU against
the reference's (``examples/*.py``): the quickstart's result within the
service's 2e-5, the mutable graph's page statistics equal, the GNN
service's firehose and reshard-under-a-kill drills through their own
asserts with no failed request, ``train_lm --smoke``'s losses within the
reference launcher's rtol 1e-5, the same argument errors, and a raise
where there is no card and no ``--device cpu``."""
import importlib.util
import pathlib
import runpy
import shutil
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples"
SERVICE_TOL = 2e-5                     # Hetero vs Octa, kernels vs plain


def _load(name: str):
    """An example file as a module (``examples/`` is no package)."""
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_matches_the_reference_flow(capsys):
    got = _load("torch_quickstart").main(["--device", "cpu"])
    want = runpy.run_path(str(EXAMPLES / "quickstart.py"))
    out = capsys.readouterr().out
    assert "inferred embeddings for 4 targets: (4, 16)" in out
    ref = np.asarray(want["out"]["Result"])
    assert got["Result"].shape == ref.shape
    np.testing.assert_allclose(got["Result"], ref, rtol=SERVICE_TOL,
                               atol=SERVICE_TOL)
    assert got["trace"].count(("AggCombine", "vector")) == 2, got["trace"]
    assert got["devices"] == sorted({d for _, d in
                                     want["service"].engine.trace})


def test_mutable_graph_page_statistics_equal_the_reference(monkeypatch,
                                                            capsys):
    days = 3
    got = _load("torch_mutable_graph").main(["--days", str(days),
                                             "--device", "cpu"])
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["mutable_graph.py", "--days",
                                      str(days)])
    _load("mutable_graph").main()
    line = capsys.readouterr().out.strip().splitlines()[-1]
    want = dict(kv.split("=") for kv in line.split())
    assert (got["pages_h"], got["pages_l"], got["l_evictions"],
            got["written_pages"]) == (
        int(want["H-pages"]), int(want["L-pages"]), int(want["L-splits"]),
        int(want["written_pages"]))
    assert got["written_pages"] > 0 and got["days"] == days


@pytest.mark.parametrize("flags,drills", [
    (["--shards", "2", "--firehose"], ("firehose",)),
    (["--shards", "2", "--replication", "2", "--reshard-grow", "1",
      "--kill-shard", "1"], ("reshard", "kill")),
], ids=["firehose", "reshard-grow-kill-shard"])
def test_serve_gnn_drills_pass_their_asserts(flags, drills):
    report = _load("torch_serve_gnn").main(
        ["--device", "cpu", "--requests", "2", "--clients", "2", *flags])
    assert report["failed"] == 0 and report["requests"] == 4, report
    for drill in drills:
        assert report[drill]["bit_identical"] is True, report[drill]
    if "reshard" in drills:
        assert report["reshard"]["n_shards"] == 3


def test_train_lm_smoke_losses_match_the_reference_launcher(tmp_path):
    """The port resumes from the reference launcher's step-1 checkpoint
    (the two packages draw their initial parameters from different
    generators) and trains on over the same deterministic stream: its
    losses are the reference run's from step 1 on."""
    from repro.launch import train as jtrain
    steps, seq = 2, 16
    ref = jtrain.main(["--arch", "xlstm-125m", "--batch", "4", "--seq",
                       str(seq), "--ckpt-every", "1", "--smoke", "--steps",
                       str(1 + steps), "--ckpt", str(tmp_path / "ref")])
    shutil.copytree(tmp_path / "ref" / "step_1", tmp_path / "port" / "step_1")
    got = _load("torch_train_lm").main(
        ["--smoke", "--steps", str(steps), "--seq", str(seq), "--device",
         "cpu", "--ckpt", str(tmp_path / "port")])
    want = [m["loss"] for m in ref.metrics_log][1:]
    assert len(got["losses"]) == steps == len(want)
    np.testing.assert_allclose(got["losses"], want, rtol=1e-5)
    assert got["step"] == 1 + steps


# every argument check of the reference's serve_gnn.py, each made to fire
SERVE_GNN_ERRORS = {
    "kill-needs-replication": ["--kill-shard", "1"],
    "chaos-needs-replication": ["--chaos"],
    "chaos-and-kill": ["--chaos", "--replication", "2", "--kill-shard", "1"],
    "remote-and-shards": ["--remote-shards", "2", "--shards", "2"],
    "firehose-and-faults": ["--firehose", "--replication", "2", "--chaos"],
    "grow-and-shrink": ["--shards", "2", "--reshard-grow", "1",
                        "--reshard-shrink", "1"],
    "reshard-and-firehose": ["--shards", "2", "--reshard-grow", "1",
                             "--firehose"],
    "reshard-needs-array": ["--reshard-grow", "1"],
    "shrink-and-kill": ["--shards", "3", "--replication", "2",
                        "--reshard-shrink", "1", "--kill-shard", "1"],
    "shrink-too-far": ["--shards", "3", "--replication", "2",
                       "--reshard-shrink", "2"],
    "unknown-model": ["--model", "gat"],
}


@pytest.mark.parametrize("case", sorted(SERVE_GNN_ERRORS))
def test_serve_gnn_argument_errors_equal_the_references(case, monkeypatch,
                                                        capsys):
    flags = SERVE_GNN_ERRORS[case]
    monkeypatch.setattr(sys, "argv", ["serve_gnn.py", *flags])
    with pytest.raises(SystemExit) as want:
        _load("serve_gnn").main()
    want_err = capsys.readouterr().err.strip().splitlines()[-1]
    with pytest.raises(SystemExit) as got:
        _load("torch_serve_gnn").main(flags)
    got_err = capsys.readouterr().err.strip().splitlines()[-1]
    assert got.value.code == want.value.code == 2
    assert got_err == want_err and "error:" in got_err


# each example's smallest run on its default device
NO_CARD_RUNS = {
    "torch_quickstart": [],
    "torch_serve_gnn": ["--requests", "1", "--clients", "1"],
    "torch_mutable_graph": ["--days", "1"],
    "torch_serve_lm_paged": ["--requests", "1", "--max-new", "1"],
    "torch_train_lm": ["--smoke", "--steps", "1", "--seq", "8"],
}


@pytest.mark.parametrize("name", sorted(NO_CARD_RUNS))
def test_each_example_raises_without_a_card(name, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = list(NO_CARD_RUNS[name])
    if name == "torch_train_lm":
        argv += ["--ckpt", str(tmp_path)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(name).main(argv)
    assert not any(tmp_path.iterdir())
