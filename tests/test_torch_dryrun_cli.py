"""The port's dry run from the command line
(``python -m repro_torch.launch.dryrun``), on the CPU: every cell of
``--all`` at ``--dev --smoke`` on both dev meshes traces, and the
command writes one record a cell (item (e) of
``tests/test_torch_dryrun.py``), each with the analysis half's keys:
peak and temp bytes (traced at the cell's own shape, so no lower
bound), ``fits`` and ``arguments_fit``, flops, dot flops,
bytes accessed, and transfers for a train cell or a serving cell split
over the model axis (None for a gathered serving cell).  About
five minutes: the recurrent families' train cells loop over 512 time
steps of meta ops, under the trace's dispatch mode."""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_command_line_dev_smoke_all_cells(tmp_path):
    # one intra-op thread: the trace's ops are small, and the test's
    # neighbours under pytest -n take the other cores
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all", "--dev",
         "--smoke", "--both-meshes", "--out", str(tmp_path)],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=900)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "ALL 68 dry-run cells traced OK" in r.stdout
    files = sorted(os.listdir(tmp_path))
    assert len(files) == 68
    rec = json.loads((tmp_path / "xlstm-125m__long_500k__pod2.json")
                     .read_text())
    assert rec["mesh"] == {"pod": 2, "data": 2, "model": 4}
    assert rec["memory"]["argument_size_in_bytes"] > 0 and rec["trace_s"] >= 0
    for name in files:
        rec = json.loads((tmp_path / name).read_text())
        m = rec["memory"]
        assert m["peak_bytes"] == m["argument_size_in_bytes"] \
            + m["temp_size_in_bytes"] and m["temp_size_in_bytes"] > 0, name
        assert rec["fits"] and rec["arguments_fit"], name
        assert m["peak_is_lower_bound"] is False, name
        assert 0 < rec["flops"] and 0 < rec["dot_flops"] \
            and 0 < rec["bytes_accessed"], name
        if rec["kind"] == "train" or rec["model_split"]:
            c = rec["collectives"]
            assert c["total_bytes"] == sum(c["bytes_by_kind"].values()) > 0
        else:
            assert rec["collectives"] is None, name
