"""The repository's static concurrency passes (``tools/analysis``: lock
order, guarded-by, thread lifecycle, RPC surface) over the port's own
package, ``src/repro_torch``, as ``tools/analyze.py`` runs them over the
reference: the registry is the reference's ``LOCK_ORDER`` plus the
port's own locks (``repro_torch/locks.py``), the baseline the
reference's, whose one entry covers the copied ``store/ingest.py``
too.  Every port lock is witness-wrapped under its spec, and the
runtime witness order-checks it."""
import re
import sys
import threading
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

from analysis import (core, guarded, lockorder,  # noqa: E402
                      rpcsurface, threads)
from repro_torch import concurrency as conc, locks  # noqa: E402

BASELINE = REPO / "tools" / "analysis" / "guarded_baseline.txt"


def _findings():
    cfg = core.AnalysisConfig(specs=conc.LOCK_ORDER + locks.PORT_LOCK_ORDER)
    src = core.load_package(REPO / "src" / "repro_torch", REPO)
    extra = core.load_package(REPO / "tests", REPO)
    gb = guarded.run(cfg, src)
    core.apply_baseline(gb, core.load_baseline(BASELINE))
    return (lockorder.run(cfg, src) + gb + threads.run(cfg, src)
            + rpcsurface.run(cfg, src, extra_modules=extra))


def test_the_port_is_clean_under_the_static_passes():
    findings = _findings()
    active = [f.render() for f in findings if not f.suppressed]
    assert active == [], active
    # the copied firehose carries the reference's reviewed GB002
    assert [f.key() for f in findings if f.suppressed] == [
        "GB002:ingest.MutationFirehose.snapshot:self.counters (read) "
        "outside its guard ingest._lock"]


def test_every_port_lock_is_witness_wrapped_and_witnessed():
    for spec in locks.PORT_LOCK_ORDER:
        assert conc.SPEC[spec.name] is spec
        for modname, attr in spec.sites:
            text = next((REPO / "src" / "repro_torch").rglob(
                f"{modname}.py")).read_text()
            assert re.search(rf"self\.{re.escape(attr)}\s*=\s*witness_",
                             text), f"{modname}.{attr} is not wrapped"
    conc.set_witness(True)
    conc.reset_witness()
    try:
        outer = conc.witness_lock("graphstore._lock", threading.RLock())
        cache = locks.witness_lock("dfg._cache_lock", threading.Lock())
        with outer:
            with cache:
                pass
        conc.assert_clean()
        with cache:                     # a leaf: nothing under it
            with conc.witness_lock("blockdev._lock", threading.Lock()):
                pass
        kinds = {v["kind"] for v in conc.witness_report()["violations"]}
        assert kinds == {"leaf"}
    finally:
        conc.reset_witness()
        conc.set_witness(False)
