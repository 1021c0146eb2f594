"""Mutable graph support (paper Fig. 20) on the PyTorch/CUDA port: replay
a DBLP-like growth stream of daily vertex/edge inserts and deletions
against the port's GraphStore and report per-day latency and page
statistics.  The same stream as ``examples/mutable_graph.py``; the store
lives on the host, as the reference's does, and the run takes the card
by default like every entry point of the port.

  PYTHONPATH=src python examples/torch_mutable_graph.py [--days 23]
  PYTHONPATH=src python examples/torch_mutable_graph.py --device cpu
"""
import argparse
import time

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.store.blockdev import BlockDevice
from repro_torch.store.graphstore import GraphStore


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--days", type=int, default=23)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (cpu: no card needed)")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    rng = np.random.default_rng(0)
    gs = GraphStore(BlockDevice(), h_threshold=64)
    gs.update_graph(np.array([[0, 1], [1, 2]], np.int64))
    next_vid = 3
    per_day = []
    for _ in range(args.days):
        t0 = time.perf_counter()
        for v in range(next_vid, next_vid + 36):
            gs.add_vertex(v)
        next_vid += 36
        for _ in range(880):
            gs.add_edge(int(rng.integers(0, next_vid)),
                        int(rng.integers(0, next_vid)))
        for _ in range(71):
            v = int(rng.integers(0, next_vid))
            nb = gs.get_neighbors(v)
            nb = nb[nb != v]
            if len(nb):
                gs.delete_edge(v, int(nb[0]))
        for _ in range(2):
            gs.delete_vertex(int(rng.integers(0, next_vid)))
        per_day.append(time.perf_counter() - t0)
    per_day = np.array(per_day) * 1e3
    print(f"{args.days} days, ~989 unit ops/day: "
          f"mean={per_day.mean():.0f} ms worst={per_day.max():.0f} ms")
    out = {"days": args.days, "mean_ms": float(per_day.mean()),
           "worst_ms": float(per_day.max()),
           "pages_h": gs.stats.pages_h, "pages_l": gs.stats.pages_l,
           "l_evictions": gs.stats.l_evictions,
           "written_pages": gs.dev.stats.written_pages}
    print(f"H-pages={out['pages_h']} L-pages={out['pages_l']} "
          f"L-splits={out['l_evictions']} "
          f"written_pages={out['written_pages']}")
    return out


if __name__ == "__main__":
    main()
