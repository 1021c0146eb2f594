"""Quickstart on the PyTorch/CUDA port: the paper's headline flow.

Build a graph -> bulk-ingest into GraphStore (near-storage) -> program the
Hetero accelerator -> run GCN inference through a DFG over RPC, the fused
GCN layers on the card's AggCombine kernel.  The same flow as
``examples/quickstart.py``, on ``repro_torch``.

  PYTHONPATH=src python examples/torch_quickstart.py                # card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu   # CPU
"""
import argparse

import numpy as np

from repro_torch.core import gnn
from repro_torch.core.service import HolisticGNNService, make_service_dfg
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import program_config
from repro_torch.rpc import RPCClient, RPCServer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device of the service (cpu: plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.default_rng(0)

    # 1. a power-law graph + node embeddings (the "raw data on storage")
    n_vertices, n_edges, feat = 1000, 8000, 64
    edges = np.stack([rng.integers(0, n_vertices, n_edges),
                      rng.zipf(1.4, n_edges) % n_vertices],
                     1).astype(np.int64)
    embeddings = rng.standard_normal((n_vertices, feat)).astype(np.float32)

    # 2. the CSSD-side service, reached over RPC-over-PCIe
    service = HolisticGNNService(h_threshold=32, pad_to=32, device=device)
    client = RPCClient(RPCServer(service))

    stats = client.call("update_graph", edge_array=edges,
                        embeddings=embeddings)
    print(f"bulk ingest: total={stats['total_s'] * 1e3:.1f} ms, "
          f"user-visible={stats['user_visible_s'] * 1e3:.1f} ms "
          f"(graph preprocessing overlapped)")

    # 3. program the User logic: vector (SpMM) + systolic (GEMM) accelerators
    reconfig_s = program_config(service.xbuilder, "hetero")
    print(f"XBuilder reconfigured to Hetero in {reconfig_s * 1e3:.2f} ms")

    # 4. ship a GCN as a dataflow graph; sampling runs where the data lives.
    # Weights travel over RoP as NumPy arrays.
    params = gnn.init_params("gcn", [feat, 32, 16], seed=1, device="cpu")
    dfg = make_service_dfg("gcn", num_layers=2, fanouts=[10, 10])
    weights = {k: v.numpy() for k, v in
               gnn.dfg_feeds("gcn", params, None, []).items() if k != "H"}
    out = client.call("run", dfg=dfg.save(), batch=[1, 2, 3, 4],
                      weights=weights)
    result = np.asarray(out["Result"])
    devices = sorted({d for _, d in service.engine.trace})
    print(f"inferred embeddings for 4 targets: {result[:4].shape}")
    print(f"executed on devices: {devices}")
    tx, rx = client.tx.stats.bytes_moved, client.rx.stats.bytes_moved
    print(f"RoP traffic: {tx / 1e3:.1f} KB sent, {rx / 1e3:.1f} KB received")
    return {"ingest_total_s": stats["total_s"],
            "ingest_user_visible_s": stats["user_visible_s"],
            "reconfig_s": reconfig_s, "Result": result,
            "devices": devices, "trace": list(service.engine.trace),
            "tx_bytes": tx, "rx_bytes": rx}


if __name__ == "__main__":
    main()
