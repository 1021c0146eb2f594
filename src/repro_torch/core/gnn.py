"""GNN models — GCN, GIN, NGCF (paper §2.1), in two executable forms.

Counterpart of ``repro/core/gnn.py``:

1. **Direct torch** forward functions (the validation oracle).
2. **DFG builders** emitting the paper-style computational graph (Fig. 10)
   whose C-operations the GraphRunner engine binds to registered C-kernels
   (Shell torch or the CUDA kernels) at run time.  Tests assert form 2 ==
   form 1, and both against the JAX reference.

``init_params`` draws from NumPy's generator exactly as the reference
does, so the weights are bit-identical; ``params_from_numpy`` brings the
reference's own parameters (as NumPy arrays) over.

* GCN  — average aggregation (degree-normalized), 1-layer transform + ReLU.
* GIN  — summation aggregation with learnable self-weight eps and a 2-layer
         MLP transform.
* NGCF — similarity-aware aggregation: element-wise product of neighbor and
         target embeddings feeds a second weight matrix.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .dfg import DFG

# ----------------------------------------------------------------- params
PARAM_KEYS = {"gcn": ("W", "b"),
              "gin": ("eps", "W1", "b1", "W2", "b2"),
              "ngcf": ("W1", "W2", "b")}


def _glorot(rng, fan_in, fan_out):
    s = np.sqrt(6.0 / (fan_in + fan_out))
    return np.asarray(rng.uniform(-s, s, (fan_in, fan_out)), np.float32)


def _init_numpy(model: str, dims: list[int], seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    params = []
    for fi, fo in zip(dims[:-1], dims[1:]):
        if model == "gcn":
            params.append({"W": _glorot(rng, fi, fo),
                           "b": np.zeros((fo,), np.float32)})
        elif model == "gin":
            params.append({
                "eps": np.zeros((), np.float32),
                "W1": _glorot(rng, fi, fo), "b1": np.zeros((fo,), np.float32),
                "W2": _glorot(rng, fo, fo), "b2": np.zeros((fo,), np.float32),
            })
        elif model == "ngcf":
            params.append({"W1": _glorot(rng, fi, fo),
                           "W2": _glorot(rng, fi, fo),
                           "b": np.zeros((fo,), np.float32)})
        else:
            raise ValueError(model)
    return params


def init_params(model: str, dims: list[int], seed: int = 0, *,
                device: str | torch.device | None = None) -> list[dict]:
    """dims = [F_in, F_h1, ..., F_out]; one param dict per GNN layer, on
    ``device`` (default: the card)."""
    return params_from_numpy(model, _init_numpy(model, dims, seed), device)


def params_from_numpy(model: str, params: list[dict],
                      device: str | torch.device | None) -> list[dict]:
    """The reference's parameters (``np.asarray`` of each
    ``repro.core.gnn.init_params`` leaf) as the port's tensors."""
    dev = resolve_device(device)
    out = []
    for p in params:
        if tuple(sorted(p)) != tuple(sorted(PARAM_KEYS[model])):
            raise ValueError(f"{model} layer params {sorted(p)} != "
                             f"{sorted(PARAM_KEYS[model])}")
        out.append({k: torch.tensor(np.asarray(v, np.float32), device=dev)
                    for k, v in p.items()})
    return out


# ------------------------------------------------------------- aggregation
def _gather(h, nbr):
    return h[nbr.long()]                                   # (D,K,F)


def agg_mean(h, nbr, mask):
    g = _gather(h, nbr) * mask[..., None]
    deg = torch.clamp(mask.sum(dim=1), min=1.0)
    return g.sum(dim=1) / deg[:, None]


def agg_sum(h, nbr, mask):
    return (_gather(h, nbr) * mask[..., None]).sum(dim=1)


# ------------------------------------------------------------ direct models
def gcn_forward(params, emb, blocks):
    """blocks: [(nbr, mask), ...] ordered layer_1..layer_L (outermost first)."""
    h = emb
    for p, (nbr, mask) in zip(params, blocks):
        h = agg_mean(h, nbr, mask)
        h = torch.relu(h @ p["W"] + p["b"])
    return h


def gin_forward(params, emb, blocks):
    h = emb
    for p, (nbr, mask) in zip(params, blocks):
        s = agg_sum(h, nbr, mask)                       # includes self-loop
        self_h = h[: nbr.shape[0]]                      # prefix ordering
        z = s + p["eps"] * self_h                       # (1+eps)·self + Σ nbrs
        z = torch.relu(z @ p["W1"] + p["b1"])
        h = torch.relu(z @ p["W2"] + p["b2"])
    return h


def ngcf_forward(params, emb, blocks, *, alpha: float = 0.2):
    h = emb
    for p, (nbr, mask) in zip(params, blocks):
        self_h = h[: nbr.shape[0]]
        g = _gather(h, nbr)                                # (D,K,F) neighbors
        prod = g * self_h[:, None, :]                      # similarity term
        deg = torch.clamp(mask.sum(dim=1), min=1.0)[:, None]
        m1 = (g * mask[..., None]).sum(dim=1) / deg
        m2 = (prod * mask[..., None]).sum(dim=1) / deg
        z = m1 @ p["W1"] + m2 @ p["W2"] + self_h @ p["W1"] + p["b"]
        h = torch.where(z > 0, z, alpha * z)               # LeakyReLU
    return h


FORWARD = {"gcn": gcn_forward, "gin": gin_forward, "ngcf": ngcf_forward}


# ---------------------------------------------------------------- DFG form
def build_gcn_dfg(num_layers: int) -> DFG:
    """Paper Fig. 10b: Batch -> SpMM_Mean -> GEMM(+W) -> ReLU, per layer."""
    g = DFG()
    h = g.create_in("H")
    for l in range(num_layers):
        nbr = g.create_in(f"nbr{l}")
        mask = g.create_in(f"mask{l}")
        w = g.create_in(f"W{l}")
        b = g.create_in(f"b{l}")
        (a,) = g.create_op("SpMM_Mean", [h, nbr, mask])
        (m,) = g.create_op("GEMM", [a, w])
        (m,) = g.create_op("BiasAdd", [m, b])
        (h,) = g.create_op("ReLU", [m])
    g.create_out("Result", h)
    return g


def build_gin_dfg(num_layers: int) -> DFG:
    g = DFG()
    h = g.create_in("H")
    for l in range(num_layers):
        nbr = g.create_in(f"nbr{l}")
        mask = g.create_in(f"mask{l}")
        eps = g.create_in(f"eps{l}")
        w1, b1 = g.create_in(f"W1_{l}"), g.create_in(f"b1_{l}")
        w2, b2 = g.create_in(f"W2_{l}"), g.create_in(f"b2_{l}")
        (s,) = g.create_op("SpMM_Sum", [h, nbr, mask])
        (selfh,) = g.create_op("Prefix", [h, nbr])
        (se,) = g.create_op("Scale", [selfh, eps])
        (z,) = g.create_op("Add", [s, se])
        (z,) = g.create_op("GEMM", [z, w1])
        (z,) = g.create_op("BiasAdd", [z, b1])
        (z,) = g.create_op("ReLU", [z])
        (z,) = g.create_op("GEMM", [z, w2])
        (z,) = g.create_op("BiasAdd", [z, b2])
        (h,) = g.create_op("ReLU", [z])
    g.create_out("Result", h)
    return g


def build_ngcf_dfg(num_layers: int) -> DFG:
    g = DFG()
    h = g.create_in("H")
    for l in range(num_layers):
        nbr = g.create_in(f"nbr{l}")
        mask = g.create_in(f"mask{l}")
        w1, w2, b = (g.create_in(f"W1_{l}"), g.create_in(f"W2_{l}"),
                     g.create_in(f"b{l}"))
        (m1,) = g.create_op("SpMM_Mean", [h, nbr, mask])
        (prod,) = g.create_op("SDDMM", [h, nbr, mask])          # (D,K,F)
        (m2sum,) = g.create_op("Reduce", [prod], attrs={"axis": 1, "op": "sum"})
        (deg,) = g.create_op("DegNorm", [mask])
        (m2,) = g.create_op("Mul", [m2sum, deg])
        (selfh,) = g.create_op("Prefix", [h, nbr])
        (t1,) = g.create_op("GEMM", [m1, w1])
        (t2,) = g.create_op("GEMM", [m2, w2])
        (t3,) = g.create_op("GEMM", [selfh, w1])
        (z,) = g.create_op("Add", [t1, t2])
        (z,) = g.create_op("Add", [z, t3])
        (z,) = g.create_op("BiasAdd", [z, b])
        (h,) = g.create_op("LeakyReLU", [z])
    g.create_out("Result", h)
    return g


BUILD_DFG = {"gcn": build_gcn_dfg, "gin": build_gin_dfg, "ngcf": build_ngcf_dfg}


def extra_shell_kernels() -> dict:
    """GNN-specific helper C-operations used by the DFG forms."""
    return {
        "Prefix": lambda h, nbr: h[: nbr.shape[0]],
        "DegNorm": lambda mask: 1.0 / torch.clamp(mask.sum(dim=1),
                                                  min=1.0)[:, None],
        "LeakyReLU": lambda z: torch.where(z > 0, z, 0.2 * z),
    }


def dfg_feeds(model: str, params, emb, blocks) -> dict:
    """Assemble the feed dict matching the build_*_dfg input names."""
    feeds = {"H": emb}
    for l, (nbr, mask) in enumerate(blocks):
        feeds[f"nbr{l}"] = nbr
        feeds[f"mask{l}"] = mask
    for l, p in enumerate(params):
        if model == "gcn":
            feeds[f"W{l}"], feeds[f"b{l}"] = p["W"], p["b"]
        elif model == "gin":
            feeds[f"eps{l}"] = p["eps"]
            feeds[f"W1_{l}"], feeds[f"b1_{l}"] = p["W1"], p["b1"]
            feeds[f"W2_{l}"], feeds[f"b2_{l}"] = p["W2"], p["b2"]
        elif model == "ngcf":
            feeds[f"W1_{l}"], feeds[f"W2_{l}"] = p["W1"], p["W2"]
            feeds[f"b{l}"] = p["b"]
    return feeds
