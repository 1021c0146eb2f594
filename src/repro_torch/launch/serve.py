"""Paged-KV serving engine: continuous batching over a page-pooled KV cache
(the paper's GraphStore paging as the serving memory manager), on the
card.

Counterpart of ``repro/launch/serve.py``.  Requests arrive with prompts;
the scheduler prefills new sequences and steps the running batch, KV
pages are chained per sequence by ``PagedKVManager``, and attention
reads through the page table.  On CUDA tensors every norm and attention
call launches its kernel: rmsnorm in each layer and before the logits,
flash_attention at prefill, decode_attention at every decode step.
There is no switch to the plain versions; they run only where the
engine's device is the CPU.  The projections are plain products
(``torch.einsum``, fp32 without TF32), as the reference leaves them to
XLA.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \\
      --requests 8 [--full] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCHS, SMOKES
from ..device import resolve_device
from ..kernels import ops as K
from ..models import build, layers as L
from ..store.pagedkv import PagePool, PagedKVManager, Sequence


class PagedLM:
    """Decoder LM over paged KV (attention-only archs).  The layer loop is
    unrolled (serving-scale depth); projections use the model params,
    which must lie on the pool's device."""

    def __init__(self, cfg, params, pool: PagePool):
        if not all(k in ("attn", "local") for k in cfg.period_pattern):
            raise ValueError("paged serving supports attention archs, got "
                             f"{cfg.period_pattern}")
        self.cfg, self.params, self.pool = cfg, params, pool
        self.mgr = PagedKVManager(pool)
        self.device = pool.k.device
        self.layers = [self._layer_params(i) for i in range(cfg.num_layers)]

    # --------------------------------------------------------- layer params
    def _layer_params(self, idx: int):
        """(params, kind) of layer ``idx``: views into the stacked tree."""
        period = len(self.cfg.period_pattern)
        if idx < self.cfg.n_periods * period:
            pos, per = idx % period, idx // period
            return L.take_layer(self.params["stack"][pos], per), \
                self.cfg.period_pattern[pos]
        pos = idx - self.cfg.n_periods * period
        return self.params["rem"][pos], self.cfg.remainder_kinds[pos]

    def _qkv(self, pm, x, cos, sin):
        xn = L.rms_norm(x, pm["ln"], self.cfg.norm_eps)
        q = L.einsum("btd,dhk->bthk", xn, pm["wq"])
        k = L.einsum("btd,dhk->bthk", xn, pm["wk"])
        v = L.einsum("btd,dhk->bthk", xn, pm["wv"])
        return L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin), v

    # -------------------------------------------------------------- prefill
    def prefill_logits(self, seq: Sequence) -> torch.Tensor:
        """Run the prompt, write its KV, return the last position's
        logits (V,)."""
        cfg, dev = self.cfg, self.device
        toks = torch.tensor([seq.tokens], dtype=torch.long, device=dev)
        x = L.embed_apply(self.params["embed"], toks, cfg)
        t = toks.shape[1]
        cos, sin = L.rope_tables(torch.arange(t, device=dev),
                                 cfg.resolved_head_dim, cfg.rope_theta)
        for li, (p, kind) in enumerate(self.layers):
            pm = p["mixer"]
            q, k, v = self._qkv(pm, x, cos, sin)
            self.mgr.write_kv(seq, li, k[0], v[0], 0)
            b, _, h, hd = q.shape
            g = h // cfg.num_kv_heads
            out = L._sdpa(q.reshape(b, t, cfg.num_kv_heads, g, hd), k, v,
                          causal=True,
                          window=cfg.window_size if kind == "local" else 0)
            x = x + L.einsum("bthk,hkd->btd", out.reshape(b, t, h, hd),
                             pm["wo"])
            if "ffn" in p:
                x = L.mlp_apply(p["ffn"], x, cfg)
        seq.length = t
        return L.logits_apply(self.params["embed"], x[:, -1:], cfg)[0, -1]

    def prefill(self, seq: Sequence) -> int:
        return int(torch.argmax(self.prefill_logits(seq)))

    # --------------------------------------------------------------- decode
    def decode_logits(self, seqs: list[Sequence]) -> torch.Tensor:
        """One token for each sequence: write its KV, return logits (B,V)."""
        cfg, dev = self.cfg, self.device
        b = len(seqs)
        toks = torch.tensor([[s.tokens[-1] if not s.generated
                              else s.generated[-1]] for s in seqs],
                            dtype=torch.long, device=dev)
        lengths = np.asarray([s.length for s in seqs], np.int32)
        for s in seqs:                        # grow page chains (H-type)
            self.mgr.ensure_capacity(s, s.length + 1)
        max_pages = max(len(s.pages) for s in seqs)
        pt = torch.from_numpy(self.mgr.page_table(seqs, max_pages)).to(dev)
        visible = torch.from_numpy(lengths + 1).to(dev)
        slots = self.mgr.slots(seqs, lengths.tolist(), [1] * b)

        x = L.embed_apply(self.params["embed"], toks, cfg)
        cos, sin = L.rope_tables(torch.from_numpy(lengths).to(dev)[:, None],
                                 cfg.resolved_head_dim, cfg.rope_theta)
        for li, (p, _) in enumerate(self.layers):
            pm = p["mixer"]
            q, k, v = self._qkv(pm, x, cos, sin)
            self.mgr.write_slots(li, slots, k[:, 0], v[:, 0])
            out = K.decode_attention(q[:, 0], self.pool.k[li],
                                     self.pool.v[li], pt, visible)
            x = x + L.einsum("bhk,hkd->bd", out, pm["wo"])[:, None]
            if "ffn" in p:
                x = L.mlp_apply(p["ffn"], x, cfg)
        for s in seqs:
            s.length += 1
        return L.logits_apply(self.params["embed"], x, cfg)[:, 0]

    def decode_step(self, seqs: list[Sequence]) -> list[int]:
        return torch.argmax(self.decode_logits(seqs), dim=-1).tolist()


def serve(cfg, *, num_requests=8, prompt_len=12, max_new=16, seed=0,
          page_size=16, num_pages=512, params=None, device=None, log=print):
    """Continuous batching of ``num_requests`` random prompts, at most 4
    running at once.  ``params`` defaults to ``init_params(seed)`` on
    ``device`` (default: the card).  Returns the finished sequences and
    stats, with the host seconds of each prefill and decode step (each
    ends in a host read of its tokens)."""
    dev = resolve_device(device)
    if params is None:
        params = build(cfg, tp=1).init_params(seed, dev)
    pool = PagePool(num_pages=num_pages, page_size=page_size,
                    num_layers=cfg.num_layers,
                    num_kv_heads=cfg.num_kv_heads,
                    head_dim=cfg.resolved_head_dim, device=dev)
    engine = PagedLM(cfg, params, pool)
    rng = np.random.default_rng(seed)

    pending = [list(rng.integers(0, cfg.vocab_size, prompt_len))
               for _ in range(num_requests)]
    running: list[Sequence] = []
    done: list[Sequence] = []
    prefill_s: list[float] = []
    step_s: list[float] = []
    t0 = time.perf_counter()
    max_batch = 4
    while pending or running:
        while pending and len(running) < max_batch:
            sid = len(done) + len(running)
            seq = engine.mgr.add_sequence(sid, pending.pop(0))
            t1 = time.perf_counter()
            seq.generated.append(engine.prefill(seq))
            prefill_s.append(time.perf_counter() - t1)
            running.append(seq)
        t1 = time.perf_counter()
        toks = engine.decode_step(running)
        step_s.append(time.perf_counter() - t1)
        for s, t in zip(list(running), toks):
            s.generated.append(t)
            if len(s.generated) >= max_new:
                s.done = True
                running.remove(s)
                engine.mgr.release(s)
                done.append(s)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(s.generated) for s in done)
    log(f"served {len(done)} requests, {total_tokens} tokens in {dt:.2f}s "
        f"({total_tokens/dt:.1f} tok/s), page pool peak alloc "
        f"{pool.alloc_count} pages, util {engine.mgr.utilization():.2%}")
    return done, {"tokens": total_tokens, "seconds": dt,
                  "decode_steps": len(step_s),
                  "pages_alloc": pool.alloc_count,
                  "prefill_s": prefill_s, "step_s": step_s}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--full", action="store_true",
                    help="full config (default: smoke-scale)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    cfg = (ARCHS if args.full else SMOKES)[args.arch]
    serve(cfg, num_requests=args.requests, max_new=args.max_new,
          device=args.device)


if __name__ == "__main__":
    main()
