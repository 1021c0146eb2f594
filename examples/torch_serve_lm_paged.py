"""LM serving over a paged KV cache on the PyTorch/CUDA port: the paper's
storage technique generalized (GraphStore VID->LPN = sequence->page
chains) with continuous batching, through ``repro_torch.launch.serve``.
On the card every layer's norms run the rmsnorm kernel, each prefill the
flash_attention kernel and each decode step the decode_attention kernel
over the page pool.  The counterpart of ``examples/serve_lm_paged.py``
(whose ``--pallas`` has no counterpart: the port's kernels are the card's
route).  Smoke-scale by default; ``--full`` serves the published widths.

  PYTHONPATH=src python examples/torch_serve_lm_paged.py --requests 8
  PYTHONPATH=src python examples/torch_serve_lm_paged.py --device cpu
"""
from repro_torch.launch.serve import main as serve_main


def main(argv=None) -> dict:
    done, stats = serve_main(argv)
    return {"requests": len(done), "tokens": stats["tokens"],
            "seconds": stats["seconds"],
            "tokens_per_s": stats["tokens"] / stats["seconds"],
            "decode_steps": stats["decode_steps"],
            "pages_alloc": stats["pages_alloc"],
            "generated": {s.sid: list(s.generated) for s in done}}


if __name__ == "__main__":
    main()
