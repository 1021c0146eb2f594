"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

The package keeps ``repro``'s module layout and names, so each module's
counterpart sits at the same relative path.  It imports ``torch`` and
NumPy, never ``jax`` and never a ``repro`` module: what it needs of the
NumPy-only reference modules (store, rpc, concurrency, registry) it keeps
as its own copies.  The four Pallas kernels on the GNN serving path
(agg_combine, spmm, gemm, sddmm) are CUDA C++ for ``sm_90a`` under
``kernels/csrc``; every entry point runs on the card unless the caller
asks for the CPU.

The reference computes in fp32 with fp32 accumulation and holds its
kernels to 1e-5, so TF32 is switched off for matmuls and convolutions.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
