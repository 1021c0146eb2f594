#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

(``--only 9,16`` runs phase 1 and the phases named, to check a few
phases; the smoke run takes no arguments.)  It imports nothing of JAX and
nothing of the JAX package ``repro``.  Each phase prints its seconds;
the last lines sum them.  Every ``kernels`` row is timed with CUDA
events behind a spin kernel (``event_ms``); torch.profiler gives only
the card's busy shares, each window held to the wrappers' launch
counters.  Phases, each uncaught, so any failure exits non-zero:

1. the card's name and power limit (``nvidia-smi``); build the CUDA
   kernels from ``src/repro_torch/kernels/csrc`` and print the seconds;
2. the quickstart flow over RPC, through ``examples/torch_quickstart.py``:
   ``update_graph``, ``program_config(..., "hetero")``, a 2-layer GCN
   ``run`` that must go through AggCombine on the vector device and
   launch the agg_combine kernel;
3. the main path at full width: the "physics" graph (12,000 vertices,
   90,000 zipf(1.35) edges, 420 features), GCN/GIN/NGCF at [420, 128, 64]
   with fanouts [10, 10], one ``run_batch`` of 32 requests x 16 targets
   each under Hetero, with every launch count zeroed just before and read
   just after; then group time, Hetero against an Octa (Shell-only)
   service at 2e-5, and fused against serial ``run`` bit for bit;
4. every GNN kernel against its plain version on the arguments the main
   path gave it (recorded in phase 3), with kernel, plain and library
   times on the card (kernel and library cold, each pass on copies of
   the inputs past the L2, and warm; the plain version warm; the plain
   version and the library call as CUDA graph replays; the kernel's
   back-to-back call time, host included) and the
   least time the card could take (``bound_ms``), which no row may read
   under, spmm and
   sddmm held bit for bit; then gemm, spmm, agg_combine and sddmm by
   shape: kernel ms a launch cold and warm beside ``torch.matmul``
   (gemm), ``embedding_bag`` (spmm) or the port's unfused spmm then gemm
   kernels (agg_combine), and the share of the bound reached;
5. the SPMD engine: phase 3's group under Hetero on a service built with
   ``mesh=make_host_mesh(shape=(d, m), devices=["cuda:0"] * (d * m))``
   for each (d, m) of MESH_SHAPES, every slot on the one card.  Per mesh
   and model: ``run_batch`` against phase 3's within 2e-5, bit for bit at
   (1, 1); at SERIAL_MESH, against the meshed serial ``run`` of each
   request bit for bit; launch counts (zeroed just before, read just
   after) equal to phase 3's times d*m (sddmm 0 where d > 1: the data-
   striped SDDMM is the reference's plain step); the engine's mesh in
   ``stats``; group ms best and median of 5, engine ms and the card's
   busy share.  Then every slot's kernel call replayed against its plain
   version (spmm and sddmm bit for bit), with device ms by slice shape
   against the bound;
6. the same group through the CSSD array and its serving runtime
   (``examples/serve_gnn.py --chaos``): a 4-shard, 2-way replicated
   array (``cache_pages=4096``) loaded by a chunked ``update_graph``
   through a runtime client, each model deployed with ``put_weights``;
   each model's group run directly on the array (bit for bit with phase
   3, its launches and its time); then every model's 32 requests by
   ``weights_ref`` from 8 client threads into the threaded
   ``ServingRuntime`` (groups of at most 16), launch counts zeroed just
   before and read just after and equal to the direct run's a group;
   every reply must be a result equal to phase 3's bit for bit.  Then
   chaos: a ``ShardSupervisor`` watches the array while one shard's
   device is killed with requests in flight (every reply still bit for
   bit); it must drain and rebuild the shard (the drain's delay after
   the kill, ``detect_s`` and ``restore_s`` printed), and a round at
   full redundancy follows; the ``stats`` RPC
   must carry the shards, failed shards, flow, QoS and engine blocks.
   Last, the same groups over remote shards behind RoP links
   (``make_rop_endpoints``), bit for bit;
7. the LM path at full width: ``serve`` of llama3.2-3b (28 layers,
   d_model 3072, 24 query heads over 8 KV heads, vocab 128,256; random
   weights from seed 0) on a 512-page pool of 16-slot pages, 8 requests
   of 500-token prompts and 32 new tokens, 4 at a time, with the launch
   counts zeroed just before and read just after; prefill and decode
   rates; rmsnorm, flash_attention and decode_attention against their
   plain versions on the arguments the run gave them, and
   flash_attention's share of its bound beside SDPA; decode_attention
   timed cold (each launch on another layer's pools, as in a decode
   step) beside its warm time; rmsnorm by shape beside ``F.rms_norm``;
   then the same
   engine with the three wrappers swapped for their plain versions:
   last-position logits of one prefill and one decode step within 1e-3,
   and the share of generated tokens that agree;
8. the dense-cache LM path (``ModelAPI.prefill`` / ``decode``) at
   gemma3-12b's published widths (d_model 3840, 16 query heads over 8
   KV heads of 256, d_ff 15,360, vocab 262,144, window 1024; bf16
   activations and caches, fp32 parameters from seed 0), depth cut from
   48 layers to one period (5 local + 1 global): a 1,536-token prompt at
   batch 4 into caches of 2,048 (past the window, so the local layers'
   rings take the roll), then 32 decode steps, launch counts zeroed
   just before and read just after; prefill and decode rates and the
   card's busy share; the cached logits against the model's own full
   forward (teacher-forced over all 1,568 tokens) and against the same
   run on the plain versions, within 2e-2; rmsnorm, flash_attention
   (windowed and causal, bf16) and decode_attention (bf16, over the
   dense cache viewed as pages) against their plain versions on the
   run's arguments, with device ms against the bound and SDPA (band or
   length mask) or ``F.rms_norm``, each timed cold (each call on copies
   of its inputs that together pass eight times the L2; no row may read
   faster than its bound).  Then minicpm3-4b (MLA), phi3.5-moe
   (16 experts, top 2), internvl2-76b (1,024 patches) and
   seamless-m4t-large-v2 at their published widths, 2 layers each: one
   prefill of 2 x 256 tokens and 8 steps, their launches and their
   logits against the plain versions' (phi3.5-moe's bf16 logits held at
   the positions where both runs routed every token alike, at that
   position and before it in the sequence: each MoE call's top-k experts
   and capacity drops recorded by wrapping ``layers._moe_dispatch``; at
   least half the positions must be so gated);
9. the recurrent mixers and training: jamba-v0.1-52b at its published
   widths (d_model 4096, Mamba with d_state 16, 32/8 heads x 128, 16
   experts top 2 of d_ff 14,336, vocab 65,536), depth cut from 32 layers
   to the first 4 of its period (mamba, mamba + MoE, mamba, attn + MoE;
   ~27 GB of fp32 parameters from seed 0), bf16 activations, batch 2 x a
   256-token prompt into caches of 512 and 8 decode steps; then
   xlstm-125m whole (12 layers, d_model 768, 4 heads, mLSTM head dim
   384, vocab 50,304), batch 4 x 128 and 8 steps.  For each: launch
   counts zeroed just before and read just after (jamba: rmsnorm,
   flash_attention and decode_attention > 0); the cached logits against
   the model's own full forward, in bf16 within 2e-2 of the logits'
   scale plus the same comparison's reading on the plain versions on the
   card (the witness of the card's shape-dependent rounding), for xlstm
   also on the CPU within 2e-2 of the scale alone, and in fp32 element
   by element within 1e-3; against the same run on the plain versions
   (2e-2 of the scale in bf16, 1e-3 in fp32), jamba's bf16 comparisons
   also at the positions whose routes agree, within 2e-2 of the scale
   alone, as phi3.5-moe's; each kernel call against its plain version,
   timed cold.  Then training xlstm-125m through
   ``examples/torch_train_lm.py`` at the launcher's default shape (batch
   8, seq 128, remat "full"): 4 steps; a run that fails at step 3 and
   its resume from the step-2 checkpoint, whose losses must equal the
   uninterrupted run's within rtol 1e-5; step ms, tokens/s, a step's
   forward / backward / optimizer split (the trainer's profiler ranges)
   and the card's busy share; a tiny overfit (15 steps on one batch of
   8 x 32 at lr 3e-3, the loss must fall by more than 0.5).  Last,
   llama3.2-3b at its widths, 2 layers, batch 4 x seq 512, 3 steps of
   the Trainer (every leaf a gradient, or the step raises), with the
   rmsnorm and flash_attention Functions' gradients on the run's
   arguments held to autograd through the plain versions (1e-4 of each
   gradient's max in fp32, 2e-2 in bf16);
10. training on a mesh: the same llama3.2-3b cut (2 layers, batch 4 x
   seq 512) in fp32, 3 steps of the unmeshed Trainer, then of
   ``Trainer(mesh=...)`` on (data, model) meshes of slots on the one
   card, (1, 1) and (1, 2), and (2, 1) and (2, 2) with ZeRO-1.  (1, 2)
   and (2, 2) split the compute over the model axis as the reference's
   GSPMD step does (each model slot its own 12 query heads, 4 KV heads,
   MLP columns and vocabulary block, the partials summed on the data
   row's first slot); (1, 1) and (2, 1) run each data row on the whole
   parameters.  Launch counts are zeroed just before each run and read
   just after (rmsnorm and flash_attention > 0): (1, 1) equal to the
   unmeshed run bit for bit in loss, grad_norm and every parameter and
   moment, the others each leaf within 1e-4 of its largest element and
   the losses within rtol 1e-5; every slot's blocks the shapes
   ``param_pspecs`` and ``opt_pspecs`` dictate; each run's
   ``max_memory_allocated`` beside the parent commit's on the same
   meshes (``tools/torch_mesh_train_peak.py``); the (2, 2) run's
   Function calls, at a slot's heads, against their plain versions
   (forward and gradients) and timed cold; step ms and tokens/s per
   mesh.  The flash_attention Function also at a slot's heads of the
   production model degree (16) for the four architectures that split
   (down to one query head of one KV head at D 256, gemma3-12b),
   against the plain version.  Then a checkpoint at step 2 on (2, 2),
   restored on (1, 1) and on (2, 1), whose step 3 loss must equal the
   uninterrupted run's within rtol 1e-5;
11. the dry run (``launch/dryrun.py``): every ``ARCHS x shapes_for``
   cell (34) on both production meshes of ``meta`` slots, (16, 16) and
   (2, 16, 16), in processes of their own (four that take the cells in
   turn, and one for the witness below; niced, CPU only) started
   after phase 8 (none runs beside phases 3-8, whose times seed the
   benchmark's cells: the script asserts it) and joined after phase 14,
   the wait printed; bytes a slot counted at the production shapes, slot (0, 0)'s
   program traced through the card's routes and kernel checks at one
   data shard's batch, at the production shapes apart from jamba's and
   xlstm's train and prefill cells, traced at ``--dev``'s shape (their
   Python loops over time take tens of minutes a cell at production
   lengths; their peaks are lower bounds).  A line a cell: GB a slot of
   arguments, outputs and aliases, the traced peak and temp bytes, the
   record's ``fits`` and ``arguments_fit``, the peak judged against the
   card's own ``total_memory`` (unknown where a lower bound fits),
   flops, dot flops, bytes accessed, the LM kernels' calls, the train
   and split serving cells' transfers between slots, whether the step
   splits over the model axis (``model_split``), and ``trace_s``.  Any failed cell fails the
   run; the dry-run processes never initialise CUDA, allocate nothing and
   launch nothing, and this process's allocated card memory is unchanged
   across the phase's wait.  Every cell splits (each slot runs its own
   heads, MLP columns or experts, Mamba channels or rows of mLSTM's C,
   vocabulary block or d_model columns and, serving, its own block of
   every cache; seamless's its heads of the encoder's, the decoder's
   self- and cross-attention); a line each gives its peak beside the
   one the gathered step traced, which it must be under; llama3.2-3b's,
   minicpm3-4b's and seamless's train_4k, internvl2-76b's prefill_32k and
   decode_32k, gemma3-27b's long_500k, the two MoE families' prefill_32k
   and decode_32k, minicpm3-4b's decode_32k and (on (2, 16, 16)) its
   prefill_32k, jamba's and xlstm's decode_32k and long_500k, and
   seamless's prefill_32k and decode_32k must fit.  Then the card witness:
   each of WITNESSES
   (phase 10's llama3.2-3b training, phase 9's xlstm-125m training, phase
   8's gemma3-12b prefill), traced on ``meta`` at a (1, 1) mesh, then one
   real step on the card after ``reset_peak_memory_stats`` with only its
   arguments allocated: the predicted ``peak_bytes`` within 10 % of
   ``max_memory_allocated``.  Then the layout witness: phase 10's
   llama3.2-3b cut on a (2, 2) mesh of slots on the card, ZeRO-1 off:
   ``lower_cell``'s bytes a slot of parameters and moments equal the
   blocks ``Trainer(mesh=...)`` holds;
12. serving on the model axis (``launch/serve.py::MeshServe``): phase
   8's gemma3-12b cut (6 layers, bf16, 4 x (1,536 + 32) into caches of
   2,048) on meshes of slots on the one card: (1, 2), heads and caches
   split by KV heads; (1, 16), one query head a slot, the 8 KV heads
   replicated, the global cache (128 positions a slot) and the rings
   (64) split by positions and merged 16 ways; (2, 2) in long mode at
   batch 1 (1 x (1,536 + 8)), the global cache's positions over the two
   data rows.  For each: launch counts zeroed just before and read just
   after (rmsnorm, flash_attention and decode_attention > 0, its partial
   entry where the cache splits by positions), the prefill's and every
   step's logits against phase 8's unmeshed run on the same parameters
   and against the same split run on the plain versions, within 2e-2 of
   the logits' scale; every slot's cache block the shape its spec gives
   and within 2e-2 of the scale of the unmeshed caches' rows; each
   kernel call against its plain version (a partial block at length 0
   among them); prefill ms, decode-step ms and ``max_memory_allocated``
   (the slots share one card: overhead, not scaling).  The (1, 16)
   run's flash calls (one head a slot, D 256) and partial calls are
   timed cold against their bounds, each partial row beside its device
   kernels a call (one where the call's splits fit a cluster);
13. MoE experts on the model axis: phi3.5-moe at its published widths
   (16 experts top 2, d_ff 6,400), 2 layers, through ``MeshServe`` on
   (1, 2) (8 experts and 4 KV heads a slot, caches by KV heads) and
   (1, 16) (one expert and 2 query heads a slot, caches by positions),
   and llama4-scout (16 experts top 1 and a shared expert of 8,192, 40
   heads padded to 48), 1 layer, on (1, 16): bf16, 8 x a 32-token prompt
   into caches of 48, 8 steps (a longer prompt leaves the route gate
   too few positions: ``tools/torch_moe_axis_prompts.py``).  For each:
   every slot's expert blocks E/16 or E/2 experts; launch counts zeroed
   just before and read just after (rmsnorm, flash_attention and
   decode_attention or its partial entry > 0); the logits against the
   unmeshed run (phase 8's path) at the positions where both the
   kernels' and the plain versions' pairs routed alike, within 2e-2 of
   the scale plus the plain versions' pair's reading there, in fp32
   within 1e-3 where the routes agree, and against the same split run
   on the plain versions; each kernel call against its plain version;
   prefill and decode ms, ``max_memory_allocated``; the (1, 16) runs'
   kernel calls timed cold (``"path": "mesh_serve_moe"`` rows).  Then
   phi3.5-moe 1 layer in fp32, 4 x 512, at a capacity that drops no
   token: 3 steps of the unmeshed Trainer and of the split step at
   (1, 2) and (2, 2) with ZeRO-1: the losses within rtol 1e-5 of the
   unmeshed run's, the grad norms and every parameter and moment within
   1e-4 of each leaf's max of a run on the same data shards (the
   unmeshed one, or the gathered (2, 1) one: the aux loss is each
   shard's); launches, step ms, ``max_memory_allocated``;
14. MLA on the model axis: phase 8's minicpm3-4b cut (published widths,
   2 layers, bf16, 2 x a 256-token prompt into caches of 512, 8 steps)
   through ``MeshServe`` on (1, 2) (20 of its 40 heads a slot, the
   compressed caches' 512 positions 256 a slot, the logits by
   vocabulary rows) and (1, 16) (40 heads padded to 48, 3 a slot, 32
   positions a slot; 73,448 does not divide 16, so the embedding and
   the logits split along d_model and every slot holds the whole
   logits), the parameters and the unmeshed run at each mesh's padding.
   For each: every slot's ``wuq``/``wukv``/``wo`` blocks its heads;
   launch counts zeroed just before and read just after (rmsnorm > 0;
   MLA's attention is plain torch, as the reference's); every slot's
   logits block and cache block the shapes their specs give; the logits
   against the unmeshed run (phase 8's path) within 2e-2 of the scale
   plus the same comparison's reading on the plain versions, in fp32
   within 1e-3, and against the same split run on the plain versions;
   each rmsnorm call against its plain version; prefill and decode ms,
   ``max_memory_allocated``; (1, 16)'s rmsnorm calls timed cold
   (``"path": "mesh_serve_mla"`` rows), in the phase beside the dry
   run's processes (``ms_beside_dryrun``) and again after phase 11's
   join (``ms``).  Then the cut in fp32, 4 x 512:
   3 steps of the unmeshed Trainer at each padding and of the split step
   at (1, 2), (2, 2) with ZeRO-1 and (1, 16) (the row-parallel loss),
   the losses and grad norms within rtol 1e-5 and every parameter and
   moment within 1e-4 of each leaf's max; launches, step ms,
   ``max_memory_allocated``;
15. the recurrent mixers on the model axis, after phase 11's join (the
   host quiet): phase 9's jamba cut (published widths, 4 layers: three
   Mamba layers and the GQA one, two MoE FFNs; fp32 parameters, bf16
   activations) through ``MeshServe`` at (1, 2) (4,096 of its 8,192
   inner channels, 8 experts and 4 KV heads a slot) and (1, 16) (512
   channels, one expert, 2 query heads a slot, the caches by
   positions), and xlstm-125m whole at (1, 2) (two mLSTM heads a slot),
   (1, 16) (96 rows of one head's C a slot) and in long mode at (2, 2),
   batch 1: 8 x a 32-token prompt into caches of 64, 4 steps.  For
   each: every slot's parameter and cache blocks the shapes their specs
   give; launch counts zeroed just before and read just after (rmsnorm
   > 0; jamba's flash_attention and decode_attention, or its partial
   entry at (1, 16), too); the logits against the unmeshed run (phase
   8's path) within 2e-2 of the scale plus the plain versions' reading
   of the same comparison (jamba's at the positions where both pairs'
   MoE routes agree, as phases 9 and 13 gate them, at least an eighth
   of them: ``RA_ROUTED_LEAST``) and against the same split run on the
   plain versions; jamba in fp32 within 1e-4 where the routes agree
   (all of them); each kernel call against its plain version; prefill
   and decode ms, ``max_memory_allocated``; jamba's (1, 16) kernel
   calls timed cold (``"path": "mesh_serve_recurrent"`` rows).  Then ``Trainer(mesh=...)`` in fp32, 4 x 64, 3 steps:
   xlstm-125m's first period (6 of 12 layers) at (1, 2) and at (2, 2)
   with ZeRO-1, and jamba cut to its first layer (Mamba and its gated
   MLP, full width) at (1, 2), each against the unmeshed Trainer:
   losses and grad norms within rtol 1e-5, every parameter and moment
   within 1e-4 of each leaf's max (xlstm's 1e-4 and 1e-3, as phase 9
   holds its fp32 runs: ``RA_TRAIN_TOL``; the parameters of leaves
   initialised to zeros printed ungated, their moments gated),
   every slot's blocks the shapes their specs give; launches, step ms,
   ``max_memory_allocated``; the phase's seconds;
16. the encoder-decoder on the model axis, after phase 15: phase 8's
   seamless-m4t-large-v2 cut (published widths: d_model 1,024, 16 heads
   and 16 KV heads of 64, d_ff 8,192, relu, vocabulary 256,206, an
   untied head; 2 encoder and 2 decoder layers; fp32 parameters, bf16
   activations) through ``MeshServe`` at (1, 2) (8 heads and 8 KV heads
   a slot of the encoder's, the decoder's self- and cross-attention, the
   vocabulary by rows) and (1, 16) (one head and one KV head a slot; the
   embedding and the head along d_model, 64 columns a slot, every slot
   holding the whole logits): phase 8's 2 x a 256-token prompt and 256
   frames into caches of 512, 8 steps, the encoder's output sent to each
   model slot once by the prefill and read from each slot's own copy at
   every step.  For each: every slot's parameter and cache blocks the
   shapes their specs give (the attention weights a slot's heads);
   launch counts zeroed just before and read just after (rmsnorm,
   flash_attention and decode_attention > 0); the logits against the
   unmeshed run (phase 8's path) within 2e-2 of the scale plus the plain
   versions' reading of the same comparison, in fp32 within 1e-3, and
   against the same split run on the plain versions; each kernel call
   against its plain version; prefill and decode ms,
   ``max_memory_allocated``; the (1, 16) run's kernel calls timed cold
   (``"path": "mesh_serve_encdec"`` rows).  Then ``Trainer(mesh=...)``
   in fp32, 4 x 512 (256 frames and 256 tokens), 3 steps at (1, 2),
   (2, 2) with ZeRO-1 and (1, 16) (the row-parallel loss), each against
   the unmeshed Trainer, in the published relu and with gelu in its
   place: losses and grad norms within rtol 1e-5; with gelu every
   parameter and moment within 1e-4 of each leaf's max; with relu, whose
   derivative jumps where the card's shape-dependent fp32 rounding moves
   a pre-activation across 0, each part's largest leaf error printed
   beside the unmeshed run's own at grad_accum 2 (``ED_TRAIN_ACTS``);
   every slot's blocks the shapes their specs give; launches, step ms,
   ``max_memory_allocated``; the phase's seconds;
17. the port's examples on the card: ``examples/torch_serve_gnn.py`` at
   4 clients x 4 requests under each drill of EXAMPLE_DRILLS (gcn and
   gin with a live grow-by-one reshard and a shard killed mid-migration,
   ngcf through the mutation firehose, gcn over remote shards with the
   autonomic chaos drill), each under the lock witness, with its model's
   kernels launched, its drills' asserts (bit for bit against a serial
   replay or a reference answer) holding and no request failed, the four
   GNN kernels launched over the four; ``examples/torch_mutable_graph.py
   --days 3``; ``examples/torch_serve_lm_paged.py`` at smoke size, the
   three LM kernels launched.  Each run's seconds and requests/s;
18. training over processes (the multi-host entry, ``launch/procs.py``),
   after phase 17 with this process's allocator emptied: phase 10's cut
   trained 3 steps by two processes on the one card, each a gloo rank
   whose slots' work runs only there: at (2, 2), each process one data
   row of two model slots, split with ZeRO-1 (spawned processes that
   build ``Trainer(mesh=...)`` on ``make_host_mesh`` of the group), and
   at (2, 1) through ``python -m repro_torch.launch.train --mesh
   --zero1`` under torchrun's environment (RANK, WORLD_SIZE,
   LOCAL_RANK, MASTER_ADDR, MASTER_PORT), gathered.  Each process's
   loss, xent, grad_norm and lr at every step and the sha256 of every
   block of its slots' parameters and moments equal phase 10's
   single-process run on the same mesh; the launcher's checkpoint,
   written once by slot 0's process, equals that run's leaves byte for
   byte; rmsnorm and flash_attention launched in each process; a rank's
   non-zero exit, or the deadline, fails the phase.  Each process's
   step ms (median after the first) beside phase 10's on the same mesh,
   with the card's name and power limit; the phase's seconds;
19. a ``kernels`` JSON line for all seven kernels (and the SPMD rows,
   keyed by ``mesh``, and the dense, recurrent, train, mesh_train,
   mesh serve, mesh_serve_moe, mesh_serve_mla, mesh_serve_recurrent and
   mesh_serve_encdec paths', keyed by ``path``; decode_attention's
   partial entry a row of its own), then ``{"ok": true, "device": ...}``
   last.

Without CUDA, or without the repository beside it, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import re
import subprocess
import sys
import threading
import time
from dataclasses import replace

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# the repo's "physics" workload (benchmarks/common.py), regenerated inline
N_VERTICES, N_EDGES, FEAT, ZIPF_A = 12_000, 90_000, 420, 1.35
DIMS = [FEAT, 128, 64]                # benchmarks/fig16_pure_inference.py
FANOUTS = [10, 10]
GROUP, TARGETS = 32, 16
MODELS = ("gcn", "gin", "ngcf")
GROUP_REPEATS = 5
DEVICE = "cuda"
GNN_KERNELS = ("agg_combine", "spmm", "gemm", "sddmm")
# the CSSD array behind the serving runtime (examples/serve_gnn.py --chaos)
ARRAY_SHARDS, ARRAY_REPLICATION, ARRAY_CLIENTS = 4, 2, 8
# the port's examples on the card (phase 17): examples/torch_serve_gnn.py
# under each drill (the README's live reshard with a kill mid-migration,
# gcn and gin; the firehose with ngcf; the autonomic chaos drill over
# remote shards), each at 4 clients x 4 requests; then
# examples/torch_mutable_graph.py and examples/torch_serve_lm_paged.py
EXAMPLE_DRILLS = (
    ("gcn reshard-grow 1, kill-shard 1",
     ["--model", "gcn", "--shards", "3", "--replication", "2",
      "--reshard-grow", "1", "--kill-shard", "1"]),
    ("gin reshard-grow 1, kill-shard 1",
     ["--model", "gin", "--shards", "3", "--replication", "2",
      "--reshard-grow", "1", "--kill-shard", "1"]),
    ("ngcf firehose", ["--model", "ngcf", "--shards", "2", "--firehose"]),
    ("gcn remote-shards 3, chaos",
     ["--model", "gcn", "--remote-shards", "3", "--replication", "2",
      "--chaos"]))
EXAMPLE_LOAD, EXAMPLE_REQUESTS = ["--requests", "4", "--clients", "4"], 16
EXAMPLE_KERNELS = {"gcn": ("agg_combine",), "gin": ("spmm", "gemm"),
                   "ngcf": ("spmm", "gemm", "sddmm")}
EXAMPLE_DAYS = 3
# the SPMD engine: (data, model) meshes of slots on the one card, and the
# mesh whose run_batch is held to its serial run bit for bit
MESH_SHAPES = ((1, 1), (1, 2), (2, 2), (1, 4), (2, 4))
SERIAL_MESH = (2, 4)
MESH_SLOT = "cuda:0"                  # the device of every slot

# the LM path: repro/launch/serve.py's engine at llama3.2-3b's full width
LM_ARCH = "llama3.2-3b"
LM_REQUESTS, LM_PROMPT, LM_NEW = 8, 500, 32
LM_PAGE_SIZE, LM_PAGES = 16, 512
LM_KERNELS = ("rmsnorm", "flash_attention", "decode_attention")
# the profiler's kernel names each LM kernel's time is summed under
LM_KERNEL_SYMBOLS = {"rmsnorm": ("rmsnorm_kernel",),
                     "flash_attention": ("flash_kernel",
                                         "flash_wgmma_kernel"),
                     "decode_attention": ("decode_split_kernel",
                                          "decode_combine_kernel",
                                          "decode_cluster_kernel")}
DECODE_COLD_ROUNDS = 3                # rounds over the 28 layers' pools
L2_BYTES = 50 * 2**20                 # the H100's L2
# cold replays (the dense, recurrent and train paths' rows): a call made
# in turn on copies of its tensor arguments that together pass eight L2s
COLD_BYTES, COLD_MAX_COPIES, COLD_LAUNCHES = 8 * L2_BYTES, 512, 40
SPIN_CYCLES_PER_US = 2000              # the H100's 1.98 GHz top clock, rounded up
EVENT_CHUNK = 16                      # timed calls behind one spin
PROFILE_TRIES = 3                     # profiler windows before giving up
LM_LOGITS_TOL = 1e-3

# the dense-cache LM path (ModelAPI.prefill / decode): gemma3-12b at its
# published widths, depth cut from 48 layers to one period (5 local + 1
# global); a 1,536-token prompt (past the 1,024 window) into caches of
# 2,048, then 32 steps (the rings wrap again)
DENSE_ARCH, DENSE_LAYERS = "gemma3-12b", 6
DENSE_BATCH, DENSE_PROMPT, DENSE_SEQ, DENSE_STEPS = 4, 1536, 2048, 32
# the other attention families at their published widths, 2 layers each
# (seamless: 2 encoder and 2 decoder layers): one prefill and 8 steps
DENSE_FAMILIES = ("minicpm3-4b", "phi3.5-moe-42b-a6.6b", "internvl2-76b",
                  "seamless-m4t-large-v2")
FAMILY_LAYERS, FAMILY_BATCH, FAMILY_PROMPT, FAMILY_STEPS = 2, 2, 256, 8
FAMILY_SEQ = 512                      # cache seq beyond the prompt and patches
DENSE_FP32_STEPS = 8                  # the same path in fp32: decode steps
# end-to-end logits (the cached path against the full forward, kernels
# against plain versions): fp32 element by element, at the LM phase's
# kernels-vs-plain tolerance; bf16 against the logits' scale, max |a - b|
# <= 2e-2 * max |b|, since the two round products to bf16 at different
# points and 34 M logits reach far into the tail of that rounding (run
# 19a: 0.072 at logits up to 12.2, argmax agreement 100 %; fp32 on the
# same path 3.0e-5).  Each kernel call is held to 2e-2 element by element.
DENSE_FP32_TOL = 1e-3

# the recurrent mixers and training (phase 9): jamba-v0.1-52b at its
# published widths, depth cut from 32 layers to the first 4 of its period
# (mamba, mamba + MoE, mamba, attn + MoE; ~27 GB of fp32 parameters, the
# two 16-expert FFNs 22.5 GB of it); xlstm-125m whole
JAMBA_ARCH, JAMBA_LAYERS = "jamba-v0.1-52b", 4
JAMBA_BATCH, JAMBA_PROMPT, JAMBA_SEQ, JAMBA_STEPS = 2, 256, 512, 8
XLSTM_ARCH = "xlstm-125m"
XLSTM_BATCH, XLSTM_PROMPT, XLSTM_SEQ, XLSTM_STEPS = 4, 128, 256, 8
# training xlstm-125m through examples/torch_train_lm.py at the example's
# batch of 4 and half its sequence (remat "full"; at seq 256 a step took
# 14-19 s and its profiled windows 6 minutes of the budget): 4 steps,
# then the launcher on the example's arguments with a checkpoint every 2
# steps, a run that fails at step 3 and its resume from the step-2
# checkpoint (losses within the reference's rtol 1e-5,
# tests/test_train_infra.py), then the tiny overfit of
# tests/test_models.py (8 steps) on one batch of 8 x 32 tokens
TRAIN_SEQ = 128
TRAIN_STEPS, TRAIN_FAULT_AT, TRAIN_CKPT_EVERY, RESUME_RTOL = 4, 3, 2, 1e-5
OVERFIT_STEPS, OVERFIT_LR, OVERFIT_DROP = 8, 3e-3, 0.5
OVERFIT_BATCH, OVERFIT_SEQ = 8, 32
# an attention family's training: llama3.2-3b at its widths, 2 layers
ATTN_TRAIN_ARCH, ATTN_TRAIN_LAYERS = "llama3.2-3b", 2
ATTN_TRAIN_BATCH, ATTN_TRAIN_SEQ, ATTN_TRAIN_STEPS = 4, 512, 3
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # of each gradient's max
TRAIN_KERNELS = ("rmsnorm", "flash_attention")
# training on a mesh (phase 10): the same llama3.2-3b cut in fp32, on
# (data, model) meshes of slots on the one card, ZeRO-1 where data > 1;
# (1, 1) equals the unmeshed Trainer bit for bit, the others each leaf
# within 1e-4 of its largest element (the fp32 gradient tolerance) and
# the losses within rtol 1e-5; a checkpoint at step 2 of SAVE_MESH
# resumes on each of RESUME_MESHES
# resumes on each of RESUME_MESHES; (1, 2) and (2, 2) split the compute
# over the model axis (models/api.py::model_split), (1, 1) and (2, 1)
# run it gathered
MESH_TRAIN_SHAPES = ((1, 1), (1, 2), (2, 1), (2, 2))
MESH_TRAIN_TOL, MESH_SAVE_AT = 1e-4, 2
SAVE_MESH, RESUME_MESHES = (2, 2), ((1, 1), (2, 1))
# each run's max_memory_allocated above what was allocated before it, in
# bytes, for the parent commit's port (every mesh gathered), measured on
# the NVIDIA H100 80GB HBM3 at 700.00 W by tools/torch_mesh_train_peak.py
# (two runs, equal to the byte)
PARENT_MESH_PEAK = {"1x1": 19_092_874_240, "1x2": 17_849_448_448,
                    "2x1": 19_060_478_464, "2x2": 21_441_979_392}
# the attention of a split step's slot at the production model degree
# (16): (query heads, KV heads, head dim, window) of llama3.2-3b,
# gemma3-12b's local and global layers, gemma3-27b and internvl2-76b,
# held to the plain version, forward and gradients, at batch 2 x 1,536
SPLIT_FLASH = ((2, 1, 128, 0), (1, 1, 256, 1024), (1, 1, 256, 0),
               (2, 1, 128, 1024), (4, 1, 128, 0))
SPLIT_FLASH_BATCH, SPLIT_FLASH_SEQ = 2, 1536
# training over processes (phase 18): phase 10's cut in PROC_WORLD
# processes on the one card, each run held to phase 10's single-process
# run on the same mesh bit for bit in PROC_METRICS and every block
PROC_WORLD, PROC_TIMEOUT_S = 2, 300
PROC_TRAIN_MESHES = {"2x2": (2, 2), "2x1": (2, 1)}
PROC_METRICS = ("loss", "xent", "grad_norm", "lr")

# serving on the model axis (phase 12): phase 8's gemma3-12b cut in bf16
# through launch/serve.py::MeshServe on meshes of MESH_SLOT slots, each
# (mesh, long mode): (1, 2) splits heads and caches by KV heads; (1, 16)
# runs one query head a slot with the 8 KV heads replicated, the caches
# split by positions (128 of the global a slot, 64 of each ring) and
# merged 16 ways; (2, 2) in long mode at batch 1, the global cache's
# positions over the two data rows.  Phase 8's prompt and caches, 32
# steps (8 at batch 1); the rows of the kernels line come from (1, 16)
MESH_SERVE = (((1, 2), False), ((1, 16), False), ((2, 2), True))
MESH_SERVE_LONG_STEPS = 8
MESH_SERVE_ROWS = "1x16"

# MoE experts on the model axis (phase 13): phi3.5-moe at its published
# widths cut to 2 layers (phase 8's cut) through MeshServe at (1, 2) (8
# experts and 4 KV heads a slot, caches by KV heads) and (1, 16) (one
# expert and 2 query heads a slot, the 8 KV heads replicated, caches by
# positions); llama4-scout one layer at (1, 16) (one expert and the
# shared expert's columns a slot, 40 heads padded to 48, 3 a slot);
# phase 8's prompt and steps at batch MOE_SERVE_BATCH.  Then phi3.5-moe
# one layer in fp32, MOE_TRAIN_STEPS Trainer steps at each of
# MOE_TRAIN_MESHES (ZeRO-1 where data > 1) at a capacity that drops no
# token (top_k x capacity = experts), so a data shard's capacity routes
# as the unmeshed step's, each held to a run on the same data shards
# (MOE_TRAIN_YARDSTICK: the unmeshed Trainer, or the gathered step on
# (data, 1)): the aux loss is each shard's, averaged, as the reference's
# pmean has it, which moves the losses from the unmeshed ones by more
# than rtol 1e-5 at (2, 2) (8.6e-5 by step 3 on the card) and the router's
# gradient by more than the leaf tolerance.  The kernels line's
# "mesh_serve_moe" rows come from the (1, 16) runs
MOE_SERVE = (("phi3.5-moe-42b-a6.6b", 2, ((1, 2), (1, 16))),
             ("llama4-scout-17b-a16e", 1, ((1, 16),)))
MOE_SERVE_BATCH, MOE_SERVE_PROMPT, MOE_SERVE_STEPS, MOE_SERVE_SEQ = \
    8, 32, 8, 48
MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS = "phi3.5-moe-42b-a6.6b", 1
MOE_TRAIN_MESHES = ((1, 2), (2, 2))
MOE_TRAIN_YARDSTICK = {(1, 2): None, (2, 2): (2, 1)}
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, MOE_TRAIN_STEPS = 4, 512, 3
MOE_ROWS_MESH = "1x16"

# MLA on the model axis (phase 14): phase 8's minicpm3-4b cut (published
# widths, 2 layers, 2 x a 256-token prompt into caches of 512, 8 steps)
# through MeshServe at (1, 2) (20 of its 40 heads a slot, vocabulary
# rows) and (1, 16) (40 heads padded to 48, 3 a slot, 32 cache positions
# a slot, the 73,448-row vocabulary over d_model: row-parallel embedding
# and logits); then the same cut in fp32, MLA_TRAIN_STEPS Trainer steps
# at 4 x 512 on each of MLA_TRAIN_MESHES (ZeRO-1 where data > 1; (1, 16)
# is the row-parallel loss), each against the unmeshed Trainer of the
# same padding.  The kernels line's "mesh_serve_mla" rows come from (1, 16)
MLA_ARCH = "minicpm3-4b"
MLA_SERVE_MESHES = ((1, 2), (1, 16))
MLA_TRAIN_MESHES = ((1, 2), (2, 2), (1, 16))
MLA_TRAIN_BATCH, MLA_TRAIN_SEQ, MLA_TRAIN_STEPS = 4, 512, 3
MLA_ROWS_MESH = "1x16"

# the recurrent mixers on the model axis (phase 15, after the dry run's
# join): phase 9's jamba cut (published widths, 4 layers: three Mamba
# layers, the first and third with their gated MLP, the second with its
# MoE, and the GQA layer with its MoE; fp32 parameters, bf16
# activations), then xlstm-125m whole, through MeshServe on each (mesh,
# long mode): jamba's Mamba by inner channels (4,096 a slot at (1, 2),
# 512 at (1, 16)), xlstm's mLSTM by rows of C (two heads a slot at
# (1, 2), 96 rows of one at (1, 16)); RA_BATCH x a RA_PROMPT-token
# prompt into caches of RA_SEQ, RA_STEPS steps (batch 1 in long mode);
# jamba also in fp32.  Then Trainer(mesh=) in fp32,
# RA_TRAIN_BATCH x RA_TRAIN_SEQ, RA_TRAIN_STEPS steps (ZeRO-1 where data
# > 1) of xlstm-125m's first period (5 mLSTM layers and an sLSTM one) and
# of jamba's first layer (Mamba and its gated MLP, as a period of one
# layer: a cut of its period of eight would stack none) against the
# unmeshed Trainer.  The kernels line's
# "mesh_serve_recurrent" rows come from jamba's RA_ROWS_MESH run
RA_SERVE = (("jamba-v0.1-52b", 4, (((1, 2), False), ((1, 16), False))),
            ("xlstm-125m", None, (((1, 2), False), ((1, 16), False),
                                  ((2, 2), True))))
RA_BATCH, RA_PROMPT, RA_SEQ, RA_STEPS = 8, 32, 64, 4
RA_FP32_TOL = 1e-4
# jamba's bf16 split against the unmeshed run: each slot's Mamba and
# attention partials are rounded to bf16 before their sum (16 of them at
# (1, 16)), which moves near-tied tokens of its MoE to other experts, and
# one such token taints its sequence from there on (through the Mamba
# state).  At 2 x 64 tokens no position was left (0 of 10 in run 29a); at
# 8 x 32, 9 to 20 of 40 (29b).  So that comparison is gated on the
# positions whose routes agree where they are at least RA_ROUTED_LEAST of
# them; fp32 (every route agrees) and the kernels against the plain
# versions (the same split) keep the half
RA_ROUTED_LEAST = 1 / 8
RA_TRAIN = (("xlstm-125m", {"num_layers": 6}, ((1, 2), (2, 2))),
            ("jamba-v0.1-52b", {"num_layers": 1, "period_pattern":
                                ("mamba",)}, ((1, 2),)))
# (rtol of the losses and grad norms, each leaf's tolerance of its
# largest element) against the unmeshed Trainer: RESUME_RTOL and
# MESH_TRAIN_TOL, but xlstm's 1e-4 and DENSE_FP32_TOL, as phase 9 holds
# its fp32 runs: the card's fp32 products round by shape, the split's
# column blocks are other shapes than the whole's, and the exp-gated
# scans carry that (in 29c a down_proj's first moment 1.25e-4 off, in
# 29d the third grad norm 2.9e-5; on the CPU both within 1e-6:
# tests/test_torch_model_axis.py)
RA_TRAIN_TOL = {"xlstm-125m": (1e-4, 1e-3),
                "jamba-v0.1-52b": (RESUME_RTOL, MESH_TRAIN_TOL)}
# the parameters of the leaves the reference initialises to zeros
# (jamba's conv_b and dt_bias) are printed, not gated: after three AdamW
# steps they hold lr-sized values whose elements follow m / sqrt(v) of
# near-cancelling gradient elements, so rounding there moves them by
# per cent of their max (conv_b 1.3e-2 in 29e) while their m and v, held
# like every leaf's, agree within 2e-6
RA_TRAIN_BATCH, RA_TRAIN_SEQ, RA_TRAIN_STEPS = 4, 64, 3
RA_ROWS_MESH = "1x16"
# the encoder-decoder on the model axis (phase 16, after phase 15): phase
# 8's seamless cut (published widths: d_model 1,024, 16 heads and 16 KV
# heads of 64, d_ff 8,192, relu, vocabulary 256,206, untied head; 2
# encoder and 2 decoder layers; fp32 parameters, bf16 activations)
# through MeshServe at (1, 2) (8 heads and 8 KV heads a slot, the
# vocabulary by rows) and (1, 16) (one head and one KV head a slot;
# 256,206 does not divide 16, so the embedding and the head split along
# d_model, 64 columns a slot, and every slot holds the whole logits):
# phase 8's FAMILY_BATCH x FAMILY_PROMPT tokens and as many frames into
# caches of FAMILY_SEQ, ED_STEPS steps; also in fp32.  Then
# Trainer(mesh=) in fp32, ED_TRAIN_BATCH x ED_TRAIN_SEQ (frames and
# tokens ED_TRAIN_SEQ / 2 each, as input_specs halves them),
# ED_TRAIN_STEPS steps, at each of ED_TRAIN_MESHES (ZeRO-1 where data >
# 1; (1, 16) the row-parallel loss) against the unmeshed Trainer.  The
# kernels line's "mesh_serve_encdec" rows come from the ED_ROWS_MESH run
ED_ARCH = "seamless-m4t-large-v2"
ED_SERVE_MESHES = ((1, 2), (1, 16))
ED_STEPS = 8
ED_TRAIN_MESHES = ((1, 2), (2, 2), (1, 16))
ED_TRAIN_BATCH, ED_TRAIN_SEQ, ED_TRAIN_STEPS = 4, 512, 3
# relu's derivative jumps at 0, and the card's fp32 products round by
# shape: a pre-activation within rounding of 0 flips its gradient term
# whenever the products take other shapes, so after 3 AdamW steps a
# split run leaves the unmeshed one by up to 1.3e-2 of a moment's max
# (w_gate's at (1, 16); 1.3e-4 of a parameter's), and so does the
# unmeshed run against itself at grad_accum ED_WITNESS_ACCUM (4.7e-3 /
# 1.3e-4, run 30e), where nothing is split; with gelu the split stays
# within 8.2e-6.  So the published relu cut is gated on its losses and grad
# norms, its leaves printed beside that witness, and the same cut with
# gelu on every leaf (MESH_TRAIN_TOL)
ED_TRAIN_ACTS = ("relu", "gelu")
ED_WITNESS_ACCUM = 2
ED_ROWS_MESH = "1x16"

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM, fp32 FMA and
# bf16 tensor cores (the rate a bound for bf16 operands is held to)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12

# the dry run (phase 11): the families whose train and prefill cells are
# traced at --dev's shape, and the seconds to wait for its processes
DRYRUN_DEV_TRACE = ("jamba-v0.1-52b", "xlstm-125m")
DRYRUN_WAIT_S = 900
# the train_4k cells whose step splits over the model axis, each with
# its peak bytes a slot on (16, 16) and (2, 16, 16) as the gathered step
# traced them (counts from shapes, the same on any host); the split
# peak must be lower, and llama3.2-3b's must fit the card
DRYRUN_SPLIT_PEAK_BEFORE = {"llama3.2-3b": (219.103e9, 125.218e9),
                            "gemma3-12b": (265.715e9, 188.624e9),
                            "gemma3-27b": (505.477e9, 373.759e9),
                            "internvl2-76b": (1068.528e9, 849.484e9),
                            "phi3.5-moe-42b-a6.6b": (566.795e9, 486.883e9),
                            "llama4-scout-17b-a16e": (1252.198e9,
                                                      1226.283e9),
                            "minicpm3-4b": (243.802e9, 140.932e9),
                            "jamba-v0.1-52b": (512.542e9, 512.541e9),
                            "xlstm-125m": (13.792e9, 13.792e9),
                            "seamless-m4t-large-v2": (83.429e9, 48.136e9)}
DRYRUN_SPLIT_FITS = ("llama3.2-3b", "minicpm3-4b", "seamless-m4t-large-v2")
# the serving cells of those families, which split too since serving on
# the model axis (the MoE two since their experts split, jamba and xlstm
# since their recurrent mixers split, seamless since its cross-attention
# split): each one's peak a slot on
# (16, 16) and (2, 16, 16) as the gathered step traced them (run 24c);
# the split peak must be lower, and those named below must fit
DRYRUN_SERVE_PEAK_BEFORE = {
    ("llama3.2-3b", "prefill_32k"): (20.803e9, 13.991e9),
    ("llama3.2-3b", "decode_32k"): (39.192e9, 23.186e9),
    ("gemma3-12b", "prefill_32k"): (39.747e9, 32.327e9),
    ("gemma3-12b", "decode_32k"): (46.081e9, 35.494e9),
    ("gemma3-12b", "long_500k"): (61.906e9, 61.906e9),
    ("gemma3-27b", "prefill_32k"): (77.412e9, 67.402e9),
    ("gemma3-27b", "decode_32k"): (83.986e9, 70.689e9),
    ("gemma3-27b", "long_500k"): (103.627e9, 103.627e9),
    ("internvl2-76b", "prefill_32k"): (191.366e9, 170.563e9),
    ("internvl2-76b", "decode_32k"): (241.164e9, 195.461e9),
    ("phi3.5-moe-42b-a6.6b", "prefill_32k"): (109.246e9, 99.096e9),
    ("phi3.5-moe-42b-a6.6b", "decode_32k"): (125.521e9, 107.233e9),
    ("llama4-scout-17b-a16e", "prefill_32k"): (252.799e9, 241.408e9),
    ("llama4-scout-17b-a16e", "decode_32k"): (284.881e9, 257.449e9),
    ("minicpm3-4b", "prefill_32k"): (1459.424e9, 734.175e9),
    ("minicpm3-4b", "decode_32k"): (28.683e9, 18.802e9),
    ("jamba-v0.1-52b", "prefill_32k"): (109.829e9, 109.794e9),
    ("jamba-v0.1-52b", "decode_32k"): (114.351e9, 111.967e9),
    ("jamba-v0.1-52b", "long_500k"): (118.863e9, 118.863e9),
    ("xlstm-125m", "prefill_32k"): (0.406e9, 0.382e9),
    ("xlstm-125m", "decode_32k"): (0.573e9, 0.450e9),
    ("xlstm-125m", "long_500k"): (0.362e9, 0.362e9),
    ("seamless-m4t-large-v2", "prefill_32k"): (15.733e9, 10.028e9),
    ("seamless-m4t-large-v2", "decode_32k"): (33.315e9, 18.820e9)}
# (a cell that must fit on one mesh only names it: True for (2, 16, 16))
DRYRUN_SERVE_FITS = (("internvl2-76b", "prefill_32k"),
                     ("internvl2-76b", "decode_32k"),
                     ("gemma3-27b", "long_500k"),
                     ("phi3.5-moe-42b-a6.6b", "prefill_32k"),
                     ("phi3.5-moe-42b-a6.6b", "decode_32k"),
                     ("llama4-scout-17b-a16e", "prefill_32k"),
                     ("llama4-scout-17b-a16e", "decode_32k"),
                     ("minicpm3-4b", "prefill_32k", True),
                     ("minicpm3-4b", "decode_32k"),
                     ("jamba-v0.1-52b", "decode_32k"),
                     ("jamba-v0.1-52b", "long_500k"),
                     ("xlstm-125m", "decode_32k"),
                     ("xlstm-125m", "long_500k"),
                     ("seamless-m4t-large-v2", "prefill_32k"),
                     ("seamless-m4t-large-v2", "decode_32k"))
# its card witness: configurations phases 8-10 run on the card, (arch,
# kind, layers or None for all, dtype or None for the config's, seq,
# batch), each traced on meta at a (1, 1) mesh and run for one step on
# the card; the predicted peak within WITNESS_TOL of max_memory_allocated
WITNESSES = (("llama3.2-3b", "train", 2, "float32", 512, 4),
             ("xlstm-125m", "train", None, None, 128, 8),
             ("gemma3-12b", "prefill", 6, None, 1536, 4))
WITNESS_TOL = 0.10

TOL = {"agg_combine": 2e-5, "spmm": 1e-5, "gemm": 1e-5, "sddmm": 1e-5,
       "rmsnorm": 1e-5, "flash_attention": 3e-5, "decode_attention": 3e-5,
       "decode_attention_partial": 3e-5}
TOL_BF16 = 2e-2
SERVICE_TOL = 2e-5
KERNEL_SOURCES = {
    "agg_combine": ("src/repro_torch/kernels/csrc/agg_combine.cu",
                    "src/repro/kernels/agg_combine.py:95"),
    "spmm": ("src/repro_torch/kernels/csrc/spmm.cu",
             "src/repro/kernels/spmm.py:56"),
    "gemm": ("src/repro_torch/kernels/csrc/gemm.cu",
             "src/repro/kernels/gemm.py:63"),
    "sddmm": ("src/repro_torch/kernels/csrc/sddmm.cu",
              "src/repro/kernels/sddmm.py:49"),
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:36"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:98"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:90"),
    "decode_attention_partial": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:90"),
}


def make_graph(seed: int = 0):
    """Power-law edges (zipf sources, uniform destinations) and Gaussian
    embeddings, the recipe of ``benchmarks/common.py::make_workload``."""
    rng = np.random.default_rng(seed)
    src = rng.zipf(ZIPF_A, N_EDGES) % N_VERTICES
    dst = rng.integers(0, N_VERTICES, N_EDGES)
    edges = np.stack([dst, src], axis=1).astype(np.int64)
    emb = rng.standard_normal((N_VERTICES, FEAT)).astype(np.float32)
    return edges, emb


def model_setup(gnn, make_service_dfg, model: str):
    params = gnn.init_params(model, DIMS, seed=0, device=DEVICE)
    weights = {k: v for k, v in gnn.dfg_feeds(model, params, None, []).items()
               if k != "H"}
    return make_service_dfg(model, len(DIMS) - 1, FANOUTS).save(), weights


def kernel_name(symbol: str) -> str:
    """A ptxas entry symbol as kernel<template args>, e.g.
    gemm_kernel<float,24,64,6,4,16,3>, or as the bare name of a kernel
    that is no template; the symbol itself if not a kernel."""
    m = re.search(r"\d+([a-z_]+_kernel)I(.+?)EEv", symbol)
    if not m:
        m = re.search(r"\d+([a-z_]+_kernel)E", symbol)
        return m.group(1) if m else symbol
    args = m.group(2).replace("13__nv_bfloat16", "bf16,")
    args = re.sub(r"Li(\d+)E", r"\1,", re.sub(r"^f", "float,", args))
    return f"{m.group(1)}<{args.strip(',')}>"


def flash_bf16_sass(_build) -> dict[str, dict[str, int]]:
    """Tensor-core instructions in the SASS of each bf16 flash_attention
    kernel (``flash_wgmma_kernel<D,...>``) of the built library, from
    ``cuobjdump -sass``: HGMMA (wgmma) and HMMA (mma.sync) counts by
    kernel."""
    from pathlib import Path
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass",
                           str(_build.build_dir() / _build.LIB_NAME)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts = {}
    for section in sass.split("Function : ")[1:]:
        name = kernel_name(section.split("\n", 1)[0].strip())
        if name.startswith("flash_wgmma_kernel"):
            counts[name] = {op: len(re.findall(rf"\b{op}\b", section))
                            for op in ("HGMMA", "HMMA")}
    return counts


# the kernel each wrapper launch runs once, as a pattern of the profiler's
# kernel names: decode_attention's combine kernel (its split kernel runs
# only where the table has a page), or the partial entry's cluster kernel,
# which runs alone where its splits fit a cluster
COUNT_SYMBOLS = {"agg_combine": r"\bagg_combine_kernel\b",
                 "spmm": r"\bspmm_kernel\b", "gemm": r"\bgemm_kernel\b",
                 "sddmm": r"\bsddmm_kernel\b",
                 "rmsnorm": r"\brmsnorm_kernel\b",
                 "flash_attention": r"\bflash_(?:wgmma_)?kernel\b",
                 "decode_attention":
                     r"\bdecode_(?:combine|cluster)_kernel\b"}


MARKERS = [64]                        # the marker burst's size, grown in use


def profiled(torch, fn, reps: int = 1):
    """The card's work during ``reps`` calls of ``fn`` under torch.profiler
    (its key_averages entries) and the host ms of that window, which ends
    in a synchronize (the profiler slows the host somewhat).  Only the
    card's activity is recorded, with ``acc_events`` on (one window is
    one cycle; without it the profiler warns that it clears events at
    the end of each cycle).  torch.profiler drops the first launches of
    a window, a few more in each window a process opens (3-4 more a
    window on torch 2.11, ``tools/torch_profiler_counts.py``), so each
    window opens with a burst of MARKERS[0] spin kernels and a
    synchronize, which absorb the loss and are left out of the entries
    and the host ms; the burst grows to twice what it lost where it lost
    half.  Each window is held to the kernel wrappers' launch counters:
    the launches of each kernel the profiler recorded (``COUNT_SYMBOLS``)
    must equal what its wrapper counted in the window.  A short window
    is printed and taken again with a burst four times larger, up to
    PROFILE_TRIES windows in all; if every window is short, the phase
    raises."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels
    for attempt in range(1, PROFILE_TRIES + 1):
        burst = MARKERS[0]
        before = kernels.launch_counts()
        with profile(activities=[ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            for _ in range(burst):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counted = {k: v - before[k]
                   for k, v in kernels.launch_counts().items()}
        counted["decode_attention"] += counted.pop("decode_attention_partial")
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0]
        lost = burst - sum(e.count for e in events
                           if re.search(r"\bspin_kernel\b", e.key))
        if 2 * lost >= burst:
            MARKERS[0] = 2 * max(lost, burst)
        events = [e for e in events
                  if not re.search(r"\bspin_kernel\b", e.key)]
        seen = {k: sum(e.count for e in events if re.search(sym, e.key))
                for k, sym in COUNT_SYMBOLS.items()}
        short = {k: (seen[k], counted[k]) for k in COUNT_SYMBOLS
                 if seen[k] != counted[k]}
        if not short and (events or not any(counted.values())):
            return events, wall * 1e3
        print(f"profiled: window {attempt} of {PROFILE_TRIES} recorded "
              f"(kernel: recorded, launched) {short or 'no device events'}"
              f"; {lost} of {burst} markers lost")
        MARKERS[0] = 4 * max(MARKERS[0], burst)
    raise AssertionError(f"torch.profiler lost kernel launches in all "
                         f"{PROFILE_TRIES} windows: {short}")


def graph_calls(torch, calls) -> list:
    """Each of ``calls`` captured into a CUDA graph (one memory pool for
    all, so replays run in turn on one stream), as callables that replay
    it and return its output: a plain version's or a library call's
    launches then reach the card as one, back to back, with none of the
    host's issue between them."""
    pool = torch.cuda.graph_pool_handle()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    replays = []
    with torch.cuda.stream(side):
        calls[0]()                      # warm: cuBLAS workspaces, plans
        for c in calls:
            g = torch.cuda.CUDAGraph()
            g.capture_begin(pool=pool)
            out = c()
            g.capture_end()
            replays.append(lambda g=g, out=out: (g.replay(), out)[1])
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    return replays


def event_ms(torch, calls, launches: int = COLD_LAUNCHES,
             graphed: bool = False) -> float:
    """Device ms of one call: ``calls`` (callables without arguments, each
    on inputs of its own) run in turn, at least ``launches`` calls timed,
    each between two CUDA events, the median of as many empty pairs (the
    events' own time) taken off.  The calls go in chunks of EVENT_CHUNK,
    each behind a spin kernel (``torch.cuda._sleep``) on an idle card
    that outlasts the host's issue of the whole chunk, so the card runs
    the chunk's calls back to back and no pair holds a host gap: each
    chunk's issue is held to its spin, and a chunk the host did not
    issue within it is taken again with a spin of twice its pace; after
    PROFILE_TRIES passes the phase raises (a spin sized from one fast
    issue of a call, as before this check, let a one-head flash launch
    read its host's gap).  The spin is sized at 1.5 times the slowest of
    three timed issues of the first call a call, at least 20 us.  With
    ``graphed``, for plain versions and library calls, each call is
    first captured into a CUDA graph (``graph_calls``) and its replay
    timed: a plain version's loops issue more launches than the card's
    queue holds, and a library call's host path can outrun a spin sized
    from its fastest issue, so neither could be covered as it is, and
    both are read as device time.  Each output is kept, so each goes to
    fresh memory; the timed pass follows an untimed one that grows the
    caching allocator's pool to hold them, so no ``cudaMalloc`` falls
    between a pair."""
    if graphed:
        calls = graph_calls(torch, calls)
    for c in calls:                     # warm: plans, allocator, modules
        c()
    torch.cuda.synchronize()
    issue_us = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        calls[0]()
        issue_us = max(issue_us, (time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()

    def timed(fns, pace_us, check):
        """Each pair's device ms, and the slowest chunk's host us a call
        where a chunk's issue outran its spin (0.0 where none did)."""
        pairs, outs, worst = [], [], 0.0   # outputs kept: fresh memory
        for i in range(0, len(fns), EVENT_CHUNK):
            chunk = fns[i:i + EVENT_CHUNK]
            torch.cuda.synchronize()
            spin = pace_us * len(chunk)
            torch.cuda._sleep(int(spin * SPIN_CYCLES_PER_US))
            t0 = time.perf_counter()
            for fn in chunk:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                outs.append(fn())
                end.record()
                pairs.append((start, end))
            host = (time.perf_counter() - t0) * 1e6
            if check and 1.2 * host + 20.0 > spin:
                worst = max(worst, host / len(chunk))
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in pairs], worst

    fns = calls * -(-launches // len(calls))
    pace = max(20.0, 1.5 * issue_us)
    gc.disable()                        # no collection inside a chunk
    try:
        timed(fns, pace, False)         # the pool grows to hold the outputs
        empty = float(np.median(timed([lambda: None] * len(fns), pace,
                                      False)[0]))
        for _ in range(PROFILE_TRIES):
            got, worst = timed(fns, pace, True)
            if not worst:
                break
            pace = 2 * worst
        else:
            raise AssertionError(
                f"event_ms: the host's issue ({worst:.1f} us a call) "
                f"outran a spin of {pace / 2:.1f} us a call in "
                f"{PROFILE_TRIES} passes")
    finally:
        gc.enable()
    return float(np.mean(got)) - empty


def warm_ms(torch, fn, launches: int = COLD_LAUNCHES, **kw) -> float:
    """Device ms of ``fn`` on the same inputs every time (``event_ms`` of
    one call repeated): its inputs in the L2 where they fit."""
    return event_ms(torch, [fn], launches, **kw)


def call_ms(torch, fn, reps: int = 20) -> float:
    """Mean time per call of ``fn`` back to back (CUDA events around
    ``reps`` calls, after one warm-up): the device time or, for a call
    shorter than its own host overhead, the host's rate of issuing it."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def gnn_plain(ref) -> dict:
    """Each GNN kernel wrapper's plain version; agg_combine's takes the
    bias or not (``agg_combine_partial``'s product)."""
    return {
        "agg_combine": lambda h, n, k, w, b=None, mode="mean":
            ref.agg_combine_ref(h, n, k, w, b, mode=mode),
        "spmm": lambda h, n, k, mode="mean": ref.spmm_ref(h, n, k, mode=mode),
        "gemm": lambda a, b: ref.gemm_ref(a, b).to(a.dtype),
        "sddmm": ref.sddmm_ref,
    }


def gnn_library(torch, name, args, kwargs):
    """One PyTorch call computing a GNN kernel's function on its
    arguments (``torch.matmul``, ``embedding_bag``), or None."""
    if name == "gemm":
        a, b = args
        return lambda: torch.matmul(a, b)
    if name == "spmm":
        h, nbr, mask = args
        per_slot = mask                  # mean: fold 1/deg into the weights
        if kwargs.get("mode", "mean") == "mean":
            per_slot = mask / torch.clamp(mask.sum(1), min=1.0)[:, None]
        idx = nbr.long()
        return lambda: torch.nn.functional.embedding_bag(
            idx, h, per_sample_weights=per_slot, mode="sum")
    return None


def signature(name, args, kwargs) -> str:
    """A GNN kernel call's shape: (MxK)@(KxN) for gemm, else its N, F, D,
    K (and O) with the aggregation mode where one is passed."""
    if name == "gemm":
        (m, k), n = args[0].shape, args[1].shape[1]
        return f"({m}x{k})@({k}x{n})"
    dims = (*args[0].shape, *args[1].shape)
    if name == "agg_combine":
        dims += (args[3].shape[1],)
    text = ", ".join(f"{a} {v}" for a, v in zip("NFDKO", dims))
    return f"({text})" + (f" {kwargs['mode']}" if "mode" in kwargs else "")


def replay(torch, card, name, fn, calls, launches, mesh=None,
           warm: bool = True):
    """One GNN kernel's recorded calls of a main-path run, held to its
    plain version and timed.  Every call is checked at TOL[name] (spmm and
    sddmm bit for bit) and counted into the bound.  Then the calls of each
    shape are timed together, every recorded call in each pass, with
    CUDA events: the kernel and the library call cold (``cold_group_ms``:
    each pass on copies of the inputs past the L2, the footing of the
    bound, which no row may read under) and warm (``warm_ms``), the
    library call the same ways as CUDA graph replays (``graphed``), the
    plain version warm as one graph of the pass (a graph for each cold
    copy took seconds a shape to capture, for loops of 420 gemm steps
    that write far past the L2 on their own), and the kernel back to
    back, host included.  Prints the kernel's line (prefixed with the
    mesh where one is given) and returns its ``kernels`` row (keyed by
    ``mesh``), timed cold, and, by shape, {"calls", "ms", "warm",
    "lib_ms", "lib_warm", "bound"} summed over its calls."""
    from repro_torch.kernels import cost, ref
    plain, tol = gnn_plain(ref)[name], TOL[name]
    shapes = {}
    max_err = by_bytes = by_ops = 0.0
    for args, kwargs in calls:
        got = fn(*args, **kwargs)
        want = plain(*args, **kwargs)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max()) \
            if got.numel() else 0.0
        assert torch.allclose(got.float(), want.float(), rtol=tol,
                              atol=tol), (mesh, name, err)
        if name in ("spmm", "sddmm"):                   # bit for bit
            assert torch.equal(got, want), (mesh, name, err)
        max_err = max(max_err, err)
        nbytes, flops = cost.call_cost(name, args)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOP_PER_S * 1e3
        if t_bytes >= t_ops:
            by_bytes += t_bytes
        else:
            by_ops += t_ops
        s = shapes.setdefault(signature(name, args, kwargs),
                              {"calls": [], "bound": 0.0})
        s["calls"].append((args, kwargs))
        s["bound"] += max(t_bytes, t_ops)

    ms = warm_sum = back_ms = plain_ms = 0.0
    lib_ms = 0.0 if name in ("gemm", "spmm") else None
    for s in shapes.values():
        group = s["calls"]
        s["ms"] = cold_group_ms(
            torch, lambda a, k: (lambda: fn(*a, **k)), group)
        if warm:
            s["warm"] = warm_ms(torch, lambda: [fn(*a, **k) for a, k in group])
            warm_sum += s["warm"]
        ms += s["ms"]
        back_ms += call_ms(torch, lambda: [fn(*a, **k) for a, k in group])
        plain_ms += warm_ms(                    # one graph: see above
            torch, lambda: [plain(*a, **k) for a, k in group], launches=3,
            graphed=True)
        if lib_ms is not None:
            libs = [gnn_library(torch, name, a, k) for a, k in group]
            s["lib_ms"] = cold_group_ms(
                torch, lambda a, k: gnn_library(torch, name, a, k), group,
                graphed=True)
            if warm:
                s["lib_warm"] = warm_ms(
                    torch, lambda: [lib() for lib in libs], graphed=True)
            lib_ms += s["lib_ms"]
    bound_ms = sum(s["bound"] for s in shapes.values())
    assert ms >= bound_ms, (mesh, name, ms, bound_ms)
    src, replaces = KERNEL_SOURCES[name]
    row = {"name": name, "route": "cuda", "source": src,
           "replaces": replaces, "launches": launches, "max_abs_err": max_err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": "bytes" if by_bytes >= by_ops else "operations",
           "library_ms": lib_ms}
    if mesh is not None:
        row["mesh"] = list(mesh)
    tag = f"spmd {mesh[0]}x{mesh[1]} " if mesh is not None else ""
    print(f"{tag}{name}: {len(calls)} calls over {len(shapes)} shapes, max "
          f"abs err {max_err:.3g} (tol {tol}), kernel {ms:.4f} ms a pass on "
          f"the card, cold ({f'warm {warm_sum:.4f}; ' if warm else ''}"
          f"{back_ms:.4f} back to back, host included), plain warm "
          f"{plain_ms:.4f} ms, library cold "
          f"{lib_ms if lib_ms is None else round(lib_ms, 4)} ms, bound "
          f"{bound_ms:.4f} ms  [{card}]")
    return row, shapes


def bound_ms_of(torch, name: str, args, kwargs) -> tuple[float, float]:
    """(bytes ms, operations ms): the call's bytes over HBM's rate and its
    flops over the peak for its operands' type (fp32 FMA, or bf16 tensor
    cores)."""
    from repro_torch.kernels import cost
    nbytes, flops = cost.lm_call_cost(name, args, kwargs)
    rate = BF16_FLOP_PER_S if args[0].dtype == torch.bfloat16 \
        else FP32_FLOP_PER_S
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / rate * 1e3


def serve_round(rt, setups, reqs, fused, during=None) -> float:
    """Every model's requests of phase 3, submitted by weights_ref from
    ``ARRAY_CLIENTS`` client threads (each submits its share, then waits
    on it); every reply must be a result equal to phase 3's fused one bit
    for bit.  ``during`` runs on this thread once every request is
    submitted and the first has come back, while the rest are in flight.
    Raises the first failure a client met; returns the round's seconds."""
    jobs = [(m, i) for i in range(len(reqs)) for m in MODELS]
    errors, submitted, first = [], threading.Barrier(ARRAY_CLIENTS + 1), \
        threading.Event()

    def client(k):
        try:
            cl = rt.client()
            ids = [(m, i, cl.submit("run", dfg=setups[m][0],
                                    batch=reqs[i]["targets"],
                                    seed=reqs[i]["seed"], weights_ref=m))
                   for m, i in jobs[k::ARRAY_CLIENTS]]
        except BaseException as e:  # noqa: BLE001 — raised on the main thread
            errors.append(e)
            ids = []
        submitted.wait()
        for m, i, cid in ids:
            try:
                got = cl.result(cid, timeout=600)["Result"]
                np.testing.assert_array_equal(
                    got, fused[m][i]["Result"],
                    err_msg=f"{m} request {i} through the runtime")
            except BaseException as e:  # noqa: BLE001 — raised on the main thread
                errors.append(e)
                return
            finally:
                first.set()

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(ARRAY_CLIENTS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    try:
        submitted.wait()
        if during is not None:
            first.wait(timeout=600)
            during()
    finally:
        for th in threads:
            th.join()
    if errors:
        raise errors[0]
    return time.perf_counter() - t0


def wait_healthy(sup, store, deadline_s: float) -> dict:
    """The supervisor's snapshot once it has handled an incident and every
    shard is live and healthy again; raises past the deadline."""
    t_end = time.monotonic() + deadline_s
    while time.monotonic() < t_end:
        snap = sup.snapshot()
        if (snap["incidents"] and not any(store.failed_shards)
                and all(st == "healthy" for st in snap["states"])):
            return snap
        time.sleep(0.01)
    raise AssertionError(f"the array did not heal: {sup.snapshot()}")


def array_phase(torch, card, edges, emb, setups, reqs, fused) -> None:
    """Phase 6: phase 3's group served through the CSSD array and its
    runtime (see the module docstring)."""
    from repro_torch import kernels
    from repro_torch.core.service import HolisticGNNService
    from repro_torch.kernels.ops import program_config
    from repro_torch.serve import HealthPolicy, ServingRuntime, ShardSupervisor
    from repro_torch.store import make_rop_endpoints

    n_req = len(MODELS) * len(reqs)
    deployed = {m: {k: v.cpu().numpy() for k, v in setups[m][1].items()}
                for m in MODELS}
    svc = HolisticGNNService(h_threshold=64, pad_to=64, cache_pages=4096,
                             n_shards=ARRAY_SHARDS,
                             replication=ARRAY_REPLICATION, device=DEVICE)
    rt = ServingRuntime(svc, n_queues=ARRAY_CLIENTS, max_group=16,
                        max_pending=512)
    sup = None
    try:
        rt.start()
        boot = rt.client()
        t0 = time.perf_counter()
        boot.call("update_graph", edge_array=edges, embeddings=emb,
                  chunked=True, timeout=600)
        print(f"array: {ARRAY_SHARDS} shards x {ARRAY_REPLICATION} replicas, "
              f"chunked update_graph through the runtime "
              f"{time.perf_counter() - t0:.3f} s")
        program_config(svc.xbuilder, "hetero")
        for m in MODELS:
            boot.call("put_weights", name=m, weights=deployed[m], timeout=600)
        serve_round(rt, setups, reqs, fused)           # warm: plans, cache
        # each model's group of 32 run directly on the array: its launches
        # (the per-group yardstick for the runtime's) and its time
        per_group, direct = {}, []
        for m in MODELS:
            kernels.reset_launch_counts()
            for got, want in zip(svc.run_batch(setups[m][0], reqs,
                                               weights_ref=m), fused[m]):
                np.testing.assert_array_equal(got["Result"], want["Result"])
            per_group[m] = kernels.launch_counts()
            times, engine = [], []
            for _ in range(GROUP_REPEATS):
                t0 = time.perf_counter()
                svc.run_batch(setups[m][0], reqs, weights_ref=m)
                times.append(time.perf_counter() - t0)
                engine.append(sum(t for op, _, t in svc.engine.timings
                                  if op == "__dfg_jit__"))
            direct.append(f"{m} {min(times) * 1e3:.3f} / "
                          f"{np.median(times) * 1e3:.3f} (engine "
                          f"{np.median(engine) * 1e3:.3f})")
        print(f"array direct run_batch of {len(reqs)} requests, ms best / "
              f"median of {GROUP_REPEATS} (engine median): "
              f"{', '.join(direct)}  [{card}]")
        # groups the scheduler forms, by model
        groups = dict.fromkeys(MODELS, 0)
        model_of = {setups[m][0]: m for m in MODELS}
        run_batch = svc.run_batch

        def counted(dfg, requests, **kwargs):
            groups[model_of[dfg]] += 1
            return run_batch(dfg, requests, **kwargs)

        svc.run_batch = counted
        try:
            kernels.reset_launch_counts()
            secs = serve_round(rt, setups, reqs, fused)
            launches = kernels.launch_counts()
        finally:
            del svc.run_batch
        print(f"array main path launches: {launches}; groups {groups}")
        assert all(launches[k] > 0 for k in GNN_KERNELS), launches
        want = {k: sum(groups[m] * per_group[m][k] for m in MODELS)
                for k in GNN_KERNELS}
        assert {k: launches[k] for k in GNN_KERNELS} == want, (launches, want)
        print("array: launches a group through the runtime equal a direct "
              f"run_batch's: {per_group}")
        qos = rt.scheduler.qos.snapshot()
        print(f"array: {n_req} requests ({len(MODELS)} models x {len(reqs)}) "
              f"from {ARRAY_CLIENTS} clients through the runtime in "
              f"{secs * 1e3:.3f} ms, {n_req / secs:.1f} requests/s, "
              f"{sum(groups.values())} groups (max 16); latency over "
              f"the last {qos['window_n']} requests p50 "
              f"{qos['p50_latency_s'] * 1e3:.3f} ms, p99 "
              f"{qos['p99_latency_s'] * 1e3:.3f} ms; every result equals "
              f"phase 3's bit for bit  [{card}]")

        sup = ShardSupervisor(svc.store, HealthPolicy(
            probe_interval_s=0.01, rebuild_retry_s=0.1)).start()
        victim = ARRAY_SHARDS - 1

        killed_at = []

        def kill():
            ep = svc.store.endpoints[victim]
            ep.local_store.dev.fail()
            killed_at.append(time.monotonic())
            print(f"array chaos: shard {victim}'s device killed with "
                  f"requests in flight")

        secs = serve_round(rt, setups, reqs, fused, during=kill)
        print(f"array chaos: {n_req} requests in {secs * 1e3:.3f} ms, "
              f"{n_req / secs:.1f} requests/s, every result bit for bit  "
              f"[{card}]")
        snap = wait_healthy(sup, svc.store, deadline_s=120.0)
        inc = snap["last_incident"]
        assert inc["shard"] == victim and inc["drained"], inc
        print(f"array chaos: incident {inc['cause']} on shard "
              f"{inc['shard']}: drained {inc['t_drained'] - killed_at[0]:.6f}"
              f" s after the kill; detect_s {inc['detect_s']:.6f} (first "
              f"error to drain), restore_s {inc['restore_s']:.6f} (drain to "
              f"healthy)  [{card}]")
        secs = serve_round(rt, setups, reqs, fused)
        print(f"array healed: {n_req} requests in {secs * 1e3:.3f} ms, "
              f"{n_req / secs:.1f} requests/s at full redundancy, every "
              f"result bit for bit  [{card}]")
        st = boot.call("stats", timeout=600)
        assert len(st["shards"]) == ARRAY_SHARDS, st["shards"]
        assert st["replication"] == {"r": ARRAY_REPLICATION,
                                     "failed_shards": []}, st["replication"]
        assert {"flow", "qos", "engine", "health"} <= set(st), sorted(st)
        print(f"array stats: qos groups {st['qos']['groups']}, average "
              f"group {st['qos']['avg_group_size']:.2f}, errors "
              f"{st['qos']['errors']}; flow {st['flow']}; engine plan cache "
              f"{st['engine']['jit_cache']}")
        assert st["qos"]["errors"] == 0, st["qos"]
    finally:
        if sup is not None:
            sup.stop()
        rt.stop()
        svc.close()

    rop = HolisticGNNService(
        h_threshold=64, pad_to=64, cache_pages=4096,
        endpoints=make_rop_endpoints(ARRAY_SHARDS, h_threshold=64),
        replication=ARRAY_REPLICATION, device=DEVICE)
    try:
        rop.update_graph(edges, emb, chunked=True)
        program_config(rop.xbuilder, "hetero")
        for m in MODELS:
            for got, want in zip(rop.run_batch(setups[m][0], reqs,
                                               weights=setups[m][1]),
                                 fused[m]):
                np.testing.assert_array_equal(got["Result"],
                                              want["Result"])
        print(f"array over RoP shard endpoints: {len(MODELS)} groups of "
              f"{len(reqs)}, every result bit for bit")
    finally:
        rop.close()


def spmd_phase(torch, card, edges, emb, setups, reqs, fused,
               per_model) -> list[dict]:
    """Phase 5: phase 3's group on the SPMD engine, over each mesh of
    MESH_SHAPES with every slot on the one card (see the module
    docstring).  Returns the ``kernels`` rows of each mesh shape, keyed
    by ``mesh``."""
    from repro_torch import kernels
    from repro_torch.core.service import HolisticGNNService
    from repro_torch.kernels import ops
    from repro_torch.kernels.ops import program_config
    from repro_torch.launch.mesh import make_host_mesh

    # what the slots call: AggCombinePartial is the agg_combine kernel
    # with its epilogue off
    entry = {"agg_combine": "agg_combine_partial", "spmm": "spmm",
             "gemm": "gemm", "sddmm": "sddmm"}

    t_phase = time.perf_counter()
    rows = []
    for d, m in MESH_SHAPES:
        mesh = make_host_mesh(shape=(d, m), devices=[MESH_SLOT] * (d * m))
        svc = HolisticGNNService(h_threshold=64, pad_to=64, device=DEVICE,
                                 mesh=mesh)
        svc.update_graph(edges, emb)
        program_config(svc.xbuilder, "hetero")

        # the SPMD path (its first groups: plans are built in them, from
        # shapes alone): counts zeroed just before, read just after; each
        # slot's kernel calls recorded to replay against the plain versions
        recorded = {name: [] for name in GNN_KERNELS}
        originals = {name: getattr(ops, attr) for name, attr in entry.items()}

        def recorder(name, fn):
            def wrapped(*args, **kwargs):
                recorded[name].append((args, kwargs))
                return fn(*args, **kwargs)
            return wrapped

        for name, fn in originals.items():
            setattr(ops, entry[name], recorder(name, fn))
        try:
            kernels.reset_launch_counts()
            got, per = {}, {}
            for mdl in MODELS:
                before = kernels.launch_counts()
                got[mdl] = svc.run_batch(setups[mdl][0], reqs,
                                         weights=setups[mdl][1])
                per[mdl] = {k: v - before[k]
                            for k, v in kernels.launch_counts().items()}
            launches = kernels.launch_counts()
        finally:
            for name, fn in originals.items():
                setattr(ops, entry[name], fn)
        tag = f"spmd {d}x{m}"
        print(f"{tag} main path launches: {launches}")
        for mdl in MODELS:
            want = {k: per_model[mdl][k] * d * m for k in GNN_KERNELS}
            if d > 1:        # data-striped SDDMM is the reference's plain step
                want["sddmm"] = 0
            assert {k: per[mdl][k] for k in GNN_KERNELS} == want, \
                (tag, mdl, per[mdl], want)
        assert per["gcn"]["agg_combine"] > 0, per["gcn"]  # not the fallback
        assert all(launches[k] > 0 for k in GNN_KERNELS
                   if k != "sddmm" or d == 1), launches
        st = svc.stats()["engine"]
        assert st["mesh"] == {"data": d, "model": m}, st

        for mdl in MODELS:
            dfg, weights = setups[mdl]
            err = 0.0
            for a, b in zip(got[mdl], fused[mdl]):
                assert a["Result"].shape == (TARGETS, DIMS[-1])
                assert np.isfinite(a["Result"]).all()
                if (d, m) == (1, 1):                # no collective, no pad
                    np.testing.assert_array_equal(a["Result"], b["Result"])
                else:
                    np.testing.assert_allclose(a["Result"], b["Result"],
                                               rtol=SERVICE_TOL,
                                               atol=SERVICE_TOL)
                err = max(err, float(np.abs(a["Result"] - b["Result"]).max()))
            same = "bit for bit" if (d, m) == (1, 1) else \
                f"max abs err {err:.3g} (tol {SERVICE_TOL})"
            if (d, m) == SERIAL_MESH:
                for a, r in zip(got[mdl], reqs):
                    serial = svc.run(dfg, r["targets"], weights=weights,
                                     seed=r["seed"])["Result"][:TARGETS]
                    np.testing.assert_array_equal(serial, a["Result"])
                same += f"; fused == serial bitwise for {GROUP} requests"
            times, engine = [], []
            for _ in range(GROUP_REPEATS):
                t0 = time.perf_counter()
                svc.run_batch(dfg, reqs, weights=weights)
                times.append(time.perf_counter() - t0)
                engine.append(sum(t for op, _, t in svc.engine.timings
                                  if op == "__dfg_jit__"))
            busy, wall, _ = profile_split(
                torch, lambda: svc.run_batch(dfg, reqs, weights=weights), {})
            print(f"{tag} {mdl}: against phase 3's run_batch {same}; "
                  f"launches {({k: per[mdl][k] for k in GNN_KERNELS})}")
            print(f"{tag} {mdl}: run_batch group {min(times) * 1e3:.3f} ms "
                  f"best of {GROUP_REPEATS} (median "
                  f"{np.median(times) * 1e3:.3f} ms); engine median "
                  f"{np.median(engine) * 1e3:.3f} ms  [{card}]")
            print(f"{tag} {mdl}: under torch.profiler, one group: card "
                  f"{busy_text(busy, wall)}  [{card}]")

        # each slot's kernel calls against the plain versions, timed by
        # slice shape with every recorded call in each window
        for name in (k for k in GNN_KERNELS if launches[k]):
            row, shapes = replay(torch, card, name, originals[name],
                                 recorded[name], launches[name], mesh=(d, m),
                                 warm=False)
            rows.append(row)
            for sig, s in shapes.items():
                n = len(s["calls"])
                print(f"{tag} {name} {sig}: {n} calls, kernel "
                      f"{s['ms'] / n:.5f} ms a launch, bound "
                      f"{s['bound'] / n:.5f} ({100 * s['bound'] / s['ms']:.1f}"
                      f" % of bound reached)  [{card}]")
        svc.close()
    print(f"spmd phase: {len(MESH_SHAPES)} meshes x {len(MODELS)} models in "
          f"{time.perf_counter() - t_phase:.1f} s")
    return rows


@contextlib.contextmanager
def wrappers_as(ops, fns: dict):
    """``ops``' kernel wrappers replaced by ``fns`` (name -> function) for
    the block: the models call their kernels as attributes of ``ops``."""
    old = {name: getattr(ops, name) for name in fns}
    for name, fn in fns.items():
        setattr(ops, name, fn)
    try:
        yield
    finally:
        for name, fn in old.items():
            setattr(ops, name, fn)


@contextlib.contextmanager
def recording(torch, ops, names):
    """Record each named wrapper's calls in the block, one entry per
    distinct argument layout: {name: {layout: [args, kwargs, count]}}.
    A tensor that requires a gradient (a training step's activation) is
    kept detached from its graph, so replaying the call runs the kernel
    alone; others are kept as given (views keep their ``_base``)."""
    recorded = {name: {} for name in names}

    def recorder(name, fn):
        def wrapped(*args, **kwargs):
            key = tuple((tuple(a.shape), a.dtype, a.stride())
                        if isinstance(a, torch.Tensor) else a for a in args)
            key += tuple(sorted(kwargs.items()))
            kept = tuple(a.detach() if isinstance(a, torch.Tensor)
                         and a.requires_grad else a for a in args)
            entry = recorded[name].setdefault(key, [kept, kwargs, 0])
            entry[2] += 1
            return fn(*args, **kwargs)
        return wrapped

    with wrappers_as(ops, {n: recorder(n, getattr(ops, n)) for n in names}):
        yield recorded


@contextlib.contextmanager
def routes_recorded(torch):
    """Each MoE call's routes in the block, in call order: the port's
    ``models/layers.py::_moe_dispatch`` (the router and dispatch of the
    unsplit and the split MoE alike) wrapped so that its top-k experts
    are recorded as (B, T, k), with -1 where the token's rank at that
    expert passes the call's capacity and the token is dropped."""
    from repro_torch.models import layers as L
    inner = L._moe_dispatch
    calls = []

    def wrapped(xl, router, *, cfg):
        eb, route, aux = inner(xl, router, cfg=cfg)
        idx, _, keep, _ = route
        calls.append(torch.where(keep, idx, -1).reshape(
            *xl.shape[:2], idx.shape[-1]))
        return eb, route, aux

    L._moe_dispatch = wrapped
    try:
        yield calls
    finally:
        L._moe_dispatch = inner


def route_positions(torch, calls):
    """One run's recorded routes by position: (B, T, layers * k).  A
    run's first calls are its first forward's, one per MoE layer (a
    prefill or a full forward); each later group of as many calls is a
    decode step's, one more position."""
    n = next((i for i, c in enumerate(calls)
              if c.shape[1] != calls[0].shape[1]), len(calls))
    layers = [torch.cat(calls[i::n], dim=1) for i in range(n)]
    return torch.cat(layers, dim=2)


def moe_reach(cfg) -> list:
    """Per MoE layer, in call order, whether its output can reach another
    position: every layer's mixer mixes positions, so an MoE's can unless
    it is in the model's last layer."""
    from repro_torch.models import transformer as T
    period, rem = cfg.period_pattern, cfg.remainder_kinds
    kinds = [T._pos_ffn_kind(cfg, pos) for _ in range(cfg.n_periods)
             for pos in range(len(period))]
    kinds += [T._pos_ffn_kind(cfg, pos) for pos in range(len(rem))]
    return [i < len(kinds) - 1 for i, k in enumerate(kinds) if k == "moe"]


def agreeing_positions(torch, calls_a, calls_b, reach, first: int,
                       count: int):
    """Two (B, count) bool masks over logits positions first .. first +
    count - 1: where no MoE layer routed any token otherwise in the two
    runs, at that position, or at an earlier one of the same sequence in
    a layer whose output can reach it (``reach``, from
    :func:`moe_reach`); and, for the record, where none did at that
    position or at any earlier one, in any layer."""
    a, b = route_positions(torch, calls_a), route_positions(torch, calls_b)
    assert a.shape == b.shape, (a.shape, b.shape)
    k = a.shape[2] // len(reach)
    layers = (a != b).reshape(*a.shape[:2], len(reach), k).any(dim=3)
    here = layers.any(dim=2)
    onward = layers[:, :, torch.tensor(reach)].any(dim=2)

    def clean(d):
        return ~torch.cummax(d.int(), dim=1).values.bool()

    return ((clean(onward) & ~here)[:, first:first + count],
            clean(here)[:, first:first + count])


def compare_routed(torch, what, got, want, masks, *, prefix, witness=None,
                   tol=None, least=0.5):
    """Logits (B, P, V) against a yardstick's at the positions the first
    of ``masks`` (from :func:`agreeing_positions`) marks, within 2e-2
    times the yardstick's largest logit there, plus, given ``witness`` (a
    pair of runs of the same comparison without the kernels), its
    reading at the same positions, or within ``tol`` element by element
    where one is given (fp32); prints how many positions are gated and
    how many are left out (and how many no differing route precedes in
    any layer), and fails if fewer than ``least`` of them (half) are
    gated."""
    agree, strict = masks
    n, total = int(agree.sum()), agree.numel()
    print(f"{prefix} {what}, gated on routes that agree: {n} of {total} "
          f"positions gated, {total - n} left out (a route differed there, "
          f"or earlier in the sequence in a layer that reaches it); "
          f"{int(strict.sum())} with no differing route before them in "
          f"any layer")
    assert n >= least * total, (what, n, total, least)
    room = 0.0
    if witness is not None:
        room = compare_logits(
            torch, f"{what} on the plain versions at the same {n} positions "
            f"(witness)", witness[0][agree][None], witness[1][agree][None],
            prefix=prefix)
    return compare_logits(torch, f"{what} at the {n} positions whose routes "
                          f"agree", got[agree][None], want[agree][None],
                          tol=tol, scale_tol=None if tol else TOL_BF16,
                          room=room, prefix=prefix)


def lm_library(torch, name, args, kwargs):
    """One PyTorch call computing an LM kernel's function on its
    arguments: ``F.rms_norm``; SDPA causal, or under the window's band
    mask; for decode_attention (and its partial entry) over a dense
    cache's page view (each sequence one chain of pages in order; a
    paged pool has no one-call equivalent), SDPA over that cache under a
    length mask.  KV heads are repeated outside the timed call."""
    import torch.nn.functional as F
    if name == "rmsnorm":
        x, w = args
        w = w.to(x.dtype)
        return lambda: F.rms_norm(x, (x.shape[-1],), w,
                                  kwargs.get("eps", 1e-6))
    if name == "flash_attention":
        q, k, v = args
        rep = q.shape[1] // k.shape[1]
        k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
        window = kwargs.get("window", 0)
        if window <= 0:
            return lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=kwargs.get("causal", True))
        i = torch.arange(q.shape[2], device=q.device)[:, None]
        j = torch.arange(k.shape[2], device=q.device)[None, :]
        band = (i >= j) & (i - j < window)
        return lambda: F.scaled_dot_product_attention(q, k, v,
                                                      attn_mask=band)
    q, kp, vp, pt, lengths = args
    b, hq, d = q.shape
    hkv = kp.shape[2]
    k, v = (p.view(b, -1, hkv, d).permute(0, 2, 1, 3).repeat_interleave(
        hq // hkv, 1) for p in (kp, vp))
    assert torch.equal(pt[:, 0], torch.arange(b, device=q.device,
                                              dtype=pt.dtype) * pt.shape[1])
    mask = (torch.arange(k.shape[2], device=q.device)[None, :]
            < lengths[:, None].long())[:, None, None, :]
    q4 = q[:, :, None, :]
    return lambda: F.scaled_dot_product_attention(q4, k, v, attn_mask=mask)


def hold_to_plain(torch, name, fn, plain_fn, args, kwargs) -> float:
    """One recorded kernel call against its plain version on the same
    arguments, each output of a call that returns several
    (decode_attention_partial's out and lse, whose -inf must match):
    2e-2 for an output rounded to bf16, else TOL[name] (the partial's
    fp32 out and lse from bf16 operands too); returns the max abs err
    over finite values."""
    got = fn(*args, **kwargs)
    want = plain_fn(*args, **kwargs)
    torch.cuda.synchronize()
    err = 0.0
    for g, w in (zip(got, want) if isinstance(got, tuple)
                 else [(got, want)]):
        tol = TOL_BF16 if g.dtype == torch.bfloat16 else TOL[name]
        g, w = g.float(), w.float()
        assert torch.equal(torch.isinf(g), torch.isinf(w)), name
        fin = torch.isfinite(w)
        err = max(err, float((g - w)[fin].abs().max()) if fin.any() else 0.0)
        assert torch.allclose(g, w, rtol=tol, atol=tol), \
            (name, tuple(g.shape), err)
    return err


def lm_phase(torch, card: str) -> list[dict]:
    """Phase 7: the paged-KV LM serving path at llama3.2-3b's full width.
    Returns the ``kernels`` rows of its three kernels."""
    from repro_torch import kernels
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.serve import PagedLM, serve
    from repro_torch.models import build
    from repro_torch.store.pagedkv import PagePool

    cfg = ARCHS[LM_ARCH]
    t0, before = time.perf_counter(), torch.cuda.memory_allocated()
    params = build(cfg).init_params(0, DEVICE)
    torch.cuda.synchronize()
    print(f"lm: {LM_ARCH} {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads x {cfg.resolved_head_dim}"
          f", d_ff {cfg.d_ff}, vocab {cfg.vocab_size}: "
          f"{(torch.cuda.memory_allocated() - before) / 1e9:.2f} GB of fp32 "
          f"parameters made on the card in {time.perf_counter() - t0:.2f} s")

    def engine(num_pages):
        pool = PagePool(num_pages=num_pages, page_size=LM_PAGE_SIZE,
                        num_layers=cfg.num_layers,
                        num_kv_heads=cfg.num_kv_heads,
                        head_dim=cfg.resolved_head_dim, device=DEVICE)
        return PagedLM(cfg, params, pool)

    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               LM_PROMPT).tolist()

    def one_prefill_and_decode():
        eng = engine(2 * -(-(LM_PROMPT + 1) // LM_PAGE_SIZE))
        seq = eng.mgr.add_sequence(0, prompt)
        pre = eng.prefill_logits(seq)
        seq.generated.append(int(torch.argmax(pre)))
        return pre, eng.decode_logits([seq])[0]

    one_prefill_and_decode()                         # warm: cuBLAS, allocator
    torch.cuda.synchronize()

    # the main path: record one call per distinct argument layout, count all
    originals = {name: getattr(ops, name) for name in LM_KERNELS}
    with recording(torch, ops, LM_KERNELS) as recorded:
        kernels.reset_launch_counts()
        done, stats = serve(cfg, num_requests=LM_REQUESTS,
                            prompt_len=LM_PROMPT, max_new=LM_NEW, seed=0,
                            page_size=LM_PAGE_SIZE, num_pages=LM_PAGES,
                            params=params, device=DEVICE)
        launches = kernels.launch_counts()
    print(f"lm main path launches: {launches}")
    assert all(launches[k] > 0 for k in LM_KERNELS), launches
    assert len(done) == LM_REQUESTS
    assert all(len(s.generated) == LM_NEW and
               all(0 <= t < cfg.vocab_size for t in s.generated)
               for s in done)
    pre, step = np.asarray(stats["prefill_s"]), np.asarray(stats["step_s"])
    dec_tokens = sum(len(s.generated) - 1 for s in done)
    print(f"lm prefill: {len(pre)} prompts of {LM_PROMPT} tokens, best "
          f"{pre.min() * 1e3:.3f} ms, median {np.median(pre) * 1e3:.3f} ms "
          f"per prompt, {LM_PROMPT * len(pre) / pre.sum():.1f} tokens/s  "
          f"[{card}]")
    print(f"lm decode: {len(step)} steps at batch 4, best "
          f"{step.min() * 1e3:.3f} ms, median {np.median(step) * 1e3:.3f} ms"
          f" per step, {dec_tokens / step.sum():.1f} tokens/s  [{card}]")
    print(f"lm serve: {stats['tokens']} tokens for {LM_REQUESTS} requests in "
          f"{stats['seconds']:.3f} s ({stats['tokens'] / stats['seconds']:.1f}"
          f" tokens/s), {stats['pages_alloc']} pages allocated  [{card}]")
    # where the time goes: one prefill, then one decode step at batch 4
    def show(what, fn):
        busy, wall, split = profile_split(torch, fn, LM_KERNEL_SYMBOLS)
        print(f"lm {what} under torch.profiler: card "
              f"{busy_text(busy, wall)}; device ms by "
              f"kernel: {split}  [{card}]")

    eng = engine(4 * -(-(LM_PROMPT + 1) // LM_PAGE_SIZE))
    seqs = [eng.mgr.add_sequence(i, prompt) for i in range(4)]
    show("prefill of one prompt", lambda: eng.prefill_logits(seqs[0]))
    for s in seqs:
        s.generated.append(eng.prefill(s))
    show("decode step at batch 4", lambda: eng.decode_logits(seqs))
    del eng, seqs

    # each kernel against its plain version on the run's arguments
    plain = {"rmsnorm": ref.rmsnorm_ref,
             "flash_attention": ref.attention_ref,
             "decode_attention": ref.decode_attention_ref}

    def decode_cold_ms(fn, args, rounds=DECODE_COLD_ROUNDS,
                       graphed=False) -> float:
        """Device ms a launch with every launch on another layer's pools:
        the call's q, page table and lengths against layers 0..L-1 of the
        pools its K and V pages are views of, ``rounds`` times over
        (``event_ms``).  The layers' pages together (L times the call's K
        and V rows, ~460 MB at batch 4) exceed the 50 MB L2, so each
        launch reads its pages from HBM, as each layer of a decode step
        does."""
        q, kp, vp, pt, lengths = args
        kb, vb = kp._base, vp._base
        assert kb is not None and tuple(kb.shape[1:]) == tuple(kp.shape)
        calls = [lambda li=li: fn(q, kb[li], vb[li], pt, lengths)
                 for li in range(kb.shape[0])]
        return event_ms(torch, calls, len(calls) * rounds, graphed=graphed)

    rows = []
    rms_shapes = {}       # (rows, F, dtype) -> [calls, kernel, lib, bound]
    for name in LM_KERNELS:
        fn = originals[name]
        ms = plain_ms = bound_ms = by_bytes = by_ops = max_err = 0.0
        calls_ms = warm = 0.0
        lib_ms = None if name == "decode_attention" else 0.0
        for args, kwargs, count in recorded[name].values():
            max_err = max(max_err, hold_to_plain(torch, name, fn,
                                                 plain[name], args, kwargs))
            warm += count * warm_ms(torch, lambda: fn(*args, **kwargs))
            if name == "decode_attention":        # the cold figure counts
                one_ms = decode_cold_ms(fn, args)
                one_plain = decode_cold_ms(plain[name], args, rounds=1,
                                           graphed=True)
            else:
                one_ms = cold_ms(torch, lambda a: (lambda: fn(*a, **kwargs)),
                                 args)
                one_plain = cold_ms(
                    torch, lambda a: (lambda: plain[name](*a, **kwargs)),
                    args, launches=3, graphed=True)
            ms += count * one_ms
            plain_ms += count * one_plain
            calls_ms += count * call_ms(torch, lambda: fn(*args, **kwargs))
            lib = None if name == "decode_attention" \
                else lm_library(torch, name, args, kwargs)
            one_lib = cold_ms(torch, lambda a: lm_library(
                torch, name, a, kwargs), args,
                graphed=True) if lib is not None else 0.0
            if lib is not None:
                lib_ms += count * one_lib
            t_bytes, t_ops = bound_ms_of(torch, name, args, kwargs)
            bound_ms += count * max(t_bytes, t_ops)
            if t_bytes >= t_ops:
                by_bytes += count * t_bytes
            else:
                by_ops += count * t_ops
            if name == "rmsnorm":
                x = args[0]
                key = (x.numel() // x.shape[-1], x.shape[-1],
                       str(x.dtype).replace("torch.", ""))
                acc = rms_shapes.setdefault(key, [0, 0.0, 0.0, 0.0])
                for i, v in enumerate((count, one_ms, one_lib,
                                       max(t_bytes, t_ops))):
                    acc[i] += v if i == 0 else count * v
        n = launches[name]
        assert ms >= bound_ms, (name, ms, bound_ms)
        src, replaces = KERNEL_SOURCES[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": n,
                     "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms,
                     "bound_by": "bytes" if by_bytes >= by_ops else "operations",
                     "library_ms": lib_ms})
        print(f"{name}: {n} launches over {len(recorded[name])} argument "
              f"layouts, max abs err {max_err:.3g} (tol {TOL[name]}, bf16 "
              f"{TOL_BF16}); summed over the run, CUDA events: kernel "
              f"{ms:.4f} ms on the card cold ({ms / n:.5f} per launch; warm "
              f"{warm / n:.5f}; back to back, host included, "
              f"{calls_ms / n:.5f}), plain {plain_ms:.4f} ms, library "
              f"{lib_ms if lib_ms is None else round(lib_ms, 4)} ms, bound "
              f"{bound_ms:.4f} ms ({bound_ms / n:.5f} per launch)  [{card}]")
        if name == "flash_attention":
            print(f"flash_attention share of bound: {100 * bound_ms / ms:.1f} "
                  f"% ({ms / n:.5f} ms a launch against a {bound_ms / n:.5f} "
                  f"ms bound; SDPA {lib_ms / n:.5f} ms a launch)  [{card}]")
        if name == "decode_attention":
            print(f"decode_attention cold: {ms / n:.5f} ms a launch, each "
                  f"launch on another layer's pools; warm (one layer's "
                  f"pools repeated) {warm / n:.5f}; plain, cold "
                  f"{plain_ms / n:.5f}; bound {bound_ms / n:.5f} "
                  f"({100 * bound_ms / ms:.1f} % of bound reached)  [{card}]")

    # rmsnorm by shape: kernel against F.rms_norm at each shape of the run
    for (r, f, dt), (calls, k_ms, l_ms, b_ms) in sorted(
            rms_shapes.items(), key=lambda kv: -kv[1][1]):
        print(f"rmsnorm ({r}x{f}) {dt}: {calls} calls, kernel "
              f"{k_ms / calls:.5f} ms a launch, F.rms_norm "
              f"{l_ms / calls:.5f}, bound {b_ms / calls:.5f} "
              f"({100 * b_ms / k_ms:.1f} % of bound reached)  [{card}]")

    # the same engine on the plain versions: logits and generated tokens
    kernel_logits = one_prefill_and_decode()
    with wrappers_as(ops, plain):
        plain_logits = one_prefill_and_decode()
        plain_done, _ = serve(cfg, num_requests=LM_REQUESTS,
                              prompt_len=LM_PROMPT, max_new=LM_NEW, seed=0,
                              page_size=LM_PAGE_SIZE, num_pages=LM_PAGES,
                              params=params, device=DEVICE,
                              log=lambda *_: None)
    for what, a, b in zip(("prefill", "decode"), kernel_logits, plain_logits):
        err = float((a - b).abs().max())
        print(f"lm {what} last-position logits, kernels vs plain: max abs "
              f"diff {err:.3g} (atol {LM_LOGITS_TOL}), argmax "
              f"{int(a.argmax())} vs {int(b.argmax())}")
        assert torch.isfinite(a).all() and a.shape == (cfg.vocab_size,)
        assert torch.allclose(a, b, rtol=0, atol=LM_LOGITS_TOL), (what, err)
    by_sid = {s.sid: s.generated for s in plain_done}
    same = sum(x == y for s in done
               for x, y in zip(s.generated, by_sid[s.sid]))
    print(f"lm generated tokens equal to the plain run's: {same} of "
          f"{stats['tokens']} ({100 * same / stats['tokens']:.1f} %)")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          " GiB")
    return rows


def dense_inputs(torch, cfg, b: int, prompt: int, steps: int) -> dict:
    """Tokens (B, prompt + steps) from seed 1, and the VLM's patches or the
    encoder-decoder's frames, on the card."""
    rng = np.random.default_rng(1)
    out = {"tokens": torch.tensor(rng.integers(0, cfg.vocab_size,
                                               (b, prompt + steps)),
                                  dtype=torch.int32, device=DEVICE)}
    if cfg.family == "vlm":
        out["patches"] = torch.tensor(rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model), dtype=np.float32),
            device=DEVICE)
    if cfg.family == "encdec":
        out["frames"] = torch.tensor(rng.standard_normal(
            (b, prompt, cfg.d_model), dtype=np.float32), device=DEVICE)
    return out


def dense_generate(torch, api, params, inp, prompt: int, steps: int,
                   seq: int):
    """``api.prefill`` of the prompt (and patches or frames) into fresh
    caches of ``seq`` positions beyond the patches, then ``steps`` calls
    of ``api.decode`` fed the next tokens of ``inp`` (teacher-forced).
    Returns each call's logits (B, V) in fp32, the prefill's and each
    step's seconds (host clock to a synchronize), the caches and the
    lengths they hold.  It runs on the device ``inp`` lies on."""
    from repro_torch.models import layers as L
    cfg = api.cfg
    b = inp["tokens"].shape[0]
    device = inp["tokens"].device
    sync = torch.cuda.synchronize if device.type == "cuda" else \
        (lambda: None)
    prefix = cfg.num_patches if cfg.family == "vlm" else 0
    caches = L.init_tree(api.cache_defs(b, seq + prefix), 0, device)
    batch = {k: v for k, v in inp.items() if k != "tokens"}
    batch["tokens"] = inp["tokens"][:, :prompt]
    sync()
    t0 = time.perf_counter()
    out = api.prefill(params, batch, caches)
    logits = [out[0][:, 0].float()]
    sync()
    prefill_s = time.perf_counter() - t0
    extra = {"enc_out": out[2]} if cfg.family == "encdec" else {}
    lengths = torch.full((b,), prompt + prefix, dtype=torch.int32,
                         device=device)
    step_s = []
    for i in range(prompt, prompt + steps):
        t0 = time.perf_counter()
        lg, caches = api.decode(params, {"tokens": inp["tokens"][:, i:i + 1],
                                         "lengths": lengths, **extra},
                                caches)
        logits.append(lg[:, 0].float())
        sync()
        step_s.append(time.perf_counter() - t0)
        lengths = lengths + 1
    return logits, prefill_s, step_s, (caches, lengths, extra)


def cold_ms(torch, make, args, launches: int = COLD_LAUNCHES,
            **kw) -> float:
    """Device ms of one call with its inputs in HBM, on the footing of a
    bound that reads every input from HBM: ``make(args)`` (a call of the
    function on ``args``) built on copies of the tensor arguments that
    together pass COLD_BYTES, eight times the L2, and run in turn
    (``event_ms``), so no copy is in the L2 when its turn comes; each
    output is kept, so each goes to fresh memory, and those still
    unwritten when the window ends (an L2 at most) are a small share of
    the bytes.  Copies are capped at COLD_MAX_COPIES: only inputs under
    0.8 MB stream less, and such calls take their launch latency, far
    above their bound.  CUDA events, not torch.profiler: late in a long
    run the profiler was seen to lose most of a window's kernel events,
    and a row then read faster than its bound."""
    size = sum(a.numel() * a.element_size() for a in args
               if isinstance(a, torch.Tensor))
    n = min(COLD_MAX_COPIES, max(2, -(-COLD_BYTES // max(size, 1))))
    calls = [make(tuple(a.clone() if isinstance(a, torch.Tensor) else a
                        for a in args)) for _ in range(n)]
    return event_ms(torch, calls, launches, **kw)


def cold_group_ms(torch, make, group, launches: int = COLD_LAUNCHES,
                  **kw) -> float:
    """Device ms of one pass over ``group``, recorded (args, kwargs)
    calls, with the inputs in HBM: ``cold_ms`` of the pass as one call
    (``make(args, kwargs)`` builds a call's callable on the copies), at
    least ``launches`` calls timed in all."""
    spans, flat = [], []
    for args, kwargs in group:
        spans.append((len(flat), len(flat) + len(args), kwargs))
        flat += args

    def one_pass(f):
        calls = [make(f[i:j], k) for i, j, k in spans]
        return lambda: [c() for c in calls]
    return cold_ms(torch, one_pass, tuple(flat),
                   max(2, -(-launches // len(group))), **kw)


def partial_kernels(torch, fn, calls) -> tuple[float, dict]:
    """(device kernels a call, {kernel: launches}) of decode_attention's
    partial entry over one call of each of ``calls``, recorded (args,
    kwargs, count), in one profiled window (held to the launch counters);
    asserted against the wrapper's plan: one kernel where a call's splits
    fit a cluster, else the split kernel (where the table has a page) and
    the combine kernel."""
    from repro_torch.kernels.decode_attention import partial_plan
    events, _ = profiled(torch, lambda: [fn(*a, **kw) for a, kw, _ in calls])
    want = 0
    for (q, kp, _, pt, _), _, _ in calls:
        _, n_split, cluster = partial_plan(kp.shape[1], q.shape[2],
                                           q.element_size(), pt.shape[1])
        want += 1 if cluster else 1 + (n_split > 0)
    names = {}
    for e in events:
        m = re.search(r"\w+_kernel(?:<[^>(]*>)?", e.key)
        key = m.group(0) if m else e.key
        names[key] = names.get(key, 0) + e.count
    assert sum(names.values()) == want, (names, want)
    return want / len(calls), names


def dense_rows(torch, card, recorded, originals, plain, path="dense",
               extra=None) -> list[dict]:
    """Each LM kernel's recorded calls held to its plain version (2e-2 in
    bf16) and timed cold (``cold_ms``) as device ms against its bound and
    its one-call library equivalent, summed over the main path's launches;
    no row may read faster than its bound.  flash_attention gives a row
    for its windowed and its causal calls.  Rows carry ``"path": path``
    and the keys of ``extra``; a kernel with no recorded call gives
    none."""
    rows = []
    groups = []
    for name in LM_KERNELS + ("decode_attention_partial",):
        calls = list(recorded.get(name, {}).values())
        if not calls:
            continue
        if name == "flash_attention":
            for w in sorted({kw.get("window", 0) for _, kw, _ in calls}):
                groups.append((name, w, [c for c in calls
                                         if c[1].get("window", 0) == w]))
        else:
            groups.append((name, None, calls))
    for name, window, calls in groups:
        fn = originals[name]
        n = ms = plain_ms = lib_ms = bound = by_bytes = by_ops = 0.0
        max_err = 0.0
        for args, kwargs, count in calls:
            max_err = max(max_err, hold_to_plain(torch, name, fn, plain[name],
                                                 args, kwargs))
            n += count
            ms += count * cold_ms(
                torch, lambda a: (lambda: fn(*a, **kwargs)), args)
            plain_ms += count * cold_ms(
                torch, lambda a: (lambda: plain[name](*a, **kwargs)), args,
                launches=3, graphed=True)
            lib_ms += count * cold_ms(
                torch, lambda a: lm_library(torch, name, a, kwargs), args,
                graphed=True)
            t_bytes, t_ops = bound_ms_of(torch, name, args, kwargs)
            bound += count * max(t_bytes, t_ops)
            by_bytes += count * t_bytes * (t_bytes >= t_ops)
            by_ops += count * t_ops * (t_ops > t_bytes)
        assert ms >= bound, (path, name, window, ms, bound)
        src, replaces = KERNEL_SOURCES[name]
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": int(n),
               "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound,
               "bound_by": "bytes" if by_bytes >= by_ops else "operations",
               "library_ms": lib_ms, "path": path, **(extra or {})}
        tag = name
        if window is not None:
            row["window"] = window
            tag = f"{name} (window {window})"
        if name == "decode_attention_partial":
            row["kernels_a_call"], names = partial_kernels(torch, fn, calls)
            tag = (f"{name} ({row['kernels_a_call']:g} device kernels a "
                   f"call: {names})")
        rows.append(row)
        print(f"{path} {tag}: {int(n)} launches over {len(calls)} argument "
              f"layouts, max abs err {max_err:.3g} (tol {TOL_BF16} on bf16 "
              f"outputs, {TOL[name]} on fp32); "
              f"summed over the main path, each timed cold (inputs past the "
              f"L2): kernel {ms:.4f} ms on the card "
              f"({ms / n:.5f} a launch), plain {plain_ms:.4f}, library "
              f"{lib_ms:.4f} ({lib_ms / n:.5f} a launch), bound "
              f"{bound:.4f} ({bound / n:.5f} a launch, by {row['bound_by']};"
              f" {100 * bound / ms:.1f} % of bound reached)  [{card}]")
    return rows


def compare_logits(torch, what, got, want, *, tol=None, scale_tol=None,
                   room=0.0, prefix="dense") -> float:
    """Logits (B, positions, V) against a yardstick's: within ``tol``
    element by element (rtol = atol), or within ``scale_tol`` times the
    yardstick's largest logit plus ``room`` (a witness's own reading), or
    not gated where neither is given; prints the max abs diff, its 99.9th
    percentile and the argmax agreement, and returns the max abs diff."""
    diff = (got - want).abs()
    err = float(diff.max())
    scale = float(want.abs().max())
    tail = float(torch.quantile(diff.flatten()[::97], 0.999))
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    widened = f" + witness {room:.4g}" if room else ""
    gate = (f"tol {tol}, rtol = atol" if tol is not None else
            f"tol {scale_tol} x max |logit|{widened} = "
            f"{scale_tol * scale + room:.4g}"
            if scale_tol is not None else "not gated")
    print(f"{prefix} {what} over {got.shape[1]} positions: max abs diff "
          f"{err:.4g} ({gate}; logits up to {scale:.3g}), 99.9th percentile "
          f"{tail:.3g}, argmax agreement {100 * agree:.1f} %")
    if tol is not None:
        assert torch.allclose(got, want, rtol=tol, atol=tol), (what, err)
    elif scale_tol is not None:
        assert err <= scale_tol * scale + room, (what, err, scale, room)
    return err


def dense_phase(torch, card) -> list[dict]:
    """Phase 8: the dense-cache LM path (``ModelAPI.prefill`` / ``decode``)
    on gemma3-12b at its published widths, then the other attention
    families (see the module docstring).  Returns the ``kernels`` rows of
    the gemma3 run, keyed ``"path": "dense"``."""
    from repro_torch import kernels
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops, ref
    from repro_torch.models import build, layers as L, transformer as T

    plain = {"rmsnorm": ref.rmsnorm_ref,
             "flash_attention": ref.attention_ref,
             "decode_attention": ref.decode_attention_ref}
    t_phase = time.perf_counter()
    cfg = ARCHS[DENSE_ARCH].replace(num_layers=DENSE_LAYERS)
    api = build(cfg)
    before = torch.cuda.memory_allocated()
    params = api.init_params(0, DEVICE)
    torch.cuda.synchronize()
    print(f"dense: {DENSE_ARCH} {cfg.num_layers} of "
          f"{ARCHS[DENSE_ARCH].num_layers} layers {cfg.period_pattern}, "
          f"d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads x"
          f" {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, window {cfg.window_size}: "
          f"{(torch.cuda.memory_allocated() - before) / 1e9:.2f} GB of fp32 "
          f"parameters, {cfg.dtype} activations and caches")
    inp = dense_inputs(torch, cfg, DENSE_BATCH, DENSE_PROMPT, DENSE_STEPS)
    run = lambda steps: dense_generate(torch, api, params, inp,  # noqa: E731
                                       DENSE_PROMPT, steps, DENSE_SEQ)
    run(2)                              # warm: cuBLAS's bf16 plans, allocator

    # the main path: counts zeroed just before, read just after
    originals = {name: getattr(ops, name) for name in LM_KERNELS}
    with recording(torch, ops, LM_KERNELS) as recorded:
        kernels.reset_launch_counts()
        logits, pre_s, step_s, state = run(DENSE_STEPS)
        launches = kernels.launch_counts()
    print(f"dense main path launches: {launches}")
    assert all(launches[k] > 0 for k in LM_KERNELS), launches
    for name in LM_KERNELS:
        assert sum(c for _, _, c in recorded[name].values()) \
            == launches[name], name
    windows = sorted({kw.get("window", 0)
                      for _, kw, _ in recorded["flash_attention"].values()})
    assert windows == [0, cfg.window_size], windows
    for lg in logits:
        assert lg.shape == (DENSE_BATCH, cfg.vocab_size)
        assert torch.isfinite(lg).all()
    step = np.asarray(step_s)
    print(f"dense prefill: {DENSE_BATCH} x {DENSE_PROMPT} tokens in "
          f"{pre_s * 1e3:.3f} ms, "
          f"{DENSE_BATCH * DENSE_PROMPT / pre_s:.1f} tokens/s  [{card}]")
    print(f"dense decode: {len(step)} steps at batch {DENSE_BATCH}, best "
          f"{step.min() * 1e3:.3f} ms, median {np.median(step) * 1e3:.3f} ms"
          f" a step, {DENSE_BATCH * len(step) / step.sum():.1f} tokens/s  "
          f"[{card}]")

    # where the time goes: one prefill, one more decode step
    caches, lengths, _ = state
    batch = {"tokens": inp["tokens"][:, :DENSE_PROMPT]}
    fresh = L.init_tree(api.cache_defs(DENSE_BATCH, DENSE_SEQ), 0, DEVICE)
    for what, fn in (
            ("prefill", lambda: api.prefill(params, batch, fresh)),
            ("decode step", lambda: api.decode(
                params, {"tokens": inp["tokens"][:, -1:],
                         "lengths": lengths}, caches))):
        busy, wall, split = profile_split(torch, fn, LM_KERNEL_SYMBOLS)
        print(f"dense {what} under torch.profiler: card "
              f"{busy_text(busy, wall)}; device ms by kernel: {split}  "
              f"[{card}]")
    del fresh, caches

    # the cached path against the model's own full forward, teacher-forced
    # over all DENSE_PROMPT + DENSE_STEPS tokens; then in fp32 on the same
    # parameters, where rounding cannot hide a fault of the path
    def full_forward(model_cfg, steps):
        x = L.embed_apply(params["embed"],
                          inp["tokens"][:, :DENSE_PROMPT + steps], model_cfg)
        x, _, _ = T.decoder_forward(params, model_cfg, x)
        return L.logits_apply(params["embed"], x[:, DENSE_PROMPT - 1:],
                              model_cfg).float()

    cached = torch.stack(logits, dim=1)
    compare_logits(torch, "bf16 cached vs full forward", cached,
                   full_forward(cfg, DENSE_STEPS), scale_tol=TOL_BF16)
    api32 = build(cfg.replace(dtype="float32"))
    cached32 = torch.stack(dense_generate(
        torch, api32, params, inp, DENSE_PROMPT, DENSE_FP32_STEPS,
        DENSE_SEQ)[0], dim=1)
    compare_logits(torch, "fp32 cached vs full forward", cached32,
                   full_forward(api32.cfg, DENSE_FP32_STEPS),
                   tol=DENSE_FP32_TOL)
    del api32, cached32

    # every kernel against its plain version, timed against its bound
    rows = dense_rows(torch, card, recorded, originals, plain)
    del recorded

    # the same run on the plain versions
    with wrappers_as(ops, plain):
        plain_logits = torch.stack(run(DENSE_STEPS)[0], dim=1)
    compare_logits(torch, "bf16 kernels vs plain versions", cached,
                   plain_logits, scale_tol=TOL_BF16)
    print(f"dense {DENSE_ARCH}: {time.perf_counter() - t_phase:.1f} s; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del params, api, inp, logits, plain_logits, cached
    torch.cuda.empty_cache()

    # the other attention families, two layers each at published widths
    for name in DENSE_FAMILIES:
        t0 = time.perf_counter()
        base = ARCHS[name]
        cut = {"num_layers": FAMILY_LAYERS}
        if base.family == "encdec":
            cut["enc_layers"] = FAMILY_LAYERS
        cfg = base.replace(**cut)
        api = build(cfg)
        params = api.init_params(0, DEVICE)
        inp = dense_inputs(torch, cfg, FAMILY_BATCH, FAMILY_PROMPT,
                           FAMILY_STEPS)
        generate = lambda api_, p_: dense_generate(  # noqa: E731
            torch, api_, p_, inp, FAMILY_PROMPT, FAMILY_STEPS, FAMILY_SEQ)[0]
        with recording(torch, ops, LM_KERNELS) as recorded, \
                routes_recorded(torch) as routes:
            kernels.reset_launch_counts()
            logits, pre_s, step_s, _ = dense_generate(
                torch, api, params, inp, FAMILY_PROMPT, FAMILY_STEPS,
                FAMILY_SEQ)
            launches = kernels.launch_counts()
        assert launches["rmsnorm"] > 0, (name, launches)
        if cfg.mla is not None:         # MLA's attention is plain torch
            assert launches["flash_attention"] == 0 and \
                launches["decode_attention"] == 0, (name, launches)
        else:
            assert launches["flash_attention"] > 0 and \
                launches["decode_attention"] > 0, (name, launches)
        for lg in logits:
            assert lg.shape == (FAMILY_BATCH, cfg.vocab_size)
            assert torch.isfinite(lg).all()
        errs = {k: max((hold_to_plain(torch, k, originals[k], plain[k], a, kw)
                        for a, kw, _ in recorded[k].values()), default=0.0)
                for k in LM_KERNELS}
        del recorded
        shape = (f"{cfg.num_layers} layers, d_model {cfg.d_model}, "
                 f"{cfg.num_heads}/{cfg.num_kv_heads} heads")
        if cfg.family == "vlm":
            shape += f", {cfg.num_patches} patches"
        if cfg.family == "encdec":
            shape += f", {cfg.enc_layers} encoder layers"
        print(f"dense {name} ({shape}): prefill {FAMILY_BATCH} x "
              f"{FAMILY_PROMPT} in {pre_s * 1e3:.3f} ms, decode median "
              f"{np.median(step_s) * 1e3:.3f} ms a step (first run, cold); "
              f"launches {launches}; each kernel call against its plain "
              f"version, max abs err {errs} (tol {TOL_BF16})  [{card}]")
        # end to end against the plain versions: in bf16, for a capacity
        # MoE only where the two runs routed alike (one rounding flip
        # reroutes a token and, past an expert's capacity, drops others),
        # and in fp32 for every family
        with wrappers_as(ops, plain), routes_recorded(torch) as routes_p:
            plain_logits = generate(api, params)
        got, want = torch.stack(logits, 1), torch.stack(plain_logits, 1)
        compare_logits(torch, f"{name} bf16 kernels vs plain versions",
                       got, want,
                       scale_tol=None if cfg.moe is not None else TOL_BF16)
        if cfg.moe is not None:
            compare_routed(torch, f"{name} bf16 kernels vs plain versions",
                           got, want, agreeing_positions(
                               torch, routes, routes_p, moe_reach(cfg),
                               FAMILY_PROMPT - 1, got.shape[1]),
                           prefix="dense")
        api32 = build(cfg.replace(dtype="float32"))
        logits32 = torch.stack(generate(api32, params), 1)
        with wrappers_as(ops, plain):
            plain32 = torch.stack(generate(api32, params), 1)
        compare_logits(torch, f"{name} fp32 kernels vs plain versions",
                       logits32, plain32, tol=DENSE_FP32_TOL)
        print(f"dense {name}: {time.perf_counter() - t0:.1f} s")
        del params, api, api32, inp, logits, plain_logits, logits32, plain32
        torch.cuda.empty_cache()
    print(f"dense phase: {time.perf_counter() - t_phase:.1f} s")
    return rows


def recurrent_serve(torch, card, arch, cut, batch, prompt, seq, steps,
                    plain, cpu_witness=False) -> list[dict]:
    """One recurrent model's dense-cache path (phase 9): ``api.prefill`` of
    ``batch`` x ``prompt`` tokens into caches of ``seq``, ``steps`` decode
    steps, launch counts zeroed just before and read just after; the
    cached logits against the model's own full forward (in bf16 within
    2e-2 of the logits' scale plus the plain versions' own reading on the
    card; with ``cpu_witness``, on the CPU too) and against the same run
    on the plain versions (2e-2 of the scale); each recorded kernel call
    against its plain version, timed.  Returns the ``kernels`` rows, keyed
    ``"path": "recurrent"``."""
    from repro_torch import kernels
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.models import build, layers as L, transformer as T

    t0 = time.perf_counter()
    base = ARCHS[arch]
    cfg = base.replace(**cut)
    api = build(cfg)
    before = torch.cuda.memory_allocated()
    params = api.init_params(0, DEVICE)
    torch.cuda.synchronize()
    print(f"recurrent: {arch} {cfg.num_layers} of {base.num_layers} layers "
          f"{cfg.period_pattern * cfg.n_periods + cfg.remainder_kinds}, "
          f"d_model {cfg.d_model}, vocab {cfg.vocab_size}: "
          f"{(torch.cuda.memory_allocated() - before) / 1e9:.2f} GB of fp32 "
          f"parameters, {cfg.dtype} activations")
    inp = dense_inputs(torch, cfg, batch, prompt, steps)
    run = lambda n: dense_generate(torch, api, params, inp,  # noqa: E731
                                   prompt, n, seq)
    run(2)                              # warm: cuBLAS's plans, allocator
    originals = {name: getattr(ops, name) for name in LM_KERNELS}
    with recording(torch, ops, LM_KERNELS) as recorded, \
            routes_recorded(torch) as routes:
        kernels.reset_launch_counts()
        logits, pre_s, step_s, state = run(steps)
        launches = kernels.launch_counts()
    print(f"recurrent {arch} main path launches: {launches}")
    kinds = cfg.period_pattern * cfg.n_periods + cfg.remainder_kinds
    wanted = LM_KERNELS if "attn" in kinds else ("rmsnorm",)
    assert all(launches[k] > 0 for k in wanted), (arch, launches)
    for lg in logits:
        assert lg.shape == (batch, cfg.vocab_size)
        assert torch.isfinite(lg).all()
    step = np.asarray(step_s)
    print(f"recurrent {arch} prefill: {batch} x {prompt} tokens in "
          f"{pre_s * 1e3:.3f} ms, {batch * prompt / pre_s:.1f} tokens/s; "
          f"decode: {len(step)} steps, best {step.min() * 1e3:.3f} ms, "
          f"median {np.median(step) * 1e3:.3f} ms a step, "
          f"{batch * len(step) / step.sum():.1f} tokens/s  [{card}]")
    caches, lengths, _ = state
    busy, wall, split = profile_split(torch, lambda: api.decode(
        params, {"tokens": inp["tokens"][:, -1:], "lengths": lengths},
        caches), LM_KERNEL_SYMBOLS)
    print(f"recurrent {arch} decode step under torch.profiler: card "
          f"{busy_text(busy, wall)}; device ms by kernel: {split}  [{card}]")
    del caches, state

    def full_forward(model_cfg, p=params, tokens=inp["tokens"]):
        x = L.embed_apply(p["embed"], tokens[:, :prompt + steps], model_cfg)
        x, _, _ = T.decoder_forward(p, model_cfg, x)
        return L.logits_apply(p["embed"], x[:, prompt - 1:],
                              model_cfg).float()

    # the cached path against the full forward.  The full forward runs
    # each product over B x (prompt + steps) rows at once, the cached path
    # over B x prompt and then B, and the card's GEMMs pick their reduction
    # order by shape, so the two round apart by an ulp here and there in
    # bf16: xlstm's exp-gated scans carry that across all 256 steps, and
    # one ulp routes a near-tied token of jamba's capacity MoE to other
    # experts (its drops also depend on how many tokens a call routes).
    # Two witnesses at full width tell that from a fault of the bf16
    # decode path: the same comparison on the plain versions on the card
    # (the card's rounding, no kernel), whose reading widens the bf16 gate
    # (the kernels may add 2e-2 of the logits' scale to it, no more); and,
    # for xlstm, on the CPU, whose products keep their order whatever the
    # rows, held to the 2e-2 rule alone.  fp32 is held element by element
    # on the same weights, the MoE at a capacity at which no token can
    # drop (e / top_k).
    # A capacity MoE's comparisons are also held where the runs compared
    # routed alike (agreeing_positions): kernels vs plain versions within
    # 2e-2 of the scale alone; cached vs full forward within that plus
    # the plain versions' own cached vs full reading at the positions
    # where both pairs of runs routed alike: at positions no differing
    # route reaches, jamba's bf16 Mamba scans still part the two by
    # about 2e-2 of the scale (0.125 at logits up to 6.19; the plain
    # versions 0.133).
    cached = torch.stack(logits, dim=1)
    with wrappers_as(ops, plain):
        with routes_recorded(torch) as routes_p:
            plain_logits = torch.stack(run(steps)[0], dim=1)
        with routes_recorded(torch) as routes_pf:
            plain_full = full_forward(cfg)
        witness = compare_logits(
            torch, f"{arch} bf16 plain versions cached vs full forward "
            f"(witness: the card's rounding, no kernel)", plain_logits,
            plain_full, prefix="recurrent")
    with routes_recorded(torch) as routes_f:
        full = full_forward(cfg)
    compare_logits(torch, f"{arch} bf16 cached vs full forward", cached,
                   full, scale_tol=TOL_BF16, room=witness,
                   prefix="recurrent")
    if cfg.moe is not None:
        reach = moe_reach(cfg)
        kern, flat = (agreeing_positions(torch, a, b, reach, prompt - 1,
                                         cached.shape[1])
                      for a, b in ((routes, routes_f), (routes_p, routes_pf)))
        agree = (kern[0] & flat[0], kern[1] & flat[1])
        compare_routed(torch, f"{arch} bf16 cached vs full forward", cached,
                       full, agree, prefix="recurrent",
                       witness=(plain_logits, plain_full))
    del full, plain_full, routes_f, routes_pf
    if cpu_witness:
        on_cpu = L.tree_map(lambda t: t.cpu(), params)
        tokens = inp["tokens"].cpu()
        t_cpu = time.perf_counter()
        cpu_cached = torch.stack(dense_generate(
            torch, api, on_cpu, {"tokens": tokens}, prompt, steps,
            seq)[0], dim=1)
        compare_logits(torch, f"{arch} bf16 cached vs full forward on the "
                       f"CPU (witness: no shape-dependent rounding; "
                       f"{time.perf_counter() - t_cpu:.1f} s)", cpu_cached,
                       full_forward(cfg, on_cpu, tokens), scale_tol=TOL_BF16,
                       prefix="recurrent")
        del on_cpu, cpu_cached
    fp32 = cfg.replace(dtype="float32")
    if cfg.moe is not None:
        fp32 = fp32.replace(moe=replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    cached32 = torch.stack(dense_generate(
        torch, build(fp32), params, inp, prompt, steps, seq)[0], dim=1)
    room = "" if fp32.moe is None else \
        f", capacity factor {fp32.moe.capacity_factor} (no drop)"
    compare_logits(torch, f"{arch} fp32 cached vs full forward{room}",
                   cached32, full_forward(fp32), tol=DENSE_FP32_TOL,
                   prefix="recurrent")
    del cached32
    rows = dense_rows(torch, card, recorded, originals, plain,
                      path="recurrent", extra={"arch": arch})
    del recorded

    # the same runs on the plain versions: bf16 within 2e-2 of the logits'
    # scale, fp32 element by element
    compare_logits(torch, f"{arch} bf16 kernels vs plain versions", cached,
                   plain_logits, scale_tol=TOL_BF16, prefix="recurrent")
    if cfg.moe is not None:
        compare_routed(torch, f"{arch} bf16 kernels vs plain versions",
                       cached, plain_logits, agreeing_positions(
                           torch, routes, routes_p, moe_reach(cfg),
                           prompt - 1, cached.shape[1]), prefix="recurrent")
    del routes, routes_p
    api32 = build(cfg.replace(dtype="float32"))
    run32 = lambda: torch.stack(dense_generate(  # noqa: E731
        torch, api32, params, inp, prompt, steps, seq)[0], dim=1)
    kernels32 = run32()
    with wrappers_as(ops, plain):
        plain32 = run32()
    compare_logits(torch, f"{arch} fp32 kernels vs plain versions",
                   kernels32, plain32, tol=DENSE_FP32_TOL, prefix="recurrent")
    del api32, kernels32, plain32
    print(f"recurrent {arch}: {time.perf_counter() - t0:.1f} s; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del params, api, inp, logits, plain_logits, cached
    torch.cuda.empty_cache()
    return rows


def hold_gradients(torch, name, fn, plain_fn, args, kwargs) -> float:
    """The gradients of one recorded call through the kernel's Function
    against autograd through its plain version, for one random output
    gradient: each within GRAD_TOL of its largest element.  Returns the
    largest error relative to that element."""
    dt = str(args[0].dtype).split(".")[-1]
    tensors = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)
               and a.is_floating_point()]
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(7)

    def grads(f, dy=None):
        xs = list(args)
        for i in tensors:
            xs[i] = args[i].detach().clone().requires_grad_(True)
        with torch.enable_grad():
            out = f(*xs, **kwargs)
            if dy is None:
                dy = torch.randn(out.shape, generator=gen, device=DEVICE,
                                 dtype=torch.float32).to(out.dtype)
            return torch.autograd.grad(out, [xs[i] for i in tensors], dy), dy

    got, dy = grads(fn)
    want, _ = grads(plain_fn, dy)
    worst = 0.0
    for a, b in zip(got, want):
        scale = float(b.float().abs().max())
        err = float((a.float() - b.float()).abs().max()) / max(scale, 1e-30)
        assert err <= GRAD_TOL[dt], (name, tuple(a.shape), err)
        worst = max(worst, err)
    return worst


def recurrent_train_phase(torch, card) -> list[dict]:
    """Phase 9: the recurrent mixers served at full width, and training on
    the card (see the module docstring).  Returns the ``kernels`` rows,
    keyed ``"path": "recurrent"`` and ``"path": "train"``."""
    import tempfile

    from repro_torch import kernels
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import train as launch_train
    from repro_torch.models import build
    from repro_torch.train import Trainer, make_train_step, optimizer as O

    plain = {"rmsnorm": ref.rmsnorm_ref,
             "flash_attention": ref.attention_ref,
             "decode_attention": ref.decode_attention_ref}
    t_phase = time.perf_counter()
    lap = [t_phase]

    def took(what):
        """Prints the seconds since the last such line (or the phase's
        start)."""
        now = time.perf_counter()
        print(f"recurrent and train phase: {what} in {now - lap[0]:.1f} s")
        lap[0] = now

    rows = recurrent_serve(torch, card, JAMBA_ARCH,
                           {"num_layers": JAMBA_LAYERS}, JAMBA_BATCH,
                           JAMBA_PROMPT, JAMBA_SEQ, JAMBA_STEPS, plain)
    rows += recurrent_serve(torch, card, XLSTM_ARCH, {}, XLSTM_BATCH,
                            XLSTM_PROMPT, XLSTM_SEQ, XLSTM_STEPS, plain,
                            cpu_witness=True)
    took("recurrent serving")

    # ---- xlstm-125m training through examples/torch_train_lm.py
    example = load_example("torch_train_lm")
    originals = {name: getattr(ops, name) for name in LM_KERNELS}
    with tempfile.TemporaryDirectory() as tmp:
        flags = ["--steps", str(TRAIN_STEPS), "--seq", str(TRAIN_SEQ),
                 "--device", DEVICE]
        with recording(torch, ops, LM_KERNELS) as recorded:
            kernels.reset_launch_counts()
            out = example.main(flags + ["--ckpt", f"{tmp}/a"])
            launches = kernels.launch_counts()
        took(f"the example's {TRAIN_STEPS} steps")
        tr = out["trainer"]
        print(f"train {XLSTM_ARCH} main path launches: {launches}")
        assert launches["rmsnorm"] > 0, launches
        losses = out["losses"]
        assert len(losses) == TRAIN_STEPS and np.isfinite(losses).all()
        assert out["step"] == TRAIN_STEPS
        argv = example.launcher_argv(example.parse_args(
            flags + ["--ckpt", f"{tmp}/b"])) + [
                "--ckpt-every", str(TRAIN_CKPT_EVERY)]
        faulty = launch_train.make_trainer(launch_train.parse_args(argv))
        try:
            faulty.run(TRAIN_STEPS, fault_hook=lambda s: s == TRAIN_FAULT_AT)
            raise AssertionError("the injected fault did not fire")
        except RuntimeError as e:
            assert "injected fault" in str(e), e
        faulty.ckpt.wait()
        resumed = launch_train.make_trainer(launch_train.parse_args(argv))
        assert resumed.ckpt.latest_step() == TRAIN_CKPT_EVERY
        resumed.run(TRAIN_STEPS - TRAIN_CKPT_EVERY)
        again = [m["loss"] for m in faulty.metrics_log][:TRAIN_CKPT_EVERY] \
            + [m["loss"] for m in resumed.metrics_log]
        np.testing.assert_allclose(again, losses, rtol=RESUME_RTOL)
        print(f"train {XLSTM_ARCH} fault at step {TRAIN_FAULT_AT}, resumed "
              f"from step {TRAIN_CKPT_EVERY}: losses within rtol "
              f"{RESUME_RTOL} of the uninterrupted run's, max rel diff "
              f"{max(abs(a - b) / abs(b) for a, b in zip(again, losses)):.3g}"
              f", bit for bit {again == losses}; losses {losses}")
    took("the fault and its resume")
    dts = np.asarray([m["dt"] for m in tr.metrics_log[1:]])
    shape = tr.shape
    tokens = shape.global_batch * shape.seq_len
    print(f"train {XLSTM_ARCH} step (batch {shape.global_batch} x seq "
          f"{shape.seq_len}, remat {tr.api.cfg.remat}): median "
          f"{np.median(dts) * 1e3:.3f} ms, best {dts.min() * 1e3:.3f} ms, "
          f"{tokens / np.median(dts):.1f} tokens/s; rmsnorm "
          f"{launches['rmsnorm'] / TRAIN_STEPS:.0f} launches a step, the "
          f"forward's and, under remat, the recomputed forward's again  "
          f"[{card}]")
    rows += dense_rows(torch, card, recorded, originals, plain,
                       path="train", extra={"arch": XLSTM_ARCH})
    del recorded

    # where a step's time goes, and the tiny overfit on one batch
    api = tr.api
    params = api.init_params(0, DEVICE)
    opt = O.init_state(params)
    batch = {k: torch.from_numpy(v).to(DEVICE)
             for k, v in synth_batch(api.cfg, shape, 0).items()}
    step_fn = make_train_step(api, tr.opt_cfg)
    spans, wall = step_ranges(torch, lambda: step_fn(params, opt, batch))
    print(f"train backward: {spans['train_step.backward']:.3f} ms "
          f"({XLSTM_ARCH}; plain torch, the remat recompute of the forward "
          f"in it), forward {spans['train_step.forward']:.3f} ms, optimizer "
          f"{spans['train_step.optimizer']:.3f} ms: host spans of the "
          f"trainer's profiler ranges in a {wall:.3f} ms step under the "
          f"profiler's op recording  [{card}]")
    busy, wall, split = profile_split(
        torch, lambda: step_fn(params, opt, batch), LM_KERNEL_SYMBOLS)
    print(f"train {XLSTM_ARCH} step under torch.profiler: card "
          f"{busy_text(busy, wall)}; device ms by kernel: {split}  [{card}]")
    step_fn = make_train_step(api, O.AdamWConfig(
        lr=OVERFIT_LR, warmup_steps=2, decay_steps=100))
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in synth_batch(
        api.cfg, replace(shape, global_batch=OVERFIT_BATCH,
                         seq_len=OVERFIT_SEQ), 0).items()}
    fit = []
    for _ in range(OVERFIT_STEPS):
        params, opt, m = step_fn(params, opt, batch)
        fit.append(float(m["loss"]))
    print(f"train {XLSTM_ARCH} tiny overfit: {OVERFIT_STEPS} steps on one "
          f"batch of {OVERFIT_BATCH} x {OVERFIT_SEQ} at lr "
          f"{OVERFIT_LR}: loss {fit[0]:.4f} -> {fit[-1]:.4f} "
          f"(must fall by more than {OVERFIT_DROP})")
    assert fit[-1] < fit[0] - OVERFIT_DROP, fit
    del tr, faulty, resumed, params, opt, api, batch
    torch.cuda.empty_cache()
    took("the train rows, a step's split and the overfit")

    # ---- an attention family's training: every leaf gets a gradient, and
    # the Functions' gradients on the run's arguments
    base = ARCHS[ATTN_TRAIN_ARCH]
    cfg = base.replace(num_layers=ATTN_TRAIN_LAYERS)
    tr = Trainer(build(cfg), ShapeConfig("smoke", "train", ATTN_TRAIN_SEQ,
                                         ATTN_TRAIN_BATCH), device=DEVICE)
    with recording(torch, ops, TRAIN_KERNELS) as recorded:
        kernels.reset_launch_counts()
        _, _, step = tr.run(ATTN_TRAIN_STEPS)
        launches = kernels.launch_counts()
    print(f"train {ATTN_TRAIN_ARCH} main path launches: {launches}")
    assert step == ATTN_TRAIN_STEPS
    assert all(launches[k] > 0 for k in TRAIN_KERNELS), launches
    losses = [m["loss"] for m in tr.metrics_log]
    assert np.isfinite(losses).all()
    worst = {k: max(hold_gradients(torch, k, originals[k], plain[k], a, kw)
                    for a, kw, _ in recorded[k].values())
             for k in TRAIN_KERNELS}
    dts = np.asarray([m["dt"] for m in tr.metrics_log])
    print(f"train {ATTN_TRAIN_ARCH} ({cfg.num_layers} of {base.num_layers} "
          f"layers, batch {ATTN_TRAIN_BATCH} x seq {ATTN_TRAIN_SEQ}, "
          f"{cfg.dtype}): {ATTN_TRAIN_STEPS} steps, every leaf a gradient, "
          f"losses {losses}, step ms {[round(float(d) * 1e3, 3) for d in dts]}; "
          f"the Functions' gradients against autograd through the plain "
          f"versions, max error / max |grad| {worst} (tol {GRAD_TOL})  "
          f"[{card}]")
    rows += dense_rows(torch, card, recorded, originals, plain,
                       path="train", extra={"arch": ATTN_TRAIN_ARCH})
    del tr, recorded
    torch.cuda.empty_cache()
    took(f"{ATTN_TRAIN_ARCH} training")
    print(f"recurrent and train phase: {time.perf_counter() - t_phase:.1f} "
          f"s")
    return rows


def slot_shape(layout, shape) -> tuple:
    """A slot's block shape as its spec dictates: each dim over the
    product of the widths of the mesh axes its entry names."""
    width = dict(zip(layout.mesh.axis_names, layout.mesh.devices.shape))
    out = []
    for i, n in enumerate(shape):
        e = layout.spec[i] if i < len(layout.spec) else None
        axes = () if e is None else (e,) if isinstance(e, str) else e
        out.append(n // int(np.prod([width[a] for a in axes])))
    return tuple(out)


def hold_state(torch, what, got, want, exact: bool,
               tol: float = MESH_TRAIN_TOL, free=()) -> float:
    """Leaves of a laid-out tree (gathered) against whole tensors: equal
    bit for bit, or each within ``tol`` (MESH_TRAIN_TOL) of its largest
    element, but the paths in ``free``, whose errors are printed
    ungated.  Returns the largest error relative to that element."""
    from repro_torch.models import layers as L
    from repro_torch.train import sharded as S
    worst = 0.0
    for (path, laid), ref in zip(L.tree_items(got), L.tree_leaves(want)):
        a = S.gather(laid)
        if exact:
            assert torch.equal(a, ref), (what, path)
            continue
        scale = float(ref.abs().max())
        err = float((a - ref).abs().max()) / max(scale, 1e-30)
        if path in free:
            print(f"{what} {'/'.join(map(str, path))}: error / leaf max "
                  f"{err:.3g} (not gated; leaf max {scale:.3g})")
            continue
        assert err <= tol, (what, path, err)
        worst = max(worst, err)
    return worst


def leaf_errors(torch, got, want) -> dict:
    """{"params", "m", "v": (largest error / its leaf's max, that leaf)}
    of a run's (params, opt) against another's, either laid out (gathered
    first) or whole."""
    from repro_torch.models import layers as L
    from repro_torch.train import sharded as S
    out = {}
    for part in ("params", "m", "v"):
        a = got[0] if part == "params" else got[1][part]
        b = want[0] if part == "params" else want[1][part]
        worst = (0.0, "")
        for (path, x), y in zip(L.tree_items(a), L.tree_leaves(b)):
            x = S.gather(x) if isinstance(x, S.Laid) else x
            err = float((x - y).abs().max()) / max(float(y.abs().max()),
                                                   1e-30)
            worst = max(worst, (err, "/".join(map(str, path))))
        out[part] = (float(f"{worst[0]:.4g}"), worst[1])
    return out


def hold_blocks(trainer, params, opt) -> dict:
    """Every slot's block of the parameters and moments has the shape its
    spec dictates, on its slot's device; returns bytes a slot holds."""
    from repro_torch.models import layers as L
    held = {}
    for part, tree, lays in (("params", params, trainer.layouts["params"]),
                             ("moments", {"m": opt["m"], "v": opt["v"]},
                              {"m": trainer.layouts["opt"]["m"],
                               "v": trainer.layouts["opt"]["v"]})):
        total = 0
        for laid, lay in zip(L.tree_leaves(tree), L.tree_leaves(lays)):
            want = slot_shape(lay, laid.shape)
            for block, dev in zip(laid.blocks, lay.mesh.devices.flat):
                assert tuple(block.shape) == want, (part, laid.shape, want)
                assert block.device == dev, (part, block.device, dev)
            total += int(np.prod(want)) * laid.blocks[0].element_size()
        held[part] = total
    return held


def split_flash(torch, card, fn, plain_fn) -> None:
    """The flash_attention Function at each SPLIT_FLASH shape, fp32 and
    bf16, causal with the window given: forward within TOL (2e-2 in bf16)
    and gradients within GRAD_TOL of each max of the plain version's."""
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    b, t = SPLIT_FLASH_BATCH, SPLIT_FLASH_SEQ
    worst = {}
    for hq, hkv, d, window in SPLIT_FLASH:
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn((b, h, t, d), generator=gen, device=DEVICE)
                       .to(dt) for h in (hq, hkv, hkv))
            kw = {"causal": True, "window": window}
            err = hold_to_plain(torch, "flash_attention", fn, plain_fn,
                                (q, k, v), kw)
            g = hold_gradients(torch, "flash_attention", fn, plain_fn,
                               (q, k, v), kw)
            worst[(hq, hkv, d, window, str(dt)[6:])] = (float(f"{err:.3g}"),
                                                         float(f"{g:.3g}"))
    print(f"mesh train split shapes: flash_attention at a slot's heads of "
          f"the production model degree, batch {b} x {t}, (query heads, KV "
          f"heads, head dim, window, dtype): (forward max abs err, gradient "
          f"error / max) {worst}  [{card}]")


def mesh_train_phase(torch, card, keep=None) -> list[dict]:
    """Phase 10: training on a mesh (see the module docstring).  Returns
    the ``kernels`` rows of the (2, 2) run, keyed ``"path":
    "mesh_train"``; fills ``keep`` with what phase 18 holds its runs in
    several processes to (:func:`kept_run`)."""
    import os
    import shutil
    import tempfile

    from repro_torch import kernels
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build, layers as L
    from repro_torch.train import Trainer

    t_phase = time.perf_counter()
    plain = {"rmsnorm": ref.rmsnorm_ref, "flash_attention": ref.attention_ref}
    originals = {name: getattr(ops, name) for name in TRAIN_KERNELS}
    base = ARCHS[ATTN_TRAIN_ARCH]
    cfg, shape = mesh_train_cut()
    tokens = ATTN_TRAIN_BATCH * ATTN_TRAIN_SEQ
    print(f"mesh train: {ATTN_TRAIN_ARCH} {cfg.num_layers} of "
          f"{base.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads x {cfg.head_dim}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}; batch "
          f"{ATTN_TRAIN_BATCH} x seq {ATTN_TRAIN_SEQ}, {ATTN_TRAIN_STEPS} "
          f"steps a mesh, every slot on {MESH_SLOT}")

    def trainer(mesh_shape, **kw):
        if mesh_shape is None:
            return Trainer(build(cfg), shape, device=DEVICE, **kw)
        d, m = mesh_shape
        mesh = make_host_mesh(shape=mesh_shape, devices=[MESH_SLOT] * (d * m))
        return Trainer(build(cfg, tp=m), shape, mesh=mesh, zero1=d > 1, **kw)

    def timing(tr, tag):
        dts = np.asarray([m["dt"] for m in tr.metrics_log])
        med = float(np.median(dts[1:]))
        ms = [round(float(x) * 1e3, 3) for x in dts]
        print(f"mesh train {tag}: step ms {ms} (the first builds cuBLAS "
              f"plans), median of the rest "
              f"{med * 1e3:.3f} ms, {tokens / med:.1f} tokens/s  [{card}]")
        return med * 1e3

    flat = trainer(None)
    kernels.reset_launch_counts()
    flat_params, flat_opt, _ = flat.run(ATTN_TRAIN_STEPS)
    launches = kernels.launch_counts()
    assert all(launches[k] > 0 for k in TRAIN_KERNELS), launches
    timing(flat, "unmeshed")
    want = {key: [m[key] for m in flat.metrics_log]
            for key in ("loss", "grad_norm")}

    rows = []
    for mesh_shape in MESH_TRAIN_SHAPES:
        tag = "x".join(map(str, mesh_shape))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tr = trainer(mesh_shape)
        split = mesh_shape[1] > 1 and tr.api.model_split()
        record = mesh_shape == SAVE_MESH
        with (recording(torch, ops, TRAIN_KERNELS) if record
              else contextlib.nullcontext({})) as recorded:
            kernels.reset_launch_counts()
            params, opt, step = tr.run(ATTN_TRAIN_STEPS)
            launches = kernels.launch_counts()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        parent = PARENT_MESH_PEAK[tag]
        print(f"mesh train {tag} main path launches: {launches}")
        print(f"mesh train {tag}: compute "
              f"{'split over the model axis' if split else 'gathered'}; "
              f"max_memory_allocated over the run {peak} bytes "
              f"({peak / 2**30:.3f} GiB) above the {base / 2**30:.3f} GiB "
              "allocated before it; the parent commit's (gathered), by "
              f"tools/torch_mesh_train_peak.py: {parent} bytes "
              f"({parent / 2**30:.3f} GiB)  [{card}]")
        assert step == ATTN_TRAIN_STEPS
        assert all(launches[k] > 0 for k in TRAIN_KERNELS), (tag, launches)
        got = {key: [m[key] for m in tr.metrics_log]
               for key in ("loss", "grad_norm")}
        exact = mesh_shape == (1, 1)
        if exact:
            assert got == want, (tag, got, want)
        else:
            for key in got:
                np.testing.assert_allclose(got[key], want[key],
                                           rtol=RESUME_RTOL, err_msg=key)
        errs = {part: hold_state(torch, f"{tag} {part}", a, b, exact)
                for part, a, b in (("params", params, flat_params),
                                   ("m", opt["m"], flat_opt["m"]),
                                   ("v", opt["v"], flat_opt["v"]))}
        held = hold_blocks(tr, params, opt)
        specs = [lay.spec for lay in L.tree_leaves(tr.layouts["opt"]["m"])]
        print(f"mesh train {tag} (zero1 {mesh_shape[0] > 1}): losses "
              f"{got['loss']}, grad_norm {got['grad_norm']}; against the "
              f"unmeshed Trainer: " + ("loss, grad_norm, every parameter "
                                       "and moment bit for bit" if exact
                                       else f"max error / leaf max {errs} "
                                       f"(tol {MESH_TRAIN_TOL}), losses "
                                       f"within rtol {RESUME_RTOL}") +
              f"; each slot holds {held['params'] / 1e9:.3f} GB of "
              f"parameters and {held['moments'] / 1e9:.3f} GB of moments "
              f"({sum('data' in str(sp) for sp in specs)} of {len(specs)} "
              f"moment specs over data), blocks as the specs dictate")
        med_ms = timing(tr, tag)
        if keep is not None and mesh_shape in PROC_TRAIN_MESHES.values():
            keep[tag] = kept_run(torch, tr, params, opt, med_ms)
        if record:
            worst = {k: max(max(hold_gradients(torch, k, originals[k],
                                               plain[k], a, kw),
                                hold_to_plain(torch, k, originals[k],
                                              plain[k], a, kw))
                            for a, kw, _ in recorded[k].values())
                     for k in TRAIN_KERNELS}
            print(f"mesh train {tag}: the Functions' recorded calls "
                  f"against their plain versions, forward within "
                  f"{[TOL[k] for k in TRAIN_KERNELS]} and gradients within "
                  f"{GRAD_TOL['float32']} of each max: worst {worst}")
            rows += dense_rows(torch, card, recorded, originals, plain,
                               path="mesh_train",
                               extra={"arch": ATTN_TRAIN_ARCH, "mesh": tag})
            uninterrupted = got["loss"]
        del tr, params, opt, recorded
        torch.cuda.empty_cache()
    del flat_params, flat_opt
    split_flash(torch, card, originals["flash_attention"],
                plain["flash_attention"])

    # ---- a checkpoint at step 2 on SAVE_MESH, step 3 on other meshes
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        saver = trainer(SAVE_MESH, ckpt_dir=f"{tmp}/save",
                        ckpt_every=ATTN_TRAIN_STEPS + 1)
        saver.run(MESH_SAVE_AT)
        save_s = time.perf_counter() - t0
        assert saver.ckpt.committed_steps() == [MESH_SAVE_AT]
        del saver
        torch.cuda.empty_cache()
        batch = {k: torch.from_numpy(v).to(DEVICE)
                 for k, v in synth_batch(cfg, shape, MESH_SAVE_AT).items()}
        for mesh_shape in RESUME_MESHES:
            tag = "x".join(map(str, mesh_shape))
            d = f"{tmp}/{tag}"
            shutil.copytree(f"{tmp}/save", d, copy_function=os.link)
            t0 = time.perf_counter()
            tr = trainer(mesh_shape, ckpt_dir=d)
            params, opt, start = tr.init_or_restore()
            restore_s = time.perf_counter() - t0
            assert start == MESH_SAVE_AT
            hold_blocks(tr, params, opt)
            _, _, m = tr.step_fn(params, opt, batch)
            loss = float(m["loss"])
            np.testing.assert_allclose(loss, uninterrupted[MESH_SAVE_AT],
                                       rtol=RESUME_RTOL)
            print(f"mesh train resume: saved at step {MESH_SAVE_AT} on "
                  f"{'x'.join(map(str, SAVE_MESH))} ({save_s:.1f} s, the "
                  f"run included), restored on {tag} ({restore_s:.1f} s): "
                  f"step {MESH_SAVE_AT + 1} loss {loss} against the "
                  f"uninterrupted run's {uninterrupted[MESH_SAVE_AT]} "
                  f"(rtol {RESUME_RTOL})")
            del tr, params, opt
            torch.cuda.empty_cache()
    print(f"mesh train phase: {time.perf_counter() - t_phase:.1f} s; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          "GiB")
    return rows


def mesh_train_cut():
    """(config, shape) of phase 10's training and phase 18's: llama3.2-3b
    at its widths, ATTN_TRAIN_LAYERS layers, fp32, ATTN_TRAIN_BATCH x
    ATTN_TRAIN_SEQ."""
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import ShapeConfig
    cfg = ARCHS[ATTN_TRAIN_ARCH].replace(num_layers=ATTN_TRAIN_LAYERS,
                                         dtype="float32")
    return cfg, ShapeConfig("mesh", "train", ATTN_TRAIN_SEQ,
                            ATTN_TRAIN_BATCH)


def sha(torch, t) -> str:
    """sha256 of a tensor's bytes."""
    import hashlib
    b = t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy()
    return hashlib.sha256(b.tobytes()).hexdigest()


def slot_digests(torch, mesh, params, opt) -> dict:
    """{slot: sha of each leaf's block of the parameters, then of the
    optimizer state} for this process's slots of ``mesh``."""
    from repro_torch.models import layers as L
    leaves = L.tree_leaves(params) + L.tree_leaves(opt)
    return {str(i): [sha(torch, a.blocks[i]) for a in leaves]
            for i in mesh.local_slots()}


def kept_run(torch, tr, params, opt, med_ms) -> dict:
    """What phase 18 holds a run in several processes to: each step's
    metrics, the median step ms, each slot's block digests and each
    leaf's whole digest under its checkpoint key."""
    from repro_torch.models import layers as L
    from repro_torch.train import sharded as S
    tree = {"params": params, "opt": opt}
    return {"metrics": [{k: m[k] for k in PROC_METRICS}
                        for m in tr.metrics_log],
            "median_ms": med_ms,
            "slots": slot_digests(torch, tr.mesh, params, opt),
            "leaves": {"/".join(map(str, path)): sha(torch, S.gather(leaf))
                       for path, leaf in L.tree_items(tree)}}


def proc_train_rank(rank: int, init_file: str, out: str) -> None:
    """One of phase 18's two processes at PROC_TRAIN_MESHES["2x2"]: a
    gloo group over ``init_file``, this process's pool two slots of the
    card (one data row), 3 steps of phase 10's cut split with ZeRO-1;
    its metrics, launch counts, step ms, slots' block digests and
    ``max_memory_allocated`` as JSON in ``out``."""
    import torch

    from repro_torch import kernels
    from repro_torch.launch import procs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build
    from repro_torch.train import Trainer

    group = procs.init("cuda", rank=rank, world_size=PROC_WORLD,
                       init_method=f"file://{init_file}",
                       timeout_s=PROC_TIMEOUT_S)
    try:
        cfg, shape = mesh_train_cut()
        mesh = make_host_mesh(devices=[MESH_SLOT] * 2)
        assert mesh.devices.shape == PROC_TRAIN_MESHES["2x2"], mesh
        tr = Trainer(build(cfg, tp=mesh.shape["model"]), shape, mesh=mesh,
                     zero1=True)
        kernels.reset_launch_counts()
        params, opt, step = tr.run(ATTN_TRAIN_STEPS)
        launches = kernels.launch_counts()
        torch.cuda.synchronize()
        with open(out, "w") as f:
            json.dump({"rank": rank, "step": step,
                       "ranks": mesh.ranks.tolist(), "moved": group.moved,
                       "metrics": tr.metrics_log, "launches": launches,
                       "slots": slot_digests(torch, mesh, params, opt),
                       "peak": torch.cuda.max_memory_allocated()}, f)
    finally:
        procs.close()


def wait_all(procs_, what: str, timeout_s: float) -> None:
    """Every process of ``procs_`` (``Popen`` or ``multiprocessing``)
    exits 0 within ``timeout_s``; a failure or the deadline kills the
    others and fails the phase."""
    def code(p):
        return p.poll() if hasattr(p, "poll") else p.exitcode

    deadline = time.monotonic() + timeout_s
    while any(code(p) is None for p in procs_):
        if time.monotonic() > deadline or any(
                code(p) not in (None, 0) for p in procs_):
            break
        time.sleep(0.2)
    for p in procs_:
        if code(p) is None:
            p.kill()
        p.wait() if hasattr(p, "poll") else p.join()
    codes = [code(p) for p in procs_]
    assert codes == [0] * len(procs_), (what, codes)


def step_ms(metrics) -> tuple[list, float]:
    """Each step's ms, and the median of the steps after the first."""
    ms = [round(m["dt"] * 1e3, 3) for m in metrics]
    return ms, float(np.median(ms[1:]))


def proc_train_phase(torch, card, keep) -> None:
    """Phase 18: phase 10's cut trained by two processes on the one card,
    each holding bit for bit to phase 10's single-process run on the
    same mesh (see the module docstring)."""
    import multiprocessing
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"proc train: {PROC_WORLD} processes on one card; this process "
          f"keeps {torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated")
    tmp = tempfile.mkdtemp(prefix="proc_train_")
    try:
        # ---- (2, 2): each process one data row of two model slots, split
        ctx = multiprocessing.get_context("spawn")
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(PROC_WORLD)]
        ps = [ctx.Process(target=proc_train_rank, name=f"proc-train-{r}",
                          args=(r, os.path.join(tmp, "init"), outs[r]))
              for r in range(PROC_WORLD)]
        t0 = time.perf_counter()
        for p in ps:
            p.start()
        wait_all(ps, "proc train 2x2", PROC_TIMEOUT_S)
        hold_proc_runs(card, "2x2 (split, ZeRO-1)", keep["2x2"],
                       [json.load(open(o)) for o in outs],
                       time.perf_counter() - t0)

        # ---- (2, 1) through the launcher under torchrun's environment
        ckpt, report = os.path.join(tmp, "ckpt"), os.path.join(tmp, "report")
        cfg, shape = mesh_train_cut()
        argv = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                ATTN_TRAIN_ARCH, "--layers", str(cfg.num_layers), "--dtype",
                cfg.dtype, "--batch", str(shape.global_batch), "--seq",
                str(shape.seq_len), "--steps", str(ATTN_TRAIN_STEPS),
                "--mesh", "--zero1", "--ckpt", ckpt, "--report", report]
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   WORLD_SIZE=str(PROC_WORLD), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(free_port()))
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
        logs = [open(os.path.join(tmp, f"launcher{r}.log"), "w+")
                for r in range(PROC_WORLD)]
        t0 = time.perf_counter()
        ps = [subprocess.Popen(argv, cwd=ROOT, stdout=logs[r],
                               stderr=subprocess.STDOUT,
                               env=dict(env, RANK=str(r), LOCAL_RANK=str(r)))
              for r in range(PROC_WORLD)]
        try:
            wait_all(ps, "proc train 2x1 launcher", PROC_TIMEOUT_S)
        finally:
            for r, log in enumerate(logs):
                log.seek(0)
                text = log.read().strip()
                print(f"proc train launcher rank {r}: "
                      f"{text.splitlines()[-1] if text else '(no output)'}")
                log.close()
        runs = [json.load(open(f"{report}.{r}")) for r in range(PROC_WORLD)]
        hold_proc_runs(card, "2x1 (gathered, ZeRO-1, the launcher)",
                       keep["2x1"], runs, time.perf_counter() - t0,
                       checkpointed=True)
        hold_checkpoint(ckpt, ATTN_TRAIN_STEPS, keep["2x1"]["leaves"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"proc train phase: {time.perf_counter() - t_phase:.1f} s  "
          f"[{card}]")


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def hold_proc_runs(card, tag, want, runs, seconds,
                   checkpointed=False) -> None:
    """Each process's run against phase 10's single-process one: its
    metrics bit for bit, its slots' block digests (where it reports
    them), rmsnorm's and flash_attention's launches > 0; its step ms
    beside the single process's."""
    mesh = PROC_TRAIN_MESHES[tag[:3]]
    for run in runs:
        r = run["rank"]
        assert tuple(np.shape(run["ranks"])) == mesh, (tag, r, run["ranks"])
        got = [{k: m[k] for k in PROC_METRICS} for m in run["metrics"]]
        assert got == want["metrics"], (tag, r, got, want["metrics"])
        assert run["step"] == ATTN_TRAIN_STEPS, (tag, r, run["step"])
        assert all(run["launches"][k] > 0 for k in TRAIN_KERNELS), \
            (tag, r, run["launches"])
        slots = run["slots"]
        mine = [str(i) for i, o in enumerate(np.ravel(run["ranks"]))
                if o == r]
        assert sorted(slots) == mine, (tag, r, sorted(slots), mine)
        for i, digests in slots.items():
            assert digests == want["slots"][i], (tag, r, i)
        ms, med = step_ms(run["metrics"])
        moved = run["moved"]
        print(f"proc train {tag} rank {r}: the transport sent "
              f"{moved['sent'] / 1e9:.3f} GB and received "
              f"{moved['received'] / 1e9:.3f} GB over the run, "
              f"{moved['seconds']:.3f} s inside send and recv (waits "
              f"included) beside {sum(m['dt'] for m in run['metrics']):.3f}"
              f" s of {len(ms)} steps"
              + (", the final checkpoint's gather included in the bytes "
                 "and seconds" if checkpointed else ""))
        print(f"proc train {tag} rank {r} of {len(runs)} (mesh {mesh}): "
              f"metrics and its slots {mine}' blocks of the parameters and "
              f"moments equal the single-process run's bit for bit; launches "
              f"{ {k: run['launches'][k] for k in TRAIN_KERNELS} }; step ms "
              f"{ms}, median of the rest {med:.3f} against the single "
              f"process's {want['median_ms']:.3f}"
              + (f"; max_memory_allocated {run['peak'] / 2**30:.3f} GiB"
                 if "peak" in run else "") + f"  [{card}]")
    print(f"proc train {tag}: {seconds:.1f} s, the processes' start "
          "included")


def hold_checkpoint(ckpt: str, step: int, want: dict) -> None:
    """The launcher's final checkpoint, written once by slot 0's
    process: every leaf's bytes equal phase 10's (2, 1) run's."""
    import hashlib
    d = os.path.join(ckpt, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    assert sorted(manifest["leaves"]) == sorted(want), \
        (sorted(manifest["leaves"]), sorted(want))
    for key, meta in manifest["leaves"].items():
        arr = np.load(os.path.join(d, meta["file"]))
        got = hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()
        assert got == want[key], key
    print(f"proc train 2x1 checkpoint: {len(want)} leaves at step {step}, "
          "each equal to the single-process run's bit for bit")


def mesh_generate(torch, serve, params, inp, prompt: int, steps: int,
                  seq: int):
    """``dense_generate`` through ``MeshServe`` (``serve``, parameters
    laid out on its mesh): the prefill (of the frames too, for an
    encoder-decoder) into fresh caches laid out by its specs, then
    ``steps`` teacher-forced decode steps (each step's offsets read from
    its ``lengths``; an encoder-decoder's fed the encoder's output the
    prefill laid out).  Returns each call's logits as laid out (a
    ``sharded.Laid`` at the logits spec), the prefill's and each step's
    seconds (host clock to a synchronize) and the caches."""
    b = inp["tokens"].shape[0]
    caches = serve.init_caches(b, seq)
    first = {k: v for k, v in inp.items() if k != "tokens"}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, caches, *enc = serve.prefill(params, serve.lay_out_inputs(
        {"tokens": inp["tokens"][:, :prompt], **first}), caches)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    logits, step_s = [lg], []
    lengths = torch.full((b,), prompt, dtype=torch.int32, device=DEVICE)
    for i in range(prompt, prompt + steps):
        t0 = time.perf_counter()
        batch = serve.lay_out_inputs({"tokens": inp["tokens"][:, i:i + 1],
                                      "lengths": lengths})
        if enc:
            batch["enc_out"] = enc[0]
        lg, caches = serve.decode(params, batch, caches)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        logits.append(lg)
        lengths = lengths + 1
    return logits, prefill_s, step_s, caches


def mesh_serve_phase(torch, card) -> list[dict]:
    """Phase 12: serving on the model axis (see the module docstring).
    Returns the ``kernels`` rows of the (1, 16) run, keyed ``"path":
    "mesh serve"``."""
    from repro_torch import kernels
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import MeshServe
    from repro_torch.models import build, layers as L
    from repro_torch.train import sharded as S

    names = LM_KERNELS + ("decode_attention_partial",)
    plain = {"rmsnorm": ref.rmsnorm_ref,
             "flash_attention": ref.attention_ref,
             "decode_attention": ref.decode_attention_ref,
             "decode_attention_partial": ref.decode_attention_partial_ref}
    originals = {name: getattr(ops, name) for name in names}
    t_phase = time.perf_counter()
    cfg = ARCHS[DENSE_ARCH].replace(num_layers=DENSE_LAYERS)
    params = build(cfg).init_params(0, DEVICE)
    rows = []
    for (d, m), long_mode in MESH_SERVE:
        t0 = time.perf_counter()
        tag = f"mesh serve {d}x{m}" + (" long mode" if long_mode else "")
        b, steps = (1, MESH_SERVE_LONG_STEPS) if long_mode \
            else (DENSE_BATCH, DENSE_STEPS)
        inp = dense_inputs(torch, cfg, b, DENSE_PROMPT, steps)
        want, _, _, (want_caches, _, _) = dense_generate(
            torch, build(cfg), params, inp, DENSE_PROMPT, steps, DENSE_SEQ)
        want = torch.stack(want, 1)
        mesh = make_host_mesh(shape=(d, m), devices=[MESH_SLOT] * (d * m))
        serve = MeshServe(build(cfg, tp=m), mesh, long_mode=long_mode)
        assert serve.split
        laid = serve.lay_out_params(params)
        run = lambda n: mesh_generate(  # noqa: E731
            torch, serve, laid, inp, DENSE_PROMPT, n, DENSE_SEQ)
        run(2)                          # warm: cuBLAS's plans, allocator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with recording(torch, ops, names) as recorded:
            kernels.reset_launch_counts()
            out, pre_s, step_s, caches = run(steps)
            launches = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated() - base
        by_positions = m == 16 or long_mode
        decode = "decode_attention_partial" if by_positions \
            else "decode_attention"
        print(f"{tag} main path launches: {launches}")
        assert launches["rmsnorm"] > 0 and launches["flash_attention"] > 0 \
            and launches[decode] > 0, (tag, launches)
        for name in names:
            assert sum(c for _, _, c in recorded[name].values()) \
                == launches[name], (tag, name)
        v, rows_a_block = cfg.vocab_size, b if long_mode else b // d
        for lg in out:
            assert lg.shape == (b, 1, v)
            for j, blk in enumerate(lg.blocks):
                assert tuple(blk.shape) == (rows_a_block, 1, v // m), \
                    (tag, j, blk.shape)
        got = torch.stack([S.gather(lg)[:, 0].float() for lg in out], 1)
        assert torch.isfinite(got).all()
        step = np.asarray(step_s)
        print(f"{tag}: prefill {b} x {DENSE_PROMPT} in {pre_s * 1e3:.3f} ms; "
              f"decode {len(step)} steps at batch {b}, best "
              f"{step.min() * 1e3:.3f} ms, median "
              f"{np.median(step) * 1e3:.3f} ms a step; "
              f"max_memory_allocated {peak / 1e9:.3f} GB above the "
              f"{base / 1e9:.3f} GB held before it (the slots share one "
              f"card's SMs and memory: overhead, not scaling)  [{card}]")
        compare_logits(torch, "split vs unmeshed (phase 8's path)", got,
                       want, scale_tol=TOL_BF16, prefix=tag)
        # each slot's block of every cache: the rows its spec gives it
        worst = 0.0
        for (path, blk_laid), whole in zip(
                L.tree_items(caches), L.tree_leaves(want_caches)):
            lay = blk_laid.layout
            for j, c in enumerate(lay.coords()):
                sl = lay.block_slices(whole.shape, c)
                blk = blk_laid.blocks[j]
                assert tuple(blk.shape) == tuple(whole[sl].shape), \
                    (tag, path, j, blk.shape)
                worst = max(worst, float((blk.float() - whole[sl].float())
                                         .abs().max()))
        scale = max(float(w.float().abs().max())
                    for w in L.tree_leaves(want_caches))
        print(f"{tag}: every slot's cache blocks the shapes their specs give"
              f" and within {worst:.4g} of the unmeshed caches' rows (tol "
              f"{TOL_BF16} x {scale:.3g})")
        assert worst <= TOL_BF16 * scale, (tag, worst, scale)
        # the same split run on the plain versions: the witness
        with wrappers_as(ops, plain):
            p_out = run(steps)[0]
        compare_logits(torch, "split kernels vs split plain versions", got,
                       torch.stack([S.gather(lg)[:, 0].float()
                                    for lg in p_out], 1),
                       scale_tol=TOL_BF16, prefix=tag)
        errs = {k: max((hold_to_plain(torch, k, originals[k], plain[k], a,
                                      kw)
                        for a, kw, _ in recorded[k].values()), default=0.0)
                for k in names}
        print(f"{tag}: each kernel call against its plain version, max abs "
              f"err {errs} (tol {TOL_BF16} on bf16 outputs, "
              f"{TOL['decode_attention_partial']} on the partial's fp32 out "
              "and lse)")
        if by_positions:             # a slot's block at length 0, too
            name = "decode_attention_partial"
            err = 0.0
            for a, kw, _ in recorded[name].values():
                lengths = a[4].clone()
                lengths[0] = 0
                empty = a[:4] + (lengths,)
                err = max(err, hold_to_plain(torch, name, originals[name],
                                             plain[name], empty, kw))
                o, lse = originals[name](*empty, **kw)
                assert not o[0].any() and bool(torch.isneginf(lse[0]).all())
            print(f"{tag}: decode_attention_partial's recorded calls with "
                  f"sequence 0's block at length 0: zeros and -inf there, "
                  f"max abs err {err:.3g} against the plain version")
        if f"{d}x{m}" == MESH_SERVE_ROWS:
            rows += dense_rows(torch, card, {
                k: recorded[k] for k in ("flash_attention",
                                         "decode_attention_partial")},
                originals, plain, path="mesh serve",
                extra={"mesh": MESH_SERVE_ROWS})
        print(f"{tag}: {time.perf_counter() - t0:.1f} s")
        del serve, laid, out, p_out, caches, recorded, want_caches
        torch.cuda.empty_cache()
    print(f"mesh serve phase: {time.perf_counter() - t_phase:.1f} s")
    del params
    torch.cuda.empty_cache()
    return rows


def moe_serve(torch, card, arch, layers, meshes, originals, plain) -> list:
    """One MoE family's split serving runs of phase 13 (see the module
    docstring): the unmeshed run (phase 8's path) in bf16, on the plain
    versions too, and in fp32, each MoE call's routes recorded, then the
    same through ``MeshServe`` on each mesh.  The bf16 split run is held
    to the unmeshed one at the positions where the routes agree in both
    pairs, within 2e-2 of the scale plus the plain versions' pair's
    reading there (the split's own rounding: each slot's partial output
    rounded to bf16 before the sum, 16 of them at (1, 16)); the fp32 one
    within DENSE_FP32_TOL; the bf16 one to its run on the plain versions.
    Returns the ``kernels`` rows of the MOE_ROWS_MESH run."""
    from repro_torch import kernels
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import MeshServe
    from repro_torch.models import build
    from repro_torch.train import sharded as S

    names = tuple(originals)
    cfg = ARCHS[arch].replace(num_layers=layers)
    widest = max(m for _, m in meshes)   # the heads padded as it pads them
    params = build(cfg, tp=widest).init_params(0, DEVICE)
    b, prompt, steps, seq = (MOE_SERVE_BATCH, MOE_SERVE_PROMPT,
                             MOE_SERVE_STEPS, MOE_SERVE_SEQ)
    inp = dense_inputs(torch, cfg, b, prompt, steps)
    reach = moe_reach(cfg)
    mc = cfg.moe
    unmeshed = {}
    for dtype, fns in (("bfloat16", {}), ("plain", plain),
                       ("float32", {})):
        with wrappers_as(ops, fns), routes_recorded(torch) as routes:
            lg = dense_generate(torch, build(cfg.replace(
                dtype="float32" if dtype == "float32" else cfg.dtype),
                tp=widest), params, inp, prompt, steps, seq)[0]
        unmeshed[dtype] = (torch.stack(lg, 1), routes)
    rows = []
    for d, m in meshes:
        t0 = time.perf_counter()
        tag = f"moe axis {arch} {d}x{m}"
        mesh = make_host_mesh(shape=(d, m), devices=[MESH_SLOT] * (d * m))
        serve = MeshServe(build(cfg, tp=m), mesh)
        assert serve.split
        laid = serve.lay_out_params(params)
        ffn = laid["stack"][0]["ffn"]
        experts = {tuple(blk.shape) for blk in ffn["w_in"].blocks}
        assert experts == {(cfg.n_periods, mc.num_experts // m, cfg.d_model,
                            mc.d_ff or cfg.d_ff)}, (tag, experts)
        run = lambda n, srv=serve: mesh_generate(  # noqa: E731
            torch, srv, laid, inp, prompt, n, seq)
        run(1)                          # warm: cuBLAS's plans, allocator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with recording(torch, ops, names) as recorded, \
                routes_recorded(torch) as routes:
            kernels.reset_launch_counts()
            out, pre_s, step_s, _ = run(steps)
            launches = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated() - base
        by_positions = cfg.num_kv_heads % m != 0
        decode = "decode_attention_partial" if by_positions \
            else "decode_attention"
        print(f"{tag} main path launches: {launches}")
        assert launches["rmsnorm"] > 0 and launches["flash_attention"] > 0 \
            and launches[decode] > 0, (tag, launches)
        v = cfg.vocab_size
        for lg in out:
            assert lg.shape == (b, 1, v)
            assert all(tuple(blk.shape) == (b, 1, v // m)
                       for blk in lg.blocks), tag
        got = torch.stack([S.gather(lg)[:, 0].float() for lg in out], 1)
        assert torch.isfinite(got).all()
        step = np.asarray(step_s)
        shared = " and 1/" + str(m) + " of the shared expert's columns" \
            if mc.num_shared else ""
        print(f"{tag} ({cfg.num_layers} layers, d_model {cfg.d_model}, "
              f"{cfg.num_heads}/{cfg.num_kv_heads} heads, "
              f"{mc.num_experts} experts top {mc.top_k}; "
              f"{mc.num_experts // m} experts{shared} a slot, caches by "
              f"{'positions' if by_positions else 'KV heads'}): prefill "
              f"{b} x {prompt} in {pre_s * 1e3:.3f} ms; decode {len(step)} "
              f"steps, best {step.min() * 1e3:.3f} ms, median "
              f"{np.median(step) * 1e3:.3f} ms a step; max_memory_allocated "
              f"{peak / 1e9:.3f} GB above the {base / 1e9:.3f} GB held "
              f"before it  [{card}]")
        # the same split run on the plain versions
        with wrappers_as(ops, plain), routes_recorded(torch) as routes_p:
            p_out = run(steps)[0]
        got_p = torch.stack([S.gather(lg)[:, 0].float() for lg in p_out], 1)
        want, routes_u = unmeshed["bfloat16"]
        want_p, routes_up = unmeshed["plain"]
        compare_logits(torch, "split vs unmeshed (phase 8's path), bf16, "
                       "every position", got, want, prefix=tag)
        both = [a & b for a, b in zip(
            agreeing_positions(torch, routes, routes_u, reach, prompt - 1,
                               got.shape[1]),
            agreeing_positions(torch, routes_p, routes_up, reach, prompt - 1,
                               got.shape[1]))]
        compare_routed(torch, "split vs unmeshed (phase 8's path), bf16",
                       got, want, both, prefix=tag, witness=(got_p, want_p))
        # fp32: the same split run against the unmeshed fp32 run
        serve32 = MeshServe(build(cfg.replace(dtype="float32"), tp=m), mesh)
        with routes_recorded(torch) as routes32:
            out32 = run(steps, serve32)[0]
        got32 = torch.stack([S.gather(lg)[:, 0].float() for lg in out32], 1)
        want32, routes32_u = unmeshed["float32"]
        compare_routed(torch, "split vs unmeshed (phase 8's path), fp32",
                       got32, want32, agreeing_positions(
                           torch, routes32, routes32_u, reach, prompt - 1,
                           got32.shape[1]), prefix=tag, tol=DENSE_FP32_TOL)
        compare_routed(torch, "split kernels vs split plain versions", got,
                       got_p, agreeing_positions(
                           torch, routes, routes_p, reach, prompt - 1,
                           got.shape[1]), prefix=tag)
        errs = {k: max((hold_to_plain(torch, k, originals[k], plain[k], a,
                                      kw)
                        for a, kw, _ in recorded[k].values()), default=0.0)
                for k in names}
        print(f"{tag}: each kernel call against its plain version, max abs "
              f"err {errs} (tol {TOL_BF16} on bf16 outputs, "
              f"{TOL['decode_attention_partial']} on the partial's fp32 out "
              "and lse)")
        if f"{d}x{m}" == MOE_ROWS_MESH:
            rows += dense_rows(torch, card, recorded, originals, plain,
                               path="mesh_serve_moe",
                               extra={"arch": arch, "mesh": MOE_ROWS_MESH})
        print(f"{tag}: {time.perf_counter() - t0:.1f} s")
        del serve, serve32, laid, out, out32, p_out, recorded
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return rows


def moe_axis_phase(torch, card) -> list[dict]:
    """Phase 13: MoE experts on the model axis (see the module
    docstring).  Returns the ``kernels`` rows of the (1, 16) serving runs,
    keyed ``"path": "mesh_serve_moe"``."""
    from repro_torch import kernels
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build, layers as L
    from repro_torch.train import Trainer, sharded as S

    t_phase = time.perf_counter()
    names = LM_KERNELS + ("decode_attention_partial",)
    plain = {"rmsnorm": ref.rmsnorm_ref,
             "flash_attention": ref.attention_ref,
             "decode_attention": ref.decode_attention_ref,
             "decode_attention_partial": ref.decode_attention_partial_ref}
    originals = {name: getattr(ops, name) for name in names}
    rows = []
    for arch, layers, meshes in MOE_SERVE:
        rows += moe_serve(torch, card, arch, layers, meshes, originals, plain)

    # ---- training: the unmeshed Trainer, then each mesh, split
    base = ARCHS[MOE_TRAIN_ARCH]
    mc = base.moe
    cfg = base.replace(num_layers=MOE_TRAIN_LAYERS, dtype="float32",
                       moe=replace(mc, capacity_factor=mc.num_experts
                                   / mc.top_k))
    shape = ShapeConfig("moe", "train", MOE_TRAIN_SEQ, MOE_TRAIN_BATCH)
    tokens = MOE_TRAIN_BATCH * MOE_TRAIN_SEQ
    flat = Trainer(build(cfg), shape, device=DEVICE)
    kernels.reset_launch_counts()
    flat_params, flat_opt, _ = flat.run(MOE_TRAIN_STEPS)
    assert all(kernels.launch_counts()[k] > 0 for k in TRAIN_KERNELS)
    want = {key: [m[key] for m in flat.metrics_log]
            for key in ("loss", "grad_norm")}

    def step_ms(tr):
        dts = np.asarray([m["dt"] for m in tr.metrics_log]) * 1e3
        return float(dts[1:].min()), float(np.median(dts[1:]))

    best, med = step_ms(flat)
    print(f"moe axis train {MOE_TRAIN_ARCH} ({cfg.num_layers} of "
          f"{base.num_layers} layers, fp32, {mc.num_experts} experts top "
          f"{mc.top_k} at capacity factor {cfg.moe.capacity_factor}: no "
          f"token drops) unmeshed: losses {want['loss']}; step ms best "
          f"{best:.3f}, median {med:.3f} (after the first), "
          f"{tokens / med * 1e3:.1f} tokens/s  [{card}]")
    del flat

    def meshed(mesh_shape):
        d, m = mesh_shape
        mesh = make_host_mesh(shape=mesh_shape, devices=[MESH_SLOT] * (d * m))
        return Trainer(build(cfg, tp=m), shape, mesh=mesh, zero1=d > 1)

    def yardstick(ys):
        """(metrics, params, moments) of the gathered run on ``ys``, whole."""
        tr = meshed(ys)
        params, opt, _ = tr.run(MOE_TRAIN_STEPS)
        got = {key: [x[key] for x in tr.metrics_log]
               for key in ("loss", "grad_norm")}
        print(f"moe axis train {ys[0]}x{ys[1]} (gathered, zero1 "
              f"{ys[0] > 1}): losses {got['loss']}, grad_norm "
              f"{got['grad_norm']}; the yardstick of the split runs on "
              f"{ys[0]} data shards")
        return got, L.tree_map(S.gather, params), {
            k: L.tree_map(S.gather, opt[k]) for k in ("m", "v")}

    current = (None, (want, flat_params, flat_opt))
    del flat_params, flat_opt
    for d, m in MOE_TRAIN_MESHES:
        tag = f"moe axis train {d}x{m}"
        ys = MOE_TRAIN_YARDSTICK[d, m]
        if current[0] != ys:            # one yardstick's state at a time
            current = None
            torch.cuda.empty_cache()
            current = (ys, yardstick(ys))
        y_met, y_params, y_opt = current[1]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tr = meshed((d, m))
        assert m > 1 and tr.api.model_split()     # the split step
        kernels.reset_launch_counts()
        params, opt, _ = tr.run(MOE_TRAIN_STEPS)
        launches = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated() - held
        assert all(launches[k] > 0 for k in TRAIN_KERNELS), (tag, launches)
        got = {key: [x[key] for x in tr.metrics_log]
               for key in ("loss", "grad_norm")}
        for key in got:
            np.testing.assert_allclose(got[key], y_met[key],
                                       rtol=RESUME_RTOL, err_msg=f"{tag} {key}")
        off = max(abs(a - b) / abs(b) for a, b in zip(got["loss"],
                                                      want["loss"]))
        errs = {part: hold_state(torch, f"{tag} {part}", a, w, False)
                for part, a, w in (("params", params, y_params),
                                   ("m", opt["m"], y_opt["m"]),
                                   ("v", opt["v"], y_opt["v"]))}
        hold_blocks(tr, params, opt)
        w_in = L.tree_leaves(params["stack"][0]["ffn"]["w_in"])[0]
        best, med = step_ms(tr)
        yard = "the unmeshed Trainer" if ys is None else \
            f"the gathered {ys[0]}x{ys[1]} run"
        print(f"{tag} main path launches: {launches}")
        print(f"{tag} (zero1 {d > 1}; {mc.num_experts // m} experts a slot, "
              f"w_in blocks {tuple(w_in.blocks[0].shape)}): losses "
              f"{got['loss']} and grad_norm {got['grad_norm']} within rtol "
              f"{RESUME_RTOL} of {yard}'s, every leaf: max error / leaf "
              f"max {errs} (tol {MESH_TRAIN_TOL}); the losses' largest "
              f"relative distance from the unmeshed Trainer's {off:.3g}; "
              f"step ms best {best:.3f}, median "
              f"{med:.3f}, {tokens / med * 1e3:.1f} tokens/s; "
              f"max_memory_allocated {peak / 1e9:.3f} GB above the "
              f"{held / 1e9:.3f} GB held before it  [{card}]")
        del tr, params, opt, y_params, y_opt
        torch.cuda.empty_cache()
    del current
    torch.cuda.empty_cache()
    print(f"moe axis phase: {time.perf_counter() - t_phase:.1f} s")
    return rows


def mla_axis_phase(torch, card):
    """Phase 14: MLA on the model axis (see the module docstring).
    Returns a function that gives the ``kernels`` rows of the (1, 16)
    serving run, keyed ``"path": "mesh_serve_mla"``, timed when it is
    called: after the dry run's join, with no dry-run process beside it
    on the host; each row's ``ms_beside_dryrun`` is the same timing
    taken in the phase, beside them."""
    from repro_torch import kernels
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import MeshServe
    from repro_torch.models import build, layers as L
    from repro_torch.train import Trainer, sharded as S

    t_phase = time.perf_counter()
    plain = {"rmsnorm": ref.rmsnorm_ref}
    originals = {"rmsnorm": ops.rmsnorm}
    base = ARCHS[MLA_ARCH]
    cfg = base.replace(num_layers=FAMILY_LAYERS)
    v, b = cfg.vocab_size, FAMILY_BATCH
    prompt, steps, seq = FAMILY_PROMPT, FAMILY_STEPS, FAMILY_SEQ
    inp = dense_inputs(torch, cfg, b, prompt, steps)
    extra = {"arch": MLA_ARCH, "mesh": MLA_ROWS_MESH}
    beside = kept = None
    for d, m in MLA_SERVE_MESHES:
        t0 = time.perf_counter()
        tag = f"mla axis {d}x{m}"
        api = build(cfg, tp=m)            # 40 heads, or padded to 48 at 16
        params = api.init_params(0, DEVICE)
        unmeshed = {}
        for what, dtype, fns in (("bf16", cfg.dtype, {}),
                                 ("plain", cfg.dtype, plain),
                                 ("fp32", "float32", {})):
            with wrappers_as(ops, fns):
                unmeshed[what] = torch.stack(dense_generate(
                    torch, build(cfg.replace(dtype=dtype), tp=m), params,
                    inp, prompt, steps, seq)[0], 1)
        mesh = make_host_mesh(shape=(d, m), devices=[MESH_SLOT] * (d * m))
        serve = MeshServe(api, mesh)
        assert serve.split
        laid = serve.lay_out_params(params)
        hp = api.param_defs()["stack"][0]["mixer"]["wuq"].shape[2]
        mix = laid["stack"][0]["mixer"]
        for key, dim in (("wuq", 2), ("wukv", 2), ("wo", 1)):
            assert {blk.shape[dim] for blk in mix[key].blocks} == {hp // m}, \
                (tag, key)
        rows_split = v % m == 0
        run = lambda n, srv=serve: mesh_generate(  # noqa: E731
            torch, srv, laid, inp, prompt, n, seq)
        run(1)                          # warm: cuBLAS's plans, allocator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        with recording(torch, ops, ("rmsnorm",)) as recorded:
            kernels.reset_launch_counts()
            out, pre_s, step_s, caches = run(steps)
            launches = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated() - base_mem
        print(f"{tag} main path launches: {launches}")
        assert launches["rmsnorm"] > 0, (tag, launches)
        for lg in out:
            assert lg.shape == (b, 1, v)
            assert all(tuple(blk.shape) == (b, 1, v // m if rows_split
                                            else v)
                       for blk in lg.blocks), tag
        for laid_c in L.tree_leaves(caches):     # positions over the slots
            assert all(blk.shape[-2] == seq // m for blk in laid_c.blocks), \
                (tag, laid_c.shape)
        got = torch.stack([S.gather(lg)[:, 0].float() for lg in out], 1)
        assert torch.isfinite(got).all()
        step = np.asarray(step_s)
        padded = f" padded to {hp}" if hp > cfg.num_heads else ""
        vocab = "vocabulary rows" if rows_split \
            else "row-parallel embedding and logits"
        print(f"{tag} ({cfg.num_layers} layers, d_model {cfg.d_model}, "
              f"{cfg.num_heads} heads{padded}, {hp // m} a slot, "
              f"{seq // m} cache positions a slot, {vocab}): prefill {b} x {prompt} in {pre_s * 1e3:.3f} ms; decode "
              f"{len(step)} steps, best {step.min() * 1e3:.3f} ms, median "
              f"{np.median(step) * 1e3:.3f} ms a step; max_memory_allocated "
              f"{peak / 1e9:.3f} GB above the {base_mem / 1e9:.3f} GB held "
              f"before it  [{card}]")
        with wrappers_as(ops, plain):
            p_out = run(steps)[0]
        got_p = torch.stack([S.gather(lg)[:, 0].float() for lg in p_out], 1)
        room = compare_logits(torch, "split plain versions vs unmeshed plain "
                              "versions (the witness), bf16", got_p,
                              unmeshed["plain"], prefix=tag)
        compare_logits(torch, "split vs unmeshed (phase 8's path), bf16",
                       got, unmeshed["bf16"], scale_tol=TOL_BF16, room=room,
                       prefix=tag)
        compare_logits(torch, "split kernels vs split plain versions, bf16",
                       got, got_p, scale_tol=TOL_BF16, prefix=tag)
        serve32 = MeshServe(build(cfg.replace(dtype="float32"), tp=m), mesh)
        got32 = torch.stack([S.gather(lg)[:, 0].float()
                             for lg in run(steps, serve32)[0]], 1)
        compare_logits(torch, "split vs unmeshed (phase 8's path), fp32",
                       got32, unmeshed["fp32"], tol=DENSE_FP32_TOL,
                       prefix=tag)
        err = max(hold_to_plain(torch, "rmsnorm", originals["rmsnorm"],
                                plain["rmsnorm"], a, kw)
                  for a, kw, _ in recorded["rmsnorm"].values())
        print(f"{tag}: each rmsnorm call against its plain version, max abs "
              f"err {err:.3g} (tol {TOL_BF16} on bf16 outputs)")
        if f"{d}x{m}" == MLA_ROWS_MESH:
            print(f"{tag}: its rmsnorm calls timed beside the dry run's "
                  "processes:")
            beside = dense_rows(torch, card, recorded, originals, plain,
                                path="mesh_serve_mla", extra=extra)
            kept = recorded
        print(f"{tag}: {time.perf_counter() - t0:.1f} s")
        del serve, serve32, laid, params, out, p_out, caches, recorded
        torch.cuda.empty_cache()

    # ---- training: the unmeshed Trainer of each padding, then each mesh
    cfg32 = cfg.replace(dtype="float32")
    shape = ShapeConfig("mla", "train", MLA_TRAIN_SEQ, MLA_TRAIN_BATCH)
    tokens = MLA_TRAIN_BATCH * MLA_TRAIN_SEQ

    def step_ms(tr):
        dts = np.asarray([x["dt"] for x in tr.metrics_log]) * 1e3
        return float(dts[1:].min()), float(np.median(dts[1:]))

    yard = {}
    for d, m in MLA_TRAIN_MESHES:
        tag = f"mla axis train {d}x{m}"
        if m not in yard:               # one yardstick's state at a time
            yard.clear()
            torch.cuda.empty_cache()
            flat = Trainer(build(cfg32, tp=m), shape, device=DEVICE)
            kernels.reset_launch_counts()
            f_params, f_opt, _ = flat.run(MLA_TRAIN_STEPS)
            assert kernels.launch_counts()["rmsnorm"] > 0
            want = {key: [x[key] for x in flat.metrics_log]
                    for key in ("loss", "grad_norm")}
            best, med = step_ms(flat)
            print(f"mla axis train unmeshed ({cfg.num_layers} of "
                  f"{base.num_layers} layers, fp32, heads padded as at model "
                  f"degree {m}): losses {want['loss']}; step ms best "
                  f"{best:.3f}, median {med:.3f} (after the first), "
                  f"{tokens / med * 1e3:.1f} tokens/s  [{card}]")
            yard[m] = (want, f_params, f_opt)
            del flat, f_params, f_opt
        want, f_params, f_opt = yard[m]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        mesh = make_host_mesh(shape=(d, m), devices=[MESH_SLOT] * (d * m))
        tr = Trainer(build(cfg32, tp=m), shape, mesh=mesh, zero1=d > 1)
        assert tr.api.model_split()
        kernels.reset_launch_counts()
        params, opt, _ = tr.run(MLA_TRAIN_STEPS)
        launches = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated() - held
        assert launches["rmsnorm"] > 0, (tag, launches)
        got = {key: [x[key] for x in tr.metrics_log]
               for key in ("loss", "grad_norm")}
        for key in got:
            np.testing.assert_allclose(got[key], want[key], rtol=RESUME_RTOL,
                                       err_msg=f"{tag} {key}")
        errs = {part: hold_state(torch, f"{tag} {part}", a, w, False)
                for part, a, w in (("params", params, f_params),
                                   ("m", opt["m"], f_opt["m"]),
                                   ("v", opt["v"], f_opt["v"]))}
        hold_blocks(tr, params, opt)
        best, med = step_ms(tr)
        loss = "row-parallel" if v % m else "by vocabulary rows"
        print(f"{tag} main path launches: {launches}")
        print(f"{tag} (zero1 {d > 1}; the loss {loss}): losses "
              f"{got['loss']} and grad_norm {got['grad_norm']} within rtol "
              f"{RESUME_RTOL} of the unmeshed Trainer's, every leaf: max "
              f"error / leaf max {errs} (tol {MESH_TRAIN_TOL}); step ms best "
              f"{best:.3f}, median {med:.3f}, {tokens / med * 1e3:.1f} "
              f"tokens/s; max_memory_allocated {peak / 1e9:.3f} GB above the "
              f"{held / 1e9:.3f} GB held before it  [{card}]")
        del tr, params, opt, f_params, f_opt
        torch.cuda.empty_cache()
    yard.clear()
    torch.cuda.empty_cache()
    print(f"mla axis phase: {time.perf_counter() - t_phase:.1f} s")

    def rows():
        print("mla axis 1x16: its rmsnorm calls timed again after the dry "
              "run's join:")
        out = dense_rows(torch, card, kept, originals, plain,
                         path="mesh_serve_mla", extra=extra)
        for row, was in zip(out, beside):
            row["ms_beside_dryrun"] = was["ms"]
        return out
    return rows


def hold_laid_blocks(what, laid_tree) -> None:
    """Every slot's block of a tree of ``sharded.Laid`` (parameters or
    caches) has the shape its spec gives."""
    from repro_torch.models import layers as L
    for path, laid in L.tree_items(laid_tree):
        want = slot_shape(laid.layout, laid.shape)
        assert all(tuple(blk.shape) == want for blk in laid.blocks), \
            (what, path, want)


def recurrent_axis_serve(torch, card, arch, layers, cases, originals,
                         plain) -> list:
    """One family's split serving runs of phase 15 (see the module
    docstring): the unmeshed run (phase 8's path) in bf16, on the plain
    versions too (and jamba's in fp32), each MoE call's routes recorded,
    then the same through ``MeshServe`` on each (mesh, long mode).
    Returns the ``kernels`` rows of the RA_ROWS_MESH run."""
    from repro_torch import kernels
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import MeshServe
    from repro_torch.models import build, layers as L
    from repro_torch.train import sharded as S

    base = ARCHS[arch]
    cfg = base if layers is None else base.replace(num_layers=layers)
    widest = max(m for (_, m), _ in cases)   # heads padded as it pads them
    params = build(cfg, tp=widest).init_params(0, DEVICE)
    prompt, steps, seq = RA_PROMPT, RA_STEPS, RA_SEQ
    moe = cfg.moe is not None
    reach = moe_reach(cfg) if moe else None
    names = tuple(originals)
    unmeshed = {}
    for b in sorted({1 if long_mode else RA_BATCH for _, long_mode in cases}):
        inp = dense_inputs(torch, cfg, b, prompt, steps)
        for what, dtype, fns in (("bf16", cfg.dtype, {}),
                                 ("plain", cfg.dtype, plain),
                                 ("fp32", "float32", {})):
            if what == "fp32" and not moe:
                continue
            with wrappers_as(ops, fns), routes_recorded(torch) as routes:
                lg = dense_generate(torch, build(cfg.replace(dtype=dtype),
                                                 tp=widest), params, inp,
                                    prompt, steps, seq)[0]
            unmeshed[b, what] = (torch.stack(lg, 1), routes)
    kinds = cfg.period_pattern * cfg.n_periods + cfg.remainder_kinds
    rows = []
    for (d, m), long_mode in cases:
        t0 = time.perf_counter()
        b = 1 if long_mode else RA_BATCH
        tag = f"recurrent axis {arch} {d}x{m}" + (" long" if long_mode
                                                  else "")
        inp = dense_inputs(torch, cfg, b, prompt, steps)
        mesh = make_host_mesh(shape=(d, m), devices=[MESH_SLOT] * (d * m))
        serve = MeshServe(build(cfg, tp=m), mesh, long_mode=long_mode)
        assert serve.split
        laid = serve.lay_out_params(params)
        hold_laid_blocks(tag, laid)
        run = lambda n, srv=serve: mesh_generate(  # noqa: E731
            torch, srv, laid, inp, prompt, n, seq)
        run(1)                          # warm: cuBLAS's plans, allocator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        with recording(torch, ops, names) as recorded, \
                routes_recorded(torch) as routes:
            kernels.reset_launch_counts()
            out, pre_s, step_s, caches = run(steps)
            launches = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated() - held
        print(f"{tag} main path launches: {launches}")
        assert launches["rmsnorm"] > 0, (tag, launches)
        if "attn" in kinds:
            by_positions = cfg.num_kv_heads % m != 0 or long_mode
            decode = "decode_attention_partial" if by_positions \
                else "decode_attention"
            assert launches["flash_attention"] > 0 \
                and launches[decode] > 0, (tag, launches)
        hold_laid_blocks(tag, caches)
        v = cfg.vocab_size
        for lg in out:
            assert lg.shape == (b, 1, v)
        got = torch.stack([S.gather(lg)[:, 0].float() for lg in out], 1)
        assert torch.isfinite(got).all()
        step = np.asarray(step_s)
        mixer = laid["stack" if cfg.n_periods else "rem"][0]["mixer"]
        w = mixer["in_proj" if "in_proj" in mixer else "up_proj"]
        print(f"{tag} ({cfg.num_layers} layers {kinds}, d_model "
              f"{cfg.d_model}; {w.blocks[0].shape[-1] // 2} inner channels "
              f"a slot): prefill {b} x {prompt} in {pre_s * 1e3:.3f} ms; "
              f"decode {len(step)} steps, best {step.min() * 1e3:.3f} ms, "
              f"median {np.median(step) * 1e3:.3f} ms a step; "
              f"max_memory_allocated {peak / 1e9:.3f} GB above the "
              f"{held / 1e9:.3f} GB held before it  [{card}]")
        with wrappers_as(ops, plain), routes_recorded(torch) as routes_p:
            p_out = run(steps)[0]
        got_p = torch.stack([S.gather(lg)[:, 0].float() for lg in p_out], 1)
        want, routes_u = unmeshed[b, "bf16"]
        want_p, routes_up = unmeshed[b, "plain"]
        if moe:
            compare_logits(torch, "split vs unmeshed (phase 8's path), "
                           "bf16, every position", got, want, prefix=tag)
            both = [x & y for x, y in zip(
                agreeing_positions(torch, routes, routes_u, reach,
                                   prompt - 1, got.shape[1]),
                agreeing_positions(torch, routes_p, routes_up, reach,
                                   prompt - 1, got.shape[1]))]
            compare_routed(torch, "split vs unmeshed (phase 8's path), bf16",
                           got, want, both, prefix=tag,
                           witness=(got_p, want_p), least=RA_ROUTED_LEAST)
            compare_routed(torch, "split kernels vs split plain versions",
                           got, got_p, agreeing_positions(
                               torch, routes, routes_p, reach, prompt - 1,
                               got.shape[1]), prefix=tag)
        else:
            room = compare_logits(torch, "split plain versions vs unmeshed "
                                  "plain versions (the witness), bf16",
                                  got_p, want_p, prefix=tag)
            compare_logits(torch, "split vs unmeshed (phase 8's path), bf16",
                           got, want, scale_tol=TOL_BF16, room=room,
                           prefix=tag)
            compare_logits(torch, "split kernels vs split plain versions, "
                           "bf16", got, got_p, scale_tol=TOL_BF16,
                           prefix=tag)
        if moe and not long_mode:
            serve32 = MeshServe(build(cfg.replace(dtype="float32"), tp=m),
                                mesh)
            with routes_recorded(torch) as routes32:
                out32 = run(steps, serve32)[0]
            got32 = torch.stack([S.gather(lg)[:, 0].float()
                                 for lg in out32], 1)
            want32, routes32_u = unmeshed[b, "fp32"]
            compare_routed(torch, "split vs unmeshed (phase 8's path), "
                           "fp32", got32, want32, agreeing_positions(
                               torch, routes32, routes32_u, reach,
                               prompt - 1, got32.shape[1]), prefix=tag,
                           tol=RA_FP32_TOL)
            del serve32, out32
        errs = {k: max((hold_to_plain(torch, k, originals[k], plain[k], a,
                                      kw)
                        for a, kw, _ in recorded[k].values()), default=0.0)
                for k in names}
        print(f"{tag}: each kernel call against its plain version, max abs "
              f"err {errs} (tol {TOL_BF16} on bf16 outputs, "
              f"{TOL['decode_attention_partial']} on the partial's fp32 out "
              "and lse)")
        if f"{d}x{m}" == RA_ROWS_MESH and "attn" in kinds:
            rows += dense_rows(torch, card, recorded, originals, plain,
                               path="mesh_serve_recurrent",
                               extra={"arch": arch, "mesh": RA_ROWS_MESH})
        print(f"{tag}: {time.perf_counter() - t0:.1f} s")
        del serve, laid, out, p_out, caches, recorded
        torch.cuda.empty_cache()
    del params
    unmeshed.clear()
    torch.cuda.empty_cache()
    return rows


def recurrent_axis_phase(torch, card) -> list[dict]:
    """Phase 15: the recurrent mixers on the model axis (see the module
    docstring).  Returns the ``kernels`` rows of jamba's (1, 16) serving
    run, keyed ``"path": "mesh_serve_recurrent"``."""
    from repro_torch import kernels
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build, layers as L
    from repro_torch.train import Trainer

    t_phase = time.perf_counter()
    plain = {"rmsnorm": ref.rmsnorm_ref,
             "flash_attention": ref.attention_ref,
             "decode_attention": ref.decode_attention_ref,
             "decode_attention_partial": ref.decode_attention_partial_ref}
    originals = {name: getattr(ops, name) for name in plain}
    rows = []
    for arch, layers, cases in RA_SERVE:
        rows += recurrent_axis_serve(torch, card, arch, layers, cases,
                                     originals, plain)

    # ---- training: the unmeshed Trainer, then each mesh, split
    shape = ShapeConfig("ra", "train", RA_TRAIN_SEQ, RA_TRAIN_BATCH)
    tokens = RA_TRAIN_BATCH * RA_TRAIN_SEQ

    def step_ms(tr):
        dts = np.asarray([x["dt"] for x in tr.metrics_log]) * 1e3
        return float(dts[1:].min()), float(np.median(dts[1:]))

    for arch, cut, meshes in RA_TRAIN:
        base = ARCHS[arch]
        cfg = base.replace(dtype="float32", **cut)
        cut = f"{cfg.num_layers} of {base.num_layers} layers " \
            f"{cfg.period_pattern * cfg.n_periods + cfg.remainder_kinds}"
        flat = Trainer(build(cfg, tp=1), shape, device=DEVICE)
        kernels.reset_launch_counts()
        f_params, f_opt, _ = flat.run(RA_TRAIN_STEPS)
        assert kernels.launch_counts()["rmsnorm"] > 0
        want = {key: [x[key] for x in flat.metrics_log]
                for key in ("loss", "grad_norm")}
        best, med = step_ms(flat)
        print(f"recurrent axis train {arch} unmeshed ({cut}, fp32): losses "
              f"{want['loss']}; step ms best {best:.3f}, median {med:.3f} "
              f"(after the first), {tokens / med * 1e3:.1f} tokens/s  "
              f"[{card}]")
        del flat
        for d, m in meshes:
            tag = f"recurrent axis train {arch} {d}x{m}"
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            mesh = make_host_mesh(shape=(d, m),
                                  devices=[MESH_SLOT] * (d * m))
            tr = Trainer(build(cfg, tp=m), shape, mesh=mesh, zero1=d > 1)
            assert tr.api.model_split()
            kernels.reset_launch_counts()
            params, opt, _ = tr.run(RA_TRAIN_STEPS)
            launches = kernels.launch_counts()
            peak = torch.cuda.max_memory_allocated() - held
            assert launches["rmsnorm"] > 0, (tag, launches)
            got = {key: [x[key] for x in tr.metrics_log]
                   for key in ("loss", "grad_norm")}
            rtol, leaf_tol = RA_TRAIN_TOL[arch]
            for key in got:
                np.testing.assert_allclose(got[key], want[key], rtol=rtol,
                                           err_msg=f"{tag} {key}")
            zeros = {path for path, d in L.tree_items(tr.api.param_defs())
                     if d.init == "zeros"}
            errs = {part: hold_state(torch, f"{tag} {part}", a, w, False,
                                     tol=leaf_tol, free=free)
                    for part, a, w, free in (
                        ("params", params, f_params, zeros),
                        ("m", opt["m"], f_opt["m"], ()),
                        ("v", opt["v"], f_opt["v"], ()))}
            hold_blocks(tr, params, opt)
            best, med = step_ms(tr)
            print(f"{tag} main path launches: {launches}")
            print(f"{tag} ({cut}, zero1 {d > 1}): losses {got['loss']} and "
                  f"grad_norm {got['grad_norm']} within rtol {rtol} of the "
                  f"unmeshed Trainer's, every leaf: max error / leaf max "
                  f"{errs} (tol {leaf_tol}); step ms best "
                  f"{best:.3f}, median {med:.3f}, "
                  f"{tokens / med * 1e3:.1f} tokens/s; max_memory_allocated "
                  f"{peak / 1e9:.3f} GB above the {held / 1e9:.3f} GB held "
                  f"before it  [{card}]")
            del tr, params, opt
        del f_params, f_opt
        torch.cuda.empty_cache()
    print(f"recurrent axis phase: {time.perf_counter() - t_phase:.1f} s")
    return rows


def encdec_axis_phase(torch, card) -> list[dict]:
    """Phase 16: the encoder-decoder on the model axis (see the module
    docstring).  Returns the ``kernels`` rows of the (1, 16) serving run,
    keyed ``"path": "mesh_serve_encdec"``."""
    from repro_torch import kernels
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import MeshServe
    from repro_torch.models import build
    from repro_torch.train import Trainer, sharded as S

    t_phase = time.perf_counter()
    plain = {"rmsnorm": ref.rmsnorm_ref,
             "flash_attention": ref.attention_ref,
             "decode_attention": ref.decode_attention_ref}
    originals = {name: getattr(ops, name) for name in plain}
    names = tuple(plain)
    base = ARCHS[ED_ARCH]
    cfg = base.replace(num_layers=FAMILY_LAYERS, enc_layers=FAMILY_LAYERS)
    v, b = cfg.vocab_size, FAMILY_BATCH
    prompt, steps, seq = FAMILY_PROMPT, ED_STEPS, FAMILY_SEQ
    inp = dense_inputs(torch, cfg, b, prompt, steps)
    params = build(cfg).init_params(0, DEVICE)     # 16 heads: no padding
    unmeshed = {}
    for what, dtype, fns in (("bf16", cfg.dtype, {}),
                             ("plain", cfg.dtype, plain),
                             ("fp32", "float32", {})):
        with wrappers_as(ops, fns):
            unmeshed[what] = torch.stack(dense_generate(
                torch, build(cfg.replace(dtype=dtype)), params, inp,
                prompt, steps, seq)[0], 1)
    rows = []
    for d, m in ED_SERVE_MESHES:
        t0 = time.perf_counter()
        tag = f"encdec axis {d}x{m}"
        mesh = make_host_mesh(shape=(d, m), devices=[MESH_SLOT] * (d * m))
        serve = MeshServe(build(cfg, tp=m), mesh)
        assert serve.split
        laid = serve.lay_out_params(params)
        hold_laid_blocks(tag, laid)
        for part in ("self", "cross"):
            for key, dim in (("wq", 2), ("wk", 2), ("wv", 2), ("wo", 1)):
                assert {blk.shape[dim] for blk in laid["dec"][part][key]
                        .blocks} == {cfg.num_heads // m}, (tag, part, key)
        rows_split = v % m == 0
        run = lambda n, srv=serve: mesh_generate(  # noqa: E731
            torch, srv, laid, inp, prompt, n, seq)
        run(1)                          # warm: cuBLAS's plans, allocator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        with recording(torch, ops, names) as recorded:
            kernels.reset_launch_counts()
            out, pre_s, step_s, caches = run(steps)
            launches = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated() - held
        print(f"{tag} main path launches: {launches}")
        assert all(launches[k] > 0 for k in names), (tag, launches)
        hold_laid_blocks(tag, caches)
        for lg in out:
            assert lg.shape == (b, 1, v)
            assert all(tuple(blk.shape) == (b, 1, v // m if rows_split
                                            else v)
                       for blk in lg.blocks), tag
        got = torch.stack([S.gather(lg)[:, 0].float() for lg in out], 1)
        assert torch.isfinite(got).all()
        step = np.asarray(step_s)
        vocab = "vocabulary rows" if rows_split \
            else "embedding and head along d_model, whole logits a slot"
        print(f"{tag} ({cfg.enc_layers} encoder and {cfg.num_layers} "
              f"decoder layers, d_model {cfg.d_model}, {cfg.num_heads // m} "
              f"of {cfg.num_heads} heads and KV heads a slot, {vocab}): "
              f"prefill {b} x {prompt} tokens and frames in "
              f"{pre_s * 1e3:.3f} ms; decode {len(step)} steps, best "
              f"{step.min() * 1e3:.3f} ms, median "
              f"{np.median(step) * 1e3:.3f} ms a step; max_memory_allocated "
              f"{peak / 1e9:.3f} GB above the {held / 1e9:.3f} GB held "
              f"before it  [{card}]")
        with wrappers_as(ops, plain):
            p_out = run(steps)[0]
        got_p = torch.stack([S.gather(lg)[:, 0].float() for lg in p_out], 1)
        room = compare_logits(torch, "split plain versions vs unmeshed "
                              "plain versions (the witness), bf16", got_p,
                              unmeshed["plain"], prefix=tag)
        compare_logits(torch, "split vs unmeshed (phase 8's path), bf16",
                       got, unmeshed["bf16"], scale_tol=TOL_BF16, room=room,
                       prefix=tag)
        # both runs carry the split's own bf16 rounding (at (1, 16) the 16
        # row-parallel partial logits summed in bf16), which the witness
        # reads: 0.0703 against 2e-2 x 3.44 unwidened in run 30a
        compare_logits(torch, "split kernels vs split plain versions, bf16",
                       got, got_p, scale_tol=TOL_BF16, room=room, prefix=tag)
        serve32 = MeshServe(build(cfg.replace(dtype="float32"), tp=m), mesh)
        got32 = torch.stack([S.gather(lg)[:, 0].float()
                             for lg in run(steps, serve32)[0]], 1)
        compare_logits(torch, "split vs unmeshed (phase 8's path), fp32",
                       got32, unmeshed["fp32"], tol=DENSE_FP32_TOL,
                       prefix=tag)
        errs = {k: max((hold_to_plain(torch, k, originals[k], plain[k], a,
                                      kw)
                        for a, kw, _ in recorded[k].values()), default=0.0)
                for k in names}
        print(f"{tag}: each kernel call against its plain version, max abs "
              f"err {errs} (tol {TOL_BF16} on bf16 outputs)")
        if f"{d}x{m}" == ED_ROWS_MESH:
            rows += dense_rows(torch, card, recorded, originals, plain,
                               path="mesh_serve_encdec",
                               extra={"arch": ED_ARCH, "mesh": ED_ROWS_MESH})
        print(f"{tag}: {time.perf_counter() - t0:.1f} s")
        del serve, serve32, laid, out, p_out, caches, recorded
        torch.cuda.empty_cache()
    del params
    unmeshed.clear()
    torch.cuda.empty_cache()

    # ---- training: the unmeshed Trainer, then each mesh, split; in the
    # published relu and with gelu in its place (see ED_TRAIN_ACTS)
    shape = ShapeConfig("encdec", "train", ED_TRAIN_SEQ, ED_TRAIN_BATCH)
    tokens = ED_TRAIN_BATCH * ED_TRAIN_SEQ // 2

    def step_ms(tr):
        dts = np.asarray([x["dt"] for x in tr.metrics_log]) * 1e3
        return float(dts[1:].min()), float(np.median(dts[1:]))

    for act in ED_TRAIN_ACTS:
        cfg32 = cfg.replace(dtype="float32", act=act)
        gated = act != cfg.act
        flat = Trainer(build(cfg32), shape, device=DEVICE)
        kernels.reset_launch_counts()
        f_params, f_opt, _ = flat.run(ED_TRAIN_STEPS)
        assert kernels.launch_counts()["rmsnorm"] > 0
        want = {key: [x[key] for x in flat.metrics_log]
                for key in ("loss", "grad_norm")}
        best, med = step_ms(flat)
        print(f"encdec axis train {act} unmeshed ({cfg.enc_layers} + "
              f"{cfg.num_layers} of {base.enc_layers} + {base.num_layers} "
              f"layers, fp32, {ED_TRAIN_BATCH} x {ED_TRAIN_SEQ // 2} frames "
              f"and tokens): losses {want['loss']}; step ms best "
              f"{best:.3f}, median {med:.3f} (after the first), "
              f"{tokens / med * 1e3:.1f} tokens/s  [{card}]")
        del flat
        witness = None
        if not gated:                   # the run against itself, reshaped
            w_params, w_opt, _ = Trainer(
                build(cfg32), shape, device=DEVICE,
                grad_accum=ED_WITNESS_ACCUM).run(ED_TRAIN_STEPS)
            witness = leaf_errors(torch, (w_params, w_opt),
                                  (f_params, f_opt))
            del w_params, w_opt
            print(f"encdec axis train {act} unmeshed at grad_accum "
                  f"{ED_WITNESS_ACCUM} (the witness: other product shapes, "
                  f"no split) against the unmeshed run, max error / leaf "
                  f"max: {witness}  [{card}]")
        for d, m in ED_TRAIN_MESHES:
            tag = f"encdec axis train {act} {d}x{m}"
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            mesh = make_host_mesh(shape=(d, m), devices=[MESH_SLOT] * (d * m))
            tr = Trainer(build(cfg32, tp=m), shape, mesh=mesh, zero1=d > 1)
            assert tr.api.model_split()
            kernels.reset_launch_counts()
            params, opt, _ = tr.run(ED_TRAIN_STEPS)
            launches = kernels.launch_counts()
            peak = torch.cuda.max_memory_allocated() - held
            assert launches["rmsnorm"] > 0 and \
                launches["flash_attention"] > 0, (tag, launches)
            got = {key: [x[key] for x in tr.metrics_log]
                   for key in ("loss", "grad_norm")}
            for key in got:
                np.testing.assert_allclose(got[key], want[key],
                                           rtol=RESUME_RTOL,
                                           err_msg=f"{tag} {key}")
            if gated:
                errs = {part: hold_state(torch, f"{tag} {part}", a, w, False)
                        for part, a, w in (("params", params, f_params),
                                           ("m", opt["m"], f_opt["m"]),
                                           ("v", opt["v"], f_opt["v"]))}
                leaves = f"(tol {MESH_TRAIN_TOL})"
            else:
                errs = leaf_errors(torch, (params, opt), (f_params, f_opt))
                leaves = "(not gated: relu's flips; the witness above)"
            hold_blocks(tr, params, opt)
            best, med = step_ms(tr)
            loss = "row-parallel" if v % m else "by vocabulary rows"
            print(f"{tag} main path launches: {launches}")
            print(f"{tag} (zero1 {d > 1}; the loss {loss}): losses "
                  f"{got['loss']} and grad_norm {got['grad_norm']} within "
                  f"rtol {RESUME_RTOL} of the unmeshed Trainer's, every "
                  f"leaf: max error / leaf max {errs} {leaves}; step ms "
                  f"best {best:.3f}, median {med:.3f}, "
                  f"{tokens / med * 1e3:.1f} tokens/s; max_memory_allocated "
                  f"{peak / 1e9:.3f} GB above the {held / 1e9:.3f} GB held "
                  f"before it  [{card}]")
            del tr, params, opt
            torch.cuda.empty_cache()
        del f_params, f_opt
        torch.cuda.empty_cache()
    print(f"encdec axis phase: {time.perf_counter() - t_phase:.1f} s")
    return rows


def step_ranges(torch, fn) -> tuple[dict, float]:
    """Host ms of each of the train step's profiler ranges (the trainer's
    ``train_step.forward``, ``.backward`` and ``.optimizer``) in one call
    of ``fn`` under torch.profiler recording host ops, and the window's
    host ms, which ends in a synchronize.  A range ends when the host
    returns from its part, not when the card does; the op recording slows
    the host, so the spans run longer than an unprofiled step's."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU], acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = {f"train_step.{part}": 0.0
             for part in ("forward", "backward", "optimizer")}
    for e in prof.events():
        if e.name in spans:
            spans[e.name] += e.cpu_time_total / 1e3
    return spans, wall


def profile_split(torch, fn, symbols: dict):
    """(device-busy ms, wall ms, {kernel: ms}) of one call of ``fn`` under
    torch.profiler; the split sums device time by kernel, each under the
    names its symbols are part of, the rest (products, copies,
    elementwise) under "other".  Busy ms is None where every profiler
    window lost the card's events."""
    events, wall = profiled(torch, fn)
    split = {name: 0.0 for name in symbols}
    split["other"] = 0.0
    for e in events:
        name = next((n for n, syms in symbols.items()
                     if any(sym in e.key for sym in syms)), "other")
        split[name] += e.self_device_time_total / 1e3
    busy = sum(split.values()) if events else None
    return busy, wall, {k: round(v, 3) for k, v in split.items()}


def busy_text(busy, wall) -> str:
    """The card's busy share of a profiled window, or "not measured"."""
    if busy is None:
        return (f"busy not measured (no device events) in {wall:.3f} ms")
    return f"busy {busy:.3f} ms of {wall:.3f} ms ({100 * busy / wall:.2f} %)"


def dryrun_files(out: str, name: str) -> tuple[str, str]:
    """The JSON result and the log of one of phase 11's processes."""
    base = os.path.join(out, name)
    return base + ".json", base + ".log"


def witness_config(arch: str, kind: str, layers, dtype, seq: int,
                   batch: int):
    """(config, shape) of a WITNESSES entry."""
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import ShapeConfig
    cfg = ARCHS[arch]
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    return cfg, ShapeConfig("witness", kind, seq, batch)


def dryrun_cells() -> list[tuple]:
    """Phase 11's cells in their order: (arch, shape, multi_pod) for every
    ``ARCHS x shapes_for`` cell on (16, 16), then on (2, 16, 16)."""
    from repro_torch.configs import ARCHS, shapes_for
    return [(a, s, mp) for mp in (False, True) for a in ARCHS
            for s in shapes_for(a)]


def dryrun_worker(name: str, out: str, taken=None) -> None:
    """One of phase 11's processes: a "cells" one takes the next of
    ``dryrun_cells`` (``taken``, a counter the cell processes share)
    until none is left, so that the long cells spread over them;
    "witness", the WITNESSES' records on a (1, 1) mesh of meta slots.
    Each record (with its index among the cells), or its exception, and
    last whether this process initialised CUDA, its allocated card
    memory before and after, and its launch counts, as JSON in
    ``dryrun_files``' first file; the module's own lines go to its
    second."""
    os.nice(10)
    import traceback

    import torch

    from repro_torch import kernels
    from repro_torch.launch import dryrun

    path, log_path = dryrun_files(out, name)
    before = torch.cuda.memory_allocated()
    cells = []

    def run(tag: dict, fn):
        try:
            cells.append({**tag, **fn()})
        except Exception as e:  # noqa: BLE001 - a failed cell is a finding
            cells.append({**tag, "error": f"{type(e).__name__}: {e}",
                          "traceback": traceback.format_exc()})

    with open(log_path, "w") as log, contextlib.redirect_stdout(log):
        if name == "witness":
            mesh = dryrun.meta_mesh((1, 1), ("data", "model"))
            for w in WITNESSES:
                cfg, shape = witness_config(*w)
                run({"witness": list(w)},
                    lambda: dryrun.analyze_cell(cfg, shape, mesh)[1])
        else:
            todo = dryrun_cells()
            while True:
                with taken.get_lock():
                    i = taken.value
                    taken.value += 1
                if i >= len(todo):
                    break
                arch, shape, multi_pod = todo[i]
                trace = None
                if arch in DRYRUN_DEV_TRACE and shape.kind != "decode":
                    trace = dryrun.dev_shape(
                        shape, dryrun.make_mesh(multi_pod=multi_pod,
                                                dev=False))
                run({"index": i, "arch": arch, "shape": shape.name,
                     "multi_pod": multi_pod},
                    lambda: dryrun.run_cell(
                        arch, shape.name, multi_pod=multi_pod, dev=False,
                        trace_shape=trace))
    with open(path, "w") as f:
        json.dump({"cells": cells,
                   "cuda_initialized": torch.cuda.is_initialized(),
                   "allocated": [before, torch.cuda.memory_allocated()],
                   "launches": kernels.launch_counts()}, f)


DRYRUN_PROCS = ("cells1", "cells2", "cells3", "cells4", "witness")


def start_dryrun() -> tuple[list, str, object]:
    """Phase 11's processes (DRYRUN_PROCS), started after phase 8 so that
    their CPU-only traces run beside phases 9-14: (processes, the
    directory of their results, the counter the cell processes share,
    which the caller holds until they are joined: its semaphore goes
    when it does).  Daemonic, so an exit ends them."""
    import multiprocessing
    import tempfile
    out = tempfile.mkdtemp(prefix="dryrun_")
    ctx = multiprocessing.get_context("spawn")
    taken = ctx.Value("i", 0)
    procs = [ctx.Process(target=dryrun_worker, daemon=True,
                         name=f"dryrun-{name}", args=(name, out, taken))
             for name in DRYRUN_PROCS]
    for p in procs:
        p.start()
    return procs, out, taken


def gb(n) -> str:
    return f"{n / 1e9:.3f} GB"


def fits_card(m: dict, total: int):
    """A record's ``memory`` judged against ``total`` bytes: whether its
    peak fits, or None where the peak is a lower bound that fits."""
    fits = m["peak_bytes"] <= total
    return None if m["peak_is_lower_bound"] and fits else fits


def dryrun_line(c: dict, total: int, card: str) -> str:
    """A cell's line: bytes a slot, peak and temp, the judgements,
    flops, bytes accessed and transfers."""
    m = c["memory"]
    coll = c["collectives"]
    moved = "no transfers (serving)" if coll is None else (
        f"transfers {gb(coll['total_bytes'])} through slot {coll['slot']} "
        f"{ {k: round(v / 1e9, 3) for k, v in coll['bytes_by_kind'].items()} }"
        f" GB, {gb(coll['mesh_total_bytes'])} over the mesh")
    return (f"a slot holds {gb(m['argument_size_in_bytes'])} of arguments, "
            f"{gb(m['output_size_in_bytes'])} of outputs, "
            f"{gb(m['alias_size_in_bytes'])} aliased (slots differ "
            f"{m['memory_slots_differ']}); peak {gb(m['peak_bytes'])}"
            f"{' (lower bound)' if m['peak_is_lower_bound'] else ''} (temp "
            f"{gb(m['temp_size_in_bytes'])}); fits {c['fits']} "
            f"(arguments_fit {c['arguments_fit']}; on this card's "
            f"{gb(total)}: {fits_card(m, total)}); flops "
            f"{c['flops']:.6g}, dot_flops {c['dot_flops']:.6g} (model_flops "
            f"{c['model_flops']:.6g}), bytes accessed "
            f"{c['bytes_accessed']:.6g}, kernel calls {c['kernel_calls']}; "
            f"{moved}; model_split {c['model_split']}; traced at "
            f"{c['trace_batch']} x {c['trace_seq_len']} "
            f"in {c['trace_s']} s on the card's host, outputs "
            f"{c['trace_outputs']}  [{card}]")


def witness_step(torch, cfg, shape) -> tuple[int, int]:
    """One real step of a witness on the card at a (1, 1) mesh: (bytes its
    arguments took, max_memory_allocated over the step), both above what
    was allocated before its arguments.  Train: ``make_mesh_train_step``
    on fp32 parameters and moments laid out on one slot; prefill or
    decode: the step on bf16 parameters, zero caches and the inputs."""
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build, layers as L
    from repro_torch.train import optimizer as O, sharded as S
    from repro_torch.train.trainer import make_mesh_train_step

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    api = build(cfg, tp=1)
    mesh = make_host_mesh(shape=(1, 1), devices=[MESH_SLOT])
    if shape.kind == "train":
        with L.use_mesh(mesh):
            specs = (api.param_pspecs(), O.opt_pspecs(api.param_defs()),
                     api.input_pspecs(shape))
        params = api.init_params(0, DEVICE)
        args = (S.lay_out_tree(params, S.layouts(mesh, specs[0])),
                S.lay_out_tree(O.init_state(params),
                               S.layouts(mesh, specs[1])),
                {k: torch.from_numpy(v).to(DEVICE)
                 for k, v in synth_batch(cfg, shape, 0).items()})
        del params
        step = make_mesh_train_step(api, O.AdamWConfig(), mesh,
                                    param_specs=specs[0], opt_specs=specs[1],
                                    batch_specs=specs[2])
    else:
        params = L.tree_map(lambda t: t.to(torch.bfloat16)
                            if t.is_floating_point() else t,
                            api.init_params(0, DEVICE))
        g = torch.Generator(device=DEVICE).manual_seed(0)
        inputs = {k: torch.randint(0, cfg.vocab_size, v.shape, generator=g,
                                   device=DEVICE, dtype=v.dtype)
                  for k, v in api.input_specs(shape).items()}
        caches = L.init_tree(api.cache_defs(shape.global_batch,
                                            shape.seq_len), 0, DEVICE)
        args = (params, inputs, caches)
        step = api.prefill if shape.kind == "prefill" else api.decode
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    with L.use_mesh(mesh), torch.set_grad_enabled(shape.kind == "train"):
        out = step(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out, args
    torch.cuda.empty_cache()
    return held, peak


def dryrun_phase(torch, card, procs, out) -> None:
    """Phase 11 (see the module docstring)."""
    import shutil

    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build
    from repro_torch.train import Trainer

    t_phase = time.perf_counter()
    total = torch.cuda.get_device_properties(0).total_memory
    allocated = torch.cuda.memory_allocated()
    results = {}
    for p, name in zip(procs, DRYRUN_PROCS):
        p.join(timeout=max(1.0, DRYRUN_WAIT_S - (time.perf_counter()
                                                 - t_phase)))
        if p.is_alive():
            p.terminate()
            p.join()
        path, log_path = dryrun_files(out, name)
        with open(log_path) as f:
            log = f.read()
        assert p.exitcode == 0, (name, p.exitcode, log[-2000:])
        with open(path) as f:
            results[name] = json.load(f)
    shutil.rmtree(out)
    assert torch.cuda.memory_allocated() == allocated
    print(f"dryrun: waited {time.perf_counter() - t_phase:.1f} s for its "
          f"{len(procs)} processes; allocated card memory of this process "
          f"{allocated} bytes before and after the wait; the dry-run "
          "processes: CUDA initialised "
          f"{[r['cuda_initialized'] for r in results.values()]}, allocated "
          "card memory before and after "
          f"{[r['allocated'] for r in results.values()]}, launches "
          f"{[r['launches'] for r in results.values()]}")
    for r in results.values():
        assert not r["cuda_initialized"] and r["allocated"] == [0, 0], r
        assert not any(r["launches"].values()), r["launches"]
    cells = sorted((c for name, r in results.items() if name != "witness"
                    for c in r["cells"]), key=lambda c: c["index"])
    want = [(a, s.name, mp) for a, s, mp in dryrun_cells()]
    assert [(c["arch"], c["shape"], c["multi_pod"]) for c in cells] == want
    failed = [c for c in cells + results["witness"]["cells"] if "error" in c]
    for c in cells:
        tag = f"dryrun {c['arch']} {c['shape']} pod{1 + c['multi_pod']}"
        if "error" in c:
            print(f"{tag}: FAILED {c['error']}\n{c['traceback']}")
            continue
        print(f"{tag}: {dryrun_line(c, total, card)}")
        assert c["memory"]["peak_is_lower_bound"] == (
            c["arch"] in DRYRUN_DEV_TRACE and c["kind"] != "decode"), tag
        assert c["model_split"] == (c["arch"] in DRYRUN_SPLIT_PEAK_BEFORE), \
            tag
        assert (c["collectives"] is None) == (c["kind"] != "train"
                                              and not c["model_split"]), tag
    assert not failed, [(c.get("arch"), c.get("shape"), c.get("multi_pod"),
                         c.get("witness"), c["error"]) for c in failed]
    for c in cells:
        if not c["model_split"]:
            continue
        train = c["kind"] == "train"
        before = (DRYRUN_SPLIT_PEAK_BEFORE[c["arch"]] if train else
                  DRYRUN_SERVE_PEAK_BEFORE[c["arch"], c["shape"]])[
                      c["multi_pod"]]
        peak = c["memory"]["peak_bytes"]
        print(f"dryrun split {c['arch']} {c['shape']} pod{1 + c['multi_pod']}"
              f": peak {gb(peak)} a slot, split over the model axis "
              f"(gathered: {gb(before)}); fits {c['fits']}, on this "
              f"card's {gb(total)}: {fits_card(c['memory'], total)}  "
              f"[{card}]")
        assert peak < before, (c["arch"], c["multi_pod"], peak, before)
        if (c["arch"] in DRYRUN_SPLIT_FITS) if train else (
                (c["arch"], c["shape"]) in DRYRUN_SERVE_FITS
                or (c["arch"], c["shape"], c["multi_pod"])
                in DRYRUN_SERVE_FITS):
            assert c["fits"], (c["arch"], c["shape"], c["multi_pod"], peak)
    judged = [fits_card(c["memory"], total) for c in cells]
    args_fit = sum(c["memory"]["argument_size_in_bytes"] <= total
                   for c in cells)
    unknown = [f"{c['arch']} {c['shape']} pod{1 + c['multi_pod']}"
               for c, j in zip(cells, judged) if j is None]
    print(f"dryrun: ALL {len(cells)} cells traced OK; on this card's "
          f"{gb(total)} a slot, {judged.count(True)} fit at their peak, "
          f"{judged.count(False)} do not, {len(unknown)} not known (a "
          f"lower bound that fits: {unknown}); {args_fit} fit by their "
          "arguments alone")

    # ---- the card witness: predicted peak against max_memory_allocated
    for w, c in zip(WITNESSES, results["witness"]["cells"]):
        assert c["witness"] == list(w), (c["witness"], w)
        cfg, shape = witness_config(*w)
        held, measured = witness_step(torch, cfg, shape)
        m = c["memory"]
        ratio = m["peak_bytes"] / measured
        print(f"dryrun witness {w[0]} {w[1]} ({cfg.num_layers} layers, "
              f"{cfg.dtype}, {shape.global_batch} x {shape.seq_len}, (1, 1) "
              f"mesh): predicted peak {m['peak_bytes']} bytes (arguments "
              f"{m['argument_size_in_bytes']}, temp "
              f"{m['temp_size_in_bytes']}; traced in {c['trace_s']} s), "
              f"measured max_memory_allocated {measured} (arguments "
              f"{held}), ratio {ratio:.4f}  [{card}]")
        assert abs(ratio - 1) <= WITNESS_TOL, (w, ratio)

    # ---- the layout witness: lower_cell's bytes a slot, held blocks
    base = ARCHS[ATTN_TRAIN_ARCH]
    cfg = base.replace(num_layers=ATTN_TRAIN_LAYERS, dtype="float32")
    shape = ShapeConfig("mesh", "train", ATTN_TRAIN_SEQ, ATTN_TRAIN_BATCH)
    mesh = make_host_mesh(shape=(2, 2), devices=[MESH_SLOT] * 4)
    tr = Trainer(build(cfg, tp=2), shape, mesh=mesh, zero1=False)
    params, opt, _ = tr.init_or_restore()
    held = hold_blocks(tr, params, opt)
    cell, _ = dryrun.lower_cell(cfg, shape, mesh)
    (p_tree, p_specs), (o_tree, o_specs) = cell.trees["params"], \
        cell.trees["opt"]
    per = {"params": dryrun.slot_bytes(p_tree, p_specs, mesh),
           "moments": sum(dryrun.slot_bytes(o_tree[k], o_specs[k], mesh)
                          for k in ("m", "v"))}
    for part, b in per.items():
        assert b.min() == b.max() == held[part], (part, b, held[part])
    print(f"dryrun layout witness: {ATTN_TRAIN_ARCH} {cfg.num_layers} "
          f"layers fp32 on a (2, 2) mesh of {MESH_SLOT} slots, ZeRO-1 off: "
          f"lower_cell counts {per['params'][0]} bytes of parameters and "
          f"{per['moments'][0]} of moments a slot, equal to the blocks "
          f"the Trainer holds ({held})")
    del tr, params, opt
    torch.cuda.empty_cache()
    print(f"dryrun phase: {time.perf_counter() - t_phase:.1f} s")


def gnn_phase(torch, card, kernel_rows: bool = True):
    """Phases 3 and 4 (see the module docstring): the main path at full
    width and, with ``kernel_rows``, every GNN kernel against its plain
    version.  Returns (the ``kernels`` rows, and what phases 5 and 6
    reuse: the graph, the models' DFGs and weights, the group's requests,
    phase 3's results and each model's launches)."""
    from repro_torch import kernels
    from repro_torch.core import gnn
    from repro_torch.core.service import HolisticGNNService, make_service_dfg
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.ops import program_config

    t_phase = time.perf_counter()
    # ------------------------------------------------ 3. main path, full width
    edges, emb = make_graph()
    svc = HolisticGNNService(h_threshold=64, pad_to=64, device=DEVICE)
    svc.update_graph(edges, emb)
    program_config(svc.xbuilder, "hetero")
    octa = HolisticGNNService(h_threshold=64, pad_to=64, device=DEVICE)
    octa.update_graph(edges, emb)
    program_config(octa.xbuilder, "octa")
    req_rng = np.random.default_rng(1)
    reqs = [{"targets": req_rng.integers(0, N_VERTICES, TARGETS).tolist(),
             "seed": 100 + i} for i in range(GROUP)]
    setups = {m: model_setup(gnn, make_service_dfg, m) for m in MODELS}
    for m in MODELS:                                   # warm: plans, allocator
        svc.run_batch(setups[m][0], reqs, weights=setups[m][1])
    torch.cuda.synchronize()

    # record what each kernel wrapper gets on the main path, to replay it
    recorded = {name: [] for name in GNN_KERNELS}
    originals = {name: getattr(ops, name) for name in GNN_KERNELS}

    def recorder(name, fn):
        def wrapped(*args, **kwargs):
            recorded[name].append((args, kwargs))
            return fn(*args, **kwargs)
        return wrapped

    for name, fn in originals.items():
        setattr(ops, name, recorder(name, fn))
    try:
        kernels.reset_launch_counts()
        fused, per_model = {}, {}
        for m in MODELS:
            before = kernels.launch_counts()
            fused[m] = svc.run_batch(setups[m][0], reqs, weights=setups[m][1])
            per_model[m] = {k: v - before[k]
                            for k, v in kernels.launch_counts().items()}
        launches = kernels.launch_counts()
    finally:
        for name, fn in originals.items():
            setattr(ops, name, fn)
    print(f"main path launches: {launches}")
    assert all(launches[k] > 0 for k in GNN_KERNELS), launches
    print(f"group: {GROUP} requests x {TARGETS} targets, fanouts {FANOUTS}; "
          f"H rows {recorded['agg_combine'][0][0][0].shape[0]}, layer dst "
          f"rows {[a[0][1].shape[0] for a in recorded['agg_combine']]}")

    for m in MODELS:
        dfg, weights = setups[m]
        for res, r in zip(fused[m], reqs):
            assert res["Result"].shape == (TARGETS, DIMS[-1])
            assert np.isfinite(res["Result"]).all()
        times, engine = [], []
        for _ in range(GROUP_REPEATS):
            t0 = time.perf_counter()
            svc.run_batch(dfg, reqs, weights=weights)
            times.append(time.perf_counter() - t0)
            engine.append(sum(t for op, _, t in svc.engine.timings
                              if op == "__dfg_jit__"))
        best = min(times)
        print(f"{m}: run_batch group {best * 1e3:.3f} ms best of "
              f"{GROUP_REPEATS} (median {np.median(times) * 1e3:.3f} ms), "
              f"{GROUP / best:.1f} requests/s; engine (plan walk to sync) "
              f"median {np.median(engine) * 1e3:.3f} ms, the rest is host "
              f"sampling, padding and copies  [{card}]")
        busy, wall, _ = profile_split(
            torch, lambda: svc.run_batch(dfg, reqs, weights=weights), {})
        print(f"{m}: under torch.profiler, one group: card "
              f"{busy_text(busy, wall)}  [{card}]")
        shell = octa.run_batch(dfg, reqs, weights=weights)
        err = max(float(np.abs(a["Result"] - b["Result"]).max())
                  for a, b in zip(fused[m], shell))
        for a, b in zip(fused[m], shell):
            np.testing.assert_allclose(a["Result"], b["Result"],
                                       rtol=SERVICE_TOL, atol=SERVICE_TOL)
        for res, r in zip(fused[m], reqs):
            serial = svc.run(dfg, r["targets"], weights=weights,
                             seed=r["seed"])["Result"][:TARGETS]
            np.testing.assert_array_equal(serial, res["Result"])
        print(f"{m}: hetero vs octa max abs err {err:.3g} (tol {SERVICE_TOL});"
              f" fused == serial bitwise for {GROUP} requests")

    print(f"gnn: phase 3 in {time.perf_counter() - t_phase:.1f} s")
    reuse = (edges, emb, setups, reqs, fused, per_model)
    if not kernel_rows:
        return [], reuse
    t_phase = time.perf_counter()
    # ------------------------------------------------ 4. kernels vs plain
    def unfused(args, kwargs):
        """The port's own spmm kernel then its gemm kernel on agg_combine's
        arguments: the pair the fused kernel replaces."""
        h, nbr, mask, w = args[:4]
        return lambda: kernels.gemm(
            kernels.spmm(h, nbr, mask, mode=kwargs.get("mode", "mean")), w)

    rows, by_shape = [], {}
    for name in GNN_KERNELS:
        row, by_shape[name] = replay(torch, card, name, originals[name],
                                     recorded[name], launches[name])
        rows.append(row)

    # by shape: where the pass's time goes, cold (inputs past the L2) and
    # warm, against torch.matmul (gemm), embedding_bag (spmm) and the
    # port's unfused spmm + gemm kernels (agg_combine)
    for name, shapes in by_shape.items():
        for sig, s in sorted(shapes.items(), key=lambda kv: -kv[1]["ms"]):
            group = s["calls"]
            n = len(group)
            yard = ""
            if name in ("gemm", "spmm"):
                lib = "torch.matmul" if name == "gemm" else "embedding_bag"
                yard = (f"; {lib} {s['lib_ms'] / n:.5f} cold, "
                        f"{s['lib_warm'] / n:.5f} warm")
            elif name == "agg_combine":
                pairs = [unfused(a, k) for a, k in group]
                pair_warm = warm_ms(torch, lambda: [u() for u in pairs])
                pair_cold = cold_group_ms(torch, unfused, group)
                yard = (f"; unfused spmm + gemm {pair_cold / n:.5f} cold, "
                        f"{pair_warm / n:.5f} warm")
            print(f"{name} {sig}: {n} calls, kernel {s['ms'] / n:.5f} ms a "
                  f"launch cold, {s['warm'] / n:.5f} warm{yard}; bound "
                  f"{s['bound'] / n:.5f} ({100 * s['bound'] / s['ms']:.1f} % "
                  f"of bound reached cold, {100 * s['bound'] / s['warm']:.1f}"
                  f" % warm)  [{card}]")

    # agg_combine_partial and bf16 gemm on main-path arguments
    (h, nbr, mask, w, _b), kw = recorded["agg_combine"][0]
    got = kernels.agg_combine_partial(h, nbr, mask, w, **kw)
    want = ref.agg_combine_ref(h, nbr, mask, w, None, **kw)
    assert torch.allclose(got, want, rtol=TOL["agg_combine"],
                          atol=TOL["agg_combine"])
    print(f"agg_combine_partial: max abs err "
          f"{float((got - want).abs().max()):.3g}")
    (a, b), _ = recorded["gemm"][0]
    a16, b16 = a.bfloat16(), b.bfloat16()
    got = kernels.gemm(a16, b16).float()
    want = ref.gemm_ref(a16, b16).bfloat16().float()
    assert torch.allclose(got, want, rtol=TOL_BF16, atol=TOL_BF16)
    print(f"gemm bf16 {tuple(a.shape)}@{tuple(b.shape)}: max abs err "
          f"{float((got - want).abs().max()):.3g} (tol {TOL_BF16})")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          " GiB")

    print(f"gnn: phase 4 in {time.perf_counter() - t_phase:.1f} s")
    return rows, reuse


def load_example(name: str):
    """``examples/<name>.py`` as a module (``examples/`` is no package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def quickstart_phase(torch) -> None:
    """Phase 2: ``examples/torch_quickstart.py`` on the card: the flow
    over RPC must run both GCN layers as AggCombine on the vector device
    and launch the agg_combine kernel."""
    from repro_torch import kernels
    before = kernels.launch_counts()["agg_combine"]
    out = load_example("torch_quickstart").main(["--device", DEVICE])
    res = out["Result"]
    assert out["trace"].count(("AggCombine", "vector")) == 2, out["trace"]
    assert kernels.launch_counts()["agg_combine"] > before
    assert res.shape[1] == 16 and np.isfinite(res).all()
    print(f"quickstart: Result {res[:4].shape} via {out['devices']}")


def examples_phase(torch, card) -> None:
    """Phase 17: the port's examples on the card (see the module
    docstring): ``torch_serve_gnn`` under each drill of EXAMPLE_DRILLS,
    ``torch_mutable_graph`` and ``torch_serve_lm_paged``; each serving
    run's launches of its model's kernels above zero, every drill's own
    asserts (bit for bit against its serial replay or reference answer)
    and none of its requests failed, under the lock witness."""
    from repro_torch import concurrency, kernels
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    serve_gnn = load_example("torch_serve_gnn")
    seen = dict.fromkeys(GNN_KERNELS, 0)
    concurrency.reset_witness()
    concurrency.set_witness(True)     # locks made from here on are checked
    try:
        for label, flags in EXAMPLE_DRILLS:
            model = flags[flags.index("--model") + 1]
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            rep = serve_gnn.main(flags + EXAMPLE_LOAD + ["--device", DEVICE])
            wall = time.perf_counter() - t0
            launches = kernels.launch_counts()
            for k in GNN_KERNELS:
                seen[k] += launches[k]
            want = EXAMPLE_KERNELS[model]
            assert all(launches[k] > 0 for k in want), (label, launches)
            assert rep["failed"] == 0 and rep["requests"] == \
                EXAMPLE_REQUESTS, (label, rep)
            drills = [d for d in ("firehose", "reshard", "kill", "chaos")
                      if d in rep]
            assert drills and all(rep[d]["bit_identical"] is True
                                  for d in drills), (label, rep)
            if "--reshard-grow" in flags and "--kill-shard" in flags:
                assert rep["kill"]["mid_migration"], (label, rep["kill"])
            assert rep["witness"]["violations"] == 0, (label, rep)
            print(f"examples serve_gnn {label}: {wall:.1f} s, "
                  f"{rep['requests']} requests in {rep['serve_s']:.3f} s "
                  f"({rep['requests_per_s']:.1f} requests/s; scheduler "
                  f"{rep['scheduler']['throughput_rps']:.1f}), drills "
                  f"{drills} bit for bit, launches "
                  f"{ {k: launches[k] for k in GNN_KERNELS} }  [{smi}]")
    finally:
        concurrency.set_witness(False)
    assert all(seen[k] > 0 for k in GNN_KERNELS), seen
    print(f"examples serve_gnn: the four GNN kernels launched {seen}")

    t0 = time.perf_counter()
    mg = load_example("torch_mutable_graph").main(
        ["--days", str(EXAMPLE_DAYS), "--device", DEVICE])
    assert mg["written_pages"] > 0 and mg["pages_h"] + mg["pages_l"] > 0
    print(f"examples mutable_graph --days {EXAMPLE_DAYS}: "
          f"{time.perf_counter() - t0:.1f} s, page statistics {mg}  [{smi}]")

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    lm = load_example("torch_serve_lm_paged").main(
        ["--requests", "2", "--max-new", "4", "--device", DEVICE])
    launches = kernels.launch_counts()
    assert all(launches[k] > 0 for k in LM_KERNELS), launches
    assert lm["requests"] == 2 and all(len(g) == 4 for g in
                                       lm["generated"].values()), lm
    print(f"examples serve_lm_paged (smoke size): "
          f"{time.perf_counter() - t0:.1f} s, {lm['requests']} requests, "
          f"{lm['tokens']} tokens in {lm['seconds']:.3f} s "
          f"({lm['tokens_per_s']:.1f} tokens/s), launches "
          f"{ {k: launches[k] for k in LM_KERNELS} }  [{smi}]")


PHASES = ("2", "3", "4", "5", "6", "7", "8", "9", "10", "12", "13", "14",
          "11", "15", "16", "17", "18")


def selected_phases(argv) -> tuple[str, ...]:
    """The phases to run, in their order: all of them with no arguments
    (as the smoke run is made); ``--only 9,16`` runs phase 1 and those
    (phase 3 also where 4, 5 or 6 is asked for, which reuse its run)."""
    if not argv:
        return PHASES
    if len(argv) != 2 or argv[0] != "--only":
        raise SystemExit(f"usage: chip_smoke.py [--only N,N,...] (phases "
                         f"{', '.join(PHASES)})")
    only = set(argv[1].split(","))
    assert only <= set(PHASES), (only, PHASES)
    if only & {"4", "5", "6"}:
        only.add("3")
    if "18" in only:             # held to phase 10's single-process runs
        only.add("10")
    return tuple(p for p in PHASES if p in only)


# the phases whose times seed the benchmark's cells: no dry-run process
# runs beside them (phase 4 runs inside phase 3's call)
TIMED_ALONE = ("3", "5", "6", "7", "8")


def no_dryrun_alive(where: str) -> None:
    """Phase 11's processes must not run beside a phase whose times seed
    the benchmark's cells (3, 5, 6, 7 and 8)."""
    import multiprocessing
    alive = [p.name for p in multiprocessing.active_children()
             if p.name.startswith("dryrun-")]
    assert not alive, (where, alive)


def main(argv=None) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the card",
              file=sys.stderr)
        return 2
    from repro_torch import kernels   # noqa: F401  (needs the repository)
    from repro_torch.kernels import _build
    phases = selected_phases(sys.argv[1:] if argv is None else argv)
    t_start = time.perf_counter()
    seconds = {}

    def run(phase: str, label: str, fn):
        """One phase, timed; its seconds printed and kept for the summary."""
        if phase not in phases:
            return None
        if phase in TIMED_ALONE:
            no_dryrun_alive(f"the start of phase {phase}")
        t0 = time.perf_counter()
        out = fn()
        seconds[phase] = time.perf_counter() - t0
        if phase in TIMED_ALONE:
            no_dryrun_alive(f"the end of phase {phase}")
        print(f"phase {phase} ({label}): {seconds[phase]:.1f} s")
        return out

    # ------------------------------------------------ 1. card, build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    card = f"{torch.cuda.get_device_name(0)}, {smi.split(',')[-1].strip()}"
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({_build.build_dir().name})")
    entry = ""
    for line in (_build.build_dir() / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:
            entry = kernel_name(line.split("'")[1])
        elif "registers" in line or "spill" in line:
            print(f"  {entry}: {line.strip()}")
    sass = flash_bf16_sass(_build)
    print(f"bf16 flash_attention SASS, tensor-core instructions: {sass}")
    assert len(sass) == 5 and all(c["HGMMA"] + c["HMMA"] > 0
                                  for c in sass.values()), sass
    seconds["1"] = time.perf_counter() - t_start
    print(f"phase 1 (card, build): {seconds['1']:.1f} s")

    # ------------------------------------------------ 2. quickstart over RPC
    run("2", "quickstart", lambda: quickstart_phase(torch))

    # ------------------------------------------------ 3-4. GNN main path
    rows, reuse = run("3", "GNN main path and kernels", lambda: gnn_phase(
        torch, card, kernel_rows="4" in phases)) or ([], None)

    # ------------------------------------------------ 5. SPMD engine
    rows += run("5", "SPMD engine", lambda: spmd_phase(
        torch, card, *reuse[:5], reuse[5])) or []

    # ------------------------------------------------ 6. array + runtime
    run("6", "array and runtime", lambda: array_phase(torch, card,
                                                       *reuse[:5]))

    # ------------------------------------------------ 7. LM path, full width
    rows += run("7", "paged LM", lambda: lm_phase(torch, card)) or []

    # ------------------------------------------------ 8. dense-cache LM path
    rows += run("8", "dense LM", lambda: dense_phase(torch, card)) or []

    # the dry run's processes (phase 11) start here: they run beside
    # phases 9-14, after the phases whose times seed the benchmark's cells
    dry = start_dryrun() if "11" in phases else None

    # ------------------------------------------------ 9. recurrent and train
    rows += run("9", "recurrent and train",
                lambda: recurrent_train_phase(torch, card)) or []

    # ------------------------------------------------ 10. training on a mesh
    kept = {}
    rows += run("10", "training on a mesh",
                lambda: mesh_train_phase(torch, card, kept)) or []

    # ------------------------------------------------ 12. serving on a mesh
    rows += run("12", "serving on a mesh",
                lambda: mesh_serve_phase(torch, card)) or []

    # ------------------------------------------------ 13. MoE on a mesh
    rows += run("13", "MoE on a mesh",
                lambda: moe_axis_phase(torch, card)) or []

    # ------------------------------------------------ 14. MLA on a mesh
    mla_rows = run("14", "MLA on a mesh", lambda: mla_axis_phase(torch, card))

    # ------------------------------------------------ 11. the dry run, joined
    # last: its processes run beside phases 9-14
    if dry is not None:
        run("11", "the dry run, joined", lambda: dryrun_phase(
            torch, card, dry[0], dry[1]))
        del dry
    if mla_rows is not None:
        rows += mla_rows()      # phase 14's rows, timed with the host quiet

    # ------------------------------------------------ 15. recurrent on a mesh
    rows += run("15", "recurrent on a mesh",   # with the host quiet too
                lambda: recurrent_axis_phase(torch, card)) or []

    # ------------------------------------------------ 16. encdec on a mesh
    rows += run("16", "encdec on a mesh",
                lambda: encdec_axis_phase(torch, card)) or []

    # ------------------------------------------------ 17. the examples
    run("17", "the examples", lambda: examples_phase(torch, card))

    # ------------------------------------------------ 18. over processes
    run("18", "training over processes",
        lambda: proc_train_phase(torch, card, kept))

    # ------------------------------------------------ 19. result lines
    total = time.perf_counter() - t_start
    print(f"chip_smoke: {total:.1f} s in all; by phase "
          f"{ {k: round(v, 1) for k, v in seconds.items()} }  [{card}]")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
