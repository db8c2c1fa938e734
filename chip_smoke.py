#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --kernels-only   # phases 1-3 and the kernel times
    python3 chip_smoke.py --families-only  # phases 1 and 17
    python3 chip_smoke.py --encdec-mesh-only  # phases 1, 2, 18 and 19
    python3 chip_smoke.py --sharded-only   # phases 1, 2, 19 and 20
    python3 chip_smoke.py --wide-k-only    # phases 1, 2, the checks past K = 256,
                                           # the kmax = 128 and 256 fits (and 256 at n = 16000),
                                           # the stored select's path, the times past K = 256

Phases (any failure exits non-zero):

  1. the card's name and power limit (``nvidia-smi``);
  2. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
     ``nvcc`` per source, all at once), with each template instance's
     registers and spills (``-Xptxas -v``) and its resident blocks per SM
     (``prim_mst``: the clusters a card holds at once);
  3. each kernel against its plain PyTorch version on the card:
     ``pairwise_topk`` at every templated width and a generic one
     (d = 2, 4, 8, 16, 32, 100), at n = 16000 and a ragged n = 1007, with
     K = 23, 72 and 128 (the kmax = 16, 64 and 120 lists), on exact ties
     and with K = n - 1; ``lune_filter`` at the same widths and sizes, and
     below 32 points, on edges whose lunes hold points and edges whose
     lunes are empty, with duplicates, endpoint hits and padded edges;
     ``edge_cascade`` bit for bit on the stage-1 and stage-2 edges of the
     n = 16000 fits at kmax = 16 and 64, in every summation order, at every
     lane count, and on synthetic unsorted edge lists (d = 2, 4, 8, 16, 32,
     64, 100; k_check = 2, 15, 63; invalid slots, duplicates, neighbours
     that are endpoints, core distances tied with edge lengths);
     ``prim_mst`` (src equal, w2 bit-equal) at d = 2, 8, 16, 32, 64, 100,
     320 and n = 1007 and 4000 (d = 320 streams its points at n = 4000),
     under every plan of ``prim_mst.plan_for`` forced once (clusters of 16
     and 8; points and state resident, points streamed, state in device
     memory), and on duplicates with tied core distances, the copies within
     one cluster rank and across ranks; ``single_linkage`` (left, right,
     height, size equal, against the plain version on the card and the
     CPU's run) on random trees with tied and zero weights at R = 1 and 15
     with its state in shared memory and, forced, in device memory; past
     the earlier card limits (the sliced instances above
     d = 256, the lists past K = 128): ``pairwise_topk`` at d = 320, 777,
     1100 and 1536 (a ragged d, two 512-deep panels, windows of windows;
     n = 4000 and 1007, K = 31 and 135), at K = 256 at d = 1536, on exact
     ties at d = 320 (each point 8 times, 500 rows apart: across key tiles
     and key splits, under both plans) and at K = 135 and 256 at d = 8
     (with exact ties), ``lune_filter`` at d = 320, 777, 1100 and 1536,
     ``edge_cascade`` at d = 1536 (windows of windows) and at
     k_check = 127; past K = 256 (``check_select_cases``), bit for bit, the
     streamed select of ``pairwise_topk`` at K = 257 and 307 (n = 4000,
     d = 8; K = 307 also with a row's buffer compacted at K + 32 keys), K =
     n - 1 at n = 1007, K = 1024 at n = 1100, K = 263 at d = 24, on exact
     ties, and the stored select at K = 307 in sort tiles of 128 keys and
     chunks of 128 rows and at K = n - 1 (n = 1007; the streamed select
     turned off), K = 1025 (n = 1100), K = 263 at d = 1536 and on exact ties
     at d = 320, and the K = 257 lists starting with the K = 256 lists;
     ``sbcn_tile`` (the SBCN tiles' products and norms in
     the reference's order above d = 256) bit for bit at d = 320, 1100 and
     1536 on every fused-path tier, the row path's panel tiles (the dense
     path), the slot path's 2-lane tiers, single pairs (XLA's loop) and
     ``_sbcn_large``'s 2-D chunks, ids padded, one bucket of 16000 cells,
     and the direct path past 131072 points;
  4. the main path, ``MultiHDBSCAN(kmax=16).fit(X).select_all()`` on the
     card with the launch counters set to 0 just before it (``select_all``
     runs its linkage through ``single_linkage`` once, checked on the fit's
     own MSTs as in phase 3), held against
     the port's own ``device="cpu"`` fit (graph edges, MST edge ids and
     labels for every mpts equal) and, at n = 2000, against dense scipy
     MSTs (weight multisets to rtol 1e-5), and a duplicate-heavy input on
     the slot path against its CPU run;
  5. the exact variant, ``MultiHDBSCAN(kmax=16, variant="rng")`` at
     n = 16000 with the counters set to 0 just before it: its graph is the
     RNG* fit's minus the edges the lune scan removed, and every mpts keeps
     the RNG* fit's MST weights bit for bit; ``lune_filter`` against its
     plain version on the fit's own unresolved edges and on a ragged
     n = 1007, d = 100 case; the exact variant on the card against its CPU
     run at n = 3000;
  6. the wide fit, ``MultiHDBSCAN(kmax=64)`` at n = 16000 on the card: its
     MST weight multisets for mpts 2..16 equal the kmax = 16 fit's bit for
     bit (the RNG^64 graph holds every smaller mpts' MST, and the canonical
     weights do not depend on kmax), with its stage seconds; ``single_linkage``
     on its R = 63 MSTs;
  7. prediction: 4096 queries against the exact fit on the card, and the
     same queries against its saved artifact loaded on the CPU (labels and
     attachment neighbours equal, probabilities and lambdas to rtol 1e-5,
     equal DBCV profiles), with the rate in queries per second;
  8. the dual-tree tier: ``MultiHDBSCAN(kmax=16).fit(X).select_all()`` at
     n = 20000 (``Plan.dualtree_min_n``, so the default plan
     takes the tier), with the ledger's tags exactly ``knn``, ``graph``,
     ``mst``; held bit for bit against the port's own ``device="cpu"`` fit
     (graph edges, d2, w2, MST edge ids, MST weights, labels) and against a
     ``candidate_method="wspd"`` fit on the card (kNN bit-equal, sorted MST
     weights bit-equal, labels equal), with both tiers' stage seconds;
     ``single_linkage`` on its MSTs (state in shared memory since PR 19);
  9. serving: ``ClusterServeEngine.load`` of phase 7's artifact on the card,
     eight client threads sending phase 7's queries in requests of 1-64
     rows (a quarter over the full range, the rest at one mpts, one in
     eight with the leaf policy): every answer bit-equal to the card
     model's direct prediction of the same rows, mean batch above 1, bad
     requests failing alone, the extraction cache bounded, labels,
     membership and profiles equal to direct calls, the engine's linkage
     through ``single_linkage``; p50/p95 latency, queries/s and the mean
     batch;
  10. the paper's baseline, ``hdbscan_baseline(X, range(2, 17), kmax=16)``
     on phase 4's points with the counters set to 0 just before it: one
     ``prim_mst`` launch per mpts, one ``pairwise_topk``, one
     ``single_linkage``; MST weight multisets equal the RNG* fit's to rtol
     1e-5 and partitions agree for every mpts; at n = 2000 the card's
     baseline equals its ``device="cpu"`` run bit for bit; warm stage
     seconds and the ratio of the baseline to ``fit + select_all``;
  12. LM serving: qwen2-1.5b at its published width and depth with random
     weights from the port's seeded init: the card's float32 logits at 2
     layers against the port's CPU run (max abs 1e-3), prefill + 5 decode
     steps against a forward over the sequence at full depth in float32
     (1e-3 x max(1, max|logit|)), and ``serve.lm.Engine`` in bfloat16 on 8
     requests (prompts of 3-12 tokens, 24 new, half greedy, half at
     temperature 0.8) with the reference's serving regressions (a greedy
     row alone and behind a hot one under two seeds, EOS masking, the
     stats); tokens/s, prefill seconds and seconds a decode step;
  13. embedding curation: the phase-12 model embeds 1500 documents (mean
     of the final hidden states over 48 tokens, d = 1536, 40 injected
     near-duplicates); ``MultiHDBSCAN(kmax=24).fit(X).select_all()`` on the
     card with the counters set to 0 just before it (``pairwise_topk``,
     ``edge_cascade`` and ``single_linkage`` must launch); the first 500
     rows' card fit equals their CPU fit bit for bit (graph counts, the
     SBCN candidates included, since the tiles' products follow the
     reference's order through ``sbcn_tile``, which must launch); the exact
     variant of the documents on the card launches the sliced
     ``lune_filter``, keeps a subset of the RNG* fit's graph and its MST
     weight multisets bit for bit,
     and ``lune_filter`` is timed on its unresolved edges beside its plain
     version and bound; MST weight multisets at mpts 2, 8, 16, 24 equal
     dense scipy MSTs; DBCV's choice and the near-duplicate pairs flagged;
  14. ``MultiHDBSCAN(kmax=128)`` at n = 4000, d = 8 (K = 135) with the
     counters set to 0 just before it: mpts 2..16 MST weight multisets
     equal a kmax = 16 fit's bit for bit; ``MultiHDBSCAN(kmax=256)`` of the
     same points (K = 263) with the counters set to 0 just before it: the
     streamed select once, ``edge_cascade`` at least twice and
     ``single_linkage`` once, 255 levels, mpts 2..128 MST weight multisets
     equal the kmax = 128 fit's bit for bit, its stage seconds and peak
     memory (the MST stage's apart); the stored select's path,
     ``hdbscan_baseline(X, [256], kmax=256)`` at n = 1007, d = 320, with
     the counters set to 0 just before it (the stored select once, MST
     weights against dense scipy); the streamed select timed at (n, d, K) =
     (4000, 8, 263), (16000, 8, 263) and (4000, 8, 307), each in turns with
     the stored select on the same points, and the stored select at (4000,
     1536, 263); then ``pairwise_topk`` at the
     shapes of phases 13 and 14 (and at n = 4000, d = 1536 on phase 3's
     points, the earlier runs' shape) and ``lune_filter`` at d = 1536, each
     beside its plain version (outputs bit-equal) and its bound; the two
     sliced rows, the streamed select's at the kmax = 256 fit's shape and
     the stored select's at d = 1536 join the ``{"kernels": ...}`` line
     (phases 12-16 run before 11);
  15. LM training on a copy of phase 12's masters (the path launches none
     of the hand-written kernels): (a) one AdamW step at full width and 2
     layers in float32 (``microbatch`` 2, ``xent_chunk`` 10 of S = 24, a
     zero mask entry), card against the port's CPU run (loss to relative
     1e-5, ``grad_norm`` 1e-4, each tensor's gradient 1e-4 and its update
     1e-3 in relative Frobenius distance, the update over the elements
     whose two gradients agree to 1e-3); (b) 6 steps at full depth as
     published (bfloat16 compute, float32 masters and AdamW states, remat,
     xent chunks of 512) on ``train_batch`` of 4 x 1024 tokens at lr 3e-4,
     warmup 2: finite losses, the last at least 0.1 below the first; warm
     seconds a step, tokens/s, ``max_memory_allocated`` and (6 N +
     attention) FLOPs as a share of the dense bf16 peak; (c) one step each
     with bfloat16 and int8 states (finite, every tensor moves, state bytes
     as reckoned from the reference's rules); (d) the reference's
     preemption drill through ``python -m repro_torch.launch.train`` on the
     card (reduced qwen2, deterministic algorithms): run A 10 steps, run B
     preempted after 5 and resumed, final checkpoints bit-equal;
  16. MoE, MLA and the patch frontend (after 15, once phase 12's masters
     are freed): deepseek-v2-lite at its published width and depth
     (1.621e10 parameters; the cut: bfloat16 masters, 32.4 GB, where the
     config has float32): float32 logits at 2 layers card vs CPU (max abs
     1e-3), prefill of 8 prompts + 5 decode steps at 2 layers card vs CPU
     (an MoE decode does not reproduce the forward, each call's expert
     capacity being its own), ``Engine`` in bfloat16 at full depth on 8
     requests (tokens/s, prefill, s a decode step, peak memory), one step
     at 1 layer in float32 card vs CPU (loss, aux, grad_norm, gradients,
     updates) and 4 steps at 4 layers in bfloat16 (bfloat16 AdamW states);
     llava-next-34b at its
     published width and 8 layers (bfloat16 masters): forward and prefill
     over 576 patches + 24 text tokens, card vs CPU in float32 at 1 layer
     and in bfloat16 on the card;
  11. warm per-stage seconds, each kernel's time beside its plain version,
     a library yardstick and its bound (``pairwise_topk`` at K = 1 and each K,
     ``lune_filter`` over its edges per block and its point tile,
     ``edge_cascade`` per stage at kmax = 16 and 64 and over its lanes per
     edge, ``prim_mst`` at the baseline's shape with its plan and step
     floor, ``single_linkage`` at R = 15 and 63 and on the n = 20000
     dual-tree fit's MSTs, ``sbcn_tile`` on the embedding fit's largest
     call on each of its paths (its kernels by ``torch.profiler``, its
     bucketing beside ``torch.sort``'s; a row-path block on the dense and
     the bucketed path) and the SBCN norms on its points, on the card
     alone and with the host's enqueue; the kernels line's ``ms`` is with
     the host's enqueue on every row),
     ``hierarchy_linkage`` with the kernel beside the plain version
     on the host, the count of implicit syncs in one warm fit, the device's
     busy share of a fit, of 8 LM decode steps and of one full-depth train
     step (with the LM runs' device time by kernel), and a host profile;
  17. the SSM and recurrent LMs (after 11, once its LM closures are freed),
     mamba2-780m and recurrentgemma-2b at their published width and depth
     (7.8e8 and 2.894e9 parameters, float32 masters, no cut) with random
     weights from the port's seeded init, each: (a) its parameter count
     and bytes; (b) float32 at 2 layers (mamba2) or 5 (griffin: one period
     and the (R, R) remainder), forward logits and prefill + 5 decode
     steps card vs CPU (max abs 1e-3); (c) decode vs forward on the card at
     that depth in float32 (1e-3), over a 300-token prompt (past the
     256-token SSD chunk) or a 2060-token one (past the 2048-slot ring) and
     8 decode steps; (d) ``serve.lm.Engine`` in bfloat16 at full depth on 8
     requests (tokens/s, prefill s, s a decode step and its device time
     from a CUDA graph of the step, peak memory); (e) one AdamW step at
     that depth card vs CPU, phase 15's form; (f) 4 steps at full width
     and depth as published (bfloat16 compute, float32 masters and AdamW
     states, remat) on 4 x 1024 tokens: warm s a step, tokens/s, peak
     memory, (6 N + attention) FLOPs as a share of the dense bf16 peak;
     (g) no clustering kernel launches on these paths (counters set to 0
     before, read after);
  18. the encoder-decoder LM, seamless-m4t-large-v2 at its published width
     and depth (24 + 24 layers, 1633724416 parameters, float32 masters, no
     cut) with random weights from the port's seeded init: (a) its
     parameter count and bytes; (b) float32 at 2 + 2 layers, forward
     logits and prefill + 5 decode steps card vs CPU (max abs 1e-3); (c)
     decode against the teacher-forced forward on the card at that depth
     over 24 steps inside ``dec_len`` (1e-3); (d) serving at full depth
     in bfloat16: 8 requests of 1024 random frames, ``max_len`` 1024
     (``dec_len`` 256), BOS and 24 greedy steps (prefill s, s a decode
     step and its device time from a CUDA graph, tokens/s, peak memory);
     (e) one AdamW step at 2 + 2 layers card vs CPU (phase 15's form);
     (f) 4 steps at full size as published (bfloat16 compute, float32
     masters and AdamW states, remat) on 4 rows of 1024 frames and 256
     decoder tokens: warm s a step, decoder tokens/s and frames/s, peak
     memory, (6 N + attention) FLOPs as a share of the dense bf16 peak;
     (g) no clustering kernel launches (counters set to 0 before, read
     after);
  19. the mesh path at world size 1: an NCCL process group of one rank
     (no fallback to gloo or to the CPU), ``launch.mesh.make_host_mesh``
     and the mesh Plan (``dataclasses.replace(resolve_plan(), mesh=...)``:
     ``sharded``, one shard), RNG* and exact fits of phase 4's points with
     the counters set to 0 just before each: the ring kNN (no
     ``pairwise_topk``), ``edge_cascade``, ``lune_filter`` in the exact
     fit and ``single_linkage`` launch; kNN, edges, MST ids, ``mst_w`` and
     labels bit-equal to the single-device fits on the card; each stage's
     seconds beside the single-device fit's;
  20. the LMs' sharded train step on phase 19's NCCL group (no fallback):
     qwen2-1.5b at its published width and depth as published takes 3
     steps of 4 x 1024 tokens unsharded and then, from the same init,
     through the sharded step (parameters, AdamW states and batch DTensors
     placed by ``dist.sharding`` on ``make_host_mesh()``, an
     ``activation_context``), both under deterministic algorithms: losses
     and updated masters bit-equal; s a step beside the unsharded one's and
     phase 15's, peak memory; no clustering kernel launched (counters set
     to 0 before, read after); and a dry run of ``qwen2_1_5b x train_4k x
     single`` in a subprocess (``launch.dryrun``, 256 fake ranks, no card),
     its bytes per device printed.

Each phase's seconds are printed at the end.  The second-to-last line is
``{"kernels": [...]}``, the last
``{"ok": true, "device": {...}}``.  The full record also goes to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
N, D, KMAX = 16000, 8, 16
KMAX_WIDE = 64
WIDTHS = (2, 4, 8, 16, 32, 100)   # the kernels' templated widths and a generic one
CASCADE_WIDTHS = (2, 4, 8, 16, 32, 64, 100)
CASCADE_K = (2, 15, 63)           # stage 1, and the full lists of kmax = 16 and 64
N_CASCADE = 4000
K_LISTS = (23, 72, 128)           # top-K lengths of kmax = 16, 64 and 120
N_RAGGED = 1007
N_DENSE = 2000
N_EXACT_CPU = 3000
N_QUERIES = 4096
N_DUALTREE = 20000                # at Plan.dualtree_min_n (24000 until the run outgrew its limit)
N_CLIENTS = 8
PRIM_WIDTHS = (2, 8, 16, 32, 64, 100, 320)  # 320 streams its points at n = 4000
N_PRIM = 4000
N_BASELINE_CPU = 2000            # the baseline's CPU comparison (4000 until the run outgrew its limit)
N_LINKAGE = 5000
WIDE_WIDTHS = (320, 1536)       # the sliced instances; 1536 is qwen2-1.5b's d_model
RAGGED_WIDE = (777, 1100)        # a ragged d (d % 4 != 0); two 512-deep panels and windows of windows
N_WIDE = 4000
K_EMBED = 31                      # the top-K of a kmax = 24 fit (the embedding fit)
K_WIDE = (135, 256)               # the top-K of kmax = 128, and the list instances' longest list
K_SELECT = (257, 307)             # past the lists (K > 256; the streamed select at d <= 256): just past, and kmax = 300's
KMAX_256 = 256                    # the streamed select's fit (K = 263)
K_SELECT_FIT = KMAX_256 + 7       # its list, also at d = 24 and, on the stored select, 1536
N_KSTREAM = 1100                  # K = 1024 (the streamed select's longest) and 1025 (the stored select's)
KMAX_128 = 128
LM_ARCH = "qwen2_1_5b"
LM_PARITY_TOL = 1e-3              # float32 logits, card vs CPU, 2 layers at full width
LM_REQUESTS, LM_NEW_TOKENS, LM_MAX_LEN = 8, 24, 48
LM_PROFILED_STEPS = 8
N_DOCS = 1500                     # 4000, 2500, then 2000, until the run outgrew its limit on slow hosts
N_DOCS_CPU = 500                  # the CPU comparison fit's rows: its worker must not set phase 13's time
KMAX_EMBED = 24
TRAIN_PARITY_LAYERS, TRAIN_PARITY_BATCH, TRAIN_PARITY_SEQ = 2, 4, 24
TRAIN_PARITY_CHUNK = 10           # does not divide TRAIN_PARITY_SEQ: chunks of 10, 10 and 4
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 6, 4, 1024   # the loss over two xent chunks of 512 (8 steps until the run outgrew its limit)
TRAIN_LR, TRAIN_WARMUP = 3e-4, 2
TRAIN_LOSS_RTOL, TRAIN_NORM_RTOL, TRAIN_GRAD_RTOL, TRAIN_DELTA_RTOL = 1e-5, 1e-4, 1e-4, 1e-3
SHARDED_STEPS = 3                 # phase 20: a warm-up step, then two timed, each way
DRILL_ARGS = ("--reduced", "--steps", "10", "--global-batch", "4", "--seq-len", "32", "--ckpt-every", "5")
MPTS_DENSE = (2, 8, 16, 24)
SBCN_WIDTHS = (320, 1100, 1536)   # above 256 the SBCN tiles take the reference's order (sbcn_tile); 1100: 8-lane tails
SBCN_TIERS = tuple((a, b, "batched") for a, b in ((1, 2), (1, 4), (1, 8), (2, 2), (2, 4), (2, 8), (4, 4), (4, 8)))
SBCN_PANELS = ((32, 64, "batched"), (256, 512, "batched"), (2, 32, "batched"), (32, 32, "batched"),
               (1, 16, "single"), (1, 600, "2d"), (3, 600, "2d"), (100, 700, "2d"), (17, 1000, "2d"))
# the row path's tiles (dense), the slot path's tiers of 1024-deep slices, single pairs and _sbcn_large's chunks
SBCN_DENSE_SHAPE = ((32, 64), (32, 128))  # a row-path block of the fused path (32 pairs of 64 x 128 cells)
SBCN_TIMED_CELLS = 1 << 19        # cells of a fit call timed, its first pairs (the plain version gathers cells x d floats twice)
MOE_ARCH, VLM_ARCH = "deepseek_v2_lite_16b", "llava_next_34b"
FAMILY_ARCHS = ("mamba2_780m", "recurrentgemma_2b")
FAMILY_PUBLISHED = {
    "mamba2_780m": (("n_layers", "d_model", "d_state", "expand", "ssm_head", "ssd_chunk", "d_conv", "vocab"),
                    (48, 1536, 128, 2, 64, 256, 4, 50280)),
    "recurrentgemma_2b": (("n_layers", "d_model", "n_heads", "n_kv", "d_head", "d_ff", "window", "block_pattern",
                           "vocab"), (26, 2560, 10, 1, 256, 7680, 2048, ("R", "R", "A"), 256000)),
}
FAMILY_DEPTH = {"mamba2_780m": 2, "recurrentgemma_2b": 5}  # griffin: one (R, R, A) period and the (R, R) remainder
FAMILY_LONG = {"mamba2_780m": (300, 8), "recurrentgemma_2b": (2060, 8)}  # (c)'s prompt and decode steps
FAMILY_LONG_NOTE = {"mamba2_780m": "the prompt crosses the 256-token SSD chunk and pads the second",
                    "recurrentgemma_2b": "the prompt fills the 2048-slot ring and wraps it"}
FAMILY_DECODE_REPS = 8
FAMILY_TRAIN_STEPS = 4
FAMILY_TRAIN_BATCH = 4            # griffin's 60 GB peak leaves room: B = 4 for both
ENCDEC_ARCH = "seamless_m4t_large_v2"
ENCDEC_PUBLISHED = (("n_enc_layers", "n_dec_layers", "d_model", "n_heads", "n_kv", "d_head", "d_ff", "vocab",
                     "frontend_dim", "dec_seq_frac", "act", "mlp_bias", "tie_embeddings"),
                    (24, 24, 1024, 16, 16, 64, 8192, 256206, 1024, 0.25, "gelu", True, False))
ENCDEC_PARAMS = 1633724416        # the reference's abstract_init
ENCDEC_DEPTH = 2                  # 2 + 2 layers for the card-vs-CPU checks
ENCDEC_PARITY_FRAMES = 32         # train_parity's frames a row (its decoder rows: TRAIN_PARITY_SEQ tokens)
ENCDEC_DECODE_STEPS = 24          # (c): decode vs the teacher-forced forward, inside dec_len
ENCDEC_REQUESTS, ENCDEC_FRAMES, ENCDEC_MAX_LEN, ENCDEC_NEW_TOKENS = 8, 1024, 1024, 24  # dec_len 256
ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_DEC, ENCDEC_TRAIN_STEPS = 4, 256, 4  # 1024 frames and 256 decoder tokens a row
MOE_PARITY_LAYERS, MOE_PROMPTS, MOE_PROMPT_LEN, MOE_DECODE_STEPS = 2, 8, 12, 5
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 4, 4, 8, 256  # microbatch 4 as published
MOE_TRAIN_STATES = "bfloat16"     # AdamW states: float32 ones (22 GB at 4 layers) left too little beside phase 11's
VLM_LAYERS, VLM_PATCHES, VLM_TEXT = 8, 576, 24
CPU_FIT_THREADS = 4               # the CPU fits' worker: half the card host's 8 cores
CPU_FIT_TIMEOUT = 900
RTOL = 1e-5
CARD = "cuda"
PEAK_F32_FLOPS = 67e12   # H100 SXM, float32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bfloat16 on the tensor cores
PEAK_BYTES = 3.35e12     # H100 SXM HBM3


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def kernel_module(name: str):
    """A kernel's module by its own name: ``repro_torch.kernels`` binds
    ``pairwise_topk``, ``edge_cascade`` and ``lune_filter`` to the kernel
    functions, as the reference's package does."""
    import importlib

    return importlib.import_module(f"repro_torch.kernels.{name}")


def make_points(n: int, d: int, seed: int):
    """16 Gaussian clusters in [-10, 10]^d plus 5% uniform noise, float32."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_noise = n // 20
    centers = rng.uniform(-10.0, 10.0, size=(16, d))
    members = centers[rng.integers(0, 16, n - n_noise)] + rng.normal(0.0, 0.6, size=(n - n_noise, d))
    noise = rng.uniform(-12.0, 12.0, size=(n_noise, d))
    x = np.concatenate([members, noise])
    return x[rng.permutation(n)].astype(np.float32)


def cuda_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean milliseconds of ``fn`` on the card, warm (one call first)
    unless ``warm`` is False (for a plain version that compiles nothing)."""
    import torch

    if warm:
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


def device_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` on the card alone, warm (one call
    first): the card sleeps while the host enqueues the calls, so the
    events time the device back to back.  ``cuda_ms`` counts the host's
    time to enqueue a call wherever that is the slower."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # about 0.1 s of the card's clock
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    check(not start.query(), "the host enqueued every call before the card reached the first")
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` replayed from a CUDA graph captured
    after one warm call on a side stream: the device time of a call of
    thousands of small launches, which ``device_ms`` cannot take (the
    launch queue fills while the card sleeps), without the host's
    dispatch."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, reps)


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def topk_flops_bytes(n: int, d: int, k_eff: int) -> tuple[float, float]:
    """The least work of ``pairwise_topk`` on (n, d) at K = ``k_eff``: d2 is
    symmetric, so n (n - 1) / 2 dot products of 2 d operations and 3 more
    for d2, plus the n norms (2 d each); x read once, the lists written
    once."""
    return n * (n - 1) / 2 * (2 * d + 3) + n * 2 * d, 4 * n * d + 8 * n * k_eff


@contextlib.contextmanager
def keys_split():
    """Within the block, every launch of the sliced ``pairwise_topk``
    splits the keys across blocks (the mirrored plan's budget set to 0)."""
    from repro_torch.kernels import _build

    fn = _build.load("pairwise_topk").repro_pairwise_topk_set_mirror_budget
    fn.argtypes, fn.restype = [ctypes.c_size_t], ctypes.c_size_t
    before = fn(0)
    try:
        yield
    finally:
        fn(before)


@contextlib.contextmanager
def select_plan(sort_tile: int, chunk_bytes: int):
    """Within the block, the select instance sorts ``sort_tile`` keys at a
    time and holds ``chunk_bytes`` of distance rows a chunk (whole tiles of
    128 rows, at least one): small values run its loops over several sort
    tiles and chunks."""
    from repro_torch.kernels import _build

    fn = _build.load("pairwise_topk").repro_pairwise_topk_set_select_plan
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_void_p], None
    before = ctypes.c_int(), ctypes.c_size_t()
    fn(sort_tile, chunk_bytes, ctypes.addressof(before[0]), ctypes.addressof(before[1]))
    try:
        yield
    finally:
        after = ctypes.c_int(), ctypes.c_size_t()
        fn(before[0].value, before[1].value, ctypes.addressof(after[0]), ctypes.addressof(after[1]))


@contextlib.contextmanager
def stream_plan(cap: int = -1, from_k: int = 0):
    """Within the block, the streamed select compacts a row's buffer at
    ``cap`` keys (clamped to [K + 32, the buffer]; -1 leaves it) and runs
    for K above ``from_k`` (0 leaves it; ``pairwise_topk.KSTREAM`` turns the
    instance off, so that the stored select takes its lists)."""
    from repro_torch.kernels import _build

    fn = _build.load("pairwise_topk").repro_pairwise_topk_set_stream_plan
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p], None
    before = ctypes.c_int(), ctypes.c_int()
    fn(cap, from_k, ctypes.addressof(before[0]), ctypes.addressof(before[1]))
    try:
        yield
    finally:
        after = ctypes.c_int(), ctypes.c_int()
        fn(before[0].value, before[1].value, ctypes.addressof(after[0]), ctypes.addressof(after[1]))


def library_topk(x, k_eff: int):
    """The library yardstick of ``pairwise_topk``: the whole d2 matrix from
    ``mm``, self masked, then ``torch.topk``."""
    import torch

    xn = (x * x).sum(1)
    d2 = (xn[:, None] + xn[None, :] - 2.0 * (x @ x.T)).clamp_min_(0.0)
    d2.fill_diagonal_(float("inf"))
    return torch.topk(d2, k_eff, dim=1, largest=False)


def check_pairwise_topk(x, k_eff: int, k_top: int, plain=None) -> float:
    """Kernel vs plain at one shape: raw d2 within 1e-5 * (|q|^2 + |k|^2)
    and, as both run the same float32 arithmetic, the raw lists (d2 and
    indices) bit-equal; refined indices equal.  ``plain`` is the plain
    version's lists where the caller has them.  Returns the largest raw d2
    difference."""
    import torch
    from repro_torch.kernels import ops

    pt = kernel_module("pairwise_topk")

    d_k, i_k = pt.pairwise_topk(x, k_eff)
    d_p, i_p = pt.pairwise_topk_plain(x, k_eff) if plain is None else plain
    torch.cuda.synchronize()
    n = x.shape[0]
    check(d_k.shape == (n, k_eff) and i_k.shape == (n, k_eff), "pairwise_topk output shape")
    check(bool(torch.isfinite(d_k).all()), "pairwise_topk d2 finite")
    rows = torch.arange(n, device=x.device)[:, None]
    check(bool(((i_k >= 0) & (i_k < n) & (i_k != rows)).all()), "pairwise_topk indices in range, self excluded")
    xn = (x * x).sum(1)
    tol = RTOL * (xn[:, None] + xn[i_k.long()])
    err = (d_k - d_p).abs()
    what = f"n={n}, d={x.shape[1]}, K={k_eff}"
    check(bool((err <= tol).all()), f"pairwise_topk raw d2 off by up to {float(err.max())} at {what}")
    n_rows = int(((d_k != d_p) | (i_k != i_p)).any(1).sum())
    check(n_rows == 0, f"pairwise_topk raw lists differ from the plain version's in {n_rows} rows at {what}")
    _, r_k = ops._refine_knn(x, x, i_k, k_top=k_top)
    _, r_p = ops._refine_knn(x, x, i_p, k_top=k_top)
    check(bool((r_k == r_p).all()), f"pairwise_topk refined indices differ at {what}")
    return float(err.max())


def make_queries(x_np, n_q: int, seed: int):
    """Half near fitted points, half uniform over the data's box, float32."""
    import numpy as np

    rng = np.random.default_rng(seed)
    near = x_np[rng.integers(0, len(x_np), n_q // 2)] + rng.normal(0.0, 0.3, size=(n_q // 2, x_np.shape[1]))
    far = rng.uniform(x_np.min(0), x_np.max(0), size=(n_q - n_q // 2, x_np.shape[1]))
    return np.concatenate([near, far]).astype(np.float32)


def lune_args(ea, eb, w2, points, cd2):
    """The ``lune_filter`` operands ``ops.lune_nonempty`` gathers."""
    a, b = ea.long(), eb.long()
    return (points[a], points[b], cd2[a], cd2[b], ea, eb, w2, points, cd2)


def check_lune_filter(args, what: str, *, block_e: int, block_c: int):
    """Kernel vs plain on one set of operands: verdict bits equal.  Returns
    the kernel's verdicts and the largest difference of the two as 0/1."""
    import torch
    lf = kernel_module("lune_filter")

    out_k = lf.lune_filter(*args, block_e=block_e, block_c=block_c)
    out_p = lf.lune_filter_plain(*args)
    torch.cuda.synchronize()
    n_diff = int((out_k != out_p).sum())
    check(n_diff == 0, f"lune_filter verdicts differ from the plain version on {n_diff} edges ({what})")
    return out_k, float((out_k.int() - out_p.int()).abs().max()) if out_k.numel() else 0.0


def lune_case(n: int, d: int, dev):
    """n points in d dimensions, clustered, with exact duplicates, and
    4000 edges: to near and far points at their mrd, weighted above their
    own mrd (an endpoint would lie inside if it counted), between a point
    and its duplicate, and padded (w2 = -inf).  Core distances are the
    7th-neighbour d2 of the plain top-K, on ``dev``."""
    import numpy as np
    import torch
    pt = kernel_module("pairwise_topk")

    rng = np.random.default_rng(SEED + 4 + d)
    centers = rng.uniform(-3.0, 3.0, size=(6, d))
    x = centers[rng.integers(0, 6, n - 100)] + rng.normal(0.0, 0.5, size=(n - 100, d))
    x = np.concatenate([x, x[:100]]).astype(np.float32)
    cd2 = pt.pairwise_topk_plain(torch.from_numpy(x).to(dev), 7)[0][:, -1].cpu().numpy()
    m = 4000
    ea = rng.integers(0, n, m).astype(np.int32)
    eb = np.where(rng.random(m) < 0.5, (ea + rng.integers(1, 30, m)) % n, rng.integers(0, n, m)).astype(np.int32)
    ea[:50], eb[:50] = np.arange(50), np.arange(n - 100, n - 50)  # a point and its duplicate
    w2 = np.maximum(((x[ea] - x[eb]) ** 2).sum(-1), np.maximum(cd2[ea], cd2[eb])).astype(np.float32)
    w2[50:400] *= 4.0
    w2[::29] = -np.inf
    t = lambda v: torch.from_numpy(v).to(dev)  # noqa: E731
    return lune_args(t(ea), t(eb), t(w2), t(x), t(cd2))


def check_lune_cases(dev, block_e: int, block_c: int) -> dict:
    """``lune_filter`` kernel vs plain (verdict bits equal) at every width
    of ``WIDTHS``, at n = 16000 and the ragged n = 1007; each case has both
    verdicts, and padded edges are never removed.  Returns the cases."""
    import torch

    cases = {}
    for d in WIDTHS:
        for n in (N, N_RAGGED):
            args = cases[(n, d)] = lune_case(n, d, dev)
            out, _ = check_lune_filter(args, f"n={n}, d={d}", block_e=block_e, block_c=block_c)
            w2 = args[6]
            check(bool(out.any()) and not bool(out[torch.isfinite(w2)].all()),
                  f"the lune case n={n}, d={d} has both verdicts")
            check(not bool(out[torch.isneginf(w2)].any()), "padded edges (w2 = -inf) are never removed")
    # fewer points than a warp's lanes, at a generic width and at d = 1
    for n, d in ((20, 3), (24, 1)):
        args = small_lune_case(n, d, dev)
        out, _ = check_lune_filter(args, f"n={n}, d={d}", block_e=block_e, block_c=block_c)
        check(not bool(out[torch.isneginf(args[6])].any()), "padded edges (w2 = -inf) are never removed")
    print(f"lune_filter: kernel == plain (verdict bits) at d={list(WIDTHS)}, n={N} and n={N_RAGGED} "
          f"({len(cases)} cases of 4000 edges), and at n=20, d=3 and n=24, d=1", flush=True)
    return cases


def small_lune_case(n: int, d: int, dev):
    """n < 32 points, half of them duplicates of the other half, and 64
    edges weighted at or above their mrd, every 7th padded (w2 = -inf)."""
    import numpy as np
    import torch
    pt = kernel_module("pairwise_topk")

    rng = np.random.default_rng(SEED + 8 + d)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[n // 2 :] = x[: n - n // 2]
    cd2 = pt.pairwise_topk_plain(torch.from_numpy(x), 3)[0][:, -1].numpy()
    ea = rng.integers(0, n, 64).astype(np.int32)
    eb = ((ea + rng.integers(1, n, 64)) % n).astype(np.int32)
    w2 = np.maximum(((x[ea] - x[eb]) ** 2).sum(-1), np.maximum(cd2[ea], cd2[eb]))
    w2 = (w2 * rng.choice([1.0, 4.0], 64)).astype(np.float32)
    w2[::7] = -np.inf
    t = lambda v: torch.from_numpy(v).to(dev)  # noqa: E731
    return lune_args(t(ea), t(eb), t(w2), t(x), t(cd2))


def check_topk_cases(dev, x) -> dict:
    """``pairwise_topk`` kernel vs plain at every width of ``WIDTHS``, at
    n = 16000 and the ragged n = 1007, for every K of ``K_LISTS``.  The
    d = 8 points are the fit's own ``x``.  Returns the largest raw d2
    difference per case."""
    import numpy as np
    import torch

    errs = {}
    for d in WIDTHS:
        xd = x if d == D else torch.from_numpy(make_points(N, d, SEED + d)).to(dev)
        for n in (N, N_RAGGED):
            for k_eff in K_LISTS:
                errs[f"n={n},d={d},K={k_eff}"] = check_pairwise_topk(xd[:n], k_eff, k_eff - 8)
    # exact ties (each point 8 times) at every K, and lists as long as the
    # row (K = n - 1) at a generic width and at d = 1
    rng = np.random.default_rng(SEED + 7)
    t = lambda v: torch.from_numpy(v.astype(np.float32)).to(dev)  # noqa: E731
    x_dup = t(np.repeat(rng.normal(size=(40, 2)), 8, axis=0))
    for xs, k_eff in [(x_dup, k) for k in K_LISTS] + [(t(rng.normal(size=(20, 3))), 19),
                                                      (t(rng.normal(size=(40, 1))), 39)]:
        n, d = xs.shape
        errs[f"n={n},d={d},K={k_eff}"] = check_pairwise_topk(xs, k_eff, max(1, k_eff - 8))
    print(f"pairwise_topk: kernel == plain (raw lists bit-equal, refined indices equal) at d={list(WIDTHS)}, "
          f"n={N} and n={N_RAGGED}, K={list(K_LISTS)}; and with exact ties (n=320) and K = n - 1 "
          f"(n=20, d=3; n=40, d=1)", flush=True)
    return errs


def check_sbcn_tile_cases(dev) -> float:
    """``sbcn_tile`` against its plain version on the card at d = 320, 1100
    and 1536: every tier of the fused path (512 pairs each), the row path's
    panel tiles ((32, 64) and (256, 512): the dense path) and the slot
    path's tiers and chunks ((2, 32), (32, 32); single pairs at a = 1 in
    XLA's loop; ``_sbcn_large``'s 2-D chunks at 600, 700 and 1000 columns,
    in 2, 1 and 4 lanes), 4 pairs each, with a tenth of the ids padded (-1);
    a tier whose cells all fall in one bucket (16 work items), and the
    direct path past ``MAX_TILES`` tiles of points; and the points' norms
    (the windows-of-32 pre-pass): bit-equal.  Returns the max abs error (0)."""
    import numpy as np
    import torch

    st = kernel_module("sbcn_tile")
    err = 0.0

    def held(x, a, b, kind, what):
        nonlocal err
        got, want = st.tile_dots(x, a, b, kind), st.tile_dots_plain(x, a, b, kind=kind)
        order = st.dot_order(a.shape[1], b.shape[1], x.shape[1], kind)
        path = st.kernel_path(order, a.shape[1], b.shape[1], x.shape[0])
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"sbcn_tile {what} == plain bit for bit (order {order}, {path} path)")
        err = max(err, float((got - want).abs().max()))

    def ids(rng, n, shape, hi=None):
        v = rng.integers(0, hi or n, shape)
        v[rng.random(v.shape) < 0.1] = -1
        return torch.from_numpy(v.astype(np.int32)).to(dev)

    for d in SBCN_WIDTHS:
        n = 2000
        x = torch.from_numpy(make_points(n, d, SEED + 50 + d)).to(dev)
        check(torch.equal(st.point_norms(x), st.point_norms_plain(x)), f"sbcn_tile norms == plain at d={d}")
        rng = np.random.default_rng(SEED + d)
        for a_w, b_w, kind in SBCN_TIERS + SBCN_PANELS:
            p = 512 if (a_w, b_w, kind) in SBCN_TIERS else 4
            held(x, ids(rng, n, (p, a_w)), ids(rng, n, (p, b_w)), kind, f"({a_w}, {b_w}) {kind} tiles at d={d}")
        held(x, ids(rng, n, (2000, 1), 128), ids(rng, n, (2000, 8), 128), "batched",
             f"one bucket's 16000 cells at d={d}")
    n_far = st.BUCKET_ROWS * st.MAX_TILES + 7
    x = torch.from_numpy(np.random.default_rng(SEED).normal(size=(n_far, 260)).astype(np.float32)).to(dev)
    rng = np.random.default_rng(SEED + 1)
    held(x, ids(rng, n_far, (4000, 1)), ids(rng, n_far, (4000, 2)), "batched", f"(1, 2) tiles over n={n_far} (direct)")
    print(f"sbcn_tile: kernel == plain bit for bit at d={list(SBCN_WIDTHS)} on tiers {list(SBCN_TIERS)} and "
          f"tiles {list(SBCN_PANELS)} (padded ids), one bucket of 16000 cells, the direct path at n={n_far}; "
          f"norms too", flush=True)
    del x
    return err


def sort_buckets(a, b, n: int):
    """The bucketed path's bucketing in torch ops, for timing only (the
    port uses none of it): each real cell's key (its bucket of 128-row
    tiles, then its a-row in the tile), sorted, and each bucket's first
    place found by ``searchsorted``; no host sync, as the kernel's counting
    pass.  Returns the cells in key order and the (buckets + 1) bounds."""
    import torch

    t = kernel_module("sbcn_tile").BUCKET_ROWS
    nt = -(-n // t)
    ia, ib = a[:, :, None].long(), b[:, None, :].long()
    key = ((ia // t) * nt + ib // t) * t + ia % t
    key = torch.where((ia >= 0) & (ib >= 0), key, torch.iinfo(torch.int64).max).reshape(-1)
    sorted_key, cells = torch.sort(key)
    return cells, torch.searchsorted(sorted_key, torch.arange(nt * nt + 1, device=a.device) * t)


def bucketed_breakdown(fn, calls: int) -> dict:
    """Device microseconds a call of each kernel (and memset) that ``fn``
    launches, from ``torch.profiler`` over ``calls`` calls (empty where the
    profiler records no device activity)."""
    import re
    from collections import Counter

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:  # "void (anonymous namespace)::name<...>(args)", "Memset (Device)"
            m = re.search(r"(\w+)(?:<[^>]*>)?\(", e.name)
            us[m.group(1) if m else e.name.strip()] += (e.time_range.end - e.time_range.start) / calls
    return dict(us)


SBCN_ROW_NAMES = {"dense": "sbcn_tile", "bucketed": "sbcn_tile_tiers", "loop": "sbcn_tile_loop",
                  "direct": "sbcn_tile_direct"}


def sbcn_tile_rows(x, calls: dict, launches: dict, smi: str, record: dict) -> list:
    """``sbcn_tile`` on the embedding fit's own largest call on each path
    of the kernel it took (``tile_dots.largest``; its first pairs, up to
    SBCN_TIMED_CELLS cells; where the fit made no row-path call, one
    row-path block of SBCN_DENSE_SHAPE on the fit's points, its
    ``fit_call_pairs`` 0), beside its plain version, a library yardstick
    (gather, then ``torch.bmm``: the same products in cuBLAS's order; on
    the dense path that is ``mm`` a pair on the same gathered rows) and
    its bound (2 d operations a real cell; each referenced row, the ids and
    the products moved once); and the points' norms (the windows-of-32
    pre-pass, ``point_norms``) on the fit's points beside their plain
    version, ``torch.einsum`` and their bound.  ``ms`` and ``library_ms``
    count the host's enqueue (``cuda_ms``), as every row of the
    ``{"kernels": ...}`` line; ``device_ms`` and ``library_device_ms`` time
    the card alone (``device_ms``); the call's bucketing is inside both.
    The row-path block is timed on the dense path and on the bucketed path
    forced (``bucketed_ms``); the bucketed call's kernels are broken down
    by ``torch.profiler`` and its bucketing timed against ``sort_buckets``
    (``torch.sort``).  Each row's launches are its path's in the fit
    (``tile_dots.path_launches``).  Returns a row of the kernels line for
    each path the fit launched, and for the norms."""
    import torch

    import numpy as np

    st = kernel_module("sbcn_tile")
    check(bool(calls), "the embedding fit called sbcn_tile")
    rows, out = {}, []
    n, d = x.shape
    fit, calls = set(calls), dict(calls)
    if "dense" not in calls:  # the fit made no row-path call: time one at the row path's shape on its points
        rng = np.random.default_rng(SEED + 22)
        calls["dense"] = tuple(torch.from_numpy(rng.integers(0, n, shape).astype(np.int32)).to(x.device)
                               for shape in SBCN_DENSE_SHAPE) + ("batched",)
    for path, (a, b, kind) in sorted(calls.items()):
        keep = max(1, SBCN_TIMED_CELLS // (a.shape[1] * b.shape[1]))
        a, b = a[:keep], b[:keep]
        cells = a.numel() * b.shape[1]
        got, want = st.tile_dots(x, a, b, kind), st.tile_dots_plain(x, a, b, kind=kind)
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"sbcn_tile == plain on the fit's {path} call")
        kernel = lambda: st.tile_dots(x, a, b, kind)  # noqa: E731
        library = lambda: torch.bmm(x[a.clamp_min(0).long()], x[b.clamp_min(0).long()].transpose(1, 2))  # noqa: E731
        dev_ms, library_dev_ms = device_ms(kernel, 10), device_ms(library, 10)
        ms, library_ms = cuda_ms(kernel, 10), cuda_ms(library, 10)
        plain_ms = cuda_ms(lambda: st.tile_dots_plain(x, a, b, kind=kind), 1, warm=False)
        real = int(((a >= 0)[:, :, None] & (b >= 0)[:, None, :]).sum())
        rows_read = int(torch.unique(torch.cat([a[a >= 0], b[b >= 0]])).numel())
        b_ms, b_by = bound(2.0 * d * real, 4.0 * (rows_read * d + a.numel() + b.numel() + cells))
        order = st.dot_order(int(a.shape[1]), int(b.shape[1]), d, kind)
        rows[path] = {"shape": [int(a.shape[0]), int(a.shape[1]), int(b.shape[1])], "d": d, "kind": kind,
                      "real_cells": real, "fit_call_pairs": int(calls[path][0].shape[0]) if path in fit else 0,
                      "order": list(order), "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                      "library_ms": library_ms, "library_device_ms": library_dev_ms, "bound_ms": b_ms,
                      "bound_by": b_by}
        if path == "dense":  # the same block through the bucketed path
            forced = lambda: st.tile_dots(x, a, b, kind, path="bucketed")  # noqa: E731
            check(torch.equal(forced().view(torch.int32), want.view(torch.int32)),
                  "sbcn_tile's bucketed path == plain on the row-path block")
            rows[path]["bucketed_ms"], rows[path]["bucketed_device_ms"] = cuda_ms(forced, 10), device_ms(forced, 10)
        if path == "bucketed":  # its kernels, and its bucketing against torch.sort's
            rows[path]["device_us_by_kernel"] = bucketed_breakdown(kernel, 5)
            rows[path]["sort_buckets_device_ms"] = device_ms(lambda: sort_buckets(a, b, n), 10)
        what = f"the embedding fit's largest {path} call" if path in fit else "a row-path block (the fit made none)"
        print(f"sbcn_tile on {what}, {smi}: " + json.dumps(rows[path]), flush=True)
        if path not in fit:  # not on the main path: in the record, not in the kernels line
            continue
        out.append({"name": SBCN_ROW_NAMES[path], "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/sbcn_tile.cu",
                    "replaces": "src/repro/core/sbcn.py:" + ("109" if kind == "2d" else "53"),
                    "launches": launches["sbcn_tile_paths"].get(path, 0),
                    "max_abs_err": float((got - want).abs().max()), "ms": ms, "device_ms": dev_ms,
                    "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
                    "library_device_ms": library_dev_ms})
    got, want = st.point_norms(x), st.point_norms_plain(x)
    check(torch.equal(got.view(torch.int32), want.view(torch.int32)), "point_norms == plain on the fit's points")
    kernel, library = (lambda: st.point_norms(x)), (lambda: torch.einsum("ij,ij->i", x, x))
    dev_ms, library_dev_ms = device_ms(kernel, 20), device_ms(library, 20)
    ms, library_ms = cuda_ms(kernel, 20), cuda_ms(library, 20)
    plain_ms = cuda_ms(lambda: st.point_norms_plain(x), 1, warm=False)
    b_ms, b_by = bound(2.0 * n * d, 4.0 * (n * d + n))
    rows["norms"] = {"n": n, "d": d, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     "library_device_ms": library_dev_ms, "bound_ms": b_ms, "bound_by": b_by}
    out.append({"name": "sbcn_norms", "route": "cuda", "source": "src/repro_torch/kernels/csrc/norms_win32.cuh",
                "replaces": "src/repro/core/sbcn.py:48", "launches": launches["sbcn_norms"],
                "max_abs_err": float((got - want).abs().max()), "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms, "library_device_ms": library_dev_ms})
    print(f"point_norms (the SBCN norms) on the embedding fit's points, {smi}: " + json.dumps(rows["norms"]),
          flush=True)
    record["sbcn_tile"] = rows
    return out


def check_wide_cases(dev) -> dict:
    """The kernels past their earlier card limits, each against its plain
    version on the card: ``pairwise_topk`` at d = 320, 777, 1100 and 1536
    (the sliced instance: a ragged d, two 512-deep panels, windows of
    windows; n = 4000 and the ragged 1007, K = 31 and 135), at K = 256 at
    d = 1536, on exact ties at d = 320 (each point 8 times, 500 rows apart,
    so that tied keys fall in different key tiles and key splits; K = 31
    under the mirrored plan and with the keys split, K = 135 split) and at
    K = 135 and 256 at d = 8 (n = 4000, 1007, and exact ties);
    ``lune_filter`` at d = 320, 777, 1100 and 1536; ``edge_cascade`` at
    d = 1536 and at k_check = 127 (the kmax = 128 list).  All bit-equal.
    Returns the largest raw d2 difference per ``pairwise_topk`` case (0
    when bit-equal)."""
    import numpy as np
    import torch
    from repro_torch.kernels import fused_cascade as fc, ops

    errs = {}
    for d in WIDE_WIDTHS + RAGGED_WIDE:
        xd = torch.from_numpy(make_points(N_WIDE, d, SEED + d)).to(dev)
        for n in (N_WIDE, N_RAGGED):
            for k_eff in (K_EMBED, K_WIDE[0]):
                errs[f"n={n},d={d},K={k_eff}"] = check_pairwise_topk(xd[:n], k_eff, k_eff - 8)
        if d == WIDE_WIDTHS[-1]:
            errs[f"n={N_WIDE},d={d},K={K_WIDE[1]}"] = check_pairwise_topk(xd, K_WIDE[1], K_WIDE[1] - 8)
    rng = np.random.default_rng(SEED + 12)
    # copy j of point i at row i + 500 j: the copies lie in other key tiles
    # (the mirrored plan's partial lists) and other key splits
    x_tie = torch.from_numpy(np.tile(rng.normal(size=(N_WIDE // 8, WIDE_WIDTHS[0])), (8, 1))
                             .astype(np.float32)).to(dev)
    for k_eff in (K_EMBED, K_WIDE[0]):
        errs[f"n={N_WIDE},d={WIDE_WIDTHS[0]},K={k_eff},ties"] = check_pairwise_topk(x_tie, k_eff, k_eff - 8)
    with keys_split():
        errs[f"n={N_WIDE},d={WIDE_WIDTHS[0]},K={K_EMBED},ties,split"] = check_pairwise_topk(
            x_tie, K_EMBED, K_EMBED - 8)
    x8 = torch.from_numpy(make_points(N_WIDE, D, SEED + 11)).to(dev)
    x_dup = torch.from_numpy(np.repeat(rng.normal(size=(40, 2)), 8, axis=0).astype(np.float32)).to(dev)
    for k_eff in K_WIDE:
        for xs in (x8, x8[:N_RAGGED], x_dup):
            n, d = xs.shape
            errs[f"n={n},d={d},K={k_eff}"] = check_pairwise_topk(xs, k_eff, k_eff - 8)
    print(f"pairwise_topk: kernel == plain (raw lists bit-equal, refined indices equal) at "
          f"d={list(WIDE_WIDTHS + RAGGED_WIDE)} (n={N_WIDE} and {N_RAGGED}, K={K_EMBED} and {K_WIDE[0]}; "
          f"K={K_WIDE[1]} at d={WIDE_WIDTHS[-1]}), on exact ties at d={WIDE_WIDTHS[0]} (n={N_WIDE}, each point 8 "
          f"times, 500 rows apart; K={K_EMBED} under both plans), and at K={list(K_WIDE)} at d={D} "
          f"(n={N_WIDE}, {N_RAGGED}, and exact ties at n=320)", flush=True)
    for d in WIDE_WIDTHS + RAGGED_WIDE:
        for n in (N_WIDE, N_RAGGED):
            args = lune_case(n, d, dev)
            out, _ = check_lune_filter(args, f"n={n}, d={d}", block_e=8, block_c=512)
            check(bool(out.any()) and not bool(out[torch.isfinite(args[6])].all()),
                  f"the lune case n={n}, d={d} has both verdicts")
            check(not bool(out[torch.isneginf(args[6])].any()), "padded edges (w2 = -inf) are never removed")
    print(f"lune_filter: kernel == plain (verdict bits) at d={list(WIDE_WIDTHS + RAGGED_WIDE)}, n={N_WIDE} and "
          f"{N_RAGGED}", flush=True)
    n_cases = 0
    for d, k_checks in ((WIDE_WIDTHS[-1], (2, K_EMBED - 8)), (D, (2, K_WIDE[0] - 8))):
        base, ea, eb, valid = cascade_case(d, max(k_checks), dev)
        fit_order = ops.sum_order(d, "cascade")
        for k_check in k_checks:
            for order in orders_at(d):
                lanes = (0, *fc.LANES) if order == fit_order else (0,)
                (killed, cert, n_valid), _ = check_cascade(base, ea, eb, valid, k_check, order,
                                                           f"the d={d} case", lanes, chunk=4096)
                check(0 < killed and 0 < cert, f"the d={d}, k_check={k_check} case has killed and certified edges")
                n_cases += 1
    print(f"edge_cascade: kernel == plain (bit for bit) on {n_cases} synthetic cases at d={WIDE_WIDTHS[-1]} "
          f"(k_check=2, {K_EMBED - 8}) and d={D} (k_check=2, {K_WIDE[0] - 8}), every order, every lane count "
          f"in the fit's order", flush=True)
    return errs


def check_select_cases(dev) -> dict:
    """The lists past K = 256 against the plain version on the card, raw
    lists bit-equal and refined indices equal.  The streamed select (K <= 1024
    at d <= 256): K = 257 and 307 at n = 4000, d = 8, K = 307 again with a
    row's buffer compacted at K + 32 keys (the small-buffer hook: a row
    compacts some (K / 32) ln(n / (K + 32)), about 21, times); K = n - 1 at
    the ragged n = 1007; K = 1024 at n = 1100; K = 263 at d = 24 (a generic
    width); exact ties (each point 8 times: n = 320, d = 2 at K = 257 and
    n - 1).  The stored select: K = 307 at d = 8 in sort tiles of 128 keys
    and chunks of 128 rows and K = n - 1 at n = 1007 (the streamed select
    turned off by the hook, on the same plain lists), K = 1025 at n = 1100
    (past the streamed select's longest), K = 263 at d = 1536 (the sliced
    product) and on exact ties at d = 320 (copies 500 rows apart).  On each
    of x8, the d = 2 ties and the d = 320 ties the first 256 entries of the
    K = 257 list equal the K = 256 list, bit for bit.  Returns the largest
    raw d2 difference per case (0 when bit-equal)."""
    import numpy as np
    import torch

    pt = kernel_module("pairwise_topk")
    errs = {}
    def case(xs, k_eff: int, label: str = "", plain=None, hook=None, stored: bool = False):
        """One case under ``hook``, on the stored select where ``stored``
        (the streamed one turned off), else on the instance ``dispatch``
        routes it to; its key names the instance."""
        n, d = xs.shape
        inst = "select" if stored else pt.instance(d, k_eff)
        with hook or contextlib.nullcontext(), stream_plan(from_k=pt.KSTREAM) if stored else contextlib.nullcontext():
            errs[f"n={n},d={d},K={k_eff},{inst}{label}"] = check_pairwise_topk(xs, k_eff, k_eff - 8, plain)

    x8 = torch.from_numpy(make_points(N_WIDE, D, SEED + 11)).to(dev)
    case(x8, K_SELECT[0])
    plain_307 = pt.pairwise_topk_plain(x8, K_SELECT[1])
    case(x8, K_SELECT[1], plain=plain_307)
    case(x8, K_SELECT[1], ",cap", plain_307, stream_plan(cap=K_SELECT[1] + 32))
    case(x8, K_SELECT[1], ",tiles", plain_307, select_plan(128, 1), stored=True)
    x_r = x8[:N_RAGGED]
    plain_r = pt.pairwise_topk_plain(x_r, N_RAGGED - 1)
    case(x_r, N_RAGGED - 1, plain=plain_r)
    case(x_r, N_RAGGED - 1, plain=plain_r, stored=True)
    x_k = torch.from_numpy(make_points(N_KSTREAM, D, SEED + 13)).to(dev)
    case(x_k, pt.KSTREAM)
    case(x_k, pt.KSTREAM + 1)
    for d in (24, WIDE_WIDTHS[-1]):
        case(torch.from_numpy(make_points(N_WIDE, d, SEED + d)).to(dev), K_SELECT_FIT)
    rng = np.random.default_rng(SEED + 12)
    t = lambda v: torch.from_numpy(v.astype(np.float32)).to(dev)  # noqa: E731
    x_dup = t(np.repeat(rng.normal(size=(40, 2)), 8, axis=0))
    x_tie = t(np.tile(rng.normal(size=(N_WIDE // 8, WIDE_WIDTHS[0])), (8, 1)))
    for xs, k_eff in ((x_dup, K_SELECT[0]), (x_dup, len(x_dup) - 1), (x_tie, K_SELECT_FIT)):
        case(xs, k_eff, ",ties")
    for xs in (x8, x_dup, x_tie):
        d_256, i_256 = pt.pairwise_topk(xs, 256)
        d_257, i_257 = pt.pairwise_topk(xs, 257)
        check(bool((d_257[:, :256].view(torch.int32) == d_256.view(torch.int32)).all()
                   and (i_257[:, :256] == i_256).all()),
              f"the K=257 lists start with the K=256 lists at n={xs.shape[0]}, d={xs.shape[1]}")
    print(f"pairwise_topk past K=256: kernel == plain (raw lists bit-equal, refined indices equal); the streamed "
          f"select at K={list(K_SELECT)} (n={N_WIDE}, d={D}; K={K_SELECT[1]} also compacting at K+32), K=n-1 "
          f"(n={N_RAGGED}), K={pt.KSTREAM} (n={N_KSTREAM}), K={K_SELECT_FIT} at d=24, on exact ties (n=320, d=2, "
          f"K={K_SELECT[0]} and n-1); the stored select at K={K_SELECT[1]} in sort tiles of 128 and chunks of 128 "
          f"rows, K=n-1 (n={N_RAGGED}), K={pt.KSTREAM + 1} (n={N_KSTREAM}), K={K_SELECT_FIT} at "
          f"d={WIDE_WIDTHS[-1]}, on exact ties (d={WIDE_WIDTHS[0]}); K=257 lists start with the K=256 lists",
          flush=True)
    return errs


def prim_case(n: int, d: int, dev, ties: str | None = None):
    """``make_points`` at (n, d) on ``dev`` and squared core distances from
    the plain top-K (7th neighbour).  With ``ties`` every point comes 8
    times and the core distances (10th neighbour) are rounded to one
    decimal, so mrd values, and the argmin's minima, tie often: ``"near"``
    puts the copies next to each other (one cluster rank), ``"apart"``
    n / 8 rows apart (``np.tile``: across the cluster's ranks, so equal
    minima meet in the cross-block reduction)."""
    import numpy as np
    import torch

    pt = kernel_module("pairwise_topk")
    x = make_points(n, d, SEED + 9 + d)
    if ties == "near":
        x = np.ascontiguousarray(np.repeat(x[: -(-n // 8)], 8, axis=0)[:n])
    elif ties == "apart":
        x = np.ascontiguousarray(np.tile(x[: -(-n // 8)], (8, 1))[:n])
    xt = torch.from_numpy(x).to(dev)
    cd2 = pt.pairwise_topk_plain(xt, 10 if ties else 7)[0][:, -1]
    if ties:
        cd2 = torch.round(cd2, decimals=1)
    return xt, cd2.contiguous()


@contextlib.contextmanager
def prim_plan(**forced):
    """Within the block, every ``prim_mst`` launch takes the forced plan
    (``prim_mst.set_plan``: cluster, points, state)."""
    pm = kernel_module("prim_mst")
    before = pm.set_plan(**forced)
    try:
        yield
    finally:
        pm.set_plan(**before)


def check_prim(x, cd2, what: str):
    """``prim_mst`` kernel vs plain on the card: src equal, w2 bit-equal."""
    import torch

    pm = kernel_module("prim_mst")
    s_k, w_k = pm.prim_mst(x, cd2)
    s_p, w_p = pm.prim_mst_plain(x, cd2)
    torch.cuda.synchronize()
    n = x.shape[0]
    check(s_k.shape == (n,) and w_k.shape == (n,) and float(w_k[0]) == 0.0, f"prim_mst output at {what}")
    check(bool(((s_k >= 0) & (s_k < n)).all()) and bool(torch.isfinite(w_k).all()), f"prim_mst src and w2 at {what}")
    n_src = int((s_k != s_p).sum())
    check(n_src == 0, f"prim_mst src differs from the plain version at {n_src} vertices ({what})")
    n_w = int((w_k.view(torch.int32) != w_p.view(torch.int32)).sum())
    check(n_w == 0, f"prim_mst w2 differs from the plain version's bits at {n_w} vertices ({what})")
    return w_k


def plan_str(plan) -> str:
    return f"C={plan.cluster}, {plan.threads} threads, points {plan.points}, state {plan.state}"


def check_prim_cases(dev) -> None:
    """``prim_mst`` kernel vs plain (src equal, w2 bit-equal) at every width
    of ``PRIM_WIDTHS`` at n = 1007 and 4000 under the chosen plans (d = 320
    streams its points); under every plan ``plan_for`` can return, each
    forced once (clusters of 16 and 8; points and state resident, points
    streamed, state in device memory); and on duplicates with tied core
    distances, the copies within one cluster rank and across ranks, under
    both cluster sizes."""
    import torch

    pm = kernel_module("prim_mst")
    from repro_torch.kernels import _build

    budget = _build.load("prim_mst").repro_prim_mst_smem_budget()
    check(budget == pm.SMEM_BUDGET, f"prim_mst.SMEM_BUDGET mirrors the library's ({budget})")
    card_c = pm.card_cluster(dev)
    chosen = {}
    for d in PRIM_WIDTHS:
        for n in (N_RAGGED, N_PRIM):
            check_prim(*prim_case(n, d, dev), f"n={n}, d={d}")
            chosen[(n, d)] = plan_str(pm.launch_plan(n, d, dev))
    check(pm.launch_plan(N_PRIM, PRIM_WIDTHS[-1], dev).points == "device", f"d={PRIM_WIDTHS[-1]} streams its points")
    forced = []
    for cluster in pm.CLUSTERS:
        for points, state in (("shared", "shared"), ("device", "shared"), ("device", "device")):
            with prim_plan(cluster=cluster, points=points, state=state):
                for n, d in ((N_PRIM, D), (N_RAGGED, 100)):
                    check_prim(*prim_case(n, d, dev), f"n={n}, d={d}, C={cluster}, points {points}, state {state}")
            forced.append(f"C={cluster}/{points}/{state}")
    distinct = {}
    for ties in ("near", "apart"):
        for cluster in pm.CLUSTERS:
            for n, d in ((N_PRIM, 2), (N_RAGGED, 8)):
                with prim_plan(cluster=cluster):
                    w2 = check_prim(*prim_case(n, d, dev, ties=ties), f"ties {ties}, n={n}, d={d}, C={cluster}")
                distinct[f"{ties},n={n},C={cluster}"] = k = len(torch.unique(w2))
                check(k < n // 4, f"the tie case ties: {k} distinct weights over {n} vertices")
    plans = {}
    for (n, d), p in chosen.items():
        plans.setdefault(p, []).append(f"n={n},d={d}")
    print(f"prim_mst: kernel == plain (src equal, w2 bit-equal) at d={list(PRIM_WIDTHS)}, n={N_RAGGED} and "
          f"n={N_PRIM} (card cluster {card_c}; chosen plans {json.dumps(plans)}); "
          f"under every plan forced at (n={N_PRIM}, d={D}) and (n={N_RAGGED}, d=100): {forced}; on duplicates with "
          f"tied core distances within a rank and across ranks at C={list(pm.CLUSTERS)}; distinct weights "
          f"{distinct}", flush=True)


def check_linkage(ea, eb, w, n: int, what: str):
    """``single_linkage`` kernel vs plain on the card on the same sorted
    endpoints (left, right, size equal), and the card's
    ``single_linkage_batch`` against the CPU's (left, right, height, size
    equal).  Returns the card's sorted endpoints."""
    import numpy as np
    import torch
    from repro_torch.core import linkage

    sl = kernel_module("single_linkage")
    dev = torch.device(CARD)
    ea_t, eb_t, w_t = (torch.from_numpy(np.array(a, order="C")).to(dev) for a in (ea, eb, w))
    _, order = torch.sort(w_t, dim=1, stable=True)
    ea_s, eb_s = ea_t.gather(1, order), eb_t.gather(1, order)
    out_k = sl.single_linkage(ea_s, eb_s, n=n)
    out_p = sl.single_linkage_plain(ea_s, eb_s, n=n)
    torch.cuda.synchronize()
    for name, a, b in zip(("left", "right", "size"), out_k, out_p):
        check(torch.equal(a, b), f"single_linkage {name} differs from the plain version ({what})")
    check(bool((out_k[2][:, -1] == n).all()), f"single_linkage: the last merge holds all {n} points ({what})")
    got = linkage.single_linkage_batch(ea_t, eb_t, w_t, n=n)
    want = linkage.single_linkage_batch(*(torch.from_numpy(np.array(a, order="C")) for a in (ea, eb, w)), n=n)
    for name, a, b in zip(("left", "right", "height", "size"), got, want):
        check(torch.equal(a.cpu(), b), f"single_linkage_batch {name}: card differs from the CPU ({what})")
    return ea_s, eb_s


@contextlib.contextmanager
def linkage_layout(layout: str):
    """Within the block, every ``single_linkage`` launch keeps its state in
    ``layout`` (``single_linkage.set_layout``)."""
    sl = kernel_module("single_linkage")
    before = sl.set_layout(layout)
    try:
        yield
    finally:
        sl.set_layout(before)


def check_linkage_cases() -> None:
    """``single_linkage`` on synthetic spanning trees with many tied and
    zero weights at R = 1 and 15, under both layouts of ``layout_for``:
    the state in shared memory and, forced at the same n, in device
    memory."""
    from repro_torch.core import linkage

    sl = kernel_module("single_linkage")
    from repro_torch.kernels import _build

    max_n = _build.load("single_linkage").repro_single_linkage_smem_max_n()
    check(max_n == sl.SMEM_MAX_N, f"single_linkage.SMEM_MAX_N mirrors the library's ({max_n})")
    check(sl.layout_for(N_LINKAGE) == "shared", f"n={N_LINKAGE} keeps the linkage state in shared memory")
    for layout in ("shared", "device"):
        with linkage_layout(layout):
            for rows in (1, 15):
                check_linkage(*linkage.random_spanning_trees(N_LINKAGE, rows, SEED + 11 + rows, ties=True),
                              N_LINKAGE, f"tied and zero weights, n={N_LINKAGE}, R={rows}, state in {layout} memory")
    print(f"single_linkage: kernel == plain and card == CPU (left, right, height, size) on random trees with "
          f"tied and zero weights at n={N_LINKAGE}, R=1 and 15, the state in shared memory and (forced) in device "
          f"memory; shared up to n={sl.SMEM_MAX_N}", flush=True)


def check_fit_linkage(msts, what: str) -> None:
    """``single_linkage`` on a fit's own MSTs: kernel == plain on the card
    and card == CPU, with the layout the fit's n takes."""
    sl = kernel_module("single_linkage")
    check_linkage(msts.mst_ea, msts.mst_eb, msts.mst_w, msts.n, what)
    print(f"single_linkage on {what} (n={msts.n}, R={len(msts.mpts_values)}, state in "
          f"{sl.layout_for(msts.n)} memory): kernel == plain and card == CPU", flush=True)


def partitions_agree(a, b, tol: float = 0.98) -> bool:
    """Same partition up to label permutation and rare tie-boundary points
    (the test of the reference's ``tests/test_api.py``)."""
    import numpy as np

    if abs(int((a >= 0).sum()) - int((b >= 0).sum())) > max(2, 0.01 * len(a)):
        return False
    agree = total = 0
    for c in np.unique(a[a >= 0]):
        members = b[a == c]
        members = members[members >= 0]
        if len(members) == 0:
            continue
        _, counts = np.unique(members, return_counts=True)
        agree += counts.max()
        total += counts.sum()
    return total > 0 and agree / total > tol


def baseline_phase(x_np, est, smi: str, record: dict) -> None:
    """The paper's re-run baseline, ``hdbscan_baseline(X, range(2, 17),
    kmax=16)``, on the main path's points: one ``prim_mst`` launch per
    mpts, one top-K, one linkage; its MST weights and labels against the
    RNG* fit ``est``; the card against the CPU at n = N_BASELINE_CPU; warm
    stage seconds and the ratio to the fit."""
    import numpy as np
    import torch
    from repro_torch import engine
    from repro_torch.api import MultiHDBSCAN
    from repro_torch.core import linkage, multi
    from repro_torch.kernels import fused_cascade as fc

    lf, pm, pt, sl = (kernel_module(k) for k in ("lune_filter", "prim_mst", "pairwise_topk", "single_linkage"))
    mpts = list(range(2, KMAX + 1))
    pt.pairwise_topk.launches = fc.edge_cascade.launches = lf.lune_filter.launches = 0
    pm.prim_mst.launches = sl.single_linkage.launches = 0
    t0 = time.monotonic()
    with engine.transfer_ledger() as led:
        base, _ = multi.hdbscan_baseline(x_np, mpts, kmax=KMAX)
    torch.cuda.synchronize()
    cold_s = time.monotonic() - t0
    launches = {"pairwise_topk": pt.pairwise_topk.launches, "edge_cascade": fc.edge_cascade.launches,
                "lune_filter": lf.lune_filter.launches, "prim_mst": pm.prim_mst.launches,
                "single_linkage": sl.single_linkage.launches}
    tags = engine.io.tags(led)
    print(f"baseline: n={len(x_np)}, mpts 2..{KMAX} on the card in {cold_s:.2f} s (cold), launches {launches}",
          flush=True)
    check(launches["prim_mst"] == len(mpts), f"the baseline launched prim_mst once per mpts: {launches}")
    check(launches["pairwise_topk"] == 1 and launches["single_linkage"] == 1,
          f"the baseline launched pairwise_topk and single_linkage once each: {launches}")
    check(launches["edge_cascade"] == 0 and launches["lune_filter"] == 0, "the baseline builds no graph")
    check(tags == ["mst"] * len(mpts) + ["knn", "linkage"], f"the baseline's syncs: {tags}")
    # Equal-weight MSTs may differ in their edges, and HDBSCAN* condenses
    # merges at one height in their order, so two exact methods can count
    # clusters differently; the single-linkage hierarchy and the partitions
    # must agree.  The cluster counts are reported beside each other.
    n_clusters = {}
    for h in base:
        ea_f, eb_f, w_fit = est.mst_for(h.mpts)
        check(np.allclose(np.sort(h.mst_w), np.sort(w_fit), rtol=RTOL, atol=0.0),
              f"baseline MST weight multiset == the RNG* fit's at mpts={h.mpts}")
        check(linkage.same_single_linkage((ea_f, eb_f, w_fit), (h.mst_ea, h.mst_eb, h.mst_w), len(x_np)),
              f"baseline and fit MSTs give the same single-linkage hierarchy at mpts={h.mpts}")
        labels = est.select(h.mpts).labels
        check(partitions_agree(labels, h.labels), f"baseline and fit partitions agree at mpts={h.mpts}")
        n_clusters[h.mpts] = (int(labels.max()) + 1, h.n_clusters)
    apart = {m: c for m, c in n_clusters.items() if abs(c[0] - c[1]) > 1}
    print(f"baseline == RNG* fit for mpts 2..{KMAX}: MST weight multisets bit for bit, the same single-linkage "
          f"partition at every height, partitions agree; clusters (fit, baseline) per mpts {n_clusters}, "
          f"more than 1 apart at {apart}", flush=True)

    _, stages = multi.hdbscan_baseline(x_np, mpts, kmax=KMAX)
    t0 = time.monotonic()
    MultiHDBSCAN(kmax=KMAX).fit(x_np).select_all()
    torch.cuda.synchronize()
    fit_s = time.monotonic() - t0
    ratio = stages["total"] / fit_s
    record["baseline"] = {"n": len(x_np), "d": D, "kmax": KMAX, "launches": launches, "cold_s": cold_s,
                          "stages_s": stages, "fit_select_all_s": fit_s, "baseline_over_fit": ratio,
                          "clusters_fit_baseline": n_clusters}
    print(f"baseline, warm stages (s) on {smi}: {json.dumps(stages)}; fit + select_all warm {fit_s:.3f} s; "
          f"baseline total / (fit + select_all) = {ratio:.4f}", flush=True)

    x4 = make_points(N_BASELINE_CPU, D, SEED + 10)
    b_g, _ = multi.hdbscan_baseline(x4, mpts, kmax=KMAX)
    t0 = time.monotonic()
    b_c, _ = multi.hdbscan_baseline(x4, mpts, kmax=KMAX, device="cpu")
    cpu_s = time.monotonic() - t0
    for g, c in zip(b_g, b_c):
        check(np.array_equal(g.mst_ea, c.mst_ea), f"n={N_BASELINE_CPU} baseline MST ids: card == CPU at mpts={g.mpts}")
        check(np.array_equal(g.mst_w.view(np.int32), c.mst_w.view(np.int32)),
              f"n={N_BASELINE_CPU} baseline MST weights bit-equal: card == CPU at mpts={g.mpts}")
        check(np.array_equal(g.labels, c.labels), f"n={N_BASELINE_CPU} baseline labels: card == CPU at mpts={g.mpts}")
    record["baseline"]["cpu_check_s"] = cpu_s
    print(f"n={N_BASELINE_CPU} baseline: card == device='cpu' run (MST ids, weights bit for bit, labels) for "
          f"mpts 2..{KMAX} (CPU run {cpu_s:.1f} s)", flush=True)


def kernel_resources(record: dict) -> None:
    """Registers and spills of every kernel instance (nvcc -Xptxas -v) and
    the resident blocks per SM of each instance at its launch configuration
    (``edge_cascade``: 256 threads a block); for ``prim_mst`` the clusters a
    card holds at once (``cudaOccupancyMaxActiveClusters``) at its plan."""
    import re

    from repro_torch.kernels import _build, fused_cascade as fc

    lf, pm, pt = kernel_module("lune_filter"), kernel_module("prim_mst"), kernel_module("pairwise_topk")
    card_c = pm.card_cluster("cuda")

    usage = []
    for log in _build.LOGS.values():
        for u in _build.ptxas_usage(log):
            m = re.search(r"(pairwise_topk_kernel|pairwise_topk_sliced_kernel|pairwise_topk_merge_kernel|"
                          r"pairwise_topk_select_kernel|pairwise_topk_stream_kernel|pairwise_d2_kernel|"
                          r"pairwise_d2_sliced_kernel|"
                          r"norms_win32_kernel|lune_filter_kernel|lune_filter_sliced_kernel|sum_sq_seq_kernel|"
                          r"edge_cascade_kernel|edge_cascade_prologue|"
                          r"prim_mst_floor_kernel|prim_mst_kernel|single_linkage_kernel|"
                          r"sbcn_bucket_kernel|sbcn_cell_kernel|sbcn_dense_kernel|bucket_count_kernel|"
                          r"bucket_plan_kernel|bucket_fill_kernel)(?:ILi(\d+)E(?:Li(\d+)E)?)?",
                          u["function"])
            u["kernel"] = m.group(1) if m else u["function"]
            where = {"0": "device", "1": "shared"}
            lay = re.search(r"Lb([01])ELb([01])EE", u["function"])  # prim_mst: the points', then the state's
            smem = re.search(r"Lb([01])EE", u["function"])  # the state's layout (prim_mst, single_linkage)
            u["points_in"] = where[lay.group(1)] if lay else None
            u["state_in"] = where[smem.group(1)] if smem else None
            sliced = "sliced" in u["kernel"] or "merge" in u["kernel"]  # the merge pass: the sliced instance's
            u["d"] = "sliced" if sliced else (int(m.group(2)) or "generic") if m and m.group(2) else None
            if u["kernel"].startswith(("sbcn_", "bucket_")):  # template arguments: the lanes, whether they halve
                lanes = int(m.group(2)) if m.group(2) else None  # 0: XLA's loop (sbcn_cell_kernel)
                u["sbcn_lanes"], u["d"] = lanes, None
                u["sbcn_halve"], u["state_in"] = u["state_in"] == "shared" if lanes else None, None
                if u["kernel"] == "sbcn_bucket_kernel":  # resident blocks, threads, shared bytes, cells a thread
                    occ = (ctypes.c_int * 4)()
                    fn = _build.load("sbcn_tile").repro_sbcn_tile_occupancy
                    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p], ctypes.c_int
                    check(fn(lanes, int(u["sbcn_halve"]), occ) == 0, "sbcn_tile's occupancy query")
                    u.update(blocks_per_sm=occ[0], threads=occ[1], smem=occ[2], cells_a_thread=occ[3])
                elif u["kernel"] == "sbcn_dense_kernel":
                    u.update(threads=256, smem=2 * 32 * 68 * 4)
                usage.append(u)
                continue
            if u["kernel"] == "norms_win32_kernel":  # rows staged a block at d = 1536 (NormPlan)
                w = -(-WIDE_WIDTHS[-1] // 32)
                u.update(threads=256, rows_a_block=min(64, 12288 // (34 * w)),
                         smem=min(64, 12288 // (34 * w)) * 34 * w * 4)
                usage.append(u)
                continue
            second = int(m.group(2 if sliced else 3)) if m and m.group(2 if sliced else 3) else None
            u["lanes" if u["kernel"] == "edge_cascade_kernel" else "slots"] = second
            usage.append(u)
    for u in usage:
        d = {"generic": 100, "sliced": WIDE_WIDTHS[-1]}.get(u["d"], u["d"])
        if u["kernel"] in ("pairwise_topk_kernel", "pairwise_topk_sliced_kernel"):
            u.update(pt.kernel_config(N, d, 32 * u["slots"]))
        elif u["kernel"] == "pairwise_topk_stream_kernel":  # the kmax = 256 fit's list at each width
            u.update(pt.kernel_config(N, d, K_SELECT_FIT))
        elif u["kernel"] == "pairwise_topk_select_kernel":  # the stored select's shape in the kernels line
            u.update(pt.kernel_config(N_WIDE, WIDE_WIDTHS[-1], K_SELECT_FIT))
        elif u["kernel"] in ("lune_filter_kernel", "lune_filter_sliced_kernel"):
            u.update(lf.kernel_config(d, 8, 512))
        elif u["kernel"] == "edge_cascade_kernel":
            cfg = fc.kernel_config(d, u["lanes"], 256)
            u.update(blocks_per_sm=cfg["blocks_per_sm"], threads=cfg["threads"])
        elif u["kernel"] == "edge_cascade_prologue":
            cfg = fc.kernel_config(d, 1, 256)
            u.update(blocks_per_sm=cfg["prologue_blocks_per_sm"], threads=cfg["prologue_threads"])
        elif u["kernel"] == "prim_mst_kernel":
            # the plan of the baseline's shape where the instance's residency fits it, else of n = N_PRIM
            for n_at in (N, N_PRIM):
                try:
                    plan = pm.plan_for(n_at, d, card_c, points=u["points_in"], state=u["state_in"])
                    break
                except ValueError:
                    continue
            u.update(plan_n=n_at, cluster=plan.cluster, threads=plan.threads, smem=plan.smem,
                     clusters_a_card=pm.max_active_clusters(plan, d, "cuda"))
    record["kernel_resources"] = usage
    for u in usage:
        print("  " + json.dumps({k: v for k, v in u.items() if k != "function" and v is not None}), flush=True)


def topk_times(x) -> dict:
    """``pairwise_topk`` milliseconds on ``x`` at K = 1 (the distance sweep
    with a few merges a row) and at every K of ``K_LISTS``."""
    pt = kernel_module("pairwise_topk")

    return {k_eff: cuda_ms(lambda: pt.pairwise_topk(x, k_eff), 5) for k_eff in (1, *K_LISTS)}


def lune_sweep(args, block_e: int, block_c: int) -> tuple[dict, dict]:
    """``lune_filter`` milliseconds on ``args`` by edges per block (at
    ``block_c``) and by points per tile (at ``block_e``)."""
    lf = kernel_module("lune_filter")

    by_e = {be: cuda_ms(lambda: lf.lune_filter(*args, block_e=be, block_c=block_c), 10) for be in (2, 4, 8, 16, 32)}
    by_c = {bc: cuda_ms(lambda: lf.lune_filter(*args, block_e=block_e, block_c=bc), 10) for bc in (128, 256, 512, 1024)}
    return by_e, by_c


def stage_inputs(x, plan, kmax: int):
    """The edge lists a kmax fit on ``x`` hands ``edge_cascade``: stage 1
    (every SBCN candidate, sorted packed keys) and stage 2 (the open
    stage-1 survivors).  Returns the shared operands and the two stages as
    ((lo, hi, valid), k_check)."""
    import numpy as np
    import torch
    from repro_torch.core import mrd, sbcn, wspd
    from repro_torch.kernels import fused_cascade as fc, ops

    n = x.shape[0]
    knn_d2, knn_idx = plan.knn(x, kmax - 1)
    cd2k = mrd.core_distances2(knn_d2)[:, -1]
    x_host = x.cpu().numpy().astype(np.float64)
    tree = wspd.build_fair_split_tree(x_host, np.sqrt(cd2k.cpu().numpy().astype(np.float64)))
    pu, pv = wspd.wspd_pairs(tree, s=1.0)
    ks, n_real, _, _, n_overflow = sbcn.cascade_candidates(
        x, cd2k, tree.perm, tree.start[pu], tree.end[pu] - tree.start[pu],
        tree.start[pv], tree.end[pv] - tree.start[pv],
        tie_cap=plan.cascade_tie_cap, tier_chunk_elems=plan.tier_chunk_elems,
    )
    check(int(n_overflow) == 0, "the smoke input stays on the fused path")
    valid, first, lo, hi = fc.unpack_keys(ks[: int(n_real)], n)
    stage1 = (lo, hi, valid)
    killed, cert, _, _ = fc.edge_cascade(
        x, cd2k, knn_idx, knn_d2, lo, hi, valid, k_check=plan.cascade_stage1_k,
        order=ops.sum_order(x.shape[1], "cascade"),
    )
    surv_open = valid & first & ~killed & ~cert
    n_open = int(surv_open.sum())
    pos = sbcn.compact_idx(surv_open, n_open)
    stage2 = (lo[pos], hi[pos], torch.ones((n_open,), dtype=torch.bool, device=x.device))
    return (x, cd2k, knn_idx, knn_d2), [(stage1, plan.cascade_stage1_k), (stage2, kmax - 1)]


def orders_at(d: int) -> tuple:
    """The summation orders that differ at width d (``win32`` is ``seq`` up to 32)."""
    return ("seq", "fma") if d <= 32 else ("seq", "fma", "win32")


def check_cascade(base, lo, hi, valid, k_check: int, order: str, what: str, lanes=(0,), chunk: int = 65536):
    """Kernel vs plain on one edge list: verdicts equal and d2, w2 bit-equal
    on the valid slots, at each lane count of ``lanes`` (0: the default).
    Returns the (killed, certified, valid) counts of the plain run and the
    largest d2 or w2 difference (0 when bit-equal)."""
    import torch
    from repro_torch.kernels import fused_cascade as fc

    out_p = fc.edge_cascade_plain(*base, lo, hi, valid, k_check=k_check, order=order, chunk=chunk)
    err = 0.0
    for g in lanes:
        out_k = fc.edge_cascade(*base, lo, hi, valid, k_check=k_check, order=order, lanes=g)
        torch.cuda.synchronize()
        at = f"{what}, k_check={k_check}, order={order}, lanes={g or fc.pick_lanes(k_check)}"
        check(out_k[0].dtype == out_k[1].dtype == torch.bool, "edge_cascade verdicts are bool")
        check(torch.equal(out_k[0], out_p[0]), f"edge_cascade killed differs at {at}")
        check(torch.equal(out_k[1], out_p[1]), f"edge_cascade cert differs at {at}")
        for j, name in ((2, "d2"), (3, "w2")):
            a, b = out_k[j][valid], out_p[j][valid]
            check(bool(torch.isfinite(a).all()), f"edge_cascade {name} finite at {at}")
            err = max(err, float((a - b).abs().max()) if a.numel() else 0.0)
            check(torch.equal(a, b), f"edge_cascade {name} not bit-equal to the plain version at {at}")
    return (int(out_p[0].sum()), int(out_p[1].sum()), int(valid.sum())), err


def check_cascade_stages(fits: dict) -> tuple[dict, float]:
    """``edge_cascade`` on each fit's stage edge lists, every order, the
    default lanes; the fit's own order also at every lane count.  Returns
    the (killed, certified, valid) counts per (kmax, k_check) in the fit's
    order, and the largest d2 or w2 difference."""
    from repro_torch.kernels import fused_cascade as fc, ops

    counts, err = {}, 0.0
    for kmax, (base, stages) in fits.items():
        fit_order = ops.sum_order(base[0].shape[1], "cascade")
        for (lo, hi, valid), k_check in stages:
            for order in orders_at(base[0].shape[1]):
                lanes = (0, *fc.LANES) if order == fit_order else (0,)
                c, e = check_cascade(base, lo, hi, valid, k_check, order, f"the kmax={kmax} fit's edges", lanes)
                err = max(err, e)
                if order == fit_order:
                    counts[(kmax, k_check)] = c
            killed, cert, n_valid = counts[(kmax, k_check)]
            print(f"edge_cascade: kernel == plain (bit for bit) on the kmax={kmax} fit's {lo.shape[0]} edges at "
                  f"k_check={k_check}, orders {list(orders_at(base[0].shape[1]))}, lanes {list(fc.LANES)} "
                  f"({killed} killed, {cert} certified of {n_valid} valid)", flush=True)
    return counts, err


def cascade_case(d: int, k_full: int, dev):
    """N_CASCADE clustered points in d dimensions with 200 exact duplicates,
    their k_full-NN lists (the card's ``knn``), core distances at the 4th
    neighbour (below the k_full-th, so that fewer edges are certified and
    more reach the checks),
    and an unsorted edge list: each point to its 3 nearest neighbours (a
    neighbour is an endpoint), to its duplicate (d2 = 0), to its 4th
    neighbour (d2 ties its core distance where the orders agree), random
    pairs, and 5% invalid slots."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops

    n = N_CASCADE
    rng = np.random.default_rng(SEED + 9 + d)
    centers = rng.uniform(-4.0, 4.0, size=(8, d))
    x = centers[rng.integers(0, 8, n - 200)] + rng.normal(0.0, 0.7, size=(n - 200, d))
    x = torch.from_numpy(np.concatenate([x, x[:200]]).astype(np.float32)).to(dev)
    knn_d2, knn_idx = ops.knn(x, k_full, backend="cuda")
    rows = torch.arange(n, device=dev)
    pairs = torch.cat([
        torch.stack([rows.repeat_interleave(3), knn_idx[:, :3].reshape(-1).long()], 1),
        torch.stack([rows[:200], rows[n - 200:]], 1),
        torch.stack([rows, knn_idx[:, 3].long()], 1),
        torch.from_numpy(rng.integers(0, n, size=(2 * n, 2))).to(dev),
    ])
    pairs = pairs[torch.from_numpy(rng.permutation(pairs.shape[0])).to(dev)].to(torch.int32)
    valid = torch.from_numpy(rng.random(pairs.shape[0]) > 0.05).to(dev)
    return (x, knn_d2[:, 3].contiguous(), knn_idx, knn_d2), pairs[:, 0].contiguous(), pairs[:, 1].contiguous(), valid


def check_cascade_cases(dev) -> None:
    """``edge_cascade`` kernel vs plain on the synthetic cases of
    ``cascade_case``: every width of ``CASCADE_WIDTHS``, every k_check of
    ``CASCADE_K``, every order at the width, every lane count.  Each case
    has killed and certified edges, and at k_check = 2 open ones (neither:
    they run every check)."""
    from repro_torch.kernels import fused_cascade as fc

    n_cases = 0
    for d in CASCADE_WIDTHS:
        base, ea, eb, valid = cascade_case(d, max(CASCADE_K), dev)
        for k_check in CASCADE_K:
            for order in orders_at(d):
                (killed, cert, n_valid), _ = check_cascade(base, ea, eb, valid, k_check, order,
                                                           f"the d={d} case", (0, *fc.LANES), chunk=4096)
                check(0 < killed and 0 < cert, f"the d={d}, k_check={k_check} case has killed and certified edges")
                check(k_check > 2 or killed + cert < n_valid, f"the d={d}, k_check=2 case has open edges")
                n_cases += 1
    print(f"edge_cascade: kernel == plain (bit for bit) on {n_cases} synthetic cases: d={list(CASCADE_WIDTHS)}, "
          f"k_check={list(CASCADE_K)}, every order at each width, lanes {list(fc.LANES)}; n={N_CASCADE}, "
          f"unsorted edges with invalid slots, duplicates and endpoint neighbours", flush=True)


def cascade_times(fits: dict, counts: dict, record: dict) -> dict:
    """Milliseconds of ``edge_cascade`` per stage of each fit: the device
    time of its two kernels (``device_ms``) at the default lanes and at
    every lane count, and the time per call with the host's enqueue
    (``cuda_ms``, ``wrapper_ms``), beside the plain
    version and the bound; and the kmax = 16 stage 1 with no checks
    (k_check = 0: the prologue and the d2, w2 and certificate alone).
    Returns the kmax = 16 kernel row's numbers: ``ms`` with the host's
    enqueue, as every row of the ``{"kernels": ...}`` line, ``device_ms``
    the card alone."""
    from repro_torch.kernels import fused_cascade as fc, ops

    per_stage, by_lanes = [], {}
    row = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0}
    for kmax, (base, stages) in fits.items():
        n, d = base[0].shape
        order = ops.sum_order(d, "cascade")
        for (lo, hi, valid), k_check in stages:
            run = lambda g=0: fc.edge_cascade(*base, lo, hi, valid, k_check=k_check, order=order, lanes=g)  # noqa: E731
            t_k = device_ms(run, 20)
            t_w = cuda_ms(run, 20)
            t_p = cuda_ms(lambda: fc.edge_cascade_plain(*base, lo, hi, valid, k_check=k_check, order=order), 3)
            killed, cert, n_valid = counts[(kmax, k_check)]
            flops, nbytes = cascade_flops_bytes(n, d, int(lo.shape[0]), k_check, n_valid, killed, cert)
            b_ms, b_by = bound(flops, nbytes)
            by_g = {g: device_ms(lambda: run(g), 20) for g in fc.LANES}
            by_lanes[f"kmax={kmax},k_check={k_check}"] = by_g
            per_stage.append({"kmax": kmax, "k_check": k_check, "edges": int(lo.shape[0]), "killed": killed,
                              "certified": cert, "lanes": fc.pick_lanes(k_check), "ms": t_k, "wrapper_ms": t_w,
                              "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by, "ms_by_lanes": by_g})
            if kmax == KMAX:
                row["ms"] += t_w
                row["device_ms"] += t_k
                row["plain_ms"] += t_p
                row["ops_ms"] += flops / PEAK_F32_FLOPS * 1e3
                row["bytes_ms"] += nbytes / PEAK_BYTES * 1e3
    base, stages = fits[KMAX]
    (lo, hi, valid), _ = stages[0]
    order = ops.sum_order(base[0].shape[1], "cascade")
    record["edge_cascade_no_checks_ms"] = device_ms(
        lambda: fc.edge_cascade(*base, lo, hi, valid, k_check=0, order=order), 20)
    record["edge_cascade_stages"] = per_stage
    record["edge_cascade_ms_by_lanes"] = by_lanes
    for st in per_stage:
        print("edge_cascade per launch (ms on the device alone; wrapper_ms with the host's enqueue): "
              + json.dumps(st), flush=True)
    print(f"edge_cascade on the kmax={KMAX} stage-1 edges with k_check=0 (prologue, d2, w2, certificate): "
          f"{record['edge_cascade_no_checks_ms']:.4f} ms on the device", flush=True)
    return row


def lune_flops_bytes(n: int, d: int, m: int, m_removed: int) -> tuple[float, float]:
    """Operations and bytes of one ``lune_filter`` launch over m edges.

    A kept edge has to be checked against every point, a removed one
    against one point at the least (the first inside).  Per (edge, point)
    pair: two d-long dot products (4 d) and the norm sums, mrd maxima,
    margins and compares (16).  Every input is read once: the endpoint
    coordinates, core distances, indices and weights of the m edges, the
    n points and their core distances; the m verdicts are written once.
    """
    pairs = (m - m_removed) * n + m_removed
    return pairs * (4 * d + 16), 4 * (m * (2 * d + 5) + n * (d + 1) + m)


def cascade_flops_bytes(n: int, d: int, m: int, k: int, m_valid: int, m_killed: int, m_cert: int):
    """Operations and bytes of one ``edge_cascade`` launch over m edges, as
    the function needs them on this run's data: every point's norm once
    (2 d); per edge its d2, w2 and certificate (3 d + 3); per check its
    cross d2 and both mrd terms with their margins (3 d + 13).  An open
    edge (valid, neither certified nor killed) needs all 2 k checks, a
    killed one at least its first hit, a certified one none (it cannot be
    killed: both mrd terms are at least its endpoints' core distances).
    Every input is read once (x, cd2k, the first k columns of knn_idx and
    knn_d2, ea, eb, valid) and every output written once at the type the
    wrapper returns: two bools and two float32 an edge."""
    checks = (m_valid - m_killed - m_cert) * 2 * k + m_killed
    flops = n * 2 * d + m * (3 * d + 3) + checks * (3 * d + 13)
    nbytes = 4 * (n * d + n + 2 * n * k) + m * (4 + 4 + 1) + m * (1 + 1 + 4 + 4)
    return flops, nbytes


def cpu_fit(x, kmax: int) -> dict:
    """The port's ``device="cpu"`` fit of ``x`` with ``select_all``, in a
    worker process (``start_cpu_fit``): what a card fit is held to, as
    arrays."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.api import MultiHDBSCAN

    torch.set_num_threads(CPU_FIT_THREADS)
    t0 = time.monotonic()
    est = MultiHDBSCAN(kmax=kmax, device="cpu").fit(x)
    fit_s = time.monotonic() - t0
    views = est.select_all()
    m = est.model_.msts
    return {"fit_s": fit_s, "total_s": time.monotonic() - t0, "stats": est.graph_.stats,
            "edges": est.graph_.edges, "d2": est.graph_.d2, "w2_kmax": est.graph_.w2_kmax,
            "knn_d2": m.knn_d2, "knn_idx": m.knn_idx, "mst_ea": m.mst_ea, "mst_eb": m.mst_eb, "mst_w": m.mst_w,
            "labels": [v.labels for v in views]}


def start_cpu_fit(pool, x, kmax: int):
    """``cpu_fit`` of ``x`` in ``pool``'s worker, so that the host's other
    cores fit it while this process drives the card; ``.get()`` waits."""
    return pool.apply_async(cpu_fit, (x, kmax))


def cpu_pool():
    """One spawned worker process (no CUDA in it), closed on leaving the
    ``with`` block."""
    import multiprocessing

    return multiprocessing.get_context("spawn").Pool(1)


def dualtree_phase(smi: str, record: dict):
    """The dual-tree tier at n = N_DUALTREE on the card, with the default
    plan: against the port's own CPU fit (bit for bit) and against the
    card's WSPD tier (the cross-tier oracle).  Returns the fit's MSTs."""
    import numpy as np
    import torch
    from repro_torch import engine
    from repro_torch.api import MultiHDBSCAN
    from repro_torch.kernels import fused_cascade as fc

    lf, pt, sl = kernel_module("lune_filter"), kernel_module("pairwise_topk"), kernel_module("single_linkage")

    def fit(**kw):
        """The fit, its views, its stage seconds and the fit's ledger tags."""
        t0 = time.monotonic()
        with engine.transfer_ledger() as led:
            est = MultiHDBSCAN(kmax=KMAX, **kw).fit(x)
        t1 = time.monotonic()
        views = est.select_all()
        stages = {k: est.timings_[k] for k in ("knn", "rng_build", "mst_range")}
        stages["hierarchy"] = time.monotonic() - t1
        stages["fit_s"] = t1 - t0
        return est, views, stages, engine.io.tags(led)

    x = make_points(N_DUALTREE, D, SEED)
    with cpu_pool() as pool:
        job = start_cpu_fit(pool, x, KMAX)
        pt.pairwise_topk.launches = fc.edge_cascade.launches = lf.lune_filter.launches = 0
        sl.single_linkage.launches = 0
        est, views, stages, tags = fit()
        torch.cuda.synchronize()
        cpu = job.get(timeout=CPU_FIT_TIMEOUT)
    torch.cuda.synchronize()
    launches = {"pairwise_topk": pt.pairwise_topk.launches, "edge_cascade": fc.edge_cascade.launches,
                "lune_filter": lf.lune_filter.launches}
    linkage_launches = sl.single_linkage.launches
    g = est.graph_.stats
    print(f"dual-tree tier: n={N_DUALTREE}, d={D}, kmax={KMAX} on the card, default plan: graph {g}, "
          f"ledger {tags}, launches {launches}, single_linkage {linkage_launches}", flush=True)
    check(est.plan_.backend == "cuda", "the dual-tree fit ran on the cuda backend")
    check(g.get("path") == "dualtree", f"n={N_DUALTREE} takes the dual-tree tier with the default plan")
    check(tags == ["knn", "graph", "mst"], f"the dual-tree fit syncs at knn, graph and mst only; got {tags}")
    check(all(v == 0 for v in launches.values()), "the dual-tree tier launches none of the three graph kernels")
    check(linkage_launches == 1, "the dual-tree fit's select_all launched single_linkage once")

    m = est.model_.msts
    for name, a, b in (("graph edges", est.graph_.edges, cpu["edges"]), ("graph d2", est.graph_.d2, cpu["d2"]),
                       ("graph w2_kmax", est.graph_.w2_kmax, cpu["w2_kmax"]), ("kNN d2", m.knn_d2, cpu["knn_d2"]),
                       ("kNN idx", m.knn_idx, cpu["knn_idx"]), ("MST ea", m.mst_ea, cpu["mst_ea"]),
                       ("MST eb", m.mst_eb, cpu["mst_eb"]), ("MST w", m.mst_w, cpu["mst_w"])):
        check(np.array_equal(a, b), f"dual-tree tier: {name} bit-equal to the CPU fit")
    for v_g, lab_c in zip(views, cpu["labels"]):
        check(v_g.labels.shape == (N_DUALTREE,), "dual-tree labels shape")
        check(np.array_equal(v_g.labels, lab_c), f"dual-tree tier: labels equal the CPU fit at mpts={v_g.mpts}")
    print(f"dual-tree tier: card == CPU fit bit for bit (graph, kNN, MSTs, labels for mpts 2..{KMAX}; "
          f"CPU fit {cpu['fit_s']:.1f} s in a worker process on {CPU_FIT_THREADS} threads, beside the card fit)",
          flush=True)
    check(sl.layout_for(N_DUALTREE) == "shared", "the dual-tree fit's linkage keeps its state in shared memory")
    check_fit_linkage(m, f"the n={N_DUALTREE} dual-tree fit's MSTs")

    pt.pairwise_topk.launches = fc.edge_cascade.launches = 0
    est_w, views_w, stages_w, _ = fit(plan=engine.resolve_plan(device="cuda", candidate_method="wspd"))
    launches_w = {"pairwise_topk": pt.pairwise_topk.launches, "edge_cascade": fc.edge_cascade.launches}
    mw = est_w.model_.msts
    check(est_w.graph_.stats.get("path") == "fused", f"the wspd fit at n={N_DUALTREE} takes the fused path")
    check(launches_w["pairwise_topk"] >= 1 and launches_w["edge_cascade"] >= 2, "the wspd fit launched its kernels")
    check(np.array_equal(m.knn_d2, mw.knn_d2) and np.array_equal(m.knn_idx, mw.knn_idx),
          "both tiers' kNN bit-equal")
    check(np.array_equal(np.sort(m.mst_w, axis=1), np.sort(mw.mst_w, axis=1)),
          "both tiers' sorted MST weights bit-equal for every mpts")
    for v_d, v_w in zip(views, views_w):
        check(np.array_equal(v_d.labels, v_w.labels), f"both tiers' labels equal at mpts={v_d.mpts}")
    record["dualtree"] = {"n": N_DUALTREE, "d": D, "kmax": KMAX, "graph": g, "ledger": tags,
                          "stages_s": stages, "cpu_fit_s": cpu["fit_s"], "wspd_stages_s": stages_w,
                          "wspd_graph": est_w.graph_.stats, "wspd_launches": launches_w}
    print(f"dual-tree tier == WSPD tier on the card (kNN, sorted MST weights, labels for mpts 2..{KMAX}); "
          f"stage seconds at n={N_DUALTREE} on {smi} (one fit each, process warm; the dual-tree fit beside "
          f"the CPU fit's worker): dual-tree "
          f"{json.dumps(stages)}, wspd {json.dumps(stages_w)}", flush=True)
    return m


def serving_requests(n_rows: int):
    """Requests over rows [0, n_rows): (start, stop, mpts or None, leaf)."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    out, r0 = [], 0
    while r0 < n_rows:
        r1 = min(n_rows, r0 + int(rng.integers(1, 65)))
        mpts = None if rng.random() < 0.25 else int(rng.integers(2, KMAX + 1))
        out.append((r0, r1, mpts, bool(rng.random() < 0.125)))
        r0 = r1
    return out


def serving_phase(path: str, q, smi: str, record: dict) -> None:
    """``ClusterServeEngine`` booted from a saved artifact on the card,
    under N_CLIENTS concurrent client threads; every answer against the
    card model's direct prediction of the same rows."""
    import threading

    import numpy as np
    from repro_torch.api import FittedModel, SelectionPolicy
    from repro_torch.serve import ClusterServeEngine

    leaf = SelectionPolicy(method="leaf")
    direct = FittedModel.load(path)
    want = {False: direct.approximate_predict(q), True: direct.approximate_predict(q, policy=leaf)}
    requests = serving_requests(len(q))
    sl = kernel_module("single_linkage")
    sl.single_linkage.launches = 0
    eng = ClusterServeEngine.load(
        path, serve_options={"max_batch": 512, "max_delay_ms": 2.0, "hierarchy_cache_size": 4})
    answers, latency, errors, cache_sizes = {}, {}, [], []
    try:
        check(eng.device.type == "cuda" and eng.model.plan.backend == "cuda", "the engine serves on the card")
        eng.predict(q[:8])  # extracts the levels once, so the timed traffic is warm
        check(sl.single_linkage.launches == 1, "the engine's model ran its linkage through single_linkage once")
        eng.reset_stats()

        def client(c: int):
            try:
                for i in range(c, len(requests), N_CLIENTS):
                    r0, r1, mpts, use_leaf = requests[i]
                    t0 = time.monotonic()
                    answers[i] = eng.predict(q[r0:r1], mpts, leaf if use_leaf else None, timeout=300)
                    latency[i] = time.monotonic() - t0
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(c,)) for c in range(N_CLIENTS)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        # bad requests in the middle of the traffic: each fails alone at submit time
        bad_nan = q[:3].copy()
        bad_nan[1, 2] = np.nan
        for bad, mpts, kind in ((bad_nan, None, ValueError), (q[:4, :5], 5, ValueError), (q[:2], 99, KeyError)):
            try:
                eng.submit_predict(bad, mpts)
                check(False, f"a bad request ({kind.__name__}) was accepted")
            except kind:
                pass
        while any(t.is_alive() for t in threads):
            cache_sizes.append(len(eng.model._cache))
            time.sleep(0.005)
        for t in threads:
            t.join()
        wall = time.monotonic() - t0
        stats = eng.stats()
        check(not errors, f"every client request was answered: {errors[:3]}")
        check(len(answers) == len(requests), "every request has an answer")
        for i, (r0, r1, mpts, use_leaf) in enumerate(requests):
            w, got = want[use_leaf], answers[i]
            if mpts is None:
                for f in ("labels", "neighbors", "lambdas", "probabilities"):
                    check(np.array_equal(getattr(got, f), getattr(w, f)[:, r0:r1]),
                          f"served {f} bit-equal to the direct prediction (request {i})")
            else:
                r = w.mpts_values.index(mpts)
                check(np.array_equal(got[0], w.labels[r, r0:r1]) and np.array_equal(got[1], w.probabilities[r, r0:r1]),
                      f"served labels and probabilities bit-equal to the direct prediction (request {i})")
        check(stats["mean_batch"] > 1, f"the engine micro-batched: mean batch {stats['mean_batch']}")
        cache_sizes.append(len(eng.model._cache))
        for mpts in (2, 9, KMAX):
            check(np.array_equal(eng.labels(mpts), direct.select(mpts).labels), f"served labels at mpts={mpts}")
            check(np.array_equal(eng.labels(mpts, policy=leaf), direct.select(mpts, leaf).labels),
                  f"served leaf labels at mpts={mpts}")
            got_m, want_m = eng.membership(mpts), direct.select(mpts)
            check(np.array_equal(got_m.labels, want_m.labels) and np.array_equal(got_m.probabilities,
                  want_m.probabilities), f"served membership at mpts={mpts}")
            cache_sizes.append(len(eng.model._cache))
        check(eng.profile() == direct.mpts_profile(), "served profile equals the direct call")
        check(eng.dbcv_profile() == direct.dbcv_profile(), "served DBCV profile equals the direct call")
        cache_sizes.append(len(eng.model._cache))
        check(max(cache_sizes) <= 4, f"the extraction cache held at most 4 entries; saw {max(cache_sizes)}")
    finally:
        eng.close()
    lat_ms = np.sort(np.fromiter(latency.values(), float)) * 1e3
    p50, p95 = float(np.percentile(lat_ms, 50)), float(np.percentile(lat_ms, 95))
    qps = len(q) / wall
    n_full = sum(r[2] is None for r in requests)
    record["serving"] = {"requests": len(requests), "full_range_requests": n_full,
                         "leaf_requests": sum(r[3] for r in requests), "clients": N_CLIENTS,
                         "p50_ms": p50, "p95_ms": p95, "queries_per_s": qps, "wall_s": wall,
                         "engine_stats": stats, "max_cache_entries": max(cache_sizes)}
    print(f"serving: {len(requests)} requests ({n_full} over the full range) from {N_CLIENTS} clients, every answer "
          f"bit-equal to the direct prediction, bad requests failed alone, cache at most {max(cache_sizes)} "
          f"entries; on {smi}: client latency p50 {p50:.3f} ms, p95 {p95:.3f} ms, {qps:.1f} queries/s, "
          f"mean batch {stats['mean_batch']} ({stats['n_batches']} batches)", flush=True)


def busy_us(spans) -> float:
    """Microseconds covered by the union of (start, end) spans."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            total += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (0.0 if cur_e is None else cur_e - cur_s)


def where_the_time_goes(fit, record: dict, lm_decode=None, lm_train_step=None) -> None:
    """Device busy share of one warm fit, of ``lm_decode`` (the
    ``LM_PROFILED_STEPS`` LM decode steps) and of ``lm_train_step`` (one
    full-depth train step of phase 15) in the same profiler session
    (``torch.profiler``: the union of the device activity intervals inside
    each one's ``record_function`` window, over the host wall time; one
    session, since a second one in a process may record no kernels), with
    the LM runs' device time by kernel name (the train step's also split
    into GEMMs and the rest); and the host functions with the most
    cumulative time in another fit (``cProfile``), whose implicit syncs it
    counts (torch's sync debug mode)."""
    import cProfile
    import pstats
    from collections import Counter

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    fns = {"fit": fit, "lm_decode": lm_decode, "lm_train_step": lm_train_step}
    walls = {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for name, fn in fns.items():
            if fn is None:
                continue
            with record_function(name):
                t0 = time.monotonic()
                fn()
                torch.cuda.synchronize()
                walls[name] = time.monotonic() - t0
    events = prof.events()
    # each record_function window also shows on the device timeline as an
    # annotation spanning it: count only the device's own activities
    device = [(e.time_range.start, e.time_range.end, e.name) for e in events
              if e.device_type == DeviceType.CUDA and e.name not in fns]
    for name, wall_s in walls.items():
        win = [e.time_range for e in events if e.name == name and e.device_type == DeviceType.CPU]
        inside = [(s, e, k) for s, e, k in device if win and win[0].start <= s and e <= win[0].end]
        busy_s = busy_us([(s, e) for s, e, _ in inside]) / 1e6
        key = "" if name == "fit" else f"{name}_"
        record[f"{key}profiled_fit_s" if name == "fit" else f"{key}profiled_s"] = wall_s
        record[f"{key}device_busy_s"] = busy_s if inside else None
        record[f"{key}device_activities"] = len(inside)
        what = {"fit": "fit", "lm_decode": "run of LM decode steps (qwen2-1.5b, 8 rows, bfloat16)",
                "lm_train_step": "full-depth train step (qwen2-1.5b, 4 x 1024 tokens, bfloat16)"}[name]
        if not inside:
            print(f"device busy share of the {what}: not measured (the profiler recorded no device activity)",
                  flush=True)
            continue
        print(f"device busy {busy_s:.4f} s of a {wall_s:.3f} s profiled {what} "
              f"({len(inside)} device activities; idle share {1 - busy_s / wall_s:.4f})", flush=True)
        if name == "lm_decode":
            record["lm_decode_device_s_per_step"] = busy_s / LM_PROFILED_STEPS
            by_kernel = Counter()
            for s, e, k in inside:
                by_kernel[k] += (e - s) / 1e3
            record["lm_decode_device_ms_by_kernel"] = dict(by_kernel.most_common(12))
            print(f"  {busy_s / LM_PROFILED_STEPS:.5f} s of device work a step; device ms by kernel in those steps: "
                  + json.dumps(record["lm_decode_device_ms_by_kernel"]), flush=True)
        if name == "lm_train_step":
            by_kernel, by_kind = Counter(), Counter()
            for s, e, k in inside:
                by_kernel[k] += (e - s) / 1e3
                gemm = any(tag in k.lower() for tag in ("gemm", "nvjet", "cutlass", "xmma"))
                by_kind["gemm" if gemm else "other"] += (e - s) / 1e3
            record["lm_train_step_device_ms_by_kind"] = dict(by_kind)
            record["lm_train_step_device_ms_by_kernel"] = dict(by_kernel.most_common(12))
            print(f"  device ms of the train step, GEMMs and the rest: {json.dumps(dict(by_kind))}; by kernel: "
                  + json.dumps(record["lm_train_step_device_ms_by_kernel"]), flush=True)

    # the host profile's fit also counts the implicit syncs (a count, which
    # neither the profiler nor the sync warnings change)
    torch.cuda.synchronize()
    pr = cProfile.Profile()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            pr.enable()
            fit()
            torch.cuda.synchronize()
            pr.disable()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    record["implicit_syncs"] = sum("synchroniz" in str(w.message) for w in caught)
    print(f"implicit syncs in one warm fit (torch sync debug mode): {record['implicit_syncs']}", flush=True)
    rows = sorted(pstats.Stats(pr).stats.items(), key=lambda kv: -kv[1][3])[:30]
    record["host_profile"] = [
        {"fn": f"{Path(f).name}:{line}({name})", "cum_s": cum, "calls": calls}
        for (f, line, name), (_, calls, _, cum, _) in rows
    ]
    print("host profile of one warm fit (cumulative s): " + "; ".join(
        f"{r['fn']} {r['cum_s']:.2f}" for r in record["host_profile"][:14]), flush=True)


def truncated(params, cfg, n_layers: int, device, copy: bool = False):
    """The first ``n_layers`` of ``params`` as a model of its own on
    ``device``: the tensors of its family's skeleton at that depth (the
    transformer's and mamba2's first layers; griffin's first whole periods
    and its remainder, so ``n_layers`` less the remainder is whole
    periods; the encoder-decoder's first ``n_layers`` of each stack); the
    same tensors where ``device`` is theirs, unless ``copy`` (a model to
    train in place, while phase 12's masters, whose norms its serving
    engine shares, must not move)."""
    import dataclasses

    from repro_torch.models import get_model

    if cfg.arch == "encdec":
        cfg_t = dataclasses.replace(cfg, n_layers=2 * n_layers, n_enc_layers=n_layers, n_dec_layers=n_layers)
    else:
        cfg_t = dataclasses.replace(cfg, n_layers=n_layers)
    p = get_model(cfg).skeleton(cfg_t)
    full = params.state_dict()
    p.load_state_dict({k: full[k].to(device, copy=copy) for k in p.state_dict()}, assign=True)
    return p, cfg_t


def lm_decode_steps(eng, reqs, steps: int):
    """A function that runs ``steps`` decode steps of ``eng`` on a cache
    prefilled now from ``reqs``."""
    import numpy as np
    import torch

    plen = max(len(r.prompt) for r in reqs)
    toks = np.zeros((len(reqs), plen), np.int32)
    for i, r in enumerate(reqs):
        toks[i, plen - len(r.prompt):] = r.prompt
    with torch.inference_mode():
        logits, cache = eng.model.prefill(eng.params, eng.cfg, torch.from_numpy(toks).to(eng.device),
                                          max_len=eng.max_len, cache_dtype=eng.cache_dtype)
    cur = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]

    def run():
        with torch.inference_mode():
            for _ in range(steps):
                eng.model.decode_step(eng.params, eng.cfg, cache, cur)

    return run


def lm_phase(smi: str, record: dict):
    """Phase 12: qwen2-1.5b at its published width on the card, with random
    weights from the port's seeded init.  Reference parity at 2 layers in
    float32 (the card's forward logits against the port's own CPU
    forward), decode against forward at full depth in float32, and
    serving at full depth in bfloat16.  Returns (cfg, params, a function
    that runs a few decode steps of the engine, for phase 11's profile)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, transformer as tf
    from repro_torch.serve.lm import Engine, GenRequest

    dev = torch.device(CARD)
    cfg = get_config(LM_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head, cfg.d_ff, cfg.vocab, cfg.padded_vocab,
           cfg.qkv_bias, cfg.rope_theta, cfg.dtype) == (28, 1536, 12, 2, 128, 8960, 151936, 152064, True, 1e6,
                                                        "bfloat16"), "qwen2-1.5b as published")
    t0 = time.monotonic()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    rec = {"arch": cfg.name, "init_s": time.monotonic() - t0,
           "n_params": sum(p.numel() for p in params.parameters()),
           "param_bytes": sum(p.numel() * p.element_size() for p in params.parameters())}
    print(f"phase 12: {cfg.name} at its published width ({cfg.n_layers} layers, d={cfg.d_model}, "
          f"{rec['n_params']} parameters, {rec['param_bytes'] / 1e9:.2f} GB of float32 masters) initialised on the "
          f"card in {rec['init_s']:.1f} s", flush=True)
    rng = np.random.default_rng(SEED + 20)

    # reference parity: full width, 2 layers, float32, the card against the CPU
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32))
    with torch.inference_mode():
        outs = {}
        for where in (CARD, "cpu"):
            p2, cfg2 = truncated(params, cfg32, 2, torch.device(where))
            h, _ = tf.forward(p2, cfg2, toks.to(where))
            outs[where] = tf.logits_fn(p2, cfg2, h).float().cpu()
            del p2
    err = float((outs[CARD] - outs["cpu"]).abs().max())
    rec["parity_2_layers_max_abs"] = err
    check(bool(torch.isfinite(outs[CARD]).all()) and outs[CARD].shape == (2, 24, cfg.padded_vocab),
          "2-layer logits finite, (B, S, padded_vocab)")
    check(err <= LM_PARITY_TOL, f"2-layer float32 logits: card vs CPU max abs {err} > {LM_PARITY_TOL}")
    print(f"  full width, 2 layers, float32: card logits == the port's CPU logits to {err:.3g} max abs "
          f"(<= {LM_PARITY_TOL})", flush=True)

    # decode against forward: full width, full depth, float32
    s_len, t_steps = 24, 6
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, s_len + t_steps)).astype(np.int32)).to(dev)
    with torch.inference_mode():
        h, _ = tf.forward(params, cfg32, toks)
        ref = tf.logits_fn(params, cfg32, h)[:, s_len - 1 : s_len + t_steps - 1]
        last, cache = tf.prefill(params, cfg32, toks[:, :s_len], max_len=s_len + t_steps, cache_dtype=torch.float32)
        steps = [last]
        for t in range(t_steps - 1):
            lg, cache = tf.decode_step(params, cfg32, cache, toks[:, s_len + t : s_len + t + 1])
            steps.append(lg)
        serve = torch.stack(steps, dim=1)
    scale = max(1.0, float(ref.abs().max()))
    err = float((serve - ref).abs().max())
    rec["decode_vs_forward_max_abs"], rec["decode_vs_forward_scale"] = err, scale
    check(bool(torch.isfinite(serve).all()), "decode logits finite")
    check(err <= 1e-3 * scale, f"decode vs forward at full depth, float32: {err} > 1e-3 * {scale}")
    print(f"  full depth, float32: prefill S={s_len} + {t_steps - 1} decode steps == forward over the sequence "
          f"to {err:.3g} max abs (<= 1e-3 x {scale:.3g})", flush=True)
    del h, ref, cache

    # serving: full depth in the config's bfloat16
    eng = Engine(cfg, params, max_len=LM_MAX_LEN, device=CARD)
    reqs = [GenRequest(prompt=rng.integers(2, cfg.vocab, size=int(rng.integers(3, 13))).astype(np.int32),
                       max_new_tokens=LM_NEW_TOKENS, temperature=0.0 if i % 2 == 0 else 0.8)
            for i in range(LM_REQUESTS)]
    eng.generate(reqs, seed=0)  # warm
    torch.cuda.synchronize()
    outs = eng.generate(reqs, seed=1)
    stats = dict(eng.last_stats)
    stats["s_per_decode_step"] = (stats["wall_s"] - stats["prefill_s"]) / max(1, stats["batch_steps"] - 1)
    check(len(outs) == LM_REQUESTS and all(1 <= len(o) <= LM_NEW_TOKENS for o in outs), "one answer a request")
    check(all(((o >= 0) & (o < cfg.padded_vocab)).all() for o in outs), "tokens in the vocabulary")
    check(stats["tokens"] == sum(len(o) for o in outs), "the stats count the answers' tokens")
    greedy = [o for o, r in zip(outs, reqs) if r.temperature == 0.0]
    # the reference's serving regressions (tests/test_serve.py)
    g = GenRequest(prompt=np.array([0, 5, 9], np.int32), max_new_tokens=8, temperature=0.0)
    hot = GenRequest(prompt=np.array([0, 7], np.int32), max_new_tokens=8, temperature=1.5)
    solo = eng.generate([g], seed=0)[0]
    m1, m2 = eng.generate([hot, g], seed=1), eng.generate([hot, g], seed=2)
    check(np.array_equal(m1[1], solo) and np.array_equal(m2[1], solo),
          "a greedy row is the same alone and behind a hot row under two seeds")
    check(not np.array_equal(m1[0], m2[0]), "the hot row samples")
    early = GenRequest(prompt=np.array([0, 5, 9], np.int32), max_new_tokens=8, temperature=0.0, eos_id=int(solo[0]))
    other = GenRequest(prompt=np.array([0, 7, 4], np.int32), max_new_tokens=8, temperature=0.0)
    both = eng.generate([early, other], seed=0)
    check(len(both[0]) == 1 and both[0][0] == solo[0], "a row that emits EOS stops there")
    check(eng.last_stats["tokens"] == len(both[0]) + len(both[1]), "the stats count only the real tokens")
    check(np.array_equal(both[1], eng.generate([other], seed=0)[0]), "the laggard row is unaffected by EOS")
    rec["serving"] = {**stats, "requests": LM_REQUESTS, "new_tokens": LM_NEW_TOKENS,
                      "greedy_rows": len(greedy), "hot_rows": LM_REQUESTS - len(greedy)}
    print(f"  serving at full depth in bfloat16 on {smi}: {LM_REQUESTS} requests (prompts 3-12 tokens, "
          f"{LM_NEW_TOKENS} new, half greedy, half at temperature 0.8): {stats['tok_per_s']:.1f} tokens/s, "
          f"{stats['tokens']} tokens in {stats['wall_s']:.3f} s, prefill {stats['prefill_s']:.4f} s, "
          f"{stats['s_per_decode_step']:.4f} s a decode step (phase 11 reads a step's device time); greedy rows "
          f"equal alone, behind hot rows and under other seeds; EOS masking and the stats checked", flush=True)
    record["lm"] = rec
    return cfg, params, lm_decode_steps(eng, reqs, LM_PROFILED_STEPS)


def embed_docs(cfg, params, n_docs: int):
    """Mean-pooled final hidden states of ``n_docs`` synthetic documents
    (``train_batch`` at seq_len 48, batches of 32) in the config's dtype,
    cast to float32, with 40 near-duplicates injected as the curation
    example makes them."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as tf
    from repro_torch.train import data as data_lib

    dcfg = data_lib.DataConfig(seed=9, vocab=cfg.vocab, seq_len=48, global_batch=32)
    embs = []
    with torch.inference_mode():
        for step in range(-(-n_docs // 32)):
            tokens = data_lib.train_batch(dcfg, step)["tokens"].to(CARD)
            h, _ = tf.forward(params, cfg, tokens)
            embs.append(h.mean(dim=1).float())
        x = torch.cat(embs)[:n_docs].cpu().numpy()
    x[-40:] = x[:40] + np.random.default_rng(0).normal(0, 1e-3, x[:40].shape)
    return x.astype(np.float32)


def embedding_phase(cfg, params, smi: str, record: dict) -> dict:
    """Phase 13: the phase-12 model embeds N_DOCS documents (d = 1536) and
    the card fits them at kmax = 24 through ``MultiHDBSCAN``, with the
    launch counters set to 0 just before it; the first N_DOCS_CPU rows
    fitted on the card equal the port's CPU fit bit for bit; the exact
    variant of the documents on the card (the sliced ``lune_filter`` on a
    fit's path) keeps a subset of the RNG* fit's graph and its MST weights
    bit for bit, and ``lune_filter`` is timed on its unresolved edges; MST
    weight multisets at mpts 2, 8, 16, 24 equal dense scipy MSTs; then the
    curation report.  Returns the launches of the fit, the embeddings and
    the fit's largest ``sbcn_tile`` calls (``tile_dots.largest``)."""
    import numpy as np
    import torch
    from repro_torch.api import MultiHDBSCAN
    from repro_torch.core import dbcv, ref as oref
    from repro_torch.kernels import fused_cascade as fc
    from repro_torch.models import transformer as tf

    lf, pt, sl, st = (kernel_module(k) for k in ("lune_filter", "pairwise_topk", "single_linkage", "sbcn_tile"))
    t0 = time.monotonic()
    p_c = tf.cast_for_compute(params, cfg)
    x = embed_docs(cfg, p_c, N_DOCS)
    torch.cuda.synchronize()
    rec = {"embed_s": time.monotonic() - t0, "n": N_DOCS, "d": int(x.shape[1]), "kmax": KMAX_EMBED}
    del p_c
    check(x.shape == (N_DOCS, cfg.d_model) and bool(np.isfinite(x).all()), "embeddings finite, (n, d_model)")
    print(f"phase 13: {N_DOCS} documents embedded by {cfg.name} in {rec['embed_s']:.2f} s (d={x.shape[1]}, "
          f"40 near-duplicates injected)", flush=True)

    x_c = x[:N_DOCS_CPU]
    with cpu_pool() as pool:
        job = start_cpu_fit(pool, x_c, KMAX_EMBED)
        pt.pairwise_topk.launches = fc.edge_cascade.launches = lf.lune_filter.launches = 0
        sl.single_linkage.launches = st.tile_dots.launches = st.point_norms.launches = 0
        st.tile_dots.path_launches.clear()
        st.tile_dots.record = True  # keep the fit's largest call a path
        t0 = time.monotonic()
        est = MultiHDBSCAN(kmax=KMAX_EMBED, device=CARD).fit(x)
        views = est.select_all()
        torch.cuda.synchronize()
        rec["fit_s"] = time.monotonic() - t0
        st.tile_dots.record = False
        launches = {"pairwise_topk": pt.pairwise_topk.launches, "edge_cascade": fc.edge_cascade.launches,
                    "single_linkage": sl.single_linkage.launches, "lune_filter": lf.lune_filter.launches,
                    "sbcn_tile": st.tile_dots.launches, "sbcn_norms": st.point_norms.launches,
                    "sbcn_tile_paths": dict(st.tile_dots.path_launches)}
        calls = dict(st.tile_dots.largest)
        st.tile_dots.largest.clear()
        est_g = MultiHDBSCAN(kmax=KMAX_EMBED, device=CARD).fit(x_c)
        views_g = est_g.select_all()
        exact_phase(x, est, smi, rec)
        cpu = job.get(timeout=CPU_FIT_TIMEOUT)
    rec["launches"], rec["graph"] = launches, est.graph_.stats
    rec["stages_s"] = {k: est.timings_[k] for k in ("knn", "rng_build", "mst_range")}
    rec["stages_s"]["hierarchy"] = rec["fit_s"] - sum(rec["stages_s"].values())
    check(launches["pairwise_topk"] >= 1, "the embedding fit launched pairwise_topk (d=1536, K=31)")
    check(launches["edge_cascade"] >= 2, "the embedding fit launched edge_cascade for both stages")
    check(launches["single_linkage"] == 1, "the embedding fit's select_all launched single_linkage once")
    check(launches["sbcn_tile"] >= 1, "the embedding fit's SBCN tiles (d=1536 > 256) launched sbcn_tile")
    check(launches["sbcn_norms"] >= 1, "the embedding fit's SBCN norms (d=1536 > 256) launched the norms pre-pass")
    check(est.plan_.backend == "cuda", "the embedding fit ran on the cuda backend")
    check(len(views) == KMAX_EMBED - 1 and all(v.labels.shape == (N_DOCS,) for v in views), "labels per mpts")
    print(f"  fit + select_all at n={N_DOCS}, d={x.shape[1]}, kmax={KMAX_EMBED} on the card in "
          f"{rec['fit_s']:.2f} s, launches {launches}, stages (s) on {smi}: {json.dumps(rec['stages_s'])}, "
          f"graph {est.graph_.stats}", flush=True)

    rec["cpu_fit_s"] = cpu["total_s"]
    check(est_g.graph_.stats == cpu["stats"],
          f"embedding fit: graph counts (SBCN candidates included) equal the CPU run: {est_g.graph_.stats} "
          f"vs {cpu['stats']}")
    check(np.array_equal(est_g.graph_.edges, cpu["edges"]), "embedding fit: graph edges equal the CPU run")
    m_g = est_g.model_.msts
    check(np.array_equal(m_g.mst_ea, cpu["mst_ea"]) and np.array_equal(m_g.mst_eb, cpu["mst_eb"]),
          "embedding fit: MST edge ids equal the CPU run for every mpts")
    check(np.array_equal(m_g.mst_w, cpu["mst_w"]), "embedding fit: MST weights equal the CPU run bit for bit")
    for v_g, lab_c in zip(views_g, cpu["labels"]):
        check(np.array_equal(v_g.labels, lab_c), f"embedding fit: labels equal the CPU run at mpts={v_g.mpts}")
    print(f"  the first {N_DOCS_CPU} embeddings: card fit == device='cpu' fit (graph counts, edges, MST ids, MST weights, labels "
          f"for every mpts; CPU fit {rec['cpu_fit_s']:.1f} s in a worker process on {CPU_FIT_THREADS} threads, "
          f"beside the card fits)", flush=True)

    x64 = x.astype(np.float64)
    t0 = time.monotonic()
    dist = oref.pairwise_d(x64)
    cd = np.sort(dist, axis=1)[:, :KMAX_EMBED]
    for mpts in MPTS_DENSE:
        c = cd[:, mpts - 1]
        m = np.maximum(np.maximum(c[:, None], c[None, :]), dist)
        np.fill_diagonal(m, 0.0)
        dense = oref.mst_weights(m)
        _, _, w = est.mst_for(mpts)
        check(np.allclose(np.sort(w.astype(np.float64)), dense, rtol=RTOL, atol=0.0),
              f"n={N_DOCS}, d={x.shape[1]}: MST weight multiset vs dense scipy at mpts={mpts}")
    rec["dense_check_s"] = time.monotonic() - t0
    print(f"  n={N_DOCS}: MST weight multisets == dense scipy MSTs at mpts {list(MPTS_DENSE)} "
          f"(rtol {RTOL}; {rec['dense_check_s']:.1f} s)", flush=True)

    scores = {}
    for v in views:
        ea, eb, w = est.mst_for(v.mpts)
        scores[v.mpts] = dbcv.dbcv_relative_validity(ea, eb, w, v.labels)
    best = max(scores, key=lambda k: scores[k])
    ea, eb, w = est.mst_for(best)
    labels = [v for v in views if v.mpts == best][0].labels
    dup = w < max(np.quantile(w, 0.01), 1e-6)
    flagged = {(min(a, b), max(a, b)) for a, b in zip(ea[dup].tolist(), eb[dup].tolist())}
    injected = {(i, N_DOCS - 40 + i) for i in range(40)}
    keep = np.ones(N_DOCS, bool)
    keep[eb[dup]] = False
    rec["curation"] = {"dbcv": scores, "mpts": best, "n_clusters": int(labels.max() + 1) if (labels >= 0).any() else 0,
                       "outliers": int((labels == -1).sum()), "dup_pairs_flagged": len(flagged),
                       "injected_pairs_flagged": len(flagged & injected), "kept": int(keep.sum())}
    print(f"  curation: DBCV chose mpts={best} (DBCV {scores[best]:.3f}); {rec['curation']['n_clusters']} clusters, "
          f"{rec['curation']['outliers']} outliers; {len(flagged)} near-duplicate pairs flagged (bottom-1% mrd), "
          f"{len(flagged & injected)} of the 40 injected among them (a reading); keep {int(keep.sum())}/{N_DOCS}",
          flush=True)
    record["embedding"] = rec
    return launches, x, calls


def exact_phase(x, est_star, smi: str, rec: dict) -> None:
    """The exact variant, ``MultiHDBSCAN(kmax=24, variant="rng")``, of the
    embedding rows ``x`` on the card, with ``lune_filter``'s counter set to
    0 just before it: it launches the sliced ``lune_filter``, keeps a
    subset of the RNG* fit ``est_star``'s graph and its MST weight
    multisets bit for bit at every mpts; then ``lune_filter`` on the fit's
    unresolved edges against its plain version (verdict bits), timed
    beside the plain version and its bound."""
    import numpy as np
    import torch
    from repro_torch.api import MultiHDBSCAN
    from repro_torch.kernels import ops

    lf = kernel_module("lune_filter")
    captured = {}

    def spy(*args, **kwargs):  # records the unresolved edges the exact pass scans
        captured["args"], captured["kwargs"] = args, kwargs
        return real_lune_nonempty(*args, **kwargs)

    real_lune_nonempty = ops.lune_nonempty
    ops.lune_nonempty = spy
    try:
        lf.lune_filter.launches = 0
        t0 = time.monotonic()
        est = MultiHDBSCAN(kmax=KMAX_EMBED, variant="rng", device=CARD).fit(x)
        torch.cuda.synchronize()
        fit_s = time.monotonic() - t0
        launches = lf.lune_filter.launches
    finally:
        ops.lune_nonempty = real_lune_nonempty
    n, d = x.shape
    gx = est.graph_.stats
    check(launches >= 1, f"the exact fit at n={n}, d={d} launched lune_filter")
    check(set(map(tuple, est.graph_.edges.tolist())) <= set(map(tuple, est_star.graph_.edges.tolist())),
          "exact embedding fit: its edges are a subset of the RNG* fit's")
    for mpts in est_star.mpts_values_:
        check(np.array_equal(np.sort(est_star.mst_for(mpts)[2]), np.sort(est.mst_for(mpts)[2])),
              f"exact embedding fit keeps the RNG* fit's MST weight multiset bit for bit at mpts={mpts}")
    args = lune_args(*captured["args"])
    kw = {"block_e": captured["kwargs"]["block_e"], "block_c": captured["kwargs"]["block_c"]}
    out, err = check_lune_filter(args, f"the exact embedding fit's {gx['m_unresolved']} unresolved edges", **kw)
    check(int(out.sum()) == gx["m_removed_exact"], "the kernel's removals are the exact embedding fit's")
    m = int(args[0].shape[0])
    ms = cuda_ms(lambda: lf.lune_filter(*args, **kw), 10)
    plain_ms = cuda_ms(lambda: lf.lune_filter_plain(*args), 1, warm=False)
    b_ms, b_by = bound(*lune_flops_bytes(n, d, m, int(out.sum())))
    rec["exact"] = {"n": n, "d": d, "fit_s": fit_s, "graph": gx, "lune_filter_launches": launches,
                    "lune_filter": {"edges": m, "removed": int(out.sum()), "ms": ms, "plain_ms": plain_ms,
                                    "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err}}
    print(f"  exact variant of the first {n} embeddings on the card in {fit_s:.2f} s, graph {gx}: edges a subset "
          f"of the RNG* fit's, MST weight multisets equal for mpts 2..{KMAX_EMBED}; lune_filter launched "
          f"{launches}x; on its {m} unresolved edges x {n} points on {smi}: {ms:.4f} ms (bound {b_ms:.4f} ms, "
          f"plain {plain_ms:.3f} ms; kernel == plain)", flush=True)


def kmax128_phase(smi: str, record: dict) -> dict:
    """Phase 14: ``MultiHDBSCAN(kmax=128)`` at n = N_WIDE, d = 8 on the card
    (K = 135), with the counters set to 0 just before it: mpts 2..16 MST
    weight multisets equal a kmax = 16 fit's bit for bit.  Returns its
    launches and the fitted estimator."""
    import numpy as np
    import torch
    from repro_torch.api import MultiHDBSCAN
    from repro_torch.kernels import fused_cascade as fc

    pt, sl = kernel_module("pairwise_topk"), kernel_module("single_linkage")
    x = make_points(N_WIDE, D, SEED + 30)
    pt.pairwise_topk.launches = fc.edge_cascade.launches = sl.single_linkage.launches = 0
    t0 = time.monotonic()
    est = MultiHDBSCAN(kmax=KMAX_128, device=CARD).fit(x)
    views = est.select_all()
    torch.cuda.synchronize()
    fit_s = time.monotonic() - t0
    launches = {"pairwise_topk": pt.pairwise_topk.launches, "edge_cascade": fc.edge_cascade.launches,
                "single_linkage": sl.single_linkage.launches}
    check(launches["pairwise_topk"] >= 1 and launches["edge_cascade"] >= 2 and launches["single_linkage"] == 1,
          f"the kmax={KMAX_128} fit launched pairwise_topk (K=135), edge_cascade and single_linkage")
    check(len(views) == KMAX_128 - 1, f"kmax={KMAX_128}: one level a mpts")
    small = MultiHDBSCAN(kmax=KMAX, device=CARD).fit(x)
    for mpts in small.mpts_values_:
        check(np.array_equal(np.sort(est.mst_for(mpts)[2]), np.sort(small.mst_for(mpts)[2])),
              f"the kmax={KMAX_128} fit keeps the kmax={KMAX} fit's MST weight multiset bit for bit at mpts={mpts}")
    stages = {k: est.timings_[k] for k in ("knn", "rng_build", "mst_range")}
    record["kmax128_fit"] = {"n": N_WIDE, "d": D, "kmax": KMAX_128, "fit_s": fit_s, "stages_s": stages,
                             "launches": launches, "graph": est.graph_.stats}
    print(f"phase 14: kmax={KMAX_128} at n={N_WIDE}, d={D} on the card in {fit_s:.2f} s (with select_all), "
          f"launches {launches}, graph {est.graph_.stats}; MST weight multisets == the kmax={KMAX} fit's for mpts "
          f"2..{KMAX}; stages (s) on {smi}: {json.dumps(stages)}", flush=True)
    return launches, est


def kmax256_phase(x, est_128, smi: str, record: dict, key: str = "kmax256_fit") -> dict:
    """``MultiHDBSCAN(kmax=256).fit(x).select_all()`` on the card (K = 263:
    the streamed select), with the counters set to 0 just before it: the
    streamed select launches once (the fit's one ``pairwise_topk`` call),
    ``edge_cascade`` at least twice, ``single_linkage`` once; 255 levels;
    where ``est_128`` is given (phase 14's kmax = 128 fit of the same
    points), its MST weight multisets at mpts 2..128 bit for bit.  Records
    the stage seconds, the peak device memory (the whole run's, and that of
    the MST stage, ``multi._mst_stage_local``, apart from what came before
    it) and what earlier phases held when it began under ``key``; returns
    the launches."""
    import numpy as np
    import torch
    from repro_torch.api import MultiHDBSCAN
    from repro_torch.core import multi
    from repro_torch.kernels import fused_cascade as fc

    pt, sl = kernel_module("pairwise_topk"), kernel_module("single_linkage")
    n, d = x.shape
    peaks = {}
    stage = multi._mst_stage_local

    def mst_stage(*args, **kwargs):
        """The MST stage with the peak before it and its own apart."""
        torch.cuda.synchronize()
        peaks["before_mst_stage"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = stage(*args, **kwargs)
        torch.cuda.synchronize()
        peaks["mst_stage"] = torch.cuda.max_memory_allocated()
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # by earlier phases: the peak counts it too
    pt.pairwise_topk.launches = pt.pairwise_topk.select_launches = pt.pairwise_topk.stream_launches = 0
    fc.edge_cascade.launches = sl.single_linkage.launches = 0
    multi._mst_stage_local = mst_stage
    try:
        t0 = time.monotonic()
        est = MultiHDBSCAN(kmax=KMAX_256, device=CARD).fit(x)
        t1 = time.monotonic()
        views = est.select_all()
        torch.cuda.synchronize()
        t2 = time.monotonic()
    finally:
        multi._mst_stage_local = stage
    launches = {"pairwise_topk": pt.pairwise_topk.launches, "pairwise_topk_select": pt.pairwise_topk.select_launches,
                "pairwise_topk_stream": pt.pairwise_topk.stream_launches,
                "edge_cascade": fc.edge_cascade.launches, "single_linkage": sl.single_linkage.launches}
    peaks["after_mst_stage"] = torch.cuda.max_memory_allocated()
    peak = max(peaks.values())
    check(launches["pairwise_topk"] == 1 and launches["pairwise_topk_stream"] == 1,
          f"the kmax={KMAX_256} fit ran its top-K (K={K_SELECT_FIT}) through the streamed select, once")
    check(launches["edge_cascade"] >= 2 and launches["single_linkage"] == 1,
          f"the kmax={KMAX_256} fit launched edge_cascade for both stages and single_linkage once")
    check(len(views) == KMAX_256 - 1 and all(v.labels.shape == (n,) for v in views),
          f"kmax={KMAX_256}: one level a mpts")
    if est_128 is not None:
        for mpts in est_128.mpts_values_:
            check(np.array_equal(np.sort(est.mst_for(mpts)[2]), np.sort(est_128.mst_for(mpts)[2])),
                  f"the kmax={KMAX_256} fit keeps the kmax={KMAX_128} fit's MST weight multiset bit for bit at "
                  f"mpts={mpts}")
    stages = {k: est.timings_[k] for k in ("knn", "rng_build", "mst_range")}
    stages["hierarchy"] = t2 - t1
    record[key] = {"n": n, "d": d, "kmax": KMAX_256, "fit_s": t1 - t0, "stages_s": stages, "launches": launches,
                   "max_memory_allocated": peak, "peaks": peaks, "allocated_before": held,
                   "graph": est.graph_.stats, "mst_chunk_rows": multi.MST_CHUNK_ELEMS // len(est.graph_.edges)}
    same = f"; MST weight multisets == the kmax={KMAX_128} fit's for mpts 2..{KMAX_128}" if est_128 else ""
    print(f"kmax={KMAX_256} at n={n}, d={d} on the card: fit {t1 - t0:.2f} s, select_all {t2 - t1:.2f} s, launches "
          f"{launches}, graph {est.graph_.stats}, peak {peak / 1e9:.3f} GB ({held / 1e9:.3f} GB held before it; "
          f"by stage {json.dumps({k: round(v / 1e9, 3) for k, v in peaks.items()})} GB; MST rows a chunk "
          f"{record[key]['mst_chunk_rows']}){same}; stages (s) on {smi}: {json.dumps(stages)}", flush=True)
    return launches


def stored_select_path(smi: str, record: dict) -> dict:
    """The stored select on a path a user takes: the paper's baseline,
    ``hdbscan_baseline(X, [256], kmax=256)``, on n = 1007 points at d = 320
    (K = 263 above d = 256), with the counters set to 0 just before it: the
    stored select once (the streamed select never), ``prim_mst`` and
    ``single_linkage`` once; its MST weight multiset equal to a dense
    float64 MST's (rtol 1e-5).  Returns the launches."""
    import numpy as np
    import torch
    from repro_torch.core import multi, ref as oref

    pm, pt, sl = (kernel_module(k) for k in ("prim_mst", "pairwise_topk", "single_linkage"))
    x = make_points(N_RAGGED, WIDE_WIDTHS[0], SEED + 40)
    pt.pairwise_topk.launches = pt.pairwise_topk.select_launches = pt.pairwise_topk.stream_launches = 0
    pm.prim_mst.launches = sl.single_linkage.launches = 0
    t0 = time.monotonic()
    (h,), _ = multi.hdbscan_baseline(x, [KMAX_256], kmax=KMAX_256, device=CARD)
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    launches = {"pairwise_topk": pt.pairwise_topk.launches, "pairwise_topk_select": pt.pairwise_topk.select_launches,
                "pairwise_topk_stream": pt.pairwise_topk.stream_launches, "prim_mst": pm.prim_mst.launches,
                "single_linkage": sl.single_linkage.launches}
    check(launches["pairwise_topk_select"] == 1 and launches["pairwise_topk_stream"] == 0
          and launches["prim_mst"] == 1 and launches["single_linkage"] == 1,
          f"the kmax={KMAX_256} baseline at d={WIDE_WIDTHS[0]} ran the stored select once: {launches}")
    x64 = x.astype(np.float64)
    dense = oref.mst_weights(oref.mrd_matrix(x64, KMAX_256, oref.core_distances(x64, KMAX_256)))
    check(h.mst_w.shape == (N_RAGGED - 1,) and np.allclose(np.sort(h.mst_w.astype(np.float64)), dense, rtol=RTOL,
                                                           atol=0.0),
          f"the kmax={KMAX_256} baseline's MST weight multiset vs dense scipy at d={WIDE_WIDTHS[0]}")
    record["stored_select_path"] = {"n": N_RAGGED, "d": WIDE_WIDTHS[0], "kmax": KMAX_256, "s": secs,
                                    "launches": launches}
    print(f"the stored select's path: hdbscan_baseline(X, [{KMAX_256}], kmax={KMAX_256}) at n={N_RAGGED}, "
          f"d={WIDE_WIDTHS[0]} on {smi} in {secs:.2f} s, launches {launches}; MST weights == dense scipy",
          flush=True)
    return launches


def select_kernel_times(launches_256: dict, launches_stored: dict, checked: dict, smi: str, record: dict) -> list:
    """The lists past K = 256 timed beside their plain version, the library
    yardstick (``mm`` + ``topk``) and their bound (``topk_flops_bytes``, as
    ``pairwise_topk.work``): the streamed select at the kmax = 256 fit's
    shape (n = 4000, d = 8, K = 263), at (16000, 8, 263) and (4000, 8, 307),
    each also on the stored select (the streamed one turned off by the hook,
    timed in turns with it: stream, stored, stored, stream); the stored
    select at (4000, 1536, 263).  Outputs bit-equal (where
    ``check_select_cases`` held a shape, its differences ``checked``
    holds).  Returns the rows of the ``{"kernels": ...}`` line: the
    streamed select at the fit's shape with the fit's launches, the stored
    select at d = 1536 with the launches of its path (``stored_select_path``)."""
    import torch
    from repro_torch.kernels import _build

    pt = kernel_module("pairwise_topk")
    dev = torch.device(CARD)
    off = lambda: stream_plan(from_k=pt.KSTREAM)  # noqa: E731  (the stored select at every K)
    rows = {}
    for name, x, k_eff in (
            ("pairwise_topk_stream", make_points(N_WIDE, D, SEED + 30), K_SELECT_FIT),
            ("pairwise_topk_stream_n16000", make_points(N, D, SEED), K_SELECT_FIT),
            ("pairwise_topk_stream_k307", make_points(N_WIDE, D, SEED + 11), K_SELECT[1]),
            ("pairwise_topk_select", make_points(N_WIDE, WIDE_WIDTHS[-1], SEED + WIDE_WIDTHS[-1]), K_SELECT_FIT)):
        x = torch.from_numpy(x).to(dev)
        n, d = x.shape
        inst = pt.instance(d, k_eff)
        err = checked.get(f"n={n},d={d},K={k_eff},{inst}")
        err = check_pairwise_topk(x, k_eff, k_eff - 8) if err is None else err
        run = lambda: pt.pairwise_topk(x, k_eff)  # noqa: E731
        if inst == "stream":
            with off():
                check_pairwise_topk(x, k_eff, k_eff - 8)  # the stored select on the same points
            ms = [cuda_ms(run, 5)]
            with off():
                stored_ms = [cuda_ms(run, 5), cuda_ms(run, 5)]
            ms.append(cuda_ms(run, 5))
        else:
            ms, stored_ms = [cuda_ms(run, 5)], None
        plain_ms = cuda_ms(lambda: pt.pairwise_topk_plain(x, k_eff), 1, warm=False)
        library_ms = cuda_ms(lambda: library_topk(x, k_eff), 5)
        b_ms, b_by = bound(*topk_flops_bytes(n, d, k_eff))
        launches = {"pairwise_topk_stream": launches_256["pairwise_topk_stream"],
                    "pairwise_topk_select": launches_stored["pairwise_topk_select"]}.get(name)
        rows[name] = {"n": n, "d": d, "K": k_eff, "instance": inst, "launches": launches, "max_abs_err": err,
                      "ms": sum(ms) / len(ms), "ms_runs": ms, "stored_select_ms_runs": stored_ms,
                      "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
                      "config": pt.kernel_config(n, d, k_eff)}
        nbytes = ctypes.c_size_t()
        lib = _build.load("pairwise_topk")
        lib.repro_pairwise_topk_workspace.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        check(lib.repro_pairwise_topk_workspace(n, d, k_eff, ctypes.addressof(nbytes)) == 0, "workspace query")
        rows[name]["workspace_bytes"] = nbytes.value
        if inst == "stream":
            with off():
                check(lib.repro_pairwise_topk_workspace(n, d, k_eff, ctypes.addressof(nbytes)) == 0, "workspace query")
            rows[name]["stored_select_workspace_bytes"] = nbytes.value
        print(f"{name} on {smi}: " + json.dumps(rows[name]), flush=True)
    record["select_kernels"] = rows
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return [{"name": name, "route": "cuda", "source": "src/repro_torch/kernels/csrc/pairwise_topk.cu",
             "replaces": "src/repro/kernels/pairwise_topk.py:37", **{k: rows[name][k] for k in keys}}
            for name in ("pairwise_topk_stream", "pairwise_topk_select")]


def wide_kernel_times(x_emb, launches_emb: dict, launches_128: dict, smi: str, record: dict) -> list:
    """``pairwise_topk`` at the embedding fit's shape (n = N_DOCS, d = 1536,
    K = 31), again at n = N_WIDE on phase 3's synthetic points at that
    width (the shape of the earlier runs, whose embedding fit had 4000
    documents), each under its mirrored plan and, as ``split_ms``, the
    keys split, and at the kmax = 128 fit's (n = 4000, d = 8, K = 135),
    and ``lune_filter`` at d = 1536, each beside its plain version (outputs
    bit-equal), the library yardstick where there is one, and its bound.
    Returns the sliced instances' rows of the ``{"kernels": ...}`` line
    (``pairwise_topk`` at the fit's shape)."""
    import torch

    lf, pt = kernel_module("lune_filter"), kernel_module("pairwise_topk")
    dev = torch.device(CARD)
    rows = {}
    x8 = torch.from_numpy(make_points(N_WIDE, D, SEED + 30)).to(dev)
    x_syn = torch.from_numpy(make_points(N_WIDE, WIDE_WIDTHS[-1], SEED + WIDE_WIDTHS[-1])).to(dev)
    for name, x, k_eff, launches in (("pairwise_topk_d1536_k31", torch.from_numpy(x_emb).to(dev), K_EMBED,
                                      launches_emb["pairwise_topk"]),
                                     ("pairwise_topk_d1536_k31_n4000", x_syn, K_EMBED, None),
                                     ("pairwise_topk_d8_k135", x8, K_WIDE[0], launches_128["pairwise_topk"])):
        n, d = x.shape
        ms = cuda_ms(lambda: pt.pairwise_topk(x, k_eff), 5)
        plain_ms = cuda_ms(lambda: pt.pairwise_topk_plain(x, k_eff), 1, warm=False)

        library_ms = cuda_ms(lambda: library_topk(x, k_eff), 5)
        b_ms, b_by = bound(*topk_flops_bytes(n, d, k_eff))
        rows[name] = {"n": n, "d": d, "K": k_eff, "launches": launches,
                      "max_abs_err": check_pairwise_topk(x, k_eff, k_eff - 8), "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}
        if d > 256:  # the mirrored plan's time beside the key split's
            want = pt.pairwise_topk(x, k_eff)
            with keys_split():
                got = pt.pairwise_topk(x, k_eff)
                rows[name]["split_ms"] = cuda_ms(lambda: pt.pairwise_topk(x, k_eff), 5)
            check(bool((got[0] == want[0]).all() and (got[1] == want[1]).all()),
                  f"pairwise_topk's split plan equals its mirrored plan at n={n}, d={d}, K={k_eff}")
    args = lune_case(N_WIDE, WIDE_WIDTHS[-1], dev)
    m = int(args[0].shape[0])
    out, err = check_lune_filter(args, f"n={N_WIDE}, d={WIDE_WIDTHS[-1]}", block_e=8, block_c=512)
    ms = cuda_ms(lambda: lf.lune_filter(*args), 5)
    plain_ms = cuda_ms(lambda: lf.lune_filter_plain(*args), 1, warm=False)
    b_ms, b_by = bound(*lune_flops_bytes(N_WIDE, WIDE_WIDTHS[-1], m, int(out.sum())))
    rows["lune_filter_d1536"] = {"n": N_WIDE, "d": WIDE_WIDTHS[-1], "edges": m, "removed": int(out.sum()),
                                 "launches": record["embedding"]["exact"]["lune_filter_launches"],
                                 "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                                 "bound_by": b_by, "library_ms": None}
    record["wide_kernels"] = rows
    for name, r in rows.items():
        print(f"{name} on {smi}: " + json.dumps(r), flush=True)
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return [
        {"name": "pairwise_topk_d1536_k31", "route": "cuda", "source": "src/repro_torch/kernels/csrc/pairwise_topk.cu",
         "replaces": "src/repro/kernels/pairwise_topk.py:37",
         **{k: rows["pairwise_topk_d1536_k31"][k] for k in keys}},
        {"name": "lune_filter_d1536", "route": "cuda", "source": "src/repro_torch/kernels/csrc/lune_filter.cu",
         "replaces": "src/repro/kernels/lune_filter.py:33", **{k: rows["lune_filter_d1536"][k] for k in keys}},
    ]


def new_kernel_times(x, est_16, est_64, msts_dualtree, launches: dict, smi: str, record: dict) -> list:
    """``prim_mst`` at the baseline's shape (n = 16000, d = 8, the mpts = 16
    core distances) with its plan and its step floor, and ``single_linkage``
    on the kmax = 16 and 64 fits' sorted MSTs and on the n = 24000
    dual-tree fit's: each beside its plain version on the card and its
    bound; and ``hierarchy_linkage`` (``linkage_range``) at n = 16000 with
    the kernel beside the plain version on the host.  Returns their
    ``kernels`` entries."""
    import numpy as np
    import torch
    from repro_torch.core import multi

    pm, sl = kernel_module("prim_mst"), kernel_module("single_linkage")
    n, d = x.shape
    cd2_16 = est_16.plan_.knn(x, KMAX - 1)[0][:, -1].contiguous()
    plan = pm.launch_plan(n, d, x.device)
    got = {}
    p_ms = cuda_ms(lambda: got.__setitem__("kernel", pm.prim_mst(x, cd2_16)), 3)
    floor_ms = cuda_ms(lambda: pm.step_floor(n - 1, plan, x.device), 3)
    p_plain = cuda_ms(lambda: got.__setitem__("plain", pm.prim_mst_plain(x, cd2_16)), 1, warm=False)
    (s_k, w_k), (s_p, w_p) = got["kernel"], got["plain"]
    n_src = int((s_k != s_p).sum())
    n_w = int((w_k.view(torch.int32) != w_p.view(torch.int32)).sum())
    check(n_src == 0 and n_w == 0, f"prim_mst at n={n}, d={d}: src differs from the plain version at {n_src} "
          f"vertices, w2 bits at {n_w}")
    p_err = float((w_k - w_p).abs().max())
    # Prim evaluates the mrd of each vertex outside the tree once a step:
    # n (n - 1) / 2 rows of d subtractions, d squares, d adds and 3 maxima
    p_bound, p_by = bound(n * (n - 1) / 2 * (3 * d + 3), 4 * n * d + 4 * n + 8 * n)
    record["prim_mst"] = {"n": n, "d": d, "ms": p_ms, "plain_ms": p_plain, "bound_ms": p_bound,
                          "bound_by": p_by, "us_per_step": p_ms * 1e3 / (n - 1), "plan": plan_str(plan),
                          "step_floor_ms": floor_ms, "step_floor_us": floor_ms * 1e3 / (n - 1),
                          "clusters_a_card": pm.max_active_clusters(plan, d, x.device)}
    print(f"prim_mst at n={n}, d={d} on {smi}: {p_ms:.3f} ms ({p_ms * 1e3 / (n - 1):.4f} us a step over "
          f"{n - 1} dependent steps; plan {plan_str(plan)}, {record['prim_mst']['clusters_a_card']} such clusters "
          f"a card; step floor {floor_ms:.3f} ms, {floor_ms * 1e3 / (n - 1):.4f} us a step; bound {p_bound:.4f} ms "
          f"by {p_by}; plain {p_plain:.1f} ms); kernel == plain (src equal, w2 bit-equal)", flush=True)
    out = [{
        "name": "prim_mst", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/prim_mst.cu",
        "replaces": "src/repro/core/boruvka.py:189",
        "launches": record["baseline"]["launches"]["prim_mst"], "max_abs_err": p_err,
        "ms": p_ms, "plain_ms": p_plain, "bound_ms": p_bound, "bound_by": p_by, "library_ms": None,
    }]

    linkage_rec = {}
    # the plain version runs (and is timed) at R = 15, n = 16000 only: phases 4, 6 and 8 held the kernel
    # to it on all three MST sets
    for msts, main in ((est_16.model_.msts, True), (est_64.model_.msts, False), (msts_dualtree, False)):
        rows, n_l = len(msts.mpts_values), msts.n
        w = torch.from_numpy(np.array(msts.mst_w)).to(x.device)
        _, order = torch.sort(w, dim=1, stable=True)
        ea_s, eb_s = (torch.from_numpy(np.array(a)).to(x.device).gather(1, order) for a in (msts.mst_ea, msts.mst_eb))
        k_ms = cuda_ms(lambda: got.__setitem__("kernel", sl.single_linkage(ea_s, eb_s, n=n_l)), 5)
        check(bool((got["kernel"][2][:, -1] == n_l).all()), f"single_linkage at n={n_l}, R={rows}: the last merge "
              f"holds all {n_l} points")
        plain_ms, l_err = None, 0.0
        if main:
            plain_ms = cuda_ms(lambda: got.__setitem__("plain", sl.single_linkage_plain(ea_s, eb_s, n=n_l)), 1,
                               warm=False)
            for name, a, b in zip(("left", "right", "size"), got["kernel"], got["plain"]):
                check(torch.equal(a, b), f"single_linkage {name} at n={n_l}, R={rows}: kernel differs from plain")
            l_err = max(float((a - b).abs().max()) for a, b in zip(got["kernel"], got["plain"]))
        # each merge reads its two endpoints and writes left, right and size
        b_ms, b_by = bound(0.0, 20.0 * rows * (n_l - 1))
        rec = linkage_rec[f"n={n_l},R={rows}"] = {
            "ms": k_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "layout": sl.layout_for(n_l),
            "ns_per_merge": k_ms * 1e6 / (n_l - 1), "max_abs_err": l_err}
        host = ""
        if n_l == n:
            multi.linkage_range(msts, device=CARD)
            t0 = time.monotonic()
            lk_card = multi.linkage_range(msts, device=CARD)
            card_s = time.monotonic() - t0
            t0 = time.monotonic()
            lk_host = multi.linkage_range(msts, device="cpu")
            host_s = time.monotonic() - t0
            for f in ("left", "right", "height", "size"):
                check(np.array_equal(getattr(lk_card, f), getattr(lk_host, f)), f"hierarchy_linkage {f}: card == host")
            rec.update(hierarchy_linkage_card_s=card_s, hierarchy_linkage_host_s=host_s)
            host = (f"; hierarchy_linkage {card_s:.4f} s with the kernel, {host_s:.4f} s with the plain version on "
                    f"the host")
        plain = f"plain {plain_ms:.1f} ms" if main else "plain not timed here"
        print(f"single_linkage at n={n_l}, R={rows} on {smi}: {k_ms:.4f} ms ({k_ms * 1e6 / (n_l - 1):.1f} ns a merge "
              f"over {n_l - 1} dependent merges, state in {rec['layout']} memory; bound {b_ms:.4f} ms by {b_by}; "
              f"{plain}){host}", flush=True)
        if main:
            out.append({
                "name": "single_linkage", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/single_linkage.cu",
                "replaces": "src/repro/core/linkage.py:47",
                "launches": launches["single_linkage"], "max_abs_err": l_err,
                "ms": k_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            })
    record["single_linkage"] = linkage_rec
    return out


def rel_fro(got, want) -> float:
    """Relative Frobenius distance of two tensors, in float64."""
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def train_parity(cfg, params, rec: dict, layers: int = TRAIN_PARITY_LAYERS, label: str = "(a)") -> None:
    """Phase 15 (a), phase 16 (d): one AdamW step at full width, ``layers``
    layers, float32 compute and float32 masters (``params`` cast where they
    are bfloat16), on the card and on the port's CPU, on the same batch
    (``microbatch`` 2, a ragged ``xent_chunk``, one zero mask entry); an
    MoE model's ``aux`` loss held as the loss is."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.train import optim, step as step_lib

    cfg_a = dataclasses.replace(cfg, dtype="float32", microbatch=2, xent_chunk=TRAIN_PARITY_CHUNK)
    ocfg = optim.OptConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=TRAIN_STEPS)
    rng = np.random.default_rng(SEED + 30)
    shape = (TRAIN_PARITY_BATCH, TRAIN_PARITY_SEQ)
    mask = np.ones(shape, np.float32)
    mask[1, 5] = 0.0
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, shape).astype(np.int32)),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab, shape).astype(np.int32)),
             "mask": torch.from_numpy(mask)}
    if cfg.arch == "encdec":  # the decoder's tokens over frames of their own
        batch = {"dec_" + k: v for k, v in batch.items()}
        frames = rng.normal(size=(TRAIN_PARITY_BATCH, ENCDEC_PARITY_FRAMES, cfg.frontend_dim))
        batch["frames"] = torch.from_numpy(frames.astype(np.float32))
    half = TRAIN_PARITY_BATCH // 2

    def side(where: str) -> dict:
        t0 = time.monotonic()
        p2, cfg2 = truncated(params, cfg_a, layers, torch.device(where), copy=True)
        p2 = p2.float()  # float32 masters (bfloat16 ones cast, exactly)
        cfg2 = dataclasses.replace(cfg2, param_dtype="float32")
        b = {k: v.to(where) for k, v in batch.items()}
        names, tensors = zip(*p2.named_parameters())
        # the gradient the step accumulates: the mean of its two slices' losses
        loss_fn = step_lib.make_loss_fn(cfg2)
        parts = [loss_fn(p2, {k: v[s] for k, v in b.items()}) for s in (slice(0, half), slice(half, None))]
        mean = (parts[0][0] + parts[1][0]) / 2
        aux = float((parts[0][1]["aux"] + parts[1][1]["aux"]).detach() / 2)
        grads = [g.cpu() for g in torch.autograd.grad(mean, tensors)]
        del parts, mean
        before = [t.detach().cpu().clone() for t in tensors]
        init, _ = optim.make_optimizer(ocfg, cfg2)
        _, _, m = step_lib.make_train_step(cfg2, ocfg)(p2, init(p2), b)
        return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "names": names, "aux": aux,
                "s": time.monotonic() - t0,
                "grads": grads, "delta": [t.detach().cpu() - b0 for t, b0 in zip(tensors, before)]}

    # the CPU side in a thread beside the card's (torch's CPU ops release the
    # interpreter's lock): on a slow host it took up to 66 s of phase 17 alone
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        cpu_side = pool.submit(side, "cpu")
        out = {CARD: side(CARD)}
        torch.cuda.empty_cache()
        out["cpu"] = cpu_side.result()
    card, cpu = out[CARD], out["cpu"]
    if cfg.n_experts:
        aux_rel = abs(card["aux"] - cpu["aux"]) / abs(cpu["aux"])
        rec["parity_aux"] = {"card": card["aux"], "cpu": cpu["aux"], "rel": aux_rel}
        check(cpu["aux"] > 0 and aux_rel <= TRAIN_LOSS_RTOL,
              f"train parity: MoE aux card {card['aux']} vs CPU {cpu['aux']}")
    loss_rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    norm_rel = abs(card["grad_norm"] - cpu["grad_norm"]) / abs(cpu["grad_norm"])
    # compared on the card a tensor at a time: the float64 distances over
    # griffin's 1.1e9 elements took about half a minute on the host
    grad_rel, delta_rel, excluded, total = 0.0, 0.0, 0, 0
    for name, *pair in zip(cpu["names"], card["delta"], cpu["delta"], card["grads"], cpu["grads"]):
        d_g, d_c, g_g, g = (t.to(CARD) for t in pair)
        grad_rel = max(grad_rel, rel_fro(g_g, g))
        check(bool(torch.isfinite(d_g).all()), f"train parity: {name} finite after the card's step")
        # Adam's first update g / (|g| + eps) is about sign(g): where a gradient
        # element is a cancellation, the two summation orders' rounding can flip
        # it; such elements (the two gradients apart by more than 1e-3 of it)
        # are held by the gradients' distance instead
        well = (g_g - g).abs() <= 1e-3 * g.abs()
        excluded += int((~well).sum())
        total += g.numel()
        delta_rel = max(delta_rel, rel_fro(d_g[well], d_c[well]))
    rec["parity"] = {"layers": layers, "loss_card": card["loss"], "loss_cpu": cpu["loss"],
                     "loss_rel": loss_rel, "grad_norm_rel": norm_rel, "grad_rel_fro_max": grad_rel,
                     "delta_rel_fro_max": delta_rel, "delta_excluded": excluded, "elements": total,
                     "card_s": card["s"], "cpu_s": cpu["s"]}
    check(loss_rel <= TRAIN_LOSS_RTOL, f"train parity: loss card {card['loss']} vs CPU {cpu['loss']}")
    check(norm_rel <= TRAIN_NORM_RTOL, f"train parity: grad_norm relative {norm_rel} > {TRAIN_NORM_RTOL}")
    check(grad_rel <= TRAIN_GRAD_RTOL, f"train parity: gradients relative Frobenius {grad_rel} > {TRAIN_GRAD_RTOL}")
    check(delta_rel <= TRAIN_DELTA_RTOL, f"train parity: updates relative Frobenius {delta_rel} > {TRAIN_DELTA_RTOL}")
    check(excluded <= 1e-2 * total, f"train parity: {excluded} of {total} gradient elements apart by > 1e-3")
    aux_note = f"aux to {rec['parity_aux']['rel']:.3g} relative, " if cfg.n_experts else ""
    depth = f"{layers} + {layers}" if cfg.arch == "encdec" else f"{layers}"
    print(f"  {label} full width, {depth} layers, float32, microbatch 2, xent chunk {TRAIN_PARITY_CHUNK} "
          f"of S={TRAIN_PARITY_SEQ}: card == CPU, loss to {loss_rel:.3g} relative (<= {TRAIN_LOSS_RTOL}), {aux_note}grad_norm "
          f"{norm_rel:.3g} (<= {TRAIN_NORM_RTOL}), gradients {grad_rel:.3g} relative Frobenius (<= {TRAIN_GRAD_RTOL}), "
          f"updates {delta_rel:.3g} (<= {TRAIN_DELTA_RTOL}; {excluded} of {total} elements, whose gradients differ by "
          f"more than 1e-3 of themselves, held by the gradients' distance alone); card side {card['s']:.1f} s, CPU "
          f"side {cpu['s']:.1f} s", flush=True)


def state_bytes(state: dict) -> int:
    import torch

    def walk(x):
        if isinstance(x, torch.Tensor):
            return x.numel() * x.element_size()
        return sum(walk(v) for v in x.values()) if isinstance(x, dict) else 0

    return walk({k: v for k, v in state.items() if k != "step"})


def reckoned_state_bytes(cfg, state_dtype: str) -> int:
    """m and v as the reference's rules size them: 4 or 2 bytes an element,
    or int8 blocks of 32 with a float32 scale (bfloat16 where the
    reference leaf's last axis is not a multiple of 32)."""
    import math

    from repro_torch.models import reference_leaves
    from repro_torch.train import optim

    total = 0
    for leaf in reference_leaves(cfg).values():
        n = math.prod(leaf.shape[1:] if leaf.layer is not None else leaf.shape)
        if state_dtype == "int8" and optim.q8_compatible(leaf.shape):
            total += n + n // 32 * 4
        else:
            total += n * (4 if state_dtype == "float32" else 2)
    return 2 * total


def resume_drill(rec: dict) -> None:
    """Phase 15 (d): the reference's preemption drill on the card through
    the launcher: run A takes 10 steps; run B is preempted after 5 (exit
    42), then resumed; the final checkpoints are equal bit for bit."""
    import os
    import shutil

    import torch
    from repro_torch.train import checkpoint as ckpt_lib

    drill = ROOT / "build" / "train_drill"
    shutil.rmtree(drill, ignore_errors=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    common = [sys.executable, "-m", "repro_torch.launch.train", "--arch", LM_ARCH, *DRILL_ARGS, "--device", CARD]
    t0 = time.monotonic()
    procs = [subprocess.Popen(common + ["--ckpt-dir", str(drill / name), *extra], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for name, extra in (("a", ()), ("b", ("--preempt-after", "5")))]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    rcs = [p.returncode for p in procs]
    check(rcs == [0, 42], f"resume drill: run A and the preempted run B exit {rcs}, not [0, 42]: "
          f"{outs[0][1][-800:]} {outs[1][1][-800:]}")
    check(ckpt_lib.latest_step(str(drill / "b")) == 5, "resume drill: run B left its step-5 checkpoint")
    r = subprocess.run(common + ["--ckpt-dir", str(drill / "b")], env=env, capture_output=True, text=True,
                       timeout=300)
    check(r.returncode == 0 and "[resume] from step 5" in r.stdout, f"resume drill: run B resumed: {r.stderr[-800:]}")
    sa, step_a = ckpt_lib.restore(str(drill / "a"))
    sb, step_b = ckpt_lib.restore(str(drill / "b"))
    fa, fb = ckpt_lib._flatten(sa), ckpt_lib._flatten(sb)
    check(step_a == step_b == 10 and fa.keys() == fb.keys(), "resume drill: both runs end at step 10")
    equal = all(fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]) for k in fa)
    check(equal, "resume drill: the resumed run's checkpoint equals the straight run's bit for bit")
    rec["resume_drill"] = {"wall_s": time.monotonic() - t0, "tensors": len(fa)}
    print(f"  (d) resume drill through `python -m repro_torch.launch.train --device {CARD}` (reduced {LM_ARCH}, "
          f"deterministic algorithms): run A 10 steps, run B preempted after 5 (exit 42) and resumed; the step-10 "
          f"checkpoints ({len(fa)} tensors, params and AdamW state) equal bit for bit; "
          f"{rec['resume_drill']['wall_s']:.1f} s wall", flush=True)
    shutil.rmtree(drill, ignore_errors=True)


def training_phase(cfg, params, smi: str, record: dict):
    """Phase 15: LM training at qwen2-1.5b's published width on a copy of
    phase 12's masters.  (a) one step at 2 layers, card against CPU;
    (b) 6 steps at full depth as published (bfloat16 compute, float32
    masters and AdamW states, remat, xent chunks of 512), timed;
    (c) one step each with bfloat16 and int8 states; (d) the resume
    drill through the launcher.  Returns a function that runs one more
    full-depth step with float32 states, for phase 11's profile."""
    import dataclasses

    import torch
    from repro_torch.train import data as data_lib, optim, step as step_lib

    dev = torch.device(CARD)
    rec: dict = {}
    check((cfg.dtype, cfg.remat, cfg.xent_chunk, cfg.microbatch, cfg.optimizer_state_dtype)
          == ("bfloat16", True, 512, 1, "float32"), "qwen2-1.5b trains as published")
    train_parity(cfg, params, rec)

    # (b) full depth, the config as published
    p, _ = truncated(params, cfg, cfg.n_layers, dev, copy=True)
    ocfg = optim.OptConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_STEPS)
    init, _ = optim.make_optimizer(ocfg, cfg)
    state = init(p)
    n_state = state_bytes(state)
    check(n_state == reckoned_state_bytes(cfg, "float32"), f"float32 AdamW states: {n_state} bytes")
    train_step = step_lib.make_train_step(cfg, ocfg)
    dcfg = data_lib.DataConfig(seed=SEED, vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    batches = [{k: v.to(dev) for k, v in data_lib.train_batch(dcfg, i).items()} for i in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for b in batches:
        t0 = time.monotonic()
        _, _, m = train_step(p, state, b)
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t0)
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(t.numel() for t in p.parameters())
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = 6 * n_params * tokens + 12 * cfg.n_layers * cfg.n_heads * cfg.d_head * TRAIN_SEQ * tokens
    warm_s = sum(step_s[1:]) / (len(step_s) - 1)
    rec["full_depth"] = {"steps": TRAIN_STEPS, "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ, "losses": losses,
                         "step_s": step_s, "warm_s_per_step": warm_s, "tokens_per_s": tokens / warm_s,
                         "max_memory_allocated": peak, "n_params": n_params, "flops_per_step": flops,
                         "bf16_peak_share": flops / warm_s / PEAK_BF16_FLOPS, "state_bytes_float32": n_state}
    check(all(torch.isfinite(torch.tensor(losses))), f"full-depth losses finite: {losses}")
    check(losses[-1] <= losses[0] - 0.1, f"the loss descends by 0.1 over {TRAIN_STEPS} steps: {losses}")
    print(f"  (b) full depth ({cfg.n_layers} layers, {n_params} parameters) as published, {TRAIN_STEPS} steps of "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens at lr {TRAIN_LR} (warmup {TRAIN_WARMUP}) on {smi}: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; warm {warm_s:.4f} s a step (steps 2-{TRAIN_STEPS}; first "
          f"{step_s[0]:.3f} s), {tokens / warm_s:.0f} tokens/s, max_memory_allocated {peak / 1e9:.2f} GB, "
          f"(6 N + attention) FLOPs {flops:.4g} a step = {rec['full_depth']['bf16_peak_share']:.4f} of the dense "
          f"bf16 peak; float32 states {n_state / 1e9:.2f} GB", flush=True)

    # (c) one step each with bfloat16 and int8 states
    rec["state_dtypes"] = {}
    for state_dtype in ("bfloat16", "int8"):
        oc = dataclasses.replace(ocfg, state_dtype=state_dtype)
        init, _ = optim.make_optimizer(oc, cfg)
        st = init(p)
        nbytes = state_bytes(st)
        check(nbytes == reckoned_state_bytes(cfg, state_dtype), f"{state_dtype} states: {nbytes} bytes")
        heads = [t.detach().flatten()[:4096].clone() for t in p.parameters()]
        _, _, m = step_lib.make_train_step(cfg, oc)(p, st, batches[-1])
        torch.cuda.synchronize()
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        moved = all(not torch.equal(h, t.detach().flatten()[:4096]) for h, t in zip(heads, p.parameters()))
        finite = all(bool(torch.isfinite(t).all()) for t in p.parameters())
        rec["state_dtypes"][state_dtype] = {"state_bytes": nbytes, "loss": loss, "grad_norm": gnorm}
        check(finite and torch.isfinite(torch.tensor([loss, gnorm])).all(), f"{state_dtype} states: finite step")
        check(moved, f"{state_dtype} states: every parameter tensor moved")
        print(f"  (c) {state_dtype} states ({nbytes / 1e9:.3f} GB, as reckoned; float32 {n_state / 1e9:.3f} GB): "
              f"one full-depth step finite (loss {loss:.4f}, grad_norm {gnorm:.4f}), every tensor moved", flush=True)
        del st, heads
    torch.cuda.empty_cache()

    resume_drill(rec)
    record["training"] = rec

    def one_step():
        train_step(p, state, batches[-1])

    return one_step


def moe_phase(smi: str, record: dict) -> None:
    """Phase 16: deepseek-v2-lite (MLA + 64 routed and 2 shared experts,
    top 6) at its published width and depth, 1.621e10 parameters, on the
    card with random weights from the port's seeded init.  Its one cut is
    the masters' dtype: bfloat16 (32.4 GB, ``param_dtype`` honoured since
    this slice) where the config has float32 (64.8 GB, which leaves no room
    beside the serving cast).  (a) float32 logits at 2 layers, card against
    the port's CPU run (max abs 1e-3); (b) prefill of 8 prompts and 5 decode
    steps at 2 layers in float32, card against CPU (an MoE decode does not
    reproduce the forward: each call's expert capacity differs); (c)
    ``serve.lm.Engine`` in bfloat16 at full depth on 8 requests; (d) one
    AdamW step at 1 layer in float32, card against CPU, then 4 steps at 4
    of the 27 layers in bfloat16 compute on the bfloat16 masters, with
    bfloat16 AdamW states (phase 11's closures keep about 22 GB); (e)
    llava-next-34b at its published width and 8 of its 60 layers
    (bfloat16 masters): forward and prefill over 576 patch positions and
    24 text tokens, card against CPU in float32 at 1 layer, and in bfloat16
    on the card.  The LM path launches none of the hand-written kernels."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import abstract_init, init_params, transformer as tf
    from repro_torch.models.layers import moe_capacity
    from repro_torch.serve.lm import Engine, GenRequest
    from repro_torch.train import data as data_lib, optim, step as step_lib

    dev = torch.device(CARD)
    rec: dict = {}
    pub = get_config(MOE_ARCH)
    check((pub.n_layers, pub.d_model, pub.n_heads, pub.n_experts, pub.n_shared, pub.top_k, pub.d_ff_expert,
           pub.kv_lora, pub.qk_nope, pub.qk_rope, pub.v_head, pub.vocab, pub.dtype, pub.param_dtype)
          == (27, 2048, 16, 64, 2, 6, 1408, 512, 128, 64, 128, 102400, "bfloat16", "float32"),
          "deepseek-v2-lite as published")
    n_ref = sum(t.numel() for t in abstract_init(pub).parameters())
    cfg = dataclasses.replace(pub, param_dtype="bfloat16")  # the cut: bfloat16 masters
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 16), device=dev)
    torch.cuda.synchronize()
    rec.update(arch=cfg.name, init_s=time.monotonic() - t0, n_params=sum(t.numel() for t in params.parameters()),
               param_bytes=sum(t.numel() * t.element_size() for t in params.parameters()))
    check(rec["n_params"] == n_ref and round(n_ref / 1e10, 3) == 1.621,
          f"deepseek-v2-lite has the reference's {n_ref} parameters: {rec['n_params']}")
    check(all(t.dtype == torch.bfloat16 for t in params.parameters()), "bfloat16 masters")
    print(f"phase 16: {cfg.name} at its published width and depth ({cfg.n_layers} layers, d={cfg.d_model}, "
          f"{cfg.n_experts} routed + {cfg.n_shared} shared experts, top {cfg.top_k}, MLA kv_lora {cfg.kv_lora}; "
          f"{rec['n_params']} parameters, {rec['param_bytes'] / 1e9:.2f} GB of bfloat16 masters) initialised on the "
          f"card in {rec['init_s']:.1f} s", flush=True)
    rng = np.random.default_rng(SEED + 40)
    cfg32 = dataclasses.replace(cfg, dtype="float32")

    # (a) and (b): 2 layers at full width in float32, the card against the CPU
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32))
    prompts = torch.from_numpy(rng.integers(2, cfg.vocab, (MOE_PROMPTS, MOE_PROMPT_LEN)).astype(np.int32))
    follow = torch.from_numpy(rng.integers(2, cfg.vocab, (MOE_PROMPTS, MOE_DECODE_STEPS)).astype(np.int32))
    outs = {}
    with torch.inference_mode():
        for where in (CARD, "cpu"):
            t0 = time.monotonic()
            p2, cfg2 = truncated(params, cfg32, MOE_PARITY_LAYERS, torch.device(where))
            h, aux = tf.forward(p2, cfg2, toks.to(where))
            logits = tf.logits_fn(p2, cfg2, h).float().cpu()
            last, cache = tf.prefill(p2, cfg2, prompts.to(where), max_len=MOE_PROMPT_LEN + MOE_DECODE_STEPS,
                                     cache_dtype=torch.float32)
            steps = [last.float().cpu()]
            for t in range(MOE_DECODE_STEPS):
                lg, cache = tf.decode_step(p2, cfg2, cache, follow[:, t : t + 1].to(where))
                steps.append(lg.float().cpu())
            outs[where] = {"logits": logits, "aux": float(aux), "steps": torch.stack(steps, dim=1),
                           "s": time.monotonic() - t0}
            del p2, h, cache
    card, cpu = outs[CARD], outs["cpu"]
    err = float((card["logits"] - cpu["logits"]).abs().max())
    aux_rel = abs(card["aux"] - cpu["aux"]) / abs(cpu["aux"])
    err_dec = float((card["steps"] - cpu["steps"]).abs().max())
    rec["parity"] = {"layers": MOE_PARITY_LAYERS, "logits_max_abs": err, "aux_card": card["aux"],
                     "aux_cpu": cpu["aux"], "aux_rel": aux_rel, "decode_max_abs": err_dec, "cpu_s": cpu["s"]}
    check(bool(torch.isfinite(card["logits"]).all()) and card["logits"].shape == (2, 24, cfg.padded_vocab),
          "2-layer logits finite, (B, S, padded_vocab)")
    check(err <= LM_PARITY_TOL, f"2-layer float32 logits: card vs CPU max abs {err} > {LM_PARITY_TOL}")
    check(cpu["aux"] > 0 and aux_rel <= TRAIN_LOSS_RTOL, f"2-layer aux: card {card['aux']} vs CPU {cpu['aux']}")
    check(bool(torch.isfinite(card["steps"]).all()), "prefill and decode logits finite")
    check(err_dec <= LM_PARITY_TOL, f"prefill + decode, 2 layers, float32: card vs CPU max abs {err_dec}")
    print(f"  (a) full width, {MOE_PARITY_LAYERS} layers, float32: card logits == the port's CPU logits to {err:.3g} "
          f"max abs (<= {LM_PARITY_TOL}), aux {card['aux']:.6g} to {aux_rel:.3g} relative", flush=True)
    print(f"  (b) prefill of {MOE_PROMPTS} prompts of {MOE_PROMPT_LEN} tokens + {MOE_DECODE_STEPS} decode steps "
          f"(latent cache, expert capacity {moe_capacity(cfg, MOE_PROMPTS)} "
          f"a decode step) at {MOE_PARITY_LAYERS} layers, float32: card == CPU to {err_dec:.3g} max abs "
          f"(<= {LM_PARITY_TOL}); CPU side {cpu['s']:.1f} s", flush=True)

    # (c) serving at full depth in bfloat16
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, params, max_len=LM_MAX_LEN, device=CARD)
    reqs = [GenRequest(prompt=rng.integers(2, cfg.vocab, size=int(rng.integers(3, 13))).astype(np.int32),
                       max_new_tokens=LM_NEW_TOKENS, temperature=0.0 if i % 2 == 0 else 0.8)
            for i in range(LM_REQUESTS)]
    eng.generate(reqs, seed=0)  # warm
    torch.cuda.synchronize()
    answers = eng.generate(reqs, seed=1)
    stats = dict(eng.last_stats)
    stats["s_per_decode_step"] = (stats["wall_s"] - stats["prefill_s"]) / max(1, stats["batch_steps"] - 1)
    stats["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    check(len(answers) == LM_REQUESTS and all(1 <= len(o) <= LM_NEW_TOKENS for o in answers), "one answer a request")
    check(all(((o >= 0) & (o < cfg.padded_vocab)).all() for o in answers), "tokens in the vocabulary")
    check(stats["tokens"] == sum(len(o) for o in answers), "the stats count the answers' tokens")
    greedy = [r.temperature == 0.0 for r in reqs]
    again = eng.generate([r for r, g in zip(reqs, greedy) if g], seed=2)
    check(len(again) == sum(greedy), "greedy rows answer again")
    rec["serving"] = {**stats, "requests": LM_REQUESTS, "new_tokens": LM_NEW_TOKENS}
    print(f"  (c) serving at full depth in bfloat16 on {smi}: {LM_REQUESTS} requests (prompts 3-12 tokens, "
          f"{LM_NEW_TOKENS} new, half greedy, half at temperature 0.8): {stats['tok_per_s']:.1f} tokens/s, "
          f"{stats['tokens']} tokens in {stats['wall_s']:.3f} s, prefill {stats['prefill_s']:.4f} s, "
          f"{stats['s_per_decode_step']:.4f} s a decode step, max_memory_allocated "
          f"{stats['max_memory_allocated'] / 1e9:.2f} GB", flush=True)
    del eng

    # (d) training: 1 layer in float32 against the CPU, then 4 layers in bfloat16 compute
    train_rec: dict = {}
    train_parity(cfg, params, train_rec, layers=1, label="(d)")
    rec["train_parity"] = train_rec
    p4, cfg4 = truncated(params, cfg, MOE_TRAIN_LAYERS, dev, copy=True)
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ocfg = optim.OptConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=MOE_TRAIN_STEPS,
                           state_dtype=MOE_TRAIN_STATES)
    init, _ = optim.make_optimizer(ocfg, cfg4)
    state = init(p4)
    train_step = step_lib.make_train_step(cfg4, ocfg)
    dcfg = data_lib.DataConfig(seed=SEED, vocab=cfg.vocab, seq_len=MOE_TRAIN_SEQ, global_batch=MOE_TRAIN_BATCH)
    batches = [{k: v.to(dev) for k, v in data_lib.train_batch(dcfg, i).items()} for i in range(MOE_TRAIN_STEPS)]
    losses, step_s = [], []
    for b in batches:
        t0 = time.monotonic()
        _, _, m = train_step(p4, state, b)
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t0)
        losses.append(float(m["loss"]))
    with torch.no_grad():
        aux = float(step_lib.make_loss_fn(cfg4)(p4, batches[-1])[1]["aux"])
    peak = torch.cuda.max_memory_allocated()
    finite = all(bool(torch.isfinite(t).all()) for t in p4.parameters())
    rec["train"] = {"layers": MOE_TRAIN_LAYERS, "steps": MOE_TRAIN_STEPS, "batch": MOE_TRAIN_BATCH,
                    "states": MOE_TRAIN_STATES,
                    "seq_len": MOE_TRAIN_SEQ, "microbatch": cfg4.microbatch, "losses": losses, "step_s": step_s,
                    "aux": aux, "max_memory_allocated": peak,
                    "n_params": sum(t.numel() for t in p4.parameters())}
    check(finite and all(np.isfinite(losses)), f"MoE training: finite losses and masters: {losses}")
    check(aux > 0, f"MoE training: aux {aux} > 0")
    print(f"  (d) {MOE_TRAIN_STEPS} steps at full width, {MOE_TRAIN_LAYERS} of {cfg.n_layers} layers "
          f"({rec['train']['n_params']} parameters, bfloat16 masters and compute, {MOE_TRAIN_STATES} AdamW states, microbatch "
          f"{cfg4.microbatch}) on {MOE_TRAIN_BATCH} x {MOE_TRAIN_SEQ} tokens on {smi}: losses "
          f"{[round(v, 4) for v in losses]}, aux {aux:.5f}, {step_s[-1]:.3f} s the last step, max_memory_allocated "
          f"{peak / 1e9:.2f} GB", flush=True)
    del p4, state, batches, train_step
    torch.cuda.empty_cache()

    # (e) the patch frontend: llava-next-34b at its published width, 8 layers
    pubv = get_config(VLM_ARCH)
    check((pubv.n_layers, pubv.d_model, pubv.n_heads, pubv.n_kv, pubv.d_head, pubv.d_ff, pubv.vocab, pubv.frontend,
           pubv.frontend_dim) == (60, 7168, 56, 8, 128, 20480, 64000, "patches", 1152), "llava-next-34b as published")
    cfgv = dataclasses.replace(pubv, n_layers=VLM_LAYERS, param_dtype="bfloat16")
    t0 = time.monotonic()
    pv = init_params(cfgv, torch.Generator(device=dev).manual_seed(SEED + 17), device=dev)
    torch.cuda.synchronize()
    vrec = {"layers": VLM_LAYERS, "init_s": time.monotonic() - t0, "n_params": sum(t.numel() for t in pv.parameters()),
            "patches": VLM_PATCHES, "text": VLM_TEXT}
    patches = torch.from_numpy(rng.normal(size=(1, VLM_PATCHES, cfgv.frontend_dim)).astype(np.float32))
    vtoks = torch.from_numpy(rng.integers(0, cfgv.vocab, (1, VLM_TEXT)).astype(np.int32))
    s_all = VLM_PATCHES + VLM_TEXT
    outs = {}
    with torch.inference_mode():
        for where in (CARD, "cpu"):
            p1, c1 = truncated(pv, dataclasses.replace(cfgv, dtype="float32"), 1, torch.device(where))
            h, _ = tf.forward(p1, c1, vtoks.to(where), patches.to(where))
            text = tf.logits_fn(p1, c1, h[:, -VLM_TEXT:]).float().cpu()
            last, cache = tf.prefill(p1, c1, vtoks.to(where), max_len=s_all + 4, patch_embeds=patches.to(where),
                                     cache_dtype=torch.float32)
            outs[where] = {"text": text, "last": last.float().cpu(), "shape": tuple(h.shape), "pos": cache["pos"]}
            del p1, h, cache
        card, cpu = outs[CARD], outs["cpu"]
        err = float((card["text"] - cpu["text"]).abs().max())
        err_last = float((card["last"] - cpu["last"]).abs().max())
        check(card["shape"] == (1, s_all, cfgv.d_model) and card["pos"] == s_all, "patches come first in the stream")
        check(err <= LM_PARITY_TOL and err_last <= LM_PARITY_TOL,
              f"llava, 1 layer, float32: text logits card vs CPU {err}, prefill {err_last} (<= {LM_PARITY_TOL})")
        torch.cuda.synchronize()
        t0 = time.monotonic()
        h, _ = tf.forward(pv, cfgv, vtoks.to(dev), patches.to(dev))
        lg = tf.logits_fn(pv, cfgv, h[:, -1:]).float()
        torch.cuda.synchronize()
        vrec["forward_bf16_s"] = time.monotonic() - t0
        last, cache = tf.prefill(pv, cfgv, vtoks.to(dev), max_len=s_all + 4, patch_embeds=patches.to(dev),
                                 cache_dtype=torch.bfloat16)
        scale = max(1.0, float(lg.abs().max()))
        err_bf16 = float((last.float() - lg[:, 0]).abs().max())
        check(bool(torch.isfinite(h).all()) and bool(torch.isfinite(last).all()), "llava bfloat16 forward finite")
        check(cache["k"].shape == (VLM_LAYERS, 1, s_all + 4, cfgv.n_kv, cfgv.d_head) and cache["pos"] == s_all,
              "llava's cache holds the patch and text positions")
        check(err_bf16 <= 1e-2 * scale, f"llava bfloat16: prefill's last logits vs the forward's {err_bf16}")
    vrec.update(parity_text_max_abs=err, parity_prefill_max_abs=err_last, bf16_prefill_vs_forward=err_bf16)
    rec["vlm"] = vrec
    print(f"  (e) {cfgv.name} at its published width (d={cfgv.d_model}, {cfgv.n_heads} heads, kv {cfgv.n_kv}), "
          f"{VLM_LAYERS} of {pubv.n_layers} layers ({vrec['n_params']} parameters, bfloat16 masters): "
          f"{VLM_PATCHES} patch positions + {VLM_TEXT} text tokens; 1 layer float32 card == CPU to {err:.3g} (text "
          f"logits) and {err_last:.3g} (prefill) max abs; bfloat16 on the card: forward {vrec['forward_bf16_s']:.3f} s, "
          f"prefill's last logits == the forward's to {err_bf16:.3g}", flush=True)
    del pv, h, cache, last
    torch.cuda.empty_cache()
    record["moe"] = rec


def family_train_flops(cfg, n_params: int, batch: int, seq: int) -> float:
    """(6 N + attention) FLOPs of one train step: 12 x attention blocks x
    heads x d_head x S a token (phase 15's count; griffin's 2048 window
    covers S = 1024 whole), none for mamba2, whose SSD chunks are not
    counted."""
    from repro_torch.models import get_model

    n_attn = sum(kind == "A" for kind, _, _ in get_model(cfg).skeleton(cfg).blocks()) if cfg.arch == "griffin" else 0
    tokens = batch * seq
    return 6 * n_params * tokens + 12 * n_attn * cfg.n_heads * cfg.d_head * seq * tokens


def family_phase(arch: str, smi: str) -> dict:
    """Phase 17 for one family at its published width and depth, random
    weights from the port's seeded init on the card: (a) the parameter
    count and bytes; (b) float32 at ``FAMILY_DEPTH`` layers, the card's
    forward logits and prefill + 5 decode steps against the port's CPU
    run (max abs 1e-3); (c) decode against forward on the card at that
    depth in float32 over ``FAMILY_LONG``'s prompt (mamba2: across the
    256-token chunk, padded; griffin: past the 2048-slot ring, which
    wraps); (d) ``serve.lm.Engine`` at full depth in bfloat16 on 8
    requests; (e) ``train_parity`` at that depth; (f) 4 train steps at full
    width and depth as published (bfloat16 compute, float32 masters and
    AdamW states, remat), B x 1024 tokens."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import abstract_init, get_model, init_params
    from repro_torch.serve.lm import Engine, GenRequest
    from repro_torch.train import data as data_lib, optim, step as step_lib

    dev = torch.device(CARD)
    cfg = get_config(arch)
    fields, want = FAMILY_PUBLISHED[arch]
    check(tuple(getattr(cfg, f) for f in fields) == want, f"{cfg.name} as published")
    check((cfg.dtype, cfg.param_dtype, cfg.remat, cfg.xent_chunk, cfg.microbatch, cfg.optimizer_state_dtype)
          == ("bfloat16", "float32", True, 512, 1, "float32"), f"{cfg.name} trains as published")
    model = get_model(cfg)
    n_ref = sum(t.numel() for t in abstract_init(cfg).parameters())
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 23), device=dev)
    torch.cuda.synchronize()
    rec = {"arch": cfg.name, "init_s": time.monotonic() - t0, "n_params": sum(t.numel() for t in params.parameters()),
           "param_bytes": sum(t.numel() * t.element_size() for t in params.parameters())}
    check(rec["n_params"] == n_ref, f"{cfg.name} has the reference's {n_ref} parameters: {rec['n_params']}")
    print(f"phase 17: {cfg.name} at its published width and depth ({cfg.n_layers} layers, d={cfg.d_model}; "
          f"{rec['n_params']} parameters, {rec['param_bytes'] / 1e9:.2f} GB of float32 masters) initialised on the "
          f"card in {rec['init_s']:.1f} s", flush=True)
    rng = np.random.default_rng(SEED + 50)
    depth = FAMILY_DEPTH[arch]
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    part_s, clock = {}, [time.monotonic()]

    def part(name: str) -> None:
        now = time.monotonic()
        part_s[name], clock[0] = now - clock[0], now

    # (b) the card against the CPU at the truncated depth, float32
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32))
    prompts = torch.from_numpy(rng.integers(2, cfg.vocab, (2, 12)).astype(np.int32))
    follow = torch.from_numpy(rng.integers(2, cfg.vocab, (2, 5)).astype(np.int32))
    outs = {}
    with torch.inference_mode():
        for where in (CARD, "cpu"):
            t0 = time.monotonic()
            p2, c2 = truncated(params, cfg32, depth, torch.device(where))
            h, _ = model.forward(p2, c2, toks.to(where))
            logits = model.logits_fn(p2, c2, h).float().cpu()
            last, cache = model.prefill(p2, c2, prompts.to(where), max_len=12 + 5, cache_dtype=torch.float32)
            steps = [last.float().cpu()]
            for t in range(5):
                lg, cache = model.decode_step(p2, c2, cache, follow[:, t : t + 1].to(where))
                steps.append(lg.float().cpu())
            outs[where] = {"logits": logits, "steps": torch.stack(steps, dim=1), "s": time.monotonic() - t0}
            del p2, h, cache
    card, cpu = outs[CARD], outs["cpu"]
    err = float((card["logits"] - cpu["logits"]).abs().max())
    err_dec = float((card["steps"] - cpu["steps"]).abs().max())
    rec["parity"] = {"layers": depth, "logits_max_abs": err, "decode_max_abs": err_dec, "cpu_s": cpu["s"]}
    check(bool(torch.isfinite(card["logits"]).all()) and card["logits"].shape == (2, 24, cfg.padded_vocab),
          f"{depth}-layer logits finite, (B, S, padded_vocab)")
    check(err <= LM_PARITY_TOL, f"{depth}-layer float32 logits: card vs CPU max abs {err} > {LM_PARITY_TOL}")
    check(bool(torch.isfinite(card["steps"]).all()) and err_dec <= LM_PARITY_TOL,
          f"{depth}-layer prefill + decode, float32: card vs CPU max abs {err_dec} > {LM_PARITY_TOL}")
    print(f"  (b) full width, {depth} layers, float32: card == the port's CPU run to {err:.3g} max abs (forward "
          f"logits) and {err_dec:.3g} (prefill of 2 x 12 tokens + 5 decode steps), <= {LM_PARITY_TOL}; CPU side "
          f"{cpu['s']:.1f} s", flush=True)
    part("b")

    # (c) decode against forward on the card, float32, past the chunk or the ring
    s_len, n_dec = FAMILY_LONG[arch]
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, s_len + n_dec)).astype(np.int32)).to(dev)
    with torch.inference_mode():
        p2, c2 = truncated(params, cfg32, depth, dev)
        h, _ = model.forward(p2, c2, toks)
        ref = model.logits_fn(p2, c2, h[:, s_len - 1 :])
        last, cache = model.prefill(p2, c2, toks[:, :s_len], max_len=s_len + n_dec, cache_dtype=torch.float32)
        steps = [last]
        for t in range(n_dec):
            lg, cache = model.decode_step(p2, c2, cache, toks[:, s_len + t : s_len + t + 1])
            steps.append(lg)
        serve = torch.stack(steps, dim=1)
        del p2, h, cache
    err = float((serve - ref).abs().max())
    rec["decode_vs_forward"] = {"prompt": s_len, "decoded": n_dec, "max_abs": err, "max_logit": float(ref.abs().max())}
    check(bool(torch.isfinite(serve).all()), "decode logits finite")
    check(err <= LM_PARITY_TOL, f"decode vs forward, {depth} layers, float32: max abs {err} > {LM_PARITY_TOL}")
    print(f"  (c) {depth} layers, float32 on the card: prefill of {s_len} tokens + {n_dec} decode steps == the "
          f"forward over the sequence to {err:.3g} max abs (<= {LM_PARITY_TOL}; {FAMILY_LONG_NOTE[arch]})", flush=True)
    part("c")

    # (d) serving at full depth in bfloat16
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, params, max_len=LM_MAX_LEN, device=CARD)
    reqs = [GenRequest(prompt=rng.integers(2, cfg.vocab, size=int(rng.integers(3, 13))).astype(np.int32),
                       max_new_tokens=LM_NEW_TOKENS, temperature=0.0 if i % 2 == 0 else 0.8)
            for i in range(LM_REQUESTS)]
    eng.generate(reqs, seed=0)  # warm
    torch.cuda.synchronize()
    answers = eng.generate(reqs, seed=1)
    stats = dict(eng.last_stats)
    stats["s_per_decode_step"] = (stats["wall_s"] - stats["prefill_s"]) / max(1, stats["batch_steps"] - 1)
    again = eng.generate(reqs, seed=2)
    stats["device_s_per_decode_step"] = graph_ms(lm_decode_steps(eng, reqs, 1), FAMILY_DECODE_REPS) / 1e3
    stats["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    check(len(answers) == LM_REQUESTS and all(1 <= len(o) <= LM_NEW_TOKENS for o in answers), "one answer a request")
    check(all(((o >= 0) & (o < cfg.padded_vocab)).all() for o in answers), "tokens in the vocabulary")
    check(stats["tokens"] == sum(len(o) for o in answers), "the stats count the answers' tokens")
    check(all(np.array_equal(a, b) for a, b, r in zip(answers, again, reqs) if r.temperature == 0.0),
          "greedy rows equal under another seed")
    rec["serving"] = {**stats, "requests": LM_REQUESTS, "new_tokens": LM_NEW_TOKENS}
    print(f"  (d) serving at full depth in bfloat16 on {smi}: {LM_REQUESTS} requests (prompts 3-12 tokens, "
          f"{LM_NEW_TOKENS} new, half greedy, half at temperature 0.8): {stats['tok_per_s']:.1f} tokens/s, "
          f"{stats['tokens']} tokens in {stats['wall_s']:.3f} s, prefill {stats['prefill_s']:.4f} s, "
          f"{stats['s_per_decode_step']:.4f} s a decode step ({stats['device_s_per_decode_step']:.5f} s of device "
          f"time, a step replayed from a CUDA graph), max_memory_allocated "
          f"{stats['max_memory_allocated'] / 1e9:.2f} GB; greedy rows equal under another seed", flush=True)
    del eng
    part("d")

    # (e) one step at the truncated depth, card against CPU
    train_rec: dict = {}
    train_parity(cfg, params, train_rec, layers=depth, label="(e)")
    rec["train_parity"] = train_rec
    torch.cuda.empty_cache()
    part("e")

    # (f) full width and depth as published
    batch = FAMILY_TRAIN_BATCH
    ocfg = optim.OptConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=FAMILY_TRAIN_STEPS)
    init, _ = optim.make_optimizer(ocfg, cfg)
    state = init(params)
    n_state = state_bytes(state)
    check(n_state == reckoned_state_bytes(cfg, "float32"), f"float32 AdamW states: {n_state} bytes")
    train_step = step_lib.make_train_step(cfg, ocfg)
    dcfg = data_lib.DataConfig(seed=SEED, vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=batch)
    batches = [{k: v.to(dev) for k, v in data_lib.train_batch(dcfg, i).items()} for i in range(FAMILY_TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for b in batches:
        t0 = time.monotonic()
        _, _, m = train_step(params, state, b)
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t0)
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    flops = family_train_flops(cfg, rec["n_params"], batch, TRAIN_SEQ)
    warm_s = sum(step_s[1:]) / (len(step_s) - 1)
    finite = all(bool(torch.isfinite(t).all()) for t in params.parameters())
    rec["train"] = {"steps": FAMILY_TRAIN_STEPS, "batch": batch, "seq_len": TRAIN_SEQ, "losses": losses,
                    "step_s": step_s, "warm_s_per_step": warm_s, "tokens_per_s": batch * TRAIN_SEQ / warm_s,
                    "max_memory_allocated": peak, "flops_per_step": flops,
                    "bf16_peak_share": flops / warm_s / PEAK_BF16_FLOPS, "state_bytes_float32": n_state}
    check(finite and all(np.isfinite(losses)), f"{cfg.name} training: finite losses and masters: {losses}")
    print(f"  (f) full width and depth as published ({rec['n_params']} parameters; bfloat16 compute, float32 "
          f"masters and AdamW states, remat), {FAMILY_TRAIN_STEPS} steps of {batch} x {TRAIN_SEQ} tokens at lr "
          f"{TRAIN_LR} on {smi}: losses {[round(v, 4) for v in losses]}; warm {warm_s:.4f} s a step (steps "
          f"2-{FAMILY_TRAIN_STEPS}; first {step_s[0]:.3f} s), {batch * TRAIN_SEQ / warm_s:.0f} tokens/s, "
          f"max_memory_allocated {peak / 1e9:.2f} GB, (6 N + attention) FLOPs {flops:.4g} a step = "
          f"{rec['train']['bf16_peak_share']:.4f} of the dense bf16 peak; float32 states {n_state / 1e9:.2f} GB",
          flush=True)
    del params, state, batches, train_step
    torch.cuda.empty_cache()
    part("f")
    rec["part_s"] = part_s
    print(f"  {cfg.name}: seconds by part {json.dumps({k: round(v, 1) for k, v in part_s.items()})}", flush=True)
    return rec


def families_phase(smi: str, record: dict) -> None:
    """Phase 17: mamba2-780m and recurrentgemma-2b (``family_phase``), with
    the launch counters set to 0 just before and read just after: (g) no
    clustering kernel launches on these paths."""
    names = ("pairwise_topk", "fused_cascade", "lune_filter", "prim_mst", "single_linkage", "sbcn_tile")
    pt, fc, lf, pm, sl, st = (kernel_module(k) for k in names)
    counters = {"pairwise_topk": pt.pairwise_topk, "edge_cascade": fc.edge_cascade, "lune_filter": lf.lune_filter,
                "prim_mst": pm.prim_mst, "single_linkage": sl.single_linkage, "sbcn_tile": st.tile_dots,
                "sbcn_norms": st.point_norms}
    for fn in counters.values():
        fn.launches = 0
    rec = {arch: family_phase(arch, smi) for arch in FAMILY_ARCHS}
    launches = {k: fn.launches for k, fn in counters.items()}
    rec["launches"] = launches
    check(not any(launches.values()), f"the SSM and recurrent paths launched no clustering kernel: {launches}")
    print(f"  (g) launches of the hand-written kernels on these paths: {launches}", flush=True)
    record["families"] = rec


def encdec_train_flops(cfg, params, batch: int, s_enc: int, s_dec: int) -> float:
    """(6 N + attention) FLOPs of one encoder-decoder train step: the
    encoder's parameters (with ``proj_in``) and the decoder's cross K/V
    projections over the frames, the rest of the decoder (with the
    ``unembed`` product; the embedding lookup has none) over the decoder
    tokens, and 12 x layers x heads x d_head x keys a token for the
    encoder's self-attention, the decoder's and its cross-attention
    (phase 15's count)."""
    n_enc = n_xkv = n_dec = 0
    for name, t in params.named_parameters():
        if name.startswith("enc.") or name.startswith("proj_in") or name == "enc_norm":
            n_enc += t.numel()
        elif ".cross_attn.wk." in name or ".cross_attn.wv." in name:
            n_xkv += t.numel()
        elif name != "embed":
            n_dec += t.numel()
    frames, toks = batch * s_enc, batch * s_dec
    hd = 12 * cfg.n_heads * cfg.d_head
    attn = hd * (cfg.n_enc_layers * s_enc * frames + cfg.n_dec_layers * (s_dec + s_enc) * toks)
    return 6 * ((n_enc + n_xkv) * frames + n_dec * toks) + attn


def encdec_serve(model, pc, cfg, frames, steps: int):
    """Greedy serving of ``frames``: prefill, then ``steps`` decode steps
    on the argmax -> (tokens (B, steps + 1), prefill s, decode s, cache)."""
    import torch

    with torch.inference_mode():
        t0 = time.monotonic()
        logits, cache = model.prefill(pc, cfg, frames, max_len=ENCDEC_MAX_LEN, cache_dtype=torch.bfloat16)
        cur = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        t1 = time.monotonic()
        toks = [cur]
        for _ in range(steps):
            logits, cache = model.decode_step(pc, cfg, cache, cur)
            cur = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            toks.append(cur)
        out = torch.cat(toks, dim=1)
        torch.cuda.synchronize()
    return out, t1 - t0, time.monotonic() - t1, cache


def encdec_phase(smi: str, record: dict) -> None:
    """Phase 18: seamless-m4t-large-v2 at its published width and depth
    (24 + 24 layers, float32 masters, random weights from the port's
    seeded init), the clustering kernels' counters set to 0 just before
    and read just after: (a) the parameter count and bytes; (b) float32
    at 2 + 2 layers, forward logits and prefill + 5 decode steps card vs
    CPU (max abs 1e-3); (c) decode against the teacher-forced forward on
    the card at that depth over 24 steps inside ``dec_len``; (d) serving
    at full depth in bfloat16: 8 requests of 1024 frames, ``max_len``
    1024 (``dec_len`` 256), 24 greedy decode steps (prefill s, s a decode
    step and its device time from a CUDA graph replay, tokens/s, peak
    memory); (e) ``train_parity`` at 2 + 2 layers; (f) 4 train steps at
    full size (bfloat16 compute, float32 masters and AdamW states, remat)
    on 4 rows of 1024 frames and 256 decoder tokens; (g) no clustering
    kernel launched."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import abstract_init, get_model, init_params
    from repro_torch.train import optim, step as step_lib

    names = ("pairwise_topk", "fused_cascade", "lune_filter", "prim_mst", "single_linkage", "sbcn_tile")
    pt, fc, lf, pm, sl, st = (kernel_module(k) for k in names)
    counters = {"pairwise_topk": pt.pairwise_topk, "edge_cascade": fc.edge_cascade, "lune_filter": lf.lune_filter,
                "prim_mst": pm.prim_mst, "single_linkage": sl.single_linkage, "sbcn_tile": st.tile_dots,
                "sbcn_norms": st.point_norms}
    for fn in counters.values():
        fn.launches = 0
    dev = torch.device(CARD)
    cfg = get_config(ENCDEC_ARCH)
    fields, want = ENCDEC_PUBLISHED
    check(tuple(getattr(cfg, f) for f in fields) == want, f"{cfg.name} as published")
    check((cfg.dtype, cfg.param_dtype, cfg.remat, cfg.xent_chunk, cfg.microbatch, cfg.optimizer_state_dtype)
          == ("bfloat16", "float32", True, 512, 1, "float32"), f"{cfg.name} trains as published")
    model = get_model(cfg)
    n_ref = sum(t.numel() for t in abstract_init(cfg).parameters())
    check(n_ref == ENCDEC_PARAMS, f"{cfg.name}: the meta skeleton counts {n_ref} parameters, not {ENCDEC_PARAMS}")
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 24), device=dev)
    torch.cuda.synchronize()
    rec = {"arch": cfg.name, "init_s": time.monotonic() - t0, "n_params": sum(t.numel() for t in params.parameters()),
           "param_bytes": sum(t.numel() * t.element_size() for t in params.parameters())}
    check(rec["n_params"] == ENCDEC_PARAMS, f"{cfg.name} has the reference's {ENCDEC_PARAMS} parameters")
    print(f"phase 18: (a) {cfg.name} at its published width and depth ({cfg.n_enc_layers} + {cfg.n_dec_layers} "
          f"layers, d={cfg.d_model}, {cfg.n_heads} heads; {rec['n_params']} parameters, "
          f"{rec['param_bytes'] / 1e9:.2f} GB of float32 masters) initialised on the card in {rec['init_s']:.1f} s",
          flush=True)
    rng = np.random.default_rng(SEED + 51)
    depth = ENCDEC_DEPTH
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    part_s, clock = {}, [time.monotonic()]

    def part(name: str) -> None:
        now = time.monotonic()
        part_s[name], clock[0] = now - clock[0], now

    def frames_of(b: int, s: int) -> torch.Tensor:
        return torch.from_numpy(rng.normal(size=(b, s, cfg.frontend_dim)).astype(np.float32))

    # (b) the card against the CPU at 2 + 2 layers, float32
    frames, toks = frames_of(2, 40), torch.from_numpy(rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32))
    follow = torch.from_numpy(rng.integers(2, cfg.vocab, (2, 5)).astype(np.int32))
    outs = {}
    with torch.inference_mode():
        for where in (CARD, "cpu"):
            t0 = time.monotonic()
            p2, c2 = truncated(params, cfg32, depth, torch.device(where))
            h, _ = model.forward(p2, c2, toks.to(where), frames.to(where))
            logits = model.logits_fn(p2, c2, h).float().cpu()
            last, cache = model.prefill(p2, c2, frames.to(where), max_len=64, cache_dtype=torch.float32)
            steps = [last.float().cpu()]
            for t in range(5):
                lg, cache = model.decode_step(p2, c2, cache, follow[:, t : t + 1].to(where))
                steps.append(lg.float().cpu())
            outs[where] = {"logits": logits, "steps": torch.stack(steps, dim=1), "s": time.monotonic() - t0}
            del p2, h, cache
    card, cpu = outs[CARD], outs["cpu"]
    err = float((card["logits"] - cpu["logits"]).abs().max())
    err_dec = float((card["steps"] - cpu["steps"]).abs().max())
    rec["parity"] = {"layers": depth, "logits_max_abs": err, "decode_max_abs": err_dec, "cpu_s": cpu["s"]}
    check(bool(torch.isfinite(card["logits"]).all()) and card["logits"].shape == (2, 24, cfg.padded_vocab),
          f"{depth} + {depth}-layer logits finite, (B, S, padded_vocab)")
    check(err <= LM_PARITY_TOL, f"{depth} + {depth}-layer float32 logits: card vs CPU max abs {err} > {LM_PARITY_TOL}")
    check(bool(torch.isfinite(card["steps"]).all()) and err_dec <= LM_PARITY_TOL,
          f"{depth} + {depth}-layer prefill + decode, float32: card vs CPU max abs {err_dec} > {LM_PARITY_TOL}")
    print(f"  (b) full width, {depth} + {depth} layers, float32: card == the port's CPU run to {err:.3g} max abs "
          f"(forward logits over 40 frames and 24 tokens) and {err_dec:.3g} (prefill of 2 x 40 frames + 5 decode "
          f"steps), <= {LM_PARITY_TOL}; CPU side {cpu['s']:.1f} s", flush=True)
    part("b")

    # (c) decode against the teacher-forced forward on the card, float32
    n_dec = ENCDEC_DECODE_STEPS
    frames = frames_of(2, 64).to(dev)
    toks = torch.from_numpy(rng.integers(2, cfg.vocab, (2, n_dec)).astype(np.int32)).to(dev)
    max_len = 128  # dec_len 32: BOS and the 24 steps write slots 0-24
    with torch.inference_mode():
        p2, c2 = truncated(params, cfg32, depth, dev)
        dec_in = torch.cat([torch.zeros((2, 1), dtype=torch.int32, device=dev), toks], dim=1)
        h, _ = model.forward(p2, c2, dec_in, frames)
        ref = model.logits_fn(p2, c2, h)
        last, cache = model.prefill(p2, c2, frames, max_len=max_len, cache_dtype=torch.float32)
        check(cache["k"].shape[2] == 32 and n_dec < 32, "the decode stays inside dec_len")
        steps = [last]
        for t in range(n_dec):
            lg, cache = model.decode_step(p2, c2, cache, toks[:, t : t + 1])
            steps.append(lg)
        serve = torch.stack(steps, dim=1)
        del p2, h, cache
    err = float((serve - ref).abs().max())
    rec["decode_vs_forward"] = {"frames": 64, "decoded": n_dec, "max_abs": err, "max_logit": float(ref.abs().max())}
    check(bool(torch.isfinite(serve).all()), "decode logits finite")
    check(err <= LM_PARITY_TOL, f"decode vs forward, {depth} + {depth} layers, float32: max abs {err} > {LM_PARITY_TOL}")
    print(f"  (c) {depth} + {depth} layers, float32 on the card: prefill over 64 frames (BOS) + {n_dec} decode steps "
          f"== the teacher-forced forward to {err:.3g} max abs (<= {LM_PARITY_TOL})", flush=True)
    del serve, ref
    part("c")

    # (d) serving at full depth in bfloat16
    b, s_enc = ENCDEC_REQUESTS, ENCDEC_FRAMES
    pc = model.cast_for_compute(params, cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 52)
    frames = torch.randn((b, s_enc, cfg.frontend_dim), generator=gen, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    again, *_ = encdec_serve(model, pc, cfg, frames, ENCDEC_NEW_TOKENS)  # warm
    out, prefill_s, decode_s, cache = encdec_serve(model, pc, cfg, frames, ENCDEC_NEW_TOKENS)
    cur = out[:, -1:]

    def one_step():
        with torch.inference_mode():
            model.decode_step(pc, cfg, cache, cur)

    graph_step = graph_ms(one_step, FAMILY_DECODE_REPS)
    peak = torch.cuda.max_memory_allocated()
    tokens = b * (ENCDEC_NEW_TOKENS + 1)
    serving = {"requests": b, "frames": s_enc, "max_len": ENCDEC_MAX_LEN, "dec_len": int(cache["k"].shape[2]),
               "new_tokens": ENCDEC_NEW_TOKENS + 1, "prefill_s": prefill_s, "decode_s": decode_s,
               "s_per_decode_step": decode_s / ENCDEC_NEW_TOKENS, "device_s_per_decode_step": graph_step / 1e3,
               "tok_per_s": tokens / (prefill_s + decode_s), "max_memory_allocated": peak}
    rec["serving"] = serving
    check(serving["dec_len"] == 256, f"max_len {ENCDEC_MAX_LEN} keeps 256 decoder slots")
    check(bool(((out >= 0) & (out < cfg.padded_vocab)).all()), "tokens in the vocabulary")
    check(torch.equal(out, again), "greedy serving is deterministic")
    print(f"  (d) serving at full depth in bfloat16 on {smi}: {b} requests of {s_enc} frames, max_len "
          f"{ENCDEC_MAX_LEN} (dec_len {serving['dec_len']}), BOS + {ENCDEC_NEW_TOKENS} greedy steps: prefill "
          f"{prefill_s:.4f} s, {serving['s_per_decode_step']:.4f} s a decode step ({graph_step / 1e3:.5f} s of device "
          f"time, a step replayed from a CUDA graph), {serving['tok_per_s']:.1f} tokens/s, max_memory_allocated "
          f"{peak / 1e9:.2f} GB; the warm-up run's tokens equal", flush=True)
    del pc, frames, cache, out, again
    torch.cuda.empty_cache()
    part("d")

    # (e) one step at 2 + 2 layers, card against CPU
    train_rec: dict = {}
    train_parity(cfg, params, train_rec, layers=depth, label="(e)")
    rec["train_parity"] = train_rec
    torch.cuda.empty_cache()
    part("e")

    # (f) full size as published
    bt, s_enc, s_dec = ENCDEC_TRAIN_BATCH, ENCDEC_FRAMES, ENCDEC_TRAIN_DEC
    ocfg = optim.OptConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=ENCDEC_TRAIN_STEPS)
    state = optim.make_optimizer(ocfg, cfg)[0](params)
    n_state = state_bytes(state)
    check(n_state == reckoned_state_bytes(cfg, "float32"), f"float32 AdamW states: {n_state} bytes")
    train_step = step_lib.make_train_step(cfg, ocfg)
    batches = [{"frames": torch.randn((bt, s_enc, cfg.frontend_dim), generator=gen, device=dev),
                "dec_tokens": torch.randint(0, cfg.vocab, (bt, s_dec), generator=gen, device=dev, dtype=torch.int32),
                "dec_labels": torch.randint(0, cfg.vocab, (bt, s_dec), generator=gen, device=dev, dtype=torch.int32)}
               for _ in range(ENCDEC_TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for bb in batches:
        t0 = time.monotonic()
        _, _, m = train_step(params, state, bb)
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t0)
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    flops = encdec_train_flops(cfg, params, bt, s_enc, s_dec)
    warm_s = sum(step_s[1:]) / (len(step_s) - 1)
    finite = all(bool(torch.isfinite(t).all()) for t in params.parameters())
    rec["train"] = {"steps": ENCDEC_TRAIN_STEPS, "batch": bt, "frames": s_enc, "dec_tokens": s_dec,
                    "losses": losses, "step_s": step_s, "warm_s_per_step": warm_s,
                    "dec_tokens_per_s": bt * s_dec / warm_s, "frames_per_s": bt * s_enc / warm_s,
                    "max_memory_allocated": peak, "flops_per_step": flops,
                    "bf16_peak_share": flops / warm_s / PEAK_BF16_FLOPS, "state_bytes_float32": n_state}
    check(finite and all(np.isfinite(losses)), f"{cfg.name} training: finite losses and masters: {losses}")
    print(f"  (f) full size as published ({rec['n_params']} parameters; bfloat16 compute, float32 masters and AdamW "
          f"states, remat), {ENCDEC_TRAIN_STEPS} steps of {bt} rows x ({s_enc} frames, {s_dec} decoder tokens) at lr "
          f"{TRAIN_LR} on {smi}: losses {[round(v, 4) for v in losses]}; warm {warm_s:.4f} s a step (steps "
          f"2-{ENCDEC_TRAIN_STEPS}; first {step_s[0]:.3f} s), {bt * s_dec / warm_s:.0f} decoder tokens/s and "
          f"{bt * s_enc / warm_s:.0f} frames/s, max_memory_allocated {peak / 1e9:.2f} GB, (6 N + attention) FLOPs "
          f"{flops:.4g} a step = {rec['train']['bf16_peak_share']:.4f} of the dense bf16 peak; float32 states "
          f"{n_state / 1e9:.2f} GB", flush=True)
    del params, state, batches, train_step
    torch.cuda.empty_cache()
    part("f")
    launches = {k: fn.launches for k, fn in counters.items()}
    rec["launches"] = launches
    check(not any(launches.values()), f"the encoder-decoder paths launched no clustering kernel: {launches}")
    print(f"  (g) launches of the hand-written kernels on these paths: {launches}", flush=True)
    rec["part_s"] = part_s
    print(f"  {cfg.name}: seconds by part {json.dumps({k: round(v, 1) for k, v in part_s.items()})}", flush=True)
    record["encdec"] = rec


@contextlib.contextmanager
def one_rank_nccl():
    """An NCCL process group of one rank on the card (a ``file://`` store in
    a temporary directory; no fallback: if NCCL cannot start, the phase
    fails), for phases 19 and 20."""
    import datetime
    import os
    import tempfile

    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'store')}", rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=120))
        try:
            check(dist.get_backend() == "nccl", f"the process group's backend is {dist.get_backend()}, not nccl")
            yield
        finally:
            dist.destroy_process_group()


def mesh_phase(x_np, fits: dict, smi: str, record: dict) -> None:
    """Phase 19: the mesh path at world size 1 on the card, on
    ``one_rank_nccl``'s group, ``make_host_mesh``,
    and the mesh Plan built directly (``resolve_plan`` rightly turns a
    one-rank mesh into ``"single"``): RNG* and exact fits of phase 4's
    points, their kNN, edges, MST ids, ``mst_w`` and labels bit-equal to
    the single-device fits in ``fits`` (variant -> estimator), with the
    launches of each fit (counters set to 0 just before it, read just
    after) and each stage's seconds beside the single-device fit's."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import engine
    from repro_torch.api import MultiHDBSCAN
    from repro_torch.launch.mesh import make_host_mesh

    names = ("pairwise_topk", "fused_cascade", "lune_filter", "single_linkage")
    pt, fc, lf, sl = (kernel_module(k) for k in names)
    counters = {"pairwise_topk": pt.pairwise_topk, "edge_cascade": fc.edge_cascade, "lune_filter": lf.lune_filter,
                "single_linkage": sl.single_linkage}
    rec: dict = {}
    mesh = make_host_mesh()
    check(mesh.device_type == "cuda" and not engine.resolve_plan(mesh=mesh).sharded,
          "'auto' turns a one-rank card mesh into the single-device plan")
    plan = dataclasses.replace(engine.resolve_plan(), mesh=mesh)
    check(plan.sharded and plan.n_shards == 1, f"the mesh plan: {plan.describe()}")
    print(f"phase 19: NCCL group of 1 rank, {plan.describe()}", flush=True)
    for variant, ref in fits.items():
        for fn in counters.values():
            fn.launches = 0
        t0 = time.monotonic()
        est = MultiHDBSCAN(kmax=KMAX, variant=variant, plan=plan).fit(x_np)
        views = est.select_all()
        torch.cuda.synchronize()
        total = time.monotonic() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        m, mr = est.model_.msts, ref.model_.msts
        check(est.plan_.sharded, f"{variant}: the fit ran on the mesh plan")
        check(np.array_equal(m.knn_idx, mr.knn_idx) and np.array_equal(m.knn_d2.view(np.int32),
                                                                        mr.knn_d2.view(np.int32)),
              f"{variant}: the ring kNN (refined) equals the single-device kNN bit for bit")
        check(np.array_equal(est.graph_.edges, ref.graph_.edges), f"{variant}: graph edges equal")
        check(np.array_equal(m.mst_ea, mr.mst_ea) and np.array_equal(m.mst_eb, mr.mst_eb),
              f"{variant}: MST edge ids equal for every mpts")
        check(np.array_equal(m.mst_w.view(np.int32), mr.mst_w.view(np.int32)), f"{variant}: mst_w bit-equal")
        for v, vr in zip(views, ref.select_all()):
            check(np.array_equal(v.labels, vr.labels), f"{variant}: labels equal at mpts={v.mpts}")
        check(launches["pairwise_topk"] == 0, f"{variant}: the mesh kNN is the ring, not pairwise_topk")
        check(launches["edge_cascade"] >= 2, f"{variant}: edge_cascade launched for both stages")
        check(launches["single_linkage"] == 1, f"{variant}: select_all launched single_linkage once")
        if variant == "rng":
            check(launches["lune_filter"] >= 1, "the exact mesh fit launched lune_filter")
        stages = {k: est.timings_[k] for k in ("knn", "rng_build", "mst_range")}
        single = {k: ref.timings_[k] for k in ("knn", "rng_build", "mst_range")}
        rec[variant] = {"launches": launches, "stages_s": stages, "single_stages_s": single,
                        "fit_and_select_all_s": total, "graph": est.graph_.stats}
        print(f"  {variant}: mesh fit + select_all {total:.2f} s, launches {launches}; kNN, edges, MST ids, "
              f"mst_w and labels == the single-device fit's; stages (s) on {smi}, mesh "
              f"{json.dumps(stages)} against single {json.dumps(single)}", flush=True)
    record["mesh"] = rec


# phase 20's dry runs, in a subprocess with no card: the grid's cell
# (qwen2_1_5b x train_4k x single) and the phase's own step on one rank
DRYRUN_PHASE20 = """
import json, sys
from pathlib import Path
import torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.dist import sharding as sh
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
arch, out, batch, seq = sys.argv[1], Path(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
dryrun.run_cell(arch, "train_4k", False, str(out))
dryrun.start_fake_world(1)
mesh = make_host_mesh(device="cpu")
rec = dryrun.reckon(get_config(arch), {"seq_len": seq, "global_batch": batch, "kind": "train"}, mesh,
                    sh.resolve_rules(mesh))
rec.pop("ops")
(out / "phase20_step.json").write_text(json.dumps(rec, indent=1))
dist.destroy_process_group()
"""


def sharded_phase(smi: str, record: dict) -> None:
    """Phase 20: the LMs' sharded train step on ``one_rank_nccl``'s group.
    qwen2-1.5b at its published width and depth, as published (bfloat16
    compute, float32 masters and AdamW states, remat, xent chunks of 512),
    takes ``SHARDED_STEPS`` steps of ``train_batch`` (B = 4, S = 1024)
    unsharded, then from the same init the same steps through the sharded
    step: parameters and states DTensors placed by ``dist.sharding`` on
    ``make_host_mesh()``, the batch by ``batch_shardings``, the step in an
    ``activation_context``.  Both run under deterministic algorithms (the
    embedding's and the label gather's backward otherwise accumulate with
    atomics in any order), so the losses and the updated masters must be
    equal bit for bit: on one rank every placement is a replica and DTensor
    runs the same kernels on the whole tensors.  The first step of each is
    its warm-up; the s a step of the others, beside phase 15's, is a
    reading (DTensor's dispatch on the host), not a gate.  The clustering
    kernels' counters are set to 0 first and must read 0 after.  Meanwhile
    a subprocess (no card) dry-runs ``qwen2_1_5b x train_4k x single``
    (``launch.dryrun``), whose bytes per device are printed, and this
    phase's own step on one rank, whose reckoned peak is printed beside the
    measured one."""
    import math
    import os

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as sh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_params, param_specs, reference_leaves
    from repro_torch.train import data as data_lib, optim, step as step_lib

    check(dist.is_initialized() and dist.get_backend() == "nccl", "phase 20 runs on phase 19's NCCL group")
    names = ("pairwise_topk", "fused_cascade", "lune_filter", "prim_mst", "single_linkage", "sbcn_tile")
    pt, fc, lf, pm, sl, st = (kernel_module(k) for k in names)
    counters = {"pairwise_topk": pt.pairwise_topk, "edge_cascade": fc.edge_cascade, "lune_filter": lf.lune_filter,
                "prim_mst": pm.prim_mst, "single_linkage": sl.single_linkage, "sbcn_tile": st.tile_dots,
                "sbcn_norms": st.point_norms}
    for fn in counters.values():
        fn.launches = 0
    out_dir = ROOT / "chiprun_out" / "dryrun_phase20"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "CUDA_VISIBLE_DEVICES": ""}
    dry = subprocess.Popen([sys.executable, "-c", DRYRUN_PHASE20, LM_ARCH, str(out_dir), str(TRAIN_BATCH),
                            str(TRAIN_SEQ)], env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    rec: dict = {}
    try:
        dev = torch.device(CARD)
        cfg = get_config(LM_ARCH)
        check((cfg.dtype, cfg.remat, cfg.xent_chunk, cfg.microbatch, cfg.optimizer_state_dtype)
              == ("bfloat16", True, 512, 1, "float32"), "qwen2-1.5b trains as published")
        ocfg = optim.OptConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_STEPS)
        init, _ = optim.make_optimizer(ocfg, cfg)
        step = step_lib.make_train_step(cfg, ocfg)
        dcfg = data_lib.DataConfig(seed=SEED, vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
        batches = [{k: v.to(dev) for k, v in data_lib.train_batch(dcfg, i).items()} for i in range(SHARDED_STEPS)]
        mesh = make_host_mesh()
        rules = sh.resolve_rules(mesh)
        shard = sh.tree_shardings(param_specs(cfg), mesh, rules)
        layouts = {n: leaf.transposed for n, leaf in reference_leaves(cfg).items()}

        def run(sharded: bool):
            params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 40), device=dev)
            state = init(params)
            if sharded:
                sh.distribute_module(params, shard)
                state = sh.distribute(state, sh.opt_state_shardings(shard, state, mesh, layouts))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            losses, secs = [], []
            for b in batches:
                t0 = time.monotonic()
                if sharded:
                    with sh.activation_context(mesh, rules):
                        _, _, m = step(params, state, sh.distribute(b, sh.batch_shardings(b, mesh)))
                else:
                    _, _, m = step(params, state, b)
                torch.cuda.synchronize()
                secs.append(time.monotonic() - t0)
                losses.append(m["loss"].item())
            del state
            masters = {n: (t.to_local() if sharded else t).detach() for n, t in params.named_parameters()}
            return losses, secs, torch.cuda.max_memory_allocated(), masters

        deterministic = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            plain = run(False)
            torch.cuda.empty_cache()
            sharded = run(True)
        finally:
            torch.use_deterministic_algorithms(deterministic)
        equal = plain[0] == sharded[0] and all(torch.equal(sharded[3][n], t) for n, t in plain[3].items())
        launches = {k: fn.launches for k, fn in counters.items()}
        warm = {k: sum(r[1][1:]) / (len(r[1]) - 1) for k, r in (("unsharded", plain), ("sharded", sharded))}
        phase15 = record.get("training", {}).get("full_depth", {}).get("warm_s_per_step")
        rec.update(losses={"unsharded": plain[0], "sharded": sharded[0]}, step_s={"unsharded": plain[1],
                   "sharded": sharded[1]}, warm_s_per_step=warm, phase15_warm_s_per_step=phase15,
                   max_memory_allocated={"unsharded": plain[2], "sharded": sharded[2]}, launches=launches,
                   bit_equal=equal, mesh=str(mesh))
        check(all(math.isfinite(x) for x in plain[0]), f"phase 20 losses finite: {plain[0]}")
        check(equal, f"the sharded steps equal the unsharded ones bit for bit: losses {plain[0]} vs {sharded[0]}")
        check(not any(launches.values()), f"the sharded LM path launched no clustering kernel: {launches}")
        print(f"phase 20: {cfg.name} at its published width and depth, {SHARDED_STEPS} steps of {TRAIN_BATCH} x "
              f"{TRAIN_SEQ} tokens on {mesh} (NCCL, 1 rank), deterministic algorithms: losses "
              f"{sharded[0]} == the unsharded steps' bit for bit, and every updated master; warm "
              f"{warm['sharded']:.4f} s a step sharded against {warm['unsharded']:.4f} unsharded on {smi}"
              + (f" (phase 15: {phase15:.4f})" if phase15 else "")
              + f"; max_memory_allocated {sharded[2] / 1e9:.2f} GB sharded, {plain[2] / 1e9:.2f} GB unsharded; "
              f"clustering kernel launches {launches}", flush=True)
        del plain, sharded, batches
        torch.cuda.empty_cache()
    finally:
        try:
            log = dry.communicate(timeout=600)[0]
        finally:
            if dry.poll() is None:
                dry.kill()
    check(dry.returncode == 0, f"the dry runs of {LM_ARCH}: {log[-2000:]}")
    cell = json.loads((out_dir / f"{LM_ARCH}__train_4k__single.json").read_text())
    own = json.loads((out_dir / "phase20_step.json").read_text())
    mem = cell["memory"]
    rec["dryrun"] = {"memory": mem, "t_trace_s": cell["t_trace_s"], "roofline": {
        k: cell["roofline"][k] for k in ("t_compute_s", "t_memory_s", "t_collective_s", "dominant")},
        "phase20_step": own["memory"]}
    gib = 2**30
    print(f"  dry run {LM_ARCH} x train_4k x single (256 fake ranks, 16 x 16; in a subprocess, no card): per device "
          f"parameters {mem['arguments']['params'] / gib:.2f} GiB, AdamW states "
          f"{mem['arguments']['opt_state'] / gib:.2f} GiB, batch {mem['arguments']['batch'] / gib:.4f} GiB, "
          f"temp {mem['temp_bytes_per_device'] / gib:.2f} GiB (traced in {cell['t_trace_s']} s)", flush=True)
    if "max_memory_allocated" in rec:
        reckoned = own["memory"]["argument_bytes_per_device"] + own["memory"]["temp_bytes_per_device"]
        rec["dryrun"]["phase20_reckoned_peak"] = reckoned
        print(f"  the dry run of this phase's own step (1 rank, {TRAIN_BATCH} x {TRAIN_SEQ}): arguments "
              f"{own['memory']['argument_bytes_per_device'] / 1e9:.2f} GB + temp "
              f"{own['memory']['temp_bytes_per_device'] / 1e9:.2f} GB = {reckoned / 1e9:.2f} GB reckoned, against "
              f"{rec['max_memory_allocated']['sharded'] / 1e9:.2f} GB measured sharded, "
              f"{rec['max_memory_allocated']['unsharded'] / 1e9:.2f} GB unsharded", flush=True)
    record["sharded"] = rec


def main(argv: list[str]) -> int:
    import os

    # phase 20's deterministic algorithms need cuBLAS's workspace fixed before
    # cuBLAS starts (32 MiB, as the launcher sets it for its bit-exact resume)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    kernels_only = "--kernels-only" in argv
    families_only = "--families-only" in argv
    encdec_mesh_only = "--encdec-mesh-only" in argv
    sharded_only = "--sharded-only" in argv
    wide_k_only = "--wide-k-only" in argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))

    import numpy as np
    from repro_torch import engine
    from repro_torch.api import FittedModel, MultiHDBSCAN
    from repro_torch.core import linkage, ref as oref
    from repro_torch.kernels import _build, fused_cascade as fc, ops

    lf, pm, pt, sl = (kernel_module(k) for k in ("lune_filter", "prim_mst", "pairwise_topk", "single_linkage"))

    record: dict = {}
    phase_s: dict = {}
    clock = {"name": "1. card", "t": time.monotonic()}

    def phase(name: str) -> None:
        """Close the running phase's seconds and start ``name``."""
        now = time.monotonic()
        phase_s[clock["name"]] = now - clock["t"]
        print(f"[{clock['name']}: {phase_s[clock['name']]:.1f} s]", flush=True)
        clock.update(name=name, t=now)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    record["card"] = smi
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}", flush=True)
    if families_only:
        phase("17. SSM and recurrent LMs")
        families_phase(smi, record)
        phase("end")
        print(f"seconds by phase: {json.dumps(phase_s)}", flush=True)
        return 0
    if encdec_mesh_only or sharded_only:
        phase("2. build")
        print(f"build: per source {_build.build_all()}", flush=True)
        if encdec_mesh_only:
            phase("18. the encoder-decoder LM")
            encdec_phase(smi, record)
        phase("19. the mesh path")
        x_np = make_points(N, D, SEED)
        fits = {v: MultiHDBSCAN(kmax=KMAX, variant=v).fit(x_np) for v in ("rng_star", "rng")}  # warm-up
        fits = {v: MultiHDBSCAN(kmax=KMAX, variant=v).fit(x_np) for v in ("rng_star", "rng")}
        with one_rank_nccl():
            mesh_phase(x_np, fits, smi, record)
            if sharded_only:
                phase("20. the sharded LM train step")
                sharded_phase(smi, record)
        phase("end")
        print(f"seconds by phase: {json.dumps(phase_s)}", flush=True)
        return 0

    phase("2. build")
    # -- 2. build ------------------------------------------------------------
    t0 = time.monotonic()
    per_kernel = _build.build_all()
    record["build_s"] = time.monotonic() - t0
    print(f"build: {record['build_s']:.1f} s wall, per source {per_kernel}", flush=True)
    print("kernel instances (registers a thread, spills, resident blocks per SM at n=16000 or the "
          "default tiles; generic d read at d=100, sliced at d=1536):", flush=True)
    kernel_resources(record)
    if wide_k_only:
        phase("3. the lists past K = 256 against their plain version")
        dev = torch.device("cuda")
        record["select_pairwise_topk_max_abs_err"] = check_select_cases(dev)
        phase("14. the kmax = 128 and 256 fits, the times past K = 256")
        launches_128, est_128 = kmax128_phase(smi, record)
        launches_256 = kmax256_phase(make_points(N_WIDE, D, SEED + 30), est_128, smi, record)
        kmax256_phase(make_points(N, D, SEED), None, smi, record, key="kmax256_fit_n16000")
        launches_stored = stored_select_path(smi, record)
        select_rows = select_kernel_times(launches_256, launches_stored, record["select_pairwise_topk_max_abs_err"],
                                          smi, record)
        x = torch.from_numpy(make_points(N, D, SEED)).to(dev)
        x_wide = torch.from_numpy(make_points(N_WIDE, WIDE_WIDTHS[-1], SEED + WIDE_WIDTHS[-1])).to(dev)
        lists_ms = {f"n={N},d={D},K={k}": ms for k, ms in topk_times(x).items()}
        lists_ms[f"n={N_WIDE},d={WIDE_WIDTHS[-1]},K={K_EMBED}"] = cuda_ms(lambda: pt.pairwise_topk(x_wide, K_EMBED), 5)
        print(f"the list instances on {smi} (ms): {json.dumps(lists_ms)}", flush=True)
        phase("end")
        print(f"seconds by phase: {json.dumps(phase_s)}", flush=True)
        print(json.dumps({"kernels": select_rows}), flush=True)
        return 0

    phase("3. kernels against their plain versions")
    # -- 3. kernels against their plain versions -----------------------------
    dev = torch.device("cuda")
    x_np = make_points(N, D, SEED)
    x = torch.from_numpy(x_np).to(dev)
    plan = engine.resolve_plan(device="cuda")
    k_eff = min(N - 1, KMAX - 1 + plan.knn_refine_slack)
    topk_errs = check_topk_cases(dev, x)
    record["pairwise_topk_max_abs_err"] = topk_errs
    lune_cases = check_lune_cases(dev, plan.lune_block_e, plan.lune_block_c)
    t0 = time.monotonic()
    fits = {kmax: stage_inputs(x, plan, kmax) for kmax in (KMAX, KMAX_WIDE)}
    print(f"stage edge lists of the kmax={KMAX} and kmax={KMAX_WIDE} fits built in {time.monotonic() - t0:.1f} s",
          flush=True)
    casc_counts, casc_err = check_cascade_stages(fits)
    check_cascade_cases(dev)
    check_prim_cases(dev)
    check_linkage_cases()
    record["wide_pairwise_topk_max_abs_err"] = check_wide_cases(dev)
    record["select_pairwise_topk_max_abs_err"] = check_select_cases(dev)
    record["sbcn_tile_max_abs_err"] = check_sbcn_tile_cases(dev)
    if kernels_only:
        record["pairwise_topk_ms_by_k"] = topk_times(x)
        record["lune_filter_ms_by_block_e"], record["lune_filter_ms_by_block_c"] = lune_sweep(
            lune_cases[(N, D)], plan.lune_block_e, plan.lune_block_c)
        cascade_times(fits, casc_counts, record)
        x_prim, cd2_prim = prim_case(N, D, dev)
        record["prim_mst_ms"] = cuda_ms(lambda: pm.prim_mst(x_prim, cd2_prim), 3)
        trees = linkage.random_spanning_trees(N, KMAX - 1, SEED + 13, ties=False)
        ea_s, eb_s = check_linkage(*trees, N, f"n={N}, R={KMAX - 1}")
        record["single_linkage_ms"] = cuda_ms(lambda: sl.single_linkage(ea_s, eb_s, n=N), 5)
        print(f"prim_mst at n={N}, d={D}: {record['prim_mst_ms']:.3f} ms; single_linkage on random trees at "
              f"n={N}, R={KMAX - 1}: {record['single_linkage_ms']:.3f} ms", flush=True)
        print(f"kernel times on {smi} (pairwise_topk at n={N}, d={D} by K; lune_filter on the n={N}, "
              f"d={D} case; edge_cascade per fit stage by lanes): " + json.dumps({k: record[k] for k in (
                  "pairwise_topk_ms_by_k", "lune_filter_ms_by_block_e", "lune_filter_ms_by_block_c",
                  "edge_cascade_ms_by_lanes")}), flush=True)
        return 0

    phase("4. the main path")
    # -- 4. the main path ----------------------------------------------------
    # the CPU run it is held to fits in a worker beside phases 4-7 (inline it
    # took 73 s of a 1180 s run on a slow host); it is compared after phase 7
    main_cpu = contextlib.ExitStack()
    main_cpu_job = start_cpu_fit(main_cpu.enter_context(cpu_pool()), x_np, KMAX)
    pt.pairwise_topk.launches = 0
    fc.edge_cascade.launches = 0
    sl.single_linkage.launches = 0
    t0 = time.monotonic()
    est = MultiHDBSCAN(kmax=KMAX).fit(x_np)
    views = est.select_all()
    torch.cuda.synchronize()
    record["cold_fit_s"] = time.monotonic() - t0
    launches = {"pairwise_topk": pt.pairwise_topk.launches, "edge_cascade": fc.edge_cascade.launches,
                "single_linkage": sl.single_linkage.launches}
    print(f"main path: fit + select_all in {record['cold_fit_s']:.2f} s, launches {launches}, "
          f"graph {est.graph_.stats}", flush=True)
    check(launches["pairwise_topk"] >= 1, "the fit launched pairwise_topk")
    check(launches["edge_cascade"] >= 2, "the fit launched edge_cascade for both stages")
    check(launches["single_linkage"] == 1, "select_all ran its linkage through single_linkage once")
    check(est.plan_.backend == "cuda", "the fit ran on the cuda backend")

    m_gpu = est.model_.msts
    check_fit_linkage(m_gpu, f"the kmax={KMAX} fit's MSTs")

    x2 = make_points(N_DENSE, D, SEED + 1)
    est2 = MultiHDBSCAN(kmax=KMAX).fit(x2)
    x2_64 = x2.astype(np.float64)
    cd = oref.core_distances(x2_64, KMAX)
    for mpts in est2.mpts_values_:
        _, _, w = est2.mst_for(mpts)
        dense = oref.mst_weights(oref.mrd_matrix(x2_64, mpts, cd))
        check(np.allclose(np.sort(w.astype(np.float64)), dense, rtol=RTOL, atol=0.0),
              f"n={N_DENSE} MST weight multiset vs dense scipy at mpts={mpts}")
    print(f"n={N_DENSE}: MST weight multisets == dense scipy MSTs for mpts 2..{KMAX}", flush=True)

    # duplicate-heavy input: per-row tie overflow sends the build to the slot path
    x_dup = np.repeat(np.random.default_rng(SEED + 3).normal(size=(40, 2)).astype(np.float32), 8, axis=0)
    est_dup, est_dup_cpu = (MultiHDBSCAN(kmax=KMAX, device=dv).fit(x_dup) for dv in ("cuda", "cpu"))
    paths = [e.graph_.stats.get("path", "slot") for e in (est_dup, est_dup_cpu)]
    check(paths == ["slot", "slot"], f"the duplicate-heavy input takes the slot path on both devices; got {paths}")
    check(np.array_equal(est_dup.graph_.edges, est_dup_cpu.graph_.edges), "slot path: graph edges equal the CPU run")
    for v_g, v_c in zip(est_dup.select_all(), est_dup_cpu.select_all()):
        check(np.array_equal(v_g.labels, v_c.labels), f"slot path: labels equal the CPU run at mpts={v_g.mpts}")
    print(f"n={len(x_dup)} duplicate-heavy: slot path on the card == CPU run for mpts 2..{KMAX}", flush=True)


    phase("5. the exact variant")
    # -- 5. the exact variant ------------------------------------------------
    captured = {}

    def spy(*args, **kwargs):  # records the unresolved edges the exact pass scans
        captured["args"], captured["kwargs"] = args, kwargs
        return real_lune_nonempty(*args, **kwargs)

    real_lune_nonempty = ops.lune_nonempty
    ops.lune_nonempty = spy
    try:
        pt.pairwise_topk.launches = fc.edge_cascade.launches = lf.lune_filter.launches = 0
        sl.single_linkage.launches = 0
        t0 = time.monotonic()
        est_x = MultiHDBSCAN(kmax=KMAX, variant="rng").fit(x_np)
        views_x = est_x.select_all()
        torch.cuda.synchronize()
        record["exact_cold_fit_s"] = time.monotonic() - t0
        launches_x = {"pairwise_topk": pt.pairwise_topk.launches, "edge_cascade": fc.edge_cascade.launches,
                      "lune_filter": lf.lune_filter.launches, "single_linkage": sl.single_linkage.launches}
    finally:
        ops.lune_nonempty = real_lune_nonempty
    gs, gx = est.graph_.stats, est_x.graph_.stats
    record["exact_graph"] = gx
    print(f"exact path: fit + select_all in {record['exact_cold_fit_s']:.2f} s, launches {launches_x}, "
          f"graph {gx}", flush=True)
    check(launches_x["lune_filter"] >= 1, "the exact fit launched lune_filter")
    check(launches_x["single_linkage"] == 1, "the exact fit's select_all launched single_linkage once")
    check(launches_x["pairwise_topk"] >= 1 and launches_x["edge_cascade"] >= 2,
          "the exact fit launched pairwise_topk and edge_cascade")
    check(gx["m_edges"] == gs["m_edges"] - gx["m_removed_exact"],
          "exact m_edges == RNG* m_edges - m_removed_exact")
    star_edges = set(map(tuple, est.graph_.edges.tolist()))
    check(set(map(tuple, est_x.graph_.edges.tolist())) <= star_edges, "exact edges are a subset of the RNG* edges")
    for mpts in est.mpts_values_:
        w_s, w_x = est.mst_for(mpts)[2], est_x.mst_for(mpts)[2]
        check(np.array_equal(np.sort(w_s), np.sort(w_x)),
              f"exact fit keeps the RNG* fit's MST weight multiset bit for bit at mpts={mpts}")
    for v in views_x:
        check(v.labels.shape == (N,), "exact fit labels shape")
    print(f"exact fit: {gx['m_unresolved']} unresolved edges scanned, {gx['m_removed_exact']} removed; "
          f"MST weight multisets == RNG* fit's for mpts 2..{KMAX}", flush=True)

    lune_main = lune_args(*captured["args"])
    lune_kw = {"block_e": captured["kwargs"]["block_e"], "block_c": captured["kwargs"]["block_c"]}
    out_l, lune_err = check_lune_filter(lune_main, f"the exact fit's {gx['m_unresolved']} unresolved edges",
                                        **lune_kw)
    check(int(out_l.sum()) == gx["m_removed_exact"], "the kernel's removals are the fit's m_removed_exact")
    print(f"lune_filter: kernel == plain on the fit's {gx['m_unresolved']} unresolved edges at n={N}", flush=True)

    x3 = make_points(N_EXACT_CPU, D, SEED + 5)
    est3, est3_cpu = (MultiHDBSCAN(kmax=KMAX, variant="rng", device=dv).fit(x3) for dv in ("cuda", "cpu"))
    check(est3.graph_.stats == est3_cpu.graph_.stats, "exact variant: graph stats equal the CPU run")
    check(np.array_equal(est3.graph_.edges, est3_cpu.graph_.edges), "exact variant: edges equal the CPU run")
    m3, m3c = est3.model_.msts, est3_cpu.model_.msts
    check(np.array_equal(m3.mst_ea, m3c.mst_ea) and np.array_equal(m3.mst_eb, m3c.mst_eb),
          "exact variant: MST edge ids equal the CPU run")
    for v_g, v_c in zip(est3.select_all(), est3_cpu.select_all()):
        check(np.array_equal(v_g.labels, v_c.labels), f"exact variant: labels equal the CPU run at mpts={v_g.mpts}")
    print(f"n={N_EXACT_CPU} exact variant: card == CPU run (graph {est3.graph_.stats})", flush=True)

    t0 = time.monotonic()
    est_xw = MultiHDBSCAN(kmax=KMAX, variant="rng").fit(x_np)
    est_xw.select_all()
    stages_x = {k: est_xw.timings_[k] for k in ("knn", "rng_build", "mst_range")}
    stages_x["total_with_hierarchy"] = time.monotonic() - t0
    record["exact_stages_s"] = stages_x
    print(f"exact fit, warm stages (s) on {smi}: " + json.dumps(stages_x), flush=True)

    phase("6. the wide fit")
    # -- 6. the wide fit -------------------------------------------------------
    pt.pairwise_topk.launches = fc.edge_cascade.launches = lf.lune_filter.launches = 0
    sl.single_linkage.launches = 0
    t0 = time.monotonic()
    est_wide = MultiHDBSCAN(kmax=KMAX_WIDE).fit(x_np)
    torch.cuda.synchronize()
    fit_s = time.monotonic() - t0
    launches_w = {"pairwise_topk": pt.pairwise_topk.launches, "edge_cascade": fc.edge_cascade.launches}
    t0 = time.monotonic()
    views_w = est_wide.select_all()
    stages_w = {k: est_wide.timings_[k] for k in ("knn", "rng_build", "mst_range")}
    stages_w["hierarchy"] = time.monotonic() - t0
    launches_w["single_linkage"] = sl.single_linkage.launches
    check(launches_w["single_linkage"] == 1, "the kmax=64 select_all launched single_linkage once")
    record["wide_fit"] = {"kmax": KMAX_WIDE, "n": N, "fit_s": fit_s, "stages_s": stages_w,
                          "graph": est_wide.graph_.stats, "launches": launches_w}
    check(launches_w["pairwise_topk"] >= 1 and launches_w["edge_cascade"] >= 2,
          "the kmax=64 fit launched pairwise_topk and edge_cascade")
    check(len(views_w) == KMAX_WIDE - 1 and all(v.labels.shape == (N,) for v in views_w), "kmax=64 labels")
    for mpts in est.mpts_values_:
        w_16, w_64 = est.mst_for(mpts)[2], est_wide.mst_for(mpts)[2]
        check(np.array_equal(np.sort(w_16), np.sort(w_64)),
              f"the kmax={KMAX_WIDE} fit keeps the kmax={KMAX} fit's MST weight multiset bit for bit at mpts={mpts}")
    print(f"wide fit: kmax={KMAX_WIDE} at n={N} on the card in {fit_s:.2f} s (one run, process warm), "
          f"launches {launches_w}, graph {est_wide.graph_.stats}; MST weight multisets == the kmax={KMAX} "
          f"fit's for mpts 2..{KMAX}; stages (s) on {smi}: " + json.dumps(stages_w), flush=True)
    check_fit_linkage(est_wide.model_.msts, f"the kmax={KMAX_WIDE} fit's MSTs")

    phase("7. prediction")
    # -- 7. prediction ---------------------------------------------------------
    q = make_queries(x_np, N_QUERIES, SEED + 6)
    pt.pairwise_topk.launches = fc.edge_cascade.launches = lf.lune_filter.launches = 0
    res_g = est_x.approximate_predict(q)
    launches_p = {"pairwise_topk": pt.pairwise_topk.launches, "edge_cascade": fc.edge_cascade.launches,
                  "lune_filter": lf.lune_filter.launches}
    reps = 5
    t0 = time.monotonic()
    for _ in range(reps):
        est_x.approximate_predict(q)
    record["predict_qps"] = reps * N_QUERIES / (time.monotonic() - t0)
    q_t, x_t = torch.from_numpy(q).to(dev), torch.from_numpy(x_np).to(dev)
    t0 = time.monotonic()
    for _ in range(reps):
        est_x.plan_.query_knn(q_t, x_t, KMAX - 1)
    torch.cuda.synchronize()
    record["predict_query_knn_ms"] = (time.monotonic() - t0) / reps * 1e3
    path = est_x.save(str(ROOT / "build" / "chip_smoke_exact.npz"))
    model_cpu = FittedModel.load(path, device="cpu")
    res_c = model_cpu.approximate_predict(q)  # extracts all levels and builds the walk tables
    t0 = time.monotonic()
    model_cpu.approximate_predict(q)
    record["predict_qps_cpu"] = N_QUERIES / (time.monotonic() - t0)
    check(res_g.labels.shape == (KMAX - 1, N_QUERIES), "prediction labels shape")
    check(np.array_equal(res_g.labels, res_c.labels), "prediction labels equal the CPU run")
    check(np.array_equal(res_g.neighbors, res_c.neighbors), "attachment neighbours equal the CPU run")
    check(np.allclose(res_g.lambdas, res_c.lambdas, rtol=RTOL, atol=0.0), "lambdas equal the CPU run to rtol")
    check(np.allclose(res_g.probabilities, res_c.probabilities, rtol=RTOL, atol=0.0),
          "probabilities equal the CPU run to rtol")
    check(bool((res_g.labels >= 0).any()) and bool((res_g.labels == -1).any()), "queries land in clusters and in noise")
    check(est_x.dbcv_profile() == model_cpu.dbcv_profile(), "DBCV profiles equal on the card and the CPU")
    print(f"prediction: {N_QUERIES} queries x {KMAX - 1} mpts rows, card == CPU run from the saved artifact; "
          f"{record['predict_qps']:.0f} queries/s on {smi} (warm, host clock, {reps} batches; "
          f"query kNN {record['predict_query_knn_ms']:.3f} ms a batch), "
          f"{record['predict_qps_cpu']:.0f} queries/s on the host CPU (warm); launches {launches_p}", flush=True)

    # -- 4 (end). the main path against its CPU run, fitted beside phases 4-7 --
    cpu = main_cpu_job.get(timeout=CPU_FIT_TIMEOUT)
    main_cpu.close()
    record["cpu_fit_s"] = cpu["total_s"]
    check(np.array_equal(est.graph_.edges, cpu["edges"]), "graph edges equal the CPU run")
    check(np.array_equal(m_gpu.mst_ea, cpu["mst_ea"]) and np.array_equal(m_gpu.mst_eb, cpu["mst_eb"]),
          "MST edge ids equal the CPU run for every mpts")
    check(np.allclose(m_gpu.mst_w, cpu["mst_w"], rtol=RTOL, atol=0.0), "MST weights equal the CPU run")
    for v_g, lab_c in zip(views, cpu["labels"]):
        check(v_g.labels.shape == (N,), "labels shape")
        check(np.array_equal(v_g.labels, lab_c), f"labels equal the CPU run at mpts={v_g.mpts}")
    n_clusters = {v.mpts: v.n_clusters for v in views}
    print(f"main path == device='cpu' run (CPU fit + select_all {record['cpu_fit_s']:.1f} s in a worker beside "
          f"phases 4-7); clusters per mpts {n_clusters}", flush=True)

    phase("8. the dual-tree tier")
    # -- 8. the dual-tree tier -----------------------------------------------
    msts_dualtree = dualtree_phase(smi, record)

    phase("9. serving")
    # -- 9. serving ------------------------------------------------------------
    serving_phase(path, q, smi, record)

    phase("10. the baseline")
    # -- 10. the baseline ------------------------------------------------------
    baseline_phase(x_np, est, smi, record)

    phase("12. LM serving")
    # -- 12. LM serving --------------------------------------------------------
    lm_cfg, lm_params, lm_decode = lm_phase(smi, record)

    phase("13. embedding curation")
    # -- 13. embedding curation ------------------------------------------------
    launches_emb, x_emb, sbcn_fit_calls = embedding_phase(lm_cfg, lm_params, smi, record)

    phase("14. the kmax = 128 and 256 fits, and the wide kernels' times")
    # -- 14. the kmax = 128 and 256 fits -----------------------------------------
    launches_128, est_128 = kmax128_phase(smi, record)
    launches_256 = kmax256_phase(make_points(N_WIDE, D, SEED + 30), est_128, smi, record)
    launches_stored = stored_select_path(smi, record)
    del est_128
    wide_rows = wide_kernel_times(x_emb, launches_emb, launches_128, smi, record)
    select_rows = select_kernel_times(launches_256, launches_stored, record["select_pairwise_topk_max_abs_err"], smi,
                                      record)

    phase("15. LM training")
    # -- 15. LM training -------------------------------------------------------
    print("phase 15: LM training (the training path launches none of the hand-written kernels)", flush=True)
    lm_train_step = training_phase(lm_cfg, lm_params, smi, record)
    del lm_params
    torch.cuda.empty_cache()

    phase("16. MoE, MLA and patches")
    # -- 16. MoE, MLA and the patch frontend -------------------------------------
    moe_phase(smi, record)

    phase("11. timings")
    # -- 11. timings ---------------------------------------------------------
    est_w = MultiHDBSCAN(kmax=KMAX).fit(x_np)
    t0 = time.monotonic()
    est_w.select_all()
    stages_s = {k: est_w.timings_[k] for k in ("knn", "rng_build", "mst_range")}
    stages_s["hierarchy"] = time.monotonic() - t0
    record["stages_s"] = stages_s
    print(f"warm stages (s) on {smi}: " + json.dumps(stages_s), flush=True)

    where_the_time_goes(lambda: MultiHDBSCAN(kmax=KMAX).fit(x_np), record, lm_decode, lm_train_step)
    del lm_train_step, lm_decode
    torch.cuda.empty_cache()

    kernels = []
    by_k = record["pairwise_topk_ms_by_k"] = topk_times(x)
    ms = by_k[k_eff]
    plain_ms = cuda_ms(lambda: pt.pairwise_topk_plain(x, k_eff), 3)

    library_ms = cuda_ms(lambda: library_topk(x, k_eff), 3)
    b_ms, b_by = bound(*topk_flops_bytes(N, D, k_eff))
    print(f"pairwise_topk at n={N}, d={D} on {smi}: {ms:.4f} ms at K={k_eff} (bound {b_ms:.4f} ms, "
          f"plain {plain_ms:.3f} ms, library {library_ms:.3f} ms); by K {json.dumps(by_k)}", flush=True)
    kernels.append({
        "name": "pairwise_topk", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pairwise_topk.cu",
        "replaces": "src/repro/kernels/pairwise_topk.py:37",
        "launches": launches["pairwise_topk"], "max_abs_err": topk_errs[f"n={N},d={D},K={k_eff}"],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
    })

    c = cascade_times(fits, casc_counts, record)
    kernels.append({
        "name": "edge_cascade", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/edge_cascade.cu",
        "replaces": "src/repro/kernels/fused_cascade.py:129",
        "launches": launches["edge_cascade"], "max_abs_err": casc_err,
        "ms": c["ms"], "device_ms": c["device_ms"], "plain_ms": c["plain_ms"],
        "bound_ms": max(c["ops_ms"], c["bytes_ms"]),
        "bound_by": "operations" if c["ops_ms"] >= c["bytes_ms"] else "bytes",
        "library_ms": None,
    })
    m_unres, m_removed = int(lune_main[0].shape[0]), gx["m_removed_exact"]
    l_ms = cuda_ms(lambda: lf.lune_filter(*lune_main, **lune_kw), 10)
    l_plain = cuda_ms(lambda: lf.lune_filter_plain(*lune_main), 3)
    l_bound, l_by = bound(*lune_flops_bytes(N, D, m_unres, m_removed))
    by_e, by_c = lune_sweep(lune_main, **lune_kw)
    record["lune_filter_block_e_ms"], record["lune_filter_block_c_ms"] = by_e, by_c
    print(f"lune_filter on {m_unres} edges x {N} points, {smi}: {l_ms:.4f} ms (bound {l_bound:.4f} ms, "
          f"plain {l_plain:.3f} ms); by edges per block {json.dumps(by_e)}, by points per tile "
          f"{json.dumps(by_c)}", flush=True)
    kernels.append({
        "name": "lune_filter", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lune_filter.cu",
        "replaces": "src/repro/kernels/lune_filter.py:33",
        "launches": launches_x["lune_filter"], "max_abs_err": lune_err,
        "ms": l_ms, "plain_ms": l_plain, "bound_ms": l_bound, "bound_by": l_by, "library_ms": None,
    })
    kernels += new_kernel_times(x, est_w, est_wide, msts_dualtree, launches, smi, record)
    kernels += wide_rows + select_rows
    kernels += sbcn_tile_rows(torch.from_numpy(x_emb).to(CARD), sbcn_fit_calls, launches_emb, smi, record)
    record["kernels"] = kernels

    phase("17. SSM and recurrent LMs")
    # -- 17. SSM and recurrent LMs (after 11, with the LM closures freed) -----
    families_phase(smi, record)

    phase("18. the encoder-decoder LM")
    # -- 18. the encoder-decoder LM ----------------------------------------------
    encdec_phase(smi, record)

    phase("19. the mesh path")
    # -- 19. the mesh path at world size 1, against phases 11's and 5's warm fits -
    with one_rank_nccl():
        mesh_phase(x_np, {"rng_star": est_w, "rng": est_xw}, smi, record)
        del est_w, est_xw
        torch.cuda.empty_cache()

        phase("20. the sharded LM train step")
        # -- 20. the LMs' sharded train step on phase 19's group ----------------
        sharded_phase(smi, record)

    phase("end")
    record["phase_s"] = phase_s
    print(f"seconds by phase: {json.dumps(phase_s)}", flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(f"card: {smi}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
