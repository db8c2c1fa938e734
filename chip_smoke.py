#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --kernels-only   # phases 1-3 and the kernel times

Phases (any failure exits non-zero):

  1. the card's name and power limit (``nvidia-smi``);
  2. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
     ``nvcc`` per source, all at once), with each template instance's
     registers and spills (``-Xptxas -v``) and its resident blocks per SM;
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
     ``prim_mst`` (src equal, w2 bit-equal) at d = 2, 8, 16, 32, 64, 100 and
     n = 1007 and 4000, and on duplicates with tied core distances with its
     state in shared memory (n = 4000) and above that limit, in device
     memory; ``single_linkage`` (left, right, height, size equal, against
     the plain version on the card and the CPU's run) on random trees with
     tied and zero weights at R = 1 and 15 in shared memory and above its
     limit; past the earlier card limits (the sliced instances above
     d = 256, the lists past K = 128): ``pairwise_topk`` at d = 320, 777,
     1100 and 1536 (a ragged d, two 512-deep panels, windows of windows;
     n = 4000 and 1007, K = 31 and 135), at K = 256 at d = 1536, on exact
     ties at d = 320 (each point 8 times, 500 rows apart: across key tiles
     and key splits, under both plans) and at K = 135 and 256 at d = 8
     (with exact ties), ``lune_filter`` at d = 320, 777, 1100 and 1536,
     ``edge_cascade`` at d = 1536 (windows of windows) and at
     k_check = 127;
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
     n = 24000 (at or above ``Plan.dualtree_min_n``, so the default plan
     takes the tier), with the ledger's tags exactly ``knn``, ``graph``,
     ``mst``; held bit for bit against the port's own ``device="cpu"`` fit
     (graph edges, d2, w2, MST edge ids, MST weights, labels) and against a
     ``candidate_method="wspd"`` fit on the card (kNN bit-equal, sorted MST
     weights bit-equal, labels equal), with both tiers' stage seconds;
     ``single_linkage`` on its MSTs (state in device memory);
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
     1e-5 and partitions agree for every mpts; at n = 4000 the card's
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
  13. embedding curation: the phase-12 model embeds 4000 documents (mean
     of the final hidden states over 48 tokens, d = 1536, 40 injected
     near-duplicates); ``MultiHDBSCAN(kmax=24).fit(X).select_all()`` on the
     card with the counters set to 0 just before it (``pairwise_topk``,
     ``edge_cascade`` and ``single_linkage`` must launch); the first 1500
     rows' card fit equals their CPU fit bit for bit; the exact variant of
     those rows on the card launches the sliced ``lune_filter``, keeps a
     subset of their RNG* graph and its MST weight multisets bit for bit,
     and ``lune_filter`` is timed on its unresolved edges beside its plain
     version and bound; MST weight multisets at mpts 2, 8, 16, 24 equal
     dense scipy MSTs; DBCV's choice and the near-duplicate pairs flagged;
  14. ``MultiHDBSCAN(kmax=128)`` at n = 4000, d = 8 (K = 135) with the
     counters set to 0 just before it: mpts 2..16 MST weight multisets
     equal a kmax = 16 fit's bit for bit; then ``pairwise_topk`` at the
     shapes of phases 13 and 14 and ``lune_filter`` at d = 1536, each
     beside its plain version (outputs bit-equal) and its bound; the two
     sliced rows join the ``{"kernels": ...}`` line (phases 12-14 run
     before 11);
  11. warm per-stage seconds, each kernel's time beside its plain version,
     a library yardstick and its bound (``pairwise_topk`` at K = 1 and each K,
     ``lune_filter`` over its edges per block and its point tile,
     ``edge_cascade`` per stage at kmax = 16 and 64 and over its lanes per
     edge, ``prim_mst`` at the baseline's shape, ``single_linkage`` at R = 15
     and 63), ``hierarchy_linkage`` with the kernel beside the plain version
     on the host, the count of implicit syncs in one warm fit, the device's
     busy share of a fit and of 8 LM decode steps (with the steps' device
     time by kernel), and a host profile.

Each phase's seconds are printed at the end.  The second-to-last line is
``{"kernels": [...]}``, the last
``{"ok": true, "device": {...}}``.  The full record also goes to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

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
N_DUALTREE = 24000                # at or above Plan.dualtree_min_n
N_CLIENTS = 8
PRIM_WIDTHS = (2, 8, 16, 32, 64, 100)
N_PRIM = 4000
N_BASELINE_CPU = 4000
N_LINKAGE = 5000
WIDE_WIDTHS = (320, 1536)       # the sliced instances; 1536 is qwen2-1.5b's d_model
RAGGED_WIDE = (777, 1100)        # a ragged d (d % 4 != 0); two 512-deep panels and windows of windows
N_WIDE = 4000
K_EMBED = 31                      # the top-K of a kmax = 24 fit (the embedding fit)
K_WIDE = (135, 256)               # the top-K of kmax = 128, and the kernel's longest list
KMAX_128 = 128
LM_ARCH = "qwen2_1_5b"
LM_PARITY_TOL = 1e-3              # float32 logits, card vs CPU, 2 layers at full width
LM_REQUESTS, LM_NEW_TOKENS, LM_MAX_LEN = 8, 24, 48
LM_PROFILED_STEPS = 8
N_DOCS, N_DOCS_CPU = 4000, 1500
KMAX_EMBED = 24
MPTS_DENSE = (2, 8, 16, 24)
CPU_FIT_THREADS = 4               # the CPU fits' worker: half the card host's 8 cores
CPU_FIT_TIMEOUT = 900
RTOL = 1e-5
CARD = "cuda"
PEAK_F32_FLOPS = 67e12   # H100 SXM, float32 outside the tensor cores
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


def check_pairwise_topk(x, k_eff: int, k_top: int) -> float:
    """Kernel vs plain at one shape: raw d2 within 1e-5 * (|q|^2 + |k|^2)
    and, as both run the same float32 arithmetic, the raw lists (d2 and
    indices) bit-equal; refined indices equal.  Returns the largest raw d2
    difference."""
    import torch
    from repro_torch.kernels import ops

    pt = kernel_module("pairwise_topk")

    d_k, i_k = pt.pairwise_topk(x, k_eff)
    d_p, i_p = pt.pairwise_topk_plain(x, k_eff)
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


def prim_case(n: int, d: int, dev, ties: bool = False):
    """``make_points`` at (n, d) on ``dev`` and squared core distances from
    the plain top-K (7th neighbour).  With ``ties`` every point comes 8
    times and the core distances (10th neighbour) are rounded to one
    decimal: mrd values, and so the argmin's minima, tie often."""
    import numpy as np
    import torch

    pt = kernel_module("pairwise_topk")
    x = make_points(n, d, SEED + 9 + d)
    if ties:
        x = np.ascontiguousarray(np.repeat(x[: -(-n // 8)], 8, axis=0)[:n])
    xt = torch.from_numpy(x).to(dev)
    cd2 = pt.pairwise_topk_plain(xt, 10 if ties else 7)[0][:, -1]
    if ties:
        cd2 = torch.round(cd2, decimals=1)
    return xt, cd2.contiguous()


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


def check_prim_cases(dev) -> None:
    """``prim_mst`` kernel vs plain (src equal, w2 bit-equal) at every width
    of ``PRIM_WIDTHS`` at n = 1007 and 4000, and on duplicates with tied
    core distances in shared memory (n = 4000) and above its limit, in
    device memory."""
    import torch

    pm = kernel_module("prim_mst")
    for d in PRIM_WIDTHS:
        for n in (N_RAGGED, N_PRIM):
            check_prim(*prim_case(n, d, dev), f"n={n}, d={d}")
    n_big = pm.smem_max_n() + 800
    distinct = {}
    for n, d in ((N_PRIM, 2), (n_big, 1)):
        w2 = check_prim(*prim_case(n, d, dev, ties=True), f"ties, n={n}, d={d}")
        distinct[n] = len(torch.unique(w2))
        check(distinct[n] < n // 4, f"the tie case ties: {distinct[n]} distinct weights over {n} vertices")
    print(f"prim_mst: kernel == plain (src equal, w2 bit-equal) at d={list(PRIM_WIDTHS)}, n={N_RAGGED} and "
          f"n={N_PRIM}; on duplicates with tied core distances at n={N_PRIM} (state in shared memory) and "
          f"n={n_big} (device memory); distinct weights {distinct}", flush=True)


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


def check_linkage_cases() -> None:
    """``single_linkage`` on synthetic spanning trees with many tied and
    zero weights: at R = 1 and 15 with the state in shared memory, and
    above its limit, in device memory."""
    from repro_torch.core import linkage

    sl = kernel_module("single_linkage")
    n_big = sl.smem_max_n() + 800
    for n, rows in ((N_LINKAGE, 1), (N_LINKAGE, 15), (n_big, 15)):
        check_linkage(*linkage.random_spanning_trees(n, rows, SEED + 11 + rows, ties=True), n,
                      f"tied and zero weights, n={n}, R={rows}")
    print(f"single_linkage: kernel == plain and card == CPU (left, right, height, size) on random trees with "
          f"tied and zero weights at n={N_LINKAGE}, R=1 and 15 (state in shared memory) and n={n_big}, R=15 "
          f"(device memory)", flush=True)


def check_fit_linkage(msts, what: str) -> None:
    """``single_linkage`` on a fit's own MSTs: kernel == plain on the card
    and card == CPU, with the layout the fit's n takes."""
    sl = kernel_module("single_linkage")
    check_linkage(msts.mst_ea, msts.mst_eb, msts.mst_w, msts.n, what)
    where = "shared" if msts.n <= sl.smem_max_n() else "device"
    print(f"single_linkage on {what} (n={msts.n}, R={len(msts.mpts_values)}, state in {where} memory): "
          f"kernel == plain and card == CPU", flush=True)


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
    (``edge_cascade``: 256 threads a block)."""
    import re

    from repro_torch.kernels import _build, fused_cascade as fc

    lf, pt = kernel_module("lune_filter"), kernel_module("pairwise_topk")

    usage = []
    for log in _build.LOGS.values():
        for u in _build.ptxas_usage(log):
            m = re.search(r"(pairwise_topk_kernel|pairwise_topk_sliced_kernel|pairwise_topk_merge_kernel|"
                          r"norms_win32_kernel|lune_filter_kernel|lune_filter_sliced_kernel|sum_sq_seq_kernel|"
                          r"edge_cascade_kernel|edge_cascade_prologue|"
                          r"prim_mst_kernel|single_linkage_kernel)(?:ILi(\d+)E(?:Li(\d+)E)?)?", u["function"])
            u["kernel"] = m.group(1) if m else u["function"]
            smem = re.search(r"Lb([01])EE", u["function"])  # the state's layout (prim_mst, single_linkage)
            u["state_in"] = ("shared" if smem.group(1) == "1" else "device") if smem else None
            sliced = "sliced" in u["kernel"] or "merge" in u["kernel"]  # the merge pass: the sliced instance's
            u["d"] = "sliced" if sliced else (int(m.group(2)) or "generic") if m and m.group(2) else None
            second = int(m.group(2 if sliced else 3)) if m and m.group(2 if sliced else 3) else None
            u["lanes" if u["kernel"] == "edge_cascade_kernel" else "slots"] = second
            usage.append(u)
    for u in usage:
        d = {"generic": 100, "sliced": WIDE_WIDTHS[-1]}.get(u["d"], u["d"])
        if u["kernel"] in ("pairwise_topk_kernel", "pairwise_topk_sliced_kernel"):
            u.update(pt.kernel_config(N, d, 32 * u["slots"]))
        elif u["kernel"] in ("lune_filter_kernel", "lune_filter_sliced_kernel"):
            u.update(lf.kernel_config(d, 8, 512))
        elif u["kernel"] == "edge_cascade_kernel":
            cfg = fc.kernel_config(d, u["lanes"], 256)
            u.update(blocks_per_sm=cfg["blocks_per_sm"], threads=cfg["threads"])
        elif u["kernel"] == "edge_cascade_prologue":
            cfg = fc.kernel_config(d, 1, 256)
            u.update(blocks_per_sm=cfg["prologue_blocks_per_sm"], threads=cfg["prologue_threads"])
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
    Returns the kmax = 16 kernel row's numbers."""
    from repro_torch.kernels import fused_cascade as fc, ops

    per_stage, by_lanes = [], {}
    row = {"ms": 0.0, "plain_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0}
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
                row["ms"] += t_k
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


def dualtree_phase(smi: str, record: dict) -> None:
    """The dual-tree tier at n = N_DUALTREE on the card, with the default
    plan: against the port's own CPU fit (bit for bit) and against the
    card's WSPD tier (the cross-tier oracle)."""
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
    check(N_DUALTREE > sl.smem_max_n(), "the dual-tree fit's linkage keeps its state in device memory")
    check_fit_linkage(m, f"the n={N_DUALTREE} dual-tree fit's MSTs")

    pt.pairwise_topk.launches = fc.edge_cascade.launches = 0
    est_w, views_w, stages_w, _ = fit(plan=engine.resolve_plan(device="cuda", candidate_method="wspd"))
    launches_w = {"pairwise_topk": pt.pairwise_topk.launches, "edge_cascade": fc.edge_cascade.launches}
    mw = est_w.model_.msts
    check(est_w.graph_.stats.get("path") == "fused", "the wspd fit at n=24000 takes the fused path")
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


def where_the_time_goes(fit, record: dict, lm_decode=None) -> None:
    """Device busy share of one warm fit, and of ``lm_decode`` (the
    ``LM_PROFILED_STEPS`` LM decode steps) in the same profiler session (``torch.profiler``: the
    union of the device activity intervals inside each one's
    ``record_function`` window, over the host wall time; one session, since
    a second one in a process may record no kernels), with the decode
    steps' device time by kernel name; and the host functions with the most
    cumulative time in another fit (``cProfile``)."""
    import cProfile
    import pstats
    from collections import Counter

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    fns = {"fit": fit, "lm_decode": lm_decode}
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
        what = "fit" if name == "fit" else "run of LM decode steps (qwen2-1.5b, 8 rows, bfloat16)"
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

    pr = cProfile.Profile()
    pr.enable()
    fit()
    torch.cuda.synchronize()
    pr.disable()
    rows = sorted(pstats.Stats(pr).stats.items(), key=lambda kv: -kv[1][3])[:30]
    record["host_profile"] = [
        {"fn": f"{Path(f).name}:{line}({name})", "cum_s": cum, "calls": calls}
        for (f, line, name), (_, calls, _, cum, _) in rows
    ]
    print("host profile of one warm fit (cumulative s): " + "; ".join(
        f"{r['fn']} {r['cum_s']:.2f}" for r in record["host_profile"][:14]), flush=True)


def truncated(params, cfg, n_layers: int, device):
    """The first ``n_layers`` of ``params`` as a model of its own on
    ``device`` (the same tensors where ``device`` is theirs)."""
    import dataclasses

    from repro_torch.models import transformer as tf

    cfg_t = dataclasses.replace(cfg, n_layers=n_layers)
    state = {k: v.to(device) for k, v in params.state_dict().items()
             if not k.startswith("layers.") or int(k.split(".")[1]) < n_layers}
    p = tf.skeleton(cfg_t)
    p.load_state_dict(state, assign=True)
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
    variant of those rows on the card (the sliced ``lune_filter`` on a
    fit's path) keeps a subset of their RNG* graph and its MST weights bit
    for bit, and ``lune_filter`` is timed on its unresolved edges; MST
    weight multisets at mpts 2, 8, 16, 24 equal dense scipy MSTs; then the
    curation report.  Returns the launches of the fit and the embeddings."""
    import numpy as np
    import torch
    from repro_torch.api import MultiHDBSCAN
    from repro_torch.core import dbcv, ref as oref
    from repro_torch.kernels import fused_cascade as fc
    from repro_torch.models import transformer as tf

    lf, pt, sl = (kernel_module(k) for k in ("lune_filter", "pairwise_topk", "single_linkage"))
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
        sl.single_linkage.launches = 0
        t0 = time.monotonic()
        est = MultiHDBSCAN(kmax=KMAX_EMBED, device=CARD).fit(x)
        views = est.select_all()
        torch.cuda.synchronize()
        rec["fit_s"] = time.monotonic() - t0
        launches = {"pairwise_topk": pt.pairwise_topk.launches, "edge_cascade": fc.edge_cascade.launches,
                    "single_linkage": sl.single_linkage.launches, "lune_filter": lf.lune_filter.launches}
        est_g = MultiHDBSCAN(kmax=KMAX_EMBED, device=CARD).fit(x_c)
        views_g = est_g.select_all()
        exact_phase(x_c, est_g, smi, rec)
        cpu = job.get(timeout=CPU_FIT_TIMEOUT)
    rec["launches"], rec["graph"] = launches, est.graph_.stats
    rec["stages_s"] = {k: est.timings_[k] for k in ("knn", "rng_build", "mst_range")}
    rec["stages_s"]["hierarchy"] = rec["fit_s"] - sum(rec["stages_s"].values())
    check(launches["pairwise_topk"] >= 1, "the embedding fit launched pairwise_topk (d=1536, K=31)")
    check(launches["edge_cascade"] >= 2, "the embedding fit launched edge_cascade for both stages")
    check(launches["single_linkage"] == 1, "the embedding fit's select_all launched single_linkage once")
    check(est.plan_.backend == "cuda", "the embedding fit ran on the cuda backend")
    check(len(views) == KMAX_EMBED - 1 and all(v.labels.shape == (N_DOCS,) for v in views), "labels per mpts")
    print(f"  fit + select_all at n={N_DOCS}, d={x.shape[1]}, kmax={KMAX_EMBED} on the card in "
          f"{rec['fit_s']:.2f} s, launches {launches}, stages (s) on {smi}: {json.dumps(rec['stages_s'])}, "
          f"graph {est.graph_.stats}", flush=True)

    rec["cpu_fit_s"] = cpu["total_s"]
    check(np.array_equal(est_g.graph_.edges, cpu["edges"]), "embedding fit: graph edges equal the CPU run")
    m_g = est_g.model_.msts
    check(np.array_equal(m_g.mst_ea, cpu["mst_ea"]) and np.array_equal(m_g.mst_eb, cpu["mst_eb"]),
          "embedding fit: MST edge ids equal the CPU run for every mpts")
    check(np.array_equal(m_g.mst_w, cpu["mst_w"]), "embedding fit: MST weights equal the CPU run bit for bit")
    for v_g, lab_c in zip(views_g, cpu["labels"]):
        check(np.array_equal(v_g.labels, lab_c), f"embedding fit: labels equal the CPU run at mpts={v_g.mpts}")
    print(f"  the first {N_DOCS_CPU} embeddings: card fit == device='cpu' fit (edges, MST ids, MST weights, labels "
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
    return launches, x


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
    launches."""
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
    return launches


def wide_kernel_times(x_emb, launches_emb: dict, launches_128: dict, smi: str, record: dict) -> list:
    """``pairwise_topk`` at the embedding fit's shape (n = 4000, d = 1536,
    K = 31; its mirrored plan and, as ``split_ms``, the keys split) and the
    kmax = 128 fit's (n = 4000, d = 8, K = 135), and
    ``lune_filter`` at d = 1536, each beside its plain version (outputs
    bit-equal), the library yardstick where there is one, and its bound.
    Returns the sliced instances' rows of the ``{"kernels": ...}`` line."""
    import torch

    lf, pt = kernel_module("lune_filter"), kernel_module("pairwise_topk")
    dev = torch.device(CARD)
    rows = {}
    x8 = torch.from_numpy(make_points(N_WIDE, D, SEED + 30)).to(dev)
    for name, x, k_eff, launches in (("pairwise_topk_d1536_k31", torch.from_numpy(x_emb).to(dev), K_EMBED,
                                      launches_emb["pairwise_topk"]),
                                     ("pairwise_topk_d8_k135", x8, K_WIDE[0], launches_128["pairwise_topk"])):
        n, d = x.shape
        ms = cuda_ms(lambda: pt.pairwise_topk(x, k_eff), 5)
        plain_ms = cuda_ms(lambda: pt.pairwise_topk_plain(x, k_eff), 1, warm=False)

        def library_topk():
            xn = (x * x).sum(1)
            d2 = (xn[:, None] + xn[None, :] - 2.0 * (x @ x.T)).clamp_min_(0.0)
            d2.fill_diagonal_(float("inf"))
            return torch.topk(d2, k_eff, dim=1, largest=False)

        library_ms = cuda_ms(library_topk, 5)
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


def new_kernel_times(x, est_16, est_64, launches: dict, smi: str, record: dict) -> list:
    """``prim_mst`` at the baseline's shape (n = 16000, d = 8, the mpts = 16
    core distances) and ``single_linkage`` on the kmax = 16 and 64 fits'
    sorted MSTs: each beside its plain version on the card and its bound;
    and ``hierarchy_linkage`` (``linkage_range``) with the kernel beside
    the plain version on the host.  Returns their ``kernels`` entries."""
    import numpy as np
    import torch
    from repro_torch.core import multi

    pm, sl = kernel_module("prim_mst"), kernel_module("single_linkage")
    n, d = x.shape
    cd2_16 = est_16.plan_.knn(x, KMAX - 1)[0][:, -1].contiguous()
    got = {}
    p_ms = cuda_ms(lambda: got.__setitem__("kernel", pm.prim_mst(x, cd2_16)), 3)
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
                          "bound_by": p_by, "us_per_step": p_ms * 1e3 / (n - 1)}
    print(f"prim_mst at n={n}, d={d} on {smi}: {p_ms:.3f} ms ({p_ms * 1e3 / (n - 1):.3f} us a step over "
          f"{n - 1} dependent steps; bound {p_bound:.4f} ms by {p_by}; plain {p_plain:.1f} ms); kernel == plain "
          f"(src equal, w2 bit-equal)", flush=True)
    out = [{
        "name": "prim_mst", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/prim_mst.cu",
        "replaces": "src/repro/core/boruvka.py:189",
        "launches": record["baseline"]["launches"]["prim_mst"], "max_abs_err": p_err,
        "ms": p_ms, "plain_ms": p_plain, "bound_ms": p_bound, "bound_by": p_by, "library_ms": None,
    }]

    linkage_rec = {}
    for est in (est_16, est_64):
        msts = est.model_.msts
        rows = len(msts.mpts_values)
        w = torch.from_numpy(np.array(msts.mst_w)).to(x.device)
        _, order = torch.sort(w, dim=1, stable=True)
        ea_s, eb_s = (torch.from_numpy(np.array(a)).to(x.device).gather(1, order) for a in (msts.mst_ea, msts.mst_eb))
        k_ms = cuda_ms(lambda: got.__setitem__("kernel", sl.single_linkage(ea_s, eb_s, n=n)), 5)
        plain_ms = cuda_ms(lambda: got.__setitem__("plain", sl.single_linkage_plain(ea_s, eb_s, n=n)), 1,
                           warm=False)
        for name, a, b in zip(("left", "right", "size"), got["kernel"], got["plain"]):
            check(torch.equal(a, b), f"single_linkage {name} at n={n}, R={rows}: kernel differs from plain")
        l_err = max(float((a - b).abs().max()) for a, b in zip(got["kernel"], got["plain"]))
        # each merge reads its two endpoints and writes left, right and size
        b_ms, b_by = bound(0.0, 20.0 * rows * (n - 1))
        multi.linkage_range(msts, device=CARD)
        t0 = time.monotonic()
        lk_card = multi.linkage_range(msts, device=CARD)
        card_s = time.monotonic() - t0
        t0 = time.monotonic()
        lk_host = multi.linkage_range(msts, device="cpu")
        host_s = time.monotonic() - t0
        for f in ("left", "right", "height", "size"):
            check(np.array_equal(getattr(lk_card, f), getattr(lk_host, f)), f"hierarchy_linkage {f}: card == host")
        linkage_rec[rows] = {"ms": k_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                             "ns_per_merge": k_ms * 1e6 / (n - 1), "max_abs_err": l_err,
                             "hierarchy_linkage_card_s": card_s,
                             "hierarchy_linkage_host_s": host_s}
        print(f"single_linkage at n={n}, R={rows} on {smi}: {k_ms:.3f} ms ({k_ms * 1e6 / (n - 1):.1f} ns a merge "
              f"over {n - 1} dependent merges; bound {b_ms:.4f} ms by {b_by}; plain {plain_ms:.1f} ms); "
              f"hierarchy_linkage {card_s:.4f} s with the kernel, {host_s:.4f} s with the plain version on "
              f"the host", flush=True)
        if rows == KMAX - 1:
            out.append({
                "name": "single_linkage", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/single_linkage.cu",
                "replaces": "src/repro/core/linkage.py:47",
                "launches": launches["single_linkage"], "max_abs_err": l_err,
                "ms": k_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            })
    record["single_linkage"] = linkage_rec
    return out


def main(argv: list[str]) -> int:
    import torch

    kernels_only = "--kernels-only" in argv
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
        clock.update(name=name, t=now)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    record["card"] = smi
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}", flush=True)

    phase("2. build")
    # -- 2. build ------------------------------------------------------------
    t0 = time.monotonic()
    per_kernel = _build.build_all()
    record["build_s"] = time.monotonic() - t0
    print(f"build: {record['build_s']:.1f} s wall, per source {per_kernel}", flush=True)
    print("kernel instances (registers a thread, spills, resident blocks per SM at n=16000 or the "
          "default tiles; generic d read at d=100, sliced at d=1536):", flush=True)
    kernel_resources(record)

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

    t0 = time.monotonic()
    est_cpu = MultiHDBSCAN(kmax=KMAX, device="cpu").fit(x_np)
    views_cpu = est_cpu.select_all()
    record["cpu_fit_s"] = time.monotonic() - t0
    check(np.array_equal(est.graph_.edges, est_cpu.graph_.edges), "graph edges equal the CPU run")
    m_gpu, m_cpu = est.model_.msts, est_cpu.model_.msts
    check(np.array_equal(m_gpu.mst_ea, m_cpu.mst_ea) and np.array_equal(m_gpu.mst_eb, m_cpu.mst_eb),
          "MST edge ids equal the CPU run for every mpts")
    check(np.allclose(m_gpu.mst_w, m_cpu.mst_w, rtol=RTOL, atol=0.0), "MST weights equal the CPU run")
    for v_g, v_c in zip(views, views_cpu):
        check(v_g.labels.shape == (N,), "labels shape")
        check(np.array_equal(v_g.labels, v_c.labels), f"labels equal the CPU run at mpts={v_g.mpts}")
    n_clusters = {v.mpts: v.n_clusters for v in views}
    print(f"main path == device='cpu' run (CPU fit {record['cpu_fit_s']:.1f} s); clusters per mpts {n_clusters}",
          flush=True)
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

    phase("8. the dual-tree tier")
    # -- 8. the dual-tree tier -----------------------------------------------
    dualtree_phase(smi, record)

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
    launches_emb, x_emb = embedding_phase(lm_cfg, lm_params, smi, record)
    del lm_params
    torch.cuda.empty_cache()

    phase("14. the kmax = 128 fit, and the wide kernels' times")
    # -- 14. the kmax = 128 fit ------------------------------------------------
    launches_128 = kmax128_phase(smi, record)
    wide_rows = wide_kernel_times(x_emb, launches_emb, launches_128, smi, record)

    phase("11. timings")
    # -- 11. timings ---------------------------------------------------------
    est_w = MultiHDBSCAN(kmax=KMAX).fit(x_np)
    t0 = time.monotonic()
    est_w.select_all()
    stages_s = {k: est_w.timings_[k] for k in ("knn", "rng_build", "mst_range")}
    stages_s["hierarchy"] = time.monotonic() - t0
    record["stages_s"] = stages_s
    print(f"warm stages (s) on {smi}: " + json.dumps(stages_s), flush=True)

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            MultiHDBSCAN(kmax=KMAX).fit(x_np)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    record["implicit_syncs"] = sum("synchroniz" in str(w.message) for w in caught)
    print(f"implicit syncs in one warm fit (torch sync debug mode): {record['implicit_syncs']}", flush=True)
    where_the_time_goes(lambda: MultiHDBSCAN(kmax=KMAX).fit(x_np), record, lm_decode)

    kernels = []
    by_k = record["pairwise_topk_ms_by_k"] = topk_times(x)
    ms = by_k[k_eff]
    plain_ms = cuda_ms(lambda: pt.pairwise_topk_plain(x, k_eff), 3)

    def library_topk():
        xn = (x * x).sum(1)
        d2 = (xn[:, None] + xn[None, :] - 2.0 * (x @ x.T)).clamp_min_(0.0)
        d2.fill_diagonal_(float("inf"))
        return torch.topk(d2, k_eff, dim=1, largest=False)

    library_ms = cuda_ms(library_topk, 3)
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
        "ms": c["ms"], "plain_ms": c["plain_ms"],
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
    kernels += new_kernel_times(x, est_w, est_wide, launches, smi, record)
    kernels += wide_rows
    record["kernels"] = kernels

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
