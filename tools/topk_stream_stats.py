"""Where a warp of pairwise_topk's streamed select spends its time, on the card.

    python3 -m tools.topk_stream_stats        # from the root of a checkout, on a CUDA machine

Builds a copy of ``src/repro_torch/kernels/csrc/pairwise_topk.cu`` with
``clock64`` counters in the streamed select (each warp's cycles from start
to end, in its buffer compactions and in the end's selects and sorts, its
compactions and appended keys, summed over the warps by one atomic each at
the kernel's end), runs it at the kmax = 256 fit's shapes and prints, per
shape, the uninstrumented kernel's time (the repo's own build, CUDA events
over 10 calls), the instrumented one's, and per warp the share of its
cycles in the sweep (with the appends), the compactions and the end, with
the compactions and appends a row and the instance's registers, spills and
blocks per SM.  The counters cost time themselves: read the shares, not the
instrumented milliseconds.  The rewrites raise if the source no longer
holds the text they expect.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "topk_stream_stats"
SHAPES = ((16000, 8, 263), (4000, 8, 263), (4000, 8, 307))

# (text, replacement) in the stream kernel's body, each found exactly once
REWRITES = (
    ("  const unsigned below_lane = (1u << lane) - 1;\n",
     "  const unsigned below_lane = (1u << lane) - 1;\n"
     "  const long long stat_t0 = clock64();\n  long long stat_cmp = 0, stat_n = 0, stat_app = 0;\n"),
    ("          tau[r] = warp_select(",
     "          const long long stat_c0 = clock64();\n          tau[r] = warp_select("),
    ("          m[r] = __ballot_sync(FULL, cand[r]);\n        }",
     "          m[r] = __ballot_sync(FULL, cand[r]);\n          stat_cmp += clock64() - stat_c0, ++stat_n;\n        }"),
    ("        cnt[r] += __popc(m[r]);\n",
     "        cnt[r] += __popc(m[r]);\n        stat_app += __popc(m[r]);\n"),
    ("  // the K smallest of each row's buffer",
     "  const long long stat_e0 = clock64();\n  // the K smallest of each row's buffer"),
)
STATS_DECL = "__device__ unsigned long long topk_stream_stats[6];\n"
STATS_ADD = ("  if (lane == 0) {\n"
             "    const unsigned long long v[6] = {(unsigned long long)(clock64() - stat_t0), (unsigned long long)stat_cmp,\n"
             "        (unsigned long long)stat_n, (unsigned long long)stat_app, (unsigned long long)(clock64() - stat_e0), 1ull};\n"
             "    for (int i = 0; i < 6; ++i) atomicAdd(&topk_stream_stats[i], v[i]);\n  }\n")
READ = ('\nextern "C" int topk_stream_stats_take(unsigned long long* h) {\n'
        '  const unsigned long long z[6] = {0};\n'
        '  int e = (int)cudaMemcpyFromSymbol(h, topk_stream_stats, sizeof(z));\n'
        '  return e != 0 ? e : (int)cudaMemcpyToSymbol(topk_stream_stats, z, sizeof(z));\n}\n')


def instrumented_source() -> str:
    """pairwise_topk.cu with the counters in the streamed select."""
    src = (CSRC / "pairwise_topk.cu").read_text()
    at = src.index("pairwise_topk_stream_kernel(")
    end = src.index("\n}\n", src.index("  // the K smallest of each row's buffer", at))
    head, body, tail = src[:at], src[at:end], src[end:]
    for old, new in REWRITES:
        if body.count(old) != 1:
            raise RuntimeError(f"pairwise_topk.cu's streamed select no longer holds {old!r}; update {__file__}")
        body = body.replace(old, new)
    if head.count("namespace {\n") != 1:
        raise RuntimeError(f"pairwise_topk.cu no longer opens one anonymous namespace; update {__file__}")
    return head.replace("namespace {\n", "namespace {\n" + STATS_DECL) + body + "\n" + STATS_ADD + tail + READ


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("topk_stream_stats: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import importlib

    import chip_smoke
    from repro_torch.kernels import _build

    pt = importlib.import_module("repro_torch.kernels.pairwise_topk")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib_path = OUT / "pairwise_topk_stats.cu", OUT / "libpairwise_topk_stats.so"
    src.write_text(instrumented_source())
    t0 = time.monotonic()
    proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, *_build.NVCC_EXTRA.get("pairwise_topk", ()),
                             f"-I{CSRC}", "-o", str(lib_path), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _build.build_all(("pairwise_topk",))
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the instrumented copy:\n{log}")
    usage = {u["function"]: u for u in _build.ptxas_usage(_build.LOGS.get("pairwise_topk", ""))}
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_pairwise_topk.argtypes = [p, i, i, i, p, p, p, p]
    lib.topk_stream_stats_take.argtypes = [p]
    print(f"{smi}; instrumented build {time.monotonic() - t0:.1f} s", flush=True)
    rows = []
    for n, d, k in SHAPES:
        if pt.instance(d, k) != "stream":
            raise RuntimeError(f"({n}, {d}, {k}) does not take the streamed select")
        x = torch.from_numpy(chip_smoke.make_points(n, d, chip_smoke.SEED)).cuda()
        od = torch.empty((n, k), device="cuda")
        oi = torch.empty((n, k), dtype=torch.int32, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        run = lambda: lib.repro_pairwise_topk(x.data_ptr(), n, d, k, od.data_ptr(), oi.data_ptr(), None, stream)  # noqa: E731
        ms = chip_smoke.cuda_ms(lambda: pt.pairwise_topk(x, k), 10)
        h = (ctypes.c_ulonglong * 6)()
        if run() != 0:
            raise RuntimeError("the instrumented launch failed")
        ms_stats = chip_smoke.cuda_ms(run, 10)
        lib.topk_stream_stats_take(ctypes.addressof(h))
        if run() != 0:
            raise RuntimeError("the instrumented launch failed")
        torch.cuda.synchronize()
        lib.topk_stream_stats_take(ctypes.addressof(h))
        want = pt.pairwise_topk(x, k)
        if not (torch.equal(od.view(torch.int32), want[0].view(torch.int32)) and torch.equal(oi, want[1])):
            raise RuntimeError("the instrumented kernel's lists differ from the kernel's")
        total, cmp_cycles, n_cmp, appended, end_cycles, warps = (int(v) for v in h)
        rows_a_warp = n / warps
        name = next((f for f in usage if "pairwise_topk_stream_kernelILi%dE" % d in f), None)
        row = {"n": n, "d": d, "K": k, "ms": ms, "instrumented_ms": ms_stats, "warps": warps,
               "share": {"sweep_and_appends": (total - cmp_cycles - end_cycles) / total,
                         "compactions": cmp_cycles / total, "end": end_cycles / total},
               "cycles_a_warp": total / warps, "compactions_a_row": n_cmp / (warps * rows_a_warp),
               "cycles_a_compaction": cmp_cycles / max(n_cmp, 1), "appends_a_row": appended / (warps * rows_a_warp),
               "registers": usage[name]["registers"] if name else None,
               "spill_stores": usage[name]["spill_stores"] if name else None,
               "config": pt.kernel_config(n, d, k)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "topk_stream_stats.json").write_text(json.dumps({"card": smi, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
