"""Build the port's chain kernels (``csrc/prim_mst.cu``,
``csrc/single_linkage.cu``), the SBCN tile products (``csrc/sbcn_tile.cu``),
the windows-of-32 norms (``csrc/norms_win32.cuh``) and the top-K
(``csrc/pairwise_topk.cu``) for the CPU with
g++ and the emulation headers in ``include/``: every CUDA thread runs as a
``std::thread``, so the kernels' barriers, warp reductions, atomics,
mbarrier rings and pushes between the blocks of a thread-block cluster run
as they would on the card.  The C entry points keep their signatures, so
a test calls them with ``ctypes`` on host buffers and holds their outputs
to the plain PyTorch versions.

    from tools import cuda_emulate
    lib = ctypes.CDLL(str(cuda_emulate.build("prim_mst", out_dir)))

It checks the kernels' logic (indices, plans, the cluster protocol, the
union-find), not their speed, nor what only the card's compiler and memory
model decide.  ``build`` rewrites the few constructs that have no C++
counterpart (shared-memory declarations, ``<<<...>>>`` launches; the
emulated ``cp_async.cuh``, ``stage_ring.cuh`` and ``dsmem.cuh`` in
``include/`` stand in for csrc's) and raises
if a source no longer holds one it expects.
"""

from __future__ import annotations

import re
import shutil
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
INCLUDE = Path(__file__).resolve().parent / "include"

# kernel<<<grid, block, smem, stream>>>(...) -> stub_launch(kernel, grid, block, smem, stream, ...)
_LAUNCH = r"(\w+(?:<[\w, ]*>)?)<<<(.+?)>>>\("
_STUB_LAUNCH = r"stub_launch(\1, \2, "

# (pattern, replacement) pairs each source must match at least once
REWRITES = {
    "prim_mst": [
        (r"extern __shared__ __align__\(16\) float smem\[\];", "float* smem = (float*)stub_dyn_smem();"),
        (r"__shared__ unsigned long long s_warp\[MAX_THREADS / 32\];",
         "STUB_SHARED(unsigned long long, s_warp, MAX_THREADS / 32);"),
    ],
    "single_linkage": [
        (r"extern __shared__ __align__\(16\) int smem\[\];", "int* smem = (int*)stub_dyn_smem();"),
        (_LAUNCH, _STUB_LAUNCH),
    ],
    "sbcn_tile": [
        (r"extern __shared__ __align__\(16\) unsigned long long ring_smem\[\];",
         "unsigned long long* ring_smem = (unsigned long long*)stub_dyn_smem();"),
        (r"__shared__ __align__\(16\) float (s[ab])\[KC \* DROW\];", r"STUB_SHARED(float, \1, KC * DROW);"),
        (r"__shared__ int s_cells\[1024\], s_items\[1024\];",
         "STUB_SHARED(int, s_cells, 1024); STUB_SHARED(int, s_items, 1024);"),
        (r"__shared__ int s_sub\[T\];", "STUB_SHARED(int, s_sub, T);"),
        (r"__shared__ int hist\[HIST_MAX\];", "STUB_SHARED(int, hist, HIST_MAX);"),
        (_LAUNCH, _STUB_LAUNCH),
    ],
    "norms_win32": [
        (r"extern __shared__ __align__\(16\) float nsm\[\];", "float* nsm = (float*)stub_dyn_smem();"),
        (_LAUNCH, _STUB_LAUNCH),
    ],
    "pairwise_topk": [
        (r"extern __shared__ __align__\(16\) float smem\[\];", "float* smem = (float*)stub_dyn_smem();"),
        (r"extern __shared__ __align__\(16\) float nsm\[\];", "float* nsm = (float*)stub_dyn_smem();"),
        (r"extern __shared__ __align__\(16\) unsigned long long keys\[\];",
         "unsigned long long* keys = (unsigned long long*)stub_dyn_smem();"),
        (r"__shared__ unsigned (hist|warp_sums)\[(\w+)\];", r"STUB_SHARED(unsigned, \1, \2);"),
        (r"__shared__ SelectState st;", 'SelectState& st = *(SelectState*)stub_static_smem("st", sizeof(SelectState));'),
        (_LAUNCH, _STUB_LAUNCH),
    ],
}
# headers a source includes that the rewrites must reach: put in its text
INLINED = {"pairwise_topk": ("norms_win32.cuh",)}
# g++ flags a source needs beyond the common ones (blocks that never wait on
# each other run a few at a time: grids of hundreds of 256-thread blocks)
EXTRA_FLAGS = {"pairwise_topk": ("-DSTUB_BLOCK_BATCH=4",)}
# a header without an entry point of its own gets one (extern "C")
ENTRIES = {
    "norms_win32": 'extern "C" int repro_norms_win32(const float* x, int n, int d, float* out) '
                   "{ return launch_norms(x, n, d, out, nullptr); }\n",
}


def compiler() -> str | None:
    """The g++ on PATH, or None."""
    return shutil.which("g++")


def build(name: str, out_dir: Path) -> Path:
    """Rewrite ``csrc/<name>.cu`` (or the header ``csrc/<name>.cuh`` with
    its ``ENTRIES`` entry point) for the emulation, compile it into
    ``out_dir/lib<name>.so`` and return that path."""
    src_file = CSRC / f"{name}.cu"
    text = src_file.read_text() if src_file.exists() else "#include <cuda_runtime.h>\n" + (
        CSRC / f"{name}.cuh").read_text() + ENTRIES[name]
    for header in INLINED.get(name, ()):
        text = text.replace(f'#include "{header}"', (CSRC / header).read_text())
    for pattern, repl in REWRITES[name]:
        text, hits = re.subn(pattern, repl, text)
        if not hits:
            raise RuntimeError(f"{name}.cu no longer holds {pattern!r}; update tools/cuda_emulate")
    out_dir.mkdir(parents=True, exist_ok=True)
    # the source's own directory comes first for #include "...": the emulated
    # dsmem.cuh there stands in for csrc's
    for header in INCLUDE.iterdir():
        shutil.copy(header, out_dir / header.name)
    shutil.copy(CSRC / "xla_order.cuh", out_dir / "xla_order.cuh")
    src = out_dir / f"{name}.cpp"
    src.write_text(text)
    lib = out_dir / f"lib{name}.so"
    cmd = [compiler() or "g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared", "-pthread",
           *EXTRA_FLAGS.get(name, ()), f"-I{out_dir}", "-include", "cuda_stub_core.h", "-x", "c++", str(src),
           "-o", str(lib)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {name}.cu:\n{proc.stderr}")
    return lib
