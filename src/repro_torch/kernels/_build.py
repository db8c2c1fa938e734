"""Build and load the port's CUDA kernels: ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``.

Each ``csrc/<name>.cu`` compiles to ``build/repro_torch_kernels/<name>-<hash>.so``
at the root of the checkout, where ``<hash>`` covers the source, the
shared headers (``csrc/*.cuh``) and the flags: a changed source builds
anew, an unchanged one loads the library already there.  ``build_all`` starts one ``nvcc`` per source, all at once.
Nothing is built when a module is imported; the first launch builds.
``-Xptxas -v`` makes nvcc report each kernel instance's registers, spills
and shared memory; ``LOGS`` keeps that output (``ptxas_usage`` parses it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
KERNEL_SOURCES = ("pairwise_topk", "edge_cascade", "lune_filter", "prim_mst", "single_linkage", "sbcn_tile")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# flags a source adds: pairwise_topk.cu's ~80 kernel instances take nvcc
# 58 s on one thread of the H100 machine's 8-core host, 29 s with its device
# code compiled on every core (both beside the other sources' builds)
NVCC_EXTRA = {"pairwise_topk": ("--split-compile=0",)}

_LIBS: dict[str, ctypes.CDLL] = {}
LOGS: dict[str, str] = {}  # nvcc's output per source built by this process
_LOCK = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            f"nvcc not found on PATH or in {cuda_home}/bin (set CUDA_HOME); "
            "the CUDA kernels are built from source at first use"
        )
    return path


def lib_path(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(SRC_DIR.glob("*.cuh")))
    flags = (*NVCC_FLAGS, *NVCC_EXTRA.get(name, ()))
    digest = hashlib.sha256(src + headers + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all(names=KERNEL_SOURCES) -> dict[str, float]:
    """Build every missing library in ``names`` in parallel.

    Returns ``{name: seconds}`` for the libraries built (0.0 where the
    library was already there).  Raises with nvcc's output on failure.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *NVCC_EXTRA.get(name, ()), "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out, time.monotonic(),
        )
    times = {name: 0.0 for name in names}
    errors = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.monotonic() - t0
        LOGS[name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def ptxas_usage(log: str) -> list[dict]:
    """Per kernel instance in an ``nvcc -Xptxas -v`` log: its mangled name,
    registers a thread, and bytes of spill stores and loads."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {"function": m.group(1), "registers": None, "spill_stores": 0, "spill_loads": 0}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if missing."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = lib_path(name)
            if not path.exists():
                build_all((name,))
            lib = _LIBS[name] = ctypes.CDLL(str(path))
        return lib


def check(status: int, what: str) -> None:
    """Raise if a launch returned a nonzero ``cudaError_t``."""
    if status != 0:
        raise RuntimeError(f"{what} launch failed: cudaError_t {status}")
