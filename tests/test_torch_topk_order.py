"""The raw top-K in the reference's summation order, on the CPU.

The refine breaks exact ties by candidate order, so the port's raw lists
(d2 and indices) must equal the reference's bit for bit, not only to the
matmul form's error scale.  XLA on the CPU sums the reference's top-K
norms in a different order at different widths (``ops.sum_order(d,
"topk")``) and its dot products in FMA chains over panels of 512
(``pairwise_topk.PANEL``).  Held here: the plain version's raw lists
against the reference's Pallas kernel in interpret mode (n = 600, 128-row
tiles) and against its jnp twin at the (1024, 2048) tiles every reference
fit above n = 1024 takes (n = 1100), the fit's kNN against the
reference's, and the panel depth against XLA's own dot.
"""

import importlib
import re
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import jaxlib
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro.kernels.pairwise_topk import pairwise_topk as j_pairwise_topk
from repro.train.data import embedding_stream

from repro_torch.kernels import ops as t_ops

t_pt = importlib.import_module("repro_torch.kernels.pairwise_topk")

N = 600
N_TWIN = 1100     # above 1024: the jnp twin's (1024, 2048) tiles
K = 31            # kmax = 24 plus the refine's slack of 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread a test worker while this module runs: the plain
    versions are long chains of small elementwise ops, which torch's thread
    pool slows several times over on a CPU shared with the other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _embeddings(n: int, d: int, seed: int = 0) -> np.ndarray:
    """``embedding_stream`` with 20 near-duplicates, as the curation
    example injects them."""
    x = embedding_stream(seed, n, d)
    x[-20:] = x[:20] + np.random.default_rng(seed).normal(0, 1e-3, x[:20].shape).astype(np.float32)
    return x


def _assert_lists_equal(got, want, what: str) -> None:
    d_t, i_t = (v.numpy() for v in got)
    d_j, i_j = (np.asarray(v) for v in want)
    np.testing.assert_array_equal(d_t.view(np.int32), d_j.view(np.int32), err_msg=f"raw d2 bits, {what}")
    np.testing.assert_array_equal(i_t, i_j, err_msg=f"raw indices, {what}")


@pytest.mark.parametrize("d", [2, 5, 8, 16, 32, 33, 64, 100, 320, 513, 777, 1030, 1536])
def test_raw_lists_equal_the_pallas_kernel(d):
    """Raw lists bit-equal to the reference's Pallas kernel in interpret
    mode: the norm orders (fma, seq at d = 5-8, windows of 32 above 32),
    one panel up to d = 512, two and three above, ragged widths."""
    x = _embeddings(N, d, seed=d)
    want = j_pairwise_topk(jnp.asarray(x), K, block_q=128, block_k=128, interpret=True)
    _assert_lists_equal(t_pt.pairwise_topk_plain(torch.from_numpy(x), K), want, f"d={d}")


@pytest.mark.parametrize("d", range(1, 34))
def test_norm_order_matches_the_pallas_kernel_at_every_small_width(d):
    """Every width up to the first windowed one, on Gaussian points: the
    orders switch at 4/5, 8/9 and 32/33."""
    x = (np.random.default_rng(100 + d).normal(size=(300, d)) * 2.0 + 1.0).astype(np.float32)
    want = j_pairwise_topk(jnp.asarray(x), K, block_q=128, block_k=128, interpret=True)
    _assert_lists_equal(t_pt.pairwise_topk_plain(torch.from_numpy(x), K), want, f"d={d}")


@pytest.mark.parametrize("d", [8, 64, 1100])
def test_raw_lists_equal_the_jnp_twin(d):
    """Raw lists bit-equal to the reference's jnp twin at n = 1100, where
    it takes (1024, 2048) tiles, as every reference fit above n = 1024."""
    x = _embeddings(N_TWIN, d, seed=d + 1)
    want = j_ops._knn_jnp_blocked(jnp.asarray(x), k_top=K)
    _assert_lists_equal(t_pt.pairwise_topk_plain(torch.from_numpy(x), K), want, f"n={N_TWIN}, d={d}")


@pytest.mark.parametrize("d", [8, 64, 1100])
def test_knn_equals_the_reference(d):
    """The fit's kNN (top-K, then the refine) equal to the reference's
    ``knn(..., backend="jnp")``: indices equal, d2 bit-equal."""
    x = _embeddings(N_TWIN, d, seed=d + 2)
    d2_j, i_j = j_ops.knn(jnp.asarray(x), K - 8, backend="jnp")
    d2_t, i_t = t_ops.knn(torch.from_numpy(x), K - 8, backend="torch")
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(d2_t.numpy(), np.asarray(d2_j))


@pytest.mark.parametrize("tiles", [(128, 128), (256, 256), (1024, 2048)])
def test_xla_dot_sums_panels_of_512(tiles, monkeypatch):
    """XLA's float32 dot at the reference's tiles and a depth of 1100 is
    the port's ``_dot_panels``, and panels of 256 or 1024 are not: the
    panel depth is read from XLA's output."""
    bq, bk = tiles
    rng = np.random.default_rng(bq)
    q = rng.normal(size=(bq, 1100)).astype(np.float32)
    k = rng.normal(size=(bk, 1100)).astype(np.float32)
    dot = jax.jit(lambda a, b: jax.lax.dot_general(a, b, (((1,), (1,)), ((), ())),
                                                   preferred_element_type=jnp.float32))
    want = np.asarray(dot(q, k))[:16, :16]
    qs, ks = torch.from_numpy(q[:16]), torch.from_numpy(k[:16])
    np.testing.assert_array_equal(t_pt._dot_panels(qs, ks).numpy(), want)
    assert t_pt.PANEL == 512
    for panel in (256, 1024):
        monkeypatch.setattr(t_pt, "PANEL", panel)
        assert not np.array_equal(t_pt._dot_panels(qs, ks).numpy(), want), panel


def test_the_dot_blocking_is_a_library_constant():
    """The blocking behind the panels is a cache size compiled into
    jaxlib (YNNPACK's ``make_dot_impl`` ... ``cache_sizes``: 131072
    bytes, read-only data), not one read from the host."""
    lib = Path(jaxlib.__file__).parent / "libjax_common.so"
    syms = subprocess.run(["readelf", "-Ws", str(lib)], capture_output=True, text=True, check=True).stdout
    # the mangled name of ynn::(anonymous)::make_dot_impl(...)::$_0::operator()(...)::cache_sizes
    m = re.search(r"^\s*\d+: ([0-9a-f]+)\s+(\d+) OBJECT .*make_dot_impl\S*cache_sizes$", syms, re.M)
    assert m, "YNNPACK's dot cache size is in the library's symbols"
    addr, size = int(m.group(1), 16), int(m.group(2))
    dump = subprocess.run(["objdump", "-s", f"--start-address={addr}", f"--stop-address={addr + size}", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    line = next(row for row in dump.splitlines() if row.strip().startswith(f"{addr:x} "))
    words = [w for w in line.split()[1:] if re.fullmatch(r"[0-9a-f]{8}", w)]  # the ASCII column is not hex
    assert int.from_bytes(bytes.fromhex("".join(words))[:size], "little") == 131072


def test_sum_order_topk():
    """The "topk" program's orders as read from the kernels' outputs above."""
    assert [t_ops.sum_order(d, "topk") for d in (1, 2, 4, 5, 8, 9, 32, 33, 1536)] == [
        "fma", "fma", "fma", "seq", "seq", "fma", "fma", "win32", "win32"]
