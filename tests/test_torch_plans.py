"""The launch plans of the port's two chain kernels, chosen in Python on the
CPU: ``prim_mst.plan_for`` (cluster size, points and state resident in
shared memory or read from device memory) and
``single_linkage.layout_for`` (the union-find state in shared or device
memory).  The limits are the sources' own: the constants mirrored here are
read back from ``csrc/`` and the limits follow from them."""

from __future__ import annotations

import importlib
import re
from pathlib import Path

import pytest

pm = importlib.import_module("repro_torch.kernels.prim_mst")
sl = importlib.import_module("repro_torch.kernels.single_linkage")

CSRC = Path(pm.__file__).resolve().parent / "csrc"


def _constant(source: str, name: str) -> str:
    m = re.search(rf"constexpr int {name} = ([^;]+);", (CSRC / source).read_text())
    assert m, f"{name} in {source}"
    return m.group(1).split("//")[0].strip()


def test_constants_mirror_the_sources():
    assert eval(_constant("prim_mst.cu", "SMEM_BUDGET")) == pm.SMEM_BUDGET  # noqa: S307 - a C constant expression
    assert int(_constant("prim_mst.cu", "SLOT_HEAD")) == pm.SLOT_HEAD
    assert int(_constant("prim_mst.cu", "BAR_WORDS")) == pm.BAR_WORDS
    assert int(_constant("prim_mst.cu", "COORDS_MAX")) == pm.COORDS_MAX
    assert int(_constant("prim_mst.cu", "MAX_THREADS")) == pm.MAX_THREADS
    assert int(_constant("prim_mst.cu", "MAX_CLUSTER")) == max(pm.CLUSTERS)
    smem_max = eval(_constant("single_linkage.cu", "SMEM_MAX"))  # noqa: S307
    chunk = int(_constant("single_linkage.cu", "CHUNK"))
    assert (smem_max - 2 * 5 * chunk * 4) // 8 == sl.SMEM_MAX_N == sl.smem_max_n() == 26368


def test_headline_shape_is_one_cluster_of_16_with_everything_resident():
    plan = pm.plan_for(16000, 8, 16)
    assert (plan.cluster, plan.threads, plan.share, plan.points, plan.state) == (16, 512, 1000, "shared", "shared")
    # two mbarriers (16 bytes), 2 x 16 slots of 12 words, then 1000 points of 8 floats and 3 words of
    # state each: 45552 bytes
    assert plan.smem == 16 + 2 * 16 * 12 * 4 + 1000 * (8 + 3) * 4 == 45552
    # the portable cluster holds twice the share
    plan8 = pm.plan_for(16000, 8, 8)
    assert (plan8.cluster, plan8.share, plan8.points, plan8.state) == (8, 2000, "shared", "shared")


# d = 8, C = 16: mbarriers 16 bytes, slots 2 x 16 x 12 words; a vertex takes 44 bytes with its point,
# 12 without
POINTS_MAX_N = 16 * ((pm.SMEM_BUDGET - 16 - 2 * 16 * 12 * 4) // 44)
STATE_MAX_N = 16 * ((pm.SMEM_BUDGET - 16 - 2 * 16 * 4 * 4) // 12)


@pytest.mark.parametrize("n, points, state", [
    (POINTS_MAX_N, "shared", "shared"),
    (POINTS_MAX_N + 1, "device", "shared"),
    (STATE_MAX_N, "device", "shared"),
    (STATE_MAX_N + 1, "device", "device"),
])
def test_residency_limits(n, points, state):
    assert (POINTS_MAX_N, STATE_MAX_N) == (83584, 307856)
    plan = pm.plan_for(n, 8, 16)
    assert (plan.points, plan.state) == (points, state)
    assert plan.smem <= pm.SMEM_BUDGET


def test_wide_rows_stream_their_points():
    plan = pm.plan_for(4000, 320, 16)
    assert (plan.cluster, plan.share, plan.threads, plan.points, plan.state) == (16, 250, 256, "device", "shared")
    # no coordinates travel above d = 32: a slot is 4 words
    assert plan.smem == 16 + 2 * 16 * 4 * 4 + 250 * 3 * 4
    assert pm.plan_for(1007, 320, 16).points == "shared"  # 63 rows of 1280 bytes a block fit


@pytest.mark.parametrize("n, d, cluster, threads", [(1, 2, 16, 32), (33, 3, 16, 32), (1007, 100, 16, 64),
                                                     (4000, 2, 8, 512), (4000, 2, 16, 256), (16000, 8, 8, 512),
                                                     (52000, 1, 16, 512)])
def test_threads_cover_the_share(n, d, cluster, threads):
    plan = pm.plan_for(n, d, cluster)
    assert plan.threads == threads and plan.share == -(-n // cluster)


def test_forced_plans():
    assert (pm.plan_for(4000, 8, 8, points="device").points, pm.plan_for(4000, 8, 8, points="device").state) == (
        "device", "shared")
    forced = pm.plan_for(4000, 8, 16, state="device")
    assert (forced.points, forced.state, forced.smem) == ("device", "device", 16 + 2 * 16 * 4 * 4)
    before = pm.set_plan(cluster=8, state="device")
    try:
        plan = pm.launch_plan(4000, 8, "cpu")  # a forced cluster asks the card nothing
        assert (plan.cluster, plan.points, plan.state) == (8, "device", "device")
        pm.set_plan(cluster=16, points="shared", state="shared")
        plan = pm.launch_plan(1007, 100, "cpu")
        assert (plan.cluster, plan.points, plan.state) == (16, "shared", "shared")
    finally:
        pm.set_plan(**before)
    assert pm.set_plan() == {}


@pytest.mark.parametrize("kwargs", [
    dict(n=16000, d=320, cluster=16, points="shared"),        # 320 KB of points a block
    dict(n=STATE_MAX_N + 1, d=8, cluster=16, state="shared"),
    dict(n=4000, d=8, cluster=16, points="shared", state="device"),
    dict(n=4000, d=8, cluster=17),
    dict(n=4000, d=8, cluster=16, points="resident"),
    dict(n=0, d=8, cluster=16),
])
def test_plans_that_cannot_fit_raise(kwargs):
    n, d, cluster = kwargs.pop("n"), kwargs.pop("d"), kwargs.pop("cluster")
    with pytest.raises(ValueError):
        pm.plan_for(n, d, cluster, **kwargs)


def test_set_plan_rejects_unknown_settings():
    with pytest.raises(ValueError, match="set_plan takes"):
        pm.set_plan(threads=64)


@pytest.mark.parametrize("n, layout", [(16000, "shared"), (24000, "shared"), (sl.SMEM_MAX_N, "shared"),
                                       (sl.SMEM_MAX_N + 1, "device"), (2, "shared")])
def test_linkage_layout(n, layout):
    assert sl.layout_for(n) == layout


def test_linkage_forced_layouts():
    assert sl.layout_for(5000, "device") == "device"
    with pytest.raises(ValueError, match="does not fit"):
        sl.layout_for(sl.SMEM_MAX_N + 1, "shared")
    with pytest.raises(ValueError):
        sl.layout_for(1)
    before = sl.set_layout("device")
    try:
        assert sl._forced_layout == "device"
    finally:
        assert sl.set_layout(before) == "device"
    with pytest.raises(ValueError):
        sl.set_layout("global")
