"""The port's dry runs on the production mesh, on the CPU in subprocesses
(their ``"fake"`` process groups of 256 and 512 ranks stay out of the
test worker):

  * ``python -m repro_torch.launch.dryrun --arch mamba2_780m --shape
    long_500k --mesh both`` prints "2 ok" and exits 0, as the reference's
    own test of its dry run (``tests/test_distributed.py``); its records
    keep the reference's memory keys, count the local work and name the
    H100's datasheet peaks; a cell whose config does not run
    ``long_500k`` is skipped;
  * ``python -m repro_torch.launch.cluster --dryrun`` at n = 65536 on 256
    fake ranks gives the three planes' records, with no ``nvcc`` on the
    path, no kernel built (``kernels._build`` fails if asked) and no kernel
    launched.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    return env


def test_dryrun_cell_subprocess(tmp_path):
    """One cell on both meshes, as the reference's ``test_dryrun_cell_subprocess``."""
    out = tmp_path / "dryrun"
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "mamba2_780m", "--shape",
                        "long_500k", "--mesh", "both", "--out", str(out)],
                       env=_env(), cwd=REPO, capture_output=True, text=True, timeout=140)
    assert r.returncode == 0, r.stdout + r.stderr[-2000:]
    assert "2 ok" in r.stdout
    for mesh, chips in (("single", 256), ("multi", 512)):
        rec = json.loads((out / f"mamba2_780m__long_500k__{mesh}.json").read_text())
        assert rec["status"] == "ok" and rec["traced_units"] == [rec["full_units"]] == [48]
        mem = rec["memory"]
        assert set(mem) >= {"argument_bytes_per_device", "output_bytes_per_device", "temp_bytes_per_device",
                            "alias_bytes_per_device"}
        assert mem["argument_bytes_per_device"] == sum(mem["arguments"].values()) > 0
        # the decode step writes its cache in place: the cache's bytes are aliased
        assert mem["alias_bytes_per_device"] == mem["arguments"]["cache"]
        stats = rec["trace_stats"]
        assert stats["flops_per_device"] > 0 and stats["hbm_bytes_per_device"] > 0
        roof = rec["roofline"]
        assert roof["peaks"]["card"].startswith("NVIDIA H100") and roof["dominant"] in ("compute", "memory",
                                                                                        "collective")
    summary = json.loads((out / "summary.json").read_text())
    assert [s["status"] for s in summary] == ["ok", "ok"]


def test_dryrun_skips_long_context_where_the_config_does():
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen2_1_5b", "--shape",
                        "long_500k", "--mesh", "single", "--out", ""],
                       env=_env(), cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "[skipped] qwen2_1_5b x long_500k x single" in r.stdout and "0 ok / 1 skipped / 0 failed" in r.stdout


CLUSTER = textwrap.dedent("""
    import json, sys
    from repro_torch.kernels import _build

    def refuse(*a, **k):
        raise AssertionError("the dry run built a kernel")

    _build.load = _build.build_all = refuse
    import importlib
    from repro_torch.launch import cluster

    cluster.main(["--dryrun", "--n", "65536", "--out", sys.argv[1]])
    launches = {k: importlib.import_module(f"repro_torch.kernels.{k}").__dict__[k].launches
                for k in ("pairwise_topk", "lune_filter")}
    print(json.dumps(launches))
""")


def test_cluster_dryrun_gives_three_records_and_builds_no_kernel(tmp_path):
    env = _env()
    env["PATH"] = os.pathsep.join(p for p in env.get("PATH", "").split(os.pathsep)
                                  if not os.path.exists(os.path.join(p, "nvcc")))
    r = subprocess.run([sys.executable, "-c", CLUSTER, str(tmp_path)], env=env, cwd=REPO, capture_output=True,
                       text=True, timeout=140)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == {"pairwise_topk": 0, "lune_filter": 0}
    rec = json.loads((tmp_path / "cluster__n65536__d64__k64__single.json").read_text())
    assert list(rec) == ["ring_knn", "ring_lune_count", "sharded_mst_range"]
    for name, plane in rec.items():
        assert plane["kernel"] == name
        assert plane["flops_per_device"] >= 0 and plane["hbm_bytes_per_device"] > 0
        assert plane["roofline"]["peak"] == "float32_flops"
    # the ring moves every rank's block once around the ring of 256: 255 sends of 256 x 64 float32
    assert rec["ring_knn"]["collectives"]["send"] == 255 * 256 * 64 * 4
    assert rec["sharded_mst_range"]["rounds_bound"] == 17 and rec["sharded_mst_range"]["unknown_trip_counts"] == 1


@pytest.mark.parametrize("bad", [["--mesh", "triple"]])
def test_dryrun_cli_refuses_an_unknown_mesh(bad):
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *bad], env=_env(), cwd=REPO,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 2 and "invalid choice" in r.stderr
