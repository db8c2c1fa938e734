"""The port's sharding layer (``dist.sharding``, ``models.param_specs``)
against the JAX package's, on the CPU.

  * ``param_specs`` equals the reference's ``abstract_init(cfg)[1]`` for
    every config as published: each leaf's logical names without the
    stacked ``layers`` axis, reversed where the port tensor is an
    ``nn.Linear`` weight (out, in);
  * ``resolve_rules`` and ``pspec_for`` on DeviceMeshes of (16, 16),
    (2, 16, 16), (4, 2) and (1, 1) (a ``"fake"`` process group of that
    many ranks in a subprocess) equal the reference's on a stand-in mesh
    (its ``_filter_axes`` reads only ``mesh.shape``): the same resolved
    rules, and each mesh dimension sharding the tensor dimension the
    reference's ``PartitionSpec`` puts it on (where a spec names one mesh
    dimension twice, the MoE's ``("experts", "ff", "embed")``, the first);
  * the dry run's parameter, optimizer-state and batch bytes per device of
    every config at ``train_4k`` on the 16 x 16 mesh equal the reckoning
    from the reference's specs and rules: numpy arithmetic on the shapes,
    ceil(size / ways) a sharded dimension (DTensor's largest shard, JAX's
    padded one);
  * ``constrain`` is the identity outside a context and on plain tensors;
    ``reshape`` and ``index_add_rows`` on plain tensors are torch's own.
"""

import json
import math
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, SHAPES
from repro.configs import get_config as j_get_config
from repro.dist import sharding as j_sharding
from repro.models import abstract_init as j_abstract_init
from repro.train import optim as j_optim

from repro_torch.configs import get_config
from repro_torch.dist import sharding as t_sharding
from repro_torch.models import param_specs, reference_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"16x16": ((16, 16), ("data", "model")), "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model")), "1x1": ((1, 1), ("data", "model"))}
ACTIVATION_SPECS = [("act_batch", "act_seq", "act_embed"), ("act_batch", "act_seq", "act_heads", None),
                    ("act_batch", "act_seq", None, None), ("act_batch", "act_seq", "act_ff"),
                    ("act_batch", "act_seq", "act_vocab"), ("act_experts", None, "act_embed"),
                    ("act_experts", None, None), ("act_batch", "act_embed"), ("act_batch", "act_seq", None)]

PORT = textwrap.dedent("""
    import json, sys
    import torch.distributed as dist
    from torch.distributed.tensor import Shard
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.dist import sharding as sh
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh_compat, make_production_mesh

    meshes, specs = json.loads(sys.argv[1]), [tuple(s) for s in json.loads(sys.argv[2])]
    out = {"rules": {}, "placements": {}, "bytes": {}}
    for name, (shape, axes) in meshes.items():
        world = 1
        for s in shape:
            world *= s
        dryrun.start_fake_world(world)
        mesh = make_mesh_compat(shape, axes, device="cpu")
        rules = sh.resolve_rules(mesh)
        out["rules"][name] = {k: list(v) if isinstance(v, tuple) else v for k, v in rules.items()}
        out["placements"][name] = [[f"S{p.dim}" if isinstance(p, Shard) else "R" for p in sh.pspec_for(s, rules)]
                                   for s in specs]
    dryrun.start_fake_world(256)
    mesh = make_production_mesh(device="cpu")
    rules = sh.resolve_rules(mesh)
    for arch in ARCH_IDS:
        _, args = dryrun.build_step(get_config(arch), "train_4k", mesh, rules)
        out["bytes"][arch] = {k: dryrun.local_bytes(v) for k, v in args.items()}
    dist.destroy_process_group()
    print(json.dumps(out))
""")


class _StandIn:
    """A mesh for the reference's ``_filter_axes``: a name -> size map."""

    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))


def _all_specs() -> list[tuple]:
    specs = {s for arch in ARCH_IDS for s in param_specs(get_config(arch)).values()}
    return sorted(specs, key=str) + ACTIVATION_SPECS


@pytest.fixture(scope="module")
def port():
    """The port's side, computed in a subprocess (its fake process groups
    stay out of the test worker)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("JAX_PLATFORMS", None)
    specs = _all_specs()
    r = subprocess.run([sys.executable, "-c", PORT, json.dumps(MESHES), json.dumps(specs)], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=140)
    assert r.returncode == 0, r.stderr[-4000:]
    return specs, json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference(arch):
    cfg = get_config(arch)
    _, specs = j_abstract_init(j_get_config(arch))
    got = param_specs(cfg)
    leaves = reference_leaves(cfg)
    assert list(got) == list(leaves)
    for name, leaf in leaves.items():
        want = specs
        for key in leaf.path:
            want = want[key]
        if leaf.layer is not None:
            assert want[0] == "layers"
            want = want[1:]
        if leaf.transposed:
            want = want[::-1]
        assert got[name] == want, name


def _reference_placements(spec, rules, axes) -> list[str]:
    """The reference's PartitionSpec as one placement a mesh dimension."""
    where = {}
    for dim, entry in enumerate(j_sharding.pspec_for(spec, rules)):
        for axis in (entry if isinstance(entry, tuple) else (entry,) if entry else ()):
            where.setdefault(axis, dim)
    return [f"S{where[a]}" if a in where else "R" for a in axes]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_resolve_rules_and_pspec_for_equal_the_reference(port, mesh):
    specs, got = port
    shape, axes = MESHES[mesh]
    rules = j_sharding.resolve_rules(_StandIn(shape, axes))
    assert got["rules"][mesh] == {k: list(v) if isinstance(v, tuple) else v for k, v in rules.items()}
    for spec, placements in zip(specs, got["placements"][mesh]):
        assert placements == _reference_placements(spec, rules, axes), spec
    # the port's own call on a stand-in reads the same shape
    assert t_sharding.resolve_rules(_StandIn(shape, axes)) == rules


def _ways(spec, rules, shape) -> list[int]:
    """Shards of each tensor dimension under the reference's rules (a mesh
    dimension counted once, on the first tensor dimension naming it)."""
    used, ways = set(), []
    sizes = dict(zip(("data", "model"), shape))
    for entry in j_sharding.pspec_for(spec, rules):
        axes = [a for a in (entry if isinstance(entry, tuple) else (entry,) if entry else ()) if a not in used]
        used.update(axes)
        ways.append(math.prod(sizes[a] for a in axes))
    return ways


def _reckoned(arch) -> dict:
    """Parameter, optimizer-state and batch bytes per device of ``arch`` at
    train_4k on 16 x 16, from the reference's specs and rules."""
    cfg = j_get_config(arch)
    shape = (16, 16)
    rules = j_sharding.resolve_rules(_StandIn(shape, ("data", "model")))
    sds, specs = j_abstract_init(cfg)
    leaves = jax.tree.leaves(sds)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda s: isinstance(s, tuple))
    params = opt = 0
    for leaf, spec in zip(leaves, spec_leaves):
        local = math.prod(-(-n // w) for n, w in zip(leaf.shape, _ways(spec, rules, shape)))
        params += local * np.dtype(leaf.dtype).itemsize
        if cfg.optimizer_state_dtype == "int8" and j_optim.q8_compatible(leaf.shape):
            # m and v: q placed like the parameter, the per-block scales whole
            opt += 2 * (local + math.prod(leaf.shape[:-1]) * (leaf.shape[-1] // 32) * 4)
        else:
            opt += 2 * local * (4 if cfg.optimizer_state_dtype == "float32" else 2)
    opt += 4  # step
    sh = SHAPES["train_4k"]
    gb, s_len = sh["global_batch"], sh["seq_len"]
    if cfg.arch == "encdec":
        dec = max(1, int(s_len * cfg.dec_seq_frac))
        rows = [(gb, s_len, cfg.frontend_dim)] + [(gb, dec)] * 3
    elif cfg.frontend == "patches":
        n_text = s_len - cfg.frontend_tokens_4k
        rows = [(gb, n_text), (gb, cfg.frontend_tokens_4k, cfg.frontend_dim), (gb, n_text), (gb, n_text)]
    else:
        rows = [(gb, s_len)] * 3
    batch = sum(math.prod(r) // shape[0] * 4 for r in rows)  # int32 and float32, rows over data
    return {"params": params, "opt_state": opt, "batch": batch}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_dryrun_argument_bytes_equal_the_reckoning(port, arch):
    assert port[1]["bytes"][arch] == _reckoned(arch)


def test_constrain_reshape_and_index_add_rows_on_plain_tensors():
    x = torch.randn(4, 6, 8)
    assert t_sharding.constrain(x, ("act_batch", "act_seq", "act_embed")) is x
    y = t_sharding.reshape(x, (4, 6, 2, 4))
    assert torch.equal(y, x.reshape(4, 6, 2, 4))
    assert torch.equal(t_sharding.unflatten(x, -1, (2, 4)), y)
    src = torch.randn(3, 5, 8)
    idx = torch.randint(0, 7, (3, 5))
    want = torch.zeros(7, 8).index_add_(0, idx.reshape(-1), src.reshape(-1, 8))
    assert torch.equal(t_sharding.index_add_rows(7, idx, src), want)
