"""Multi-pod dry run, the port of ``repro/launch/dryrun.py``: trace every
(arch x shape x mesh) cell's step on the production mesh, sharded as the
rules say, with nothing allocated.

The reference lowers and compiles each cell for 256 or 512 fake XLA
devices and reads XLA's memory and cost analyses.  The port runs the same
step function the card runs (``train.step``, ``prefill``, ``decode_step``)
in ONE process as rank 0 of a ``"fake"`` process group of 256 (16 x 16:
``data``, ``model``) or 512 (2 x 16 x 16: ``pod``, ``data``, ``model``)
ranks, whose collectives move nothing, on
``launch.mesh.make_production_mesh(device="cpu")``.  Parameters come from
``models.abstract_init`` on the meta device and become DTensors by
``dist.sharding``; their local shards, optimizer states, batches and
caches are meta tensors too, so a cell of kimi-k2 (1.045e12 parameters)
holds no memory.  A ``TorchDispatchMode`` (``Tally``) sees every op this
rank runs on its local shards and counts:

  * ``memory``: ``argument_bytes_per_device``, the local shards of the
    parameters, optimizer states and batch (or cache), exact (rank 0 holds
    DTensor's largest shard of an uneven split), broken down in
    ``arguments``; ``output_bytes_per_device``, the local shards of what
    the step returns, of which ``alias_bytes_per_device`` are arguments
    updated in place (the reference donates them); ``temp_bytes_per_device``,
    the peak of the storages the step allocates and holds at once (its
    peak less its arguments);
  * ``trace_stats``: ``flops_per_device`` from ``torch.utils.flop_counter``'s
    formulas on the local shapes; ``hbm_bytes_per_device``, the bytes every
    non-view op reads and writes (eager PyTorch fuses nothing);
    ``collective_bytes_per_device``, operand bytes of the collectives, by
    type (``collectives``) and by mesh dimension (``collective_bytes_by_axis``);
    ``unknown_trip_counts`` 0: every loop runs in Python and is traced whole;
  * ``roofline``: the three times against one NVIDIA H100 SXM's datasheet
    peaks (``H100``), collectives at the rate of the link their mesh
    dimension crosses.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all \\
      --mesh both --out artifacts/dryrun_torch
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch kimi_k2_1t_a32b \\
      --shape train_4k --mesh single --rules '{"embed": "data"}'

It sets no ``XLA_FLAGS`` and reads no HLO; ``--keep-hlo`` keeps the traced
op list (``<cell>.ops.gz``, one op a line with its local shapes).  Exit
code 1 on any ``FAILED`` cell.
"""

from __future__ import annotations

import argparse
import dataclasses
import gzip
import json
import os
import sys
import time
import traceback
import weakref
from collections import defaultdict

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.dist import sharding as shardlib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import abstract_init, get_model, param_specs, reference_leaves
from repro_torch.train import optim as optim_mod
from repro_torch.train.step import make_train_step

# One NVIDIA H100 SXM5, NVIDIA's datasheet figures (dense, no sparsity).
# An HGX H100 board joins 8 GPUs by NVLink; a mesh dimension whose group
# spans more than those 8 consecutive ranks crosses the InfiniBand fabric
# (one ConnectX-7 NDR port of 400 Gb/s a GPU).  On the production mesh the
# model axis (16 consecutive ranks) spans two boards, and the data and pod
# axes (strides of 16 and 256) cross boards at every step, so every
# collective here runs at the InfiniBand rate.
H100 = {
    "card": "NVIDIA H100 SXM5 80GB (datasheet)",
    "bf16_dense_flops": 989.4e12,
    "float32_flops": 66.9e12,         # outside the tensor cores (the port turns TF32 off)
    "hbm3_bytes_per_s": 3.35e12,
    "nvlink_bytes_per_s": 450e9,      # NVLink 4: 900 GB/s both ways together, 450 one way
    "nvlink_domain": 8,
    "infiniband_bytes_per_s": 50e9,   # NDR 400 Gb/s
}

# functional collectives (DTensor's) and the c10d ops torch.distributed's
# own calls dispatch (``dist.cluster_parallel``'s); a receive is the other
# end of a send, counted once
_COLLECTIVES = {
    "all_gather_into_tensor", "all_gather_into_tensor_coalesced", "reduce_scatter_tensor",
    "reduce_scatter_tensor_coalesced", "all_reduce", "all_reduce_coalesced", "all_to_all_single", "broadcast",
}
_C10D = {"allreduce_", "allreduce_coalesced_", "allgather_", "_allgather_base_", "allgather_into_tensor_coalesced_",
         "reduce_scatter_", "_reduce_scatter_base_", "reduce_scatter_tensor_coalesced_", "alltoall_",
         "alltoall_base_", "broadcast_", "send"}


def _group_of(args, known) -> str | None:
    """The name of the process group a collective's arguments carry (a
    functional collective's ``group_name``, a c10d op's ProcessGroup)."""
    for a in args:
        if isinstance(a, torch.ScriptObject) and "ProcessGroup" in str(a._type()):
            return dist.ProcessGroup.unbox(a).group_name
        if isinstance(a, str) and a in known:
            return a
    return None


def start_fake_world(world: int) -> None:
    """Rank 0 of a ``"fake"`` process group of ``world`` ranks (collectives
    move nothing), replacing any other."""
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers the "fake" backend

    if dist.is_initialized():
        if dist.get_world_size() == world and "fake" in str(dist.get_backend()):
            return
        dist.destroy_process_group()
    # "meta" too: torch.distributed's own calls look their backend up by the
    # tensors' device
    dist.init_process_group("cpu:fake,meta:fake", store=FakeStore(), rank=0, world_size=world)


def link_rate(mesh, axis: str) -> tuple[float, str]:
    """(bytes/s, link name) of the link a collective along ``axis`` crosses:
    NVLink where the axis' group lies within one 8-GPU board, else
    InfiniBand."""
    ranks = mesh.mesh.transpose(mesh.mesh_dim_names.index(axis), -1).reshape(-1, mesh[axis].size())[0]
    boards = {int(r) // H100["nvlink_domain"] for r in ranks}
    if len(boards) == 1:
        return H100["nvlink_bytes_per_s"], "nvlink"
    return H100["infiniband_bytes_per_s"], "infiniband"


class Tally(TorchDispatchMode):
    """The local work of everything traced under it on this rank: FLOPs
    (``flop_registry``'s formulas on local shapes), the bytes every non-view
    op reads and writes, collective operand bytes by type and by mesh
    dimension, and the peak of the storages allocated and held at once.
    DTensor's sharding propagation runs on fake tensors; those ops are not
    work and are skipped."""

    def __init__(self, axis_of_group: dict[str, str], keep_ops: bool = False):
        super().__init__()
        self.axis_of_group = axis_of_group
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.coll_bytes: dict[str, float] = defaultdict(float)
        self.coll_axis: dict[str, float] = defaultdict(float)
        self.live = 0
        self.peak = 0
        self.ops: list[str] | None = [] if keep_ops else None

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # let DTensor run first: this mode then sees its local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if any(isinstance(t, FakeTensor) for t in outs):
            return out
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        packet = func._overloadpacket
        name = packet.__name__
        if self.ops is not None:
            self.ops.append(f"{func} {[tuple(t.shape) for t in ins]} -> {[tuple(t.shape) for t in outs]}")
        coll = (func.namespace == "_c10d_functional" and name in _COLLECTIVES) or (
            func.namespace == "c10d" and name in _C10D)
        if coll:
            # operand bytes: an all-gather's second argument is its input
            operands = args[1] if "allgather" in name else args[0]
            nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(operands) if isinstance(t, torch.Tensor))
            self.coll_bytes[name] += nbytes
            self.coll_axis[self.axis_of_group.get(_group_of(args, self.axis_of_group), "other")] += nbytes
        elif packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        seen = {t.untyped_storage()._cdata for t in ins}
        new = []
        for t in outs:
            st = t.untyped_storage()
            if st._cdata not in seen:
                seen.add(st._cdata)
                new.append(st)
        if new or not func.is_view:
            self.hbm_bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        for st in new:
            nbytes = st.nbytes()
            self.live += nbytes
            weakref.finalize(st, self._free, nbytes)
        self.peak = max(self.peak, self.live)
        return out


def local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor in a nested dict (or
    module): a DTensor's local tensor, a plain tensor whole."""
    if isinstance(tree, torch.nn.Module):
        tree = dict(tree.named_parameters())
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def _shape(shape) -> dict:
    """A shape cell by name (``configs.SHAPES``) or as its dict itself
    (``seq_len``, ``global_batch``, ``kind``)."""
    return SHAPES[shape] if isinstance(shape, str) else shape


def input_specs(cfg, shape_name) -> dict:
    """Meta-tensor stand-ins for every model input of a shape cell (the
    reference's ShapeDtypeStructs): the batch, or a decode step's cache and
    token."""
    sh = _shape(shape_name)
    s_len, gb, kind = sh["seq_len"], sh["global_batch"], sh["kind"]

    def t(shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device="meta")

    f32 = torch.float32
    if kind == "train":
        if cfg.arch == "encdec":
            dec = max(1, int(s_len * cfg.dec_seq_frac))
            return {"frames": t((gb, s_len, cfg.frontend_dim), f32), "dec_tokens": t((gb, dec)),
                    "dec_labels": t((gb, dec)), "dec_mask": t((gb, dec), f32)}
        if cfg.frontend == "patches":
            n_text = s_len - cfg.frontend_tokens_4k
            return {"tokens": t((gb, n_text)), "patch_embeds": t((gb, cfg.frontend_tokens_4k, cfg.frontend_dim), f32),
                    "labels": t((gb, n_text)), "mask": t((gb, n_text), f32)}
        return {"tokens": t((gb, s_len)), "labels": t((gb, s_len)), "mask": t((gb, s_len), f32)}
    if kind == "prefill":
        if cfg.arch == "encdec":
            return {"frames": t((gb, s_len, cfg.frontend_dim), f32)}
        if cfg.frontend == "patches":
            n_text = s_len - cfg.frontend_tokens_4k
            return {"tokens": t((gb, n_text)), "patch_embeds": t((gb, cfg.frontend_tokens_4k, cfg.frontend_dim), f32)}
        return {"tokens": t((gb, s_len))}
    # decode: a cache of the whole context and one token
    return {"cache": get_model(cfg).init_cache(cfg, gb, s_len, device="meta"), "cur_tokens": t((gb, 1))}


def build_step(cfg, shape_name: str, mesh, rules):
    """(fn, arguments): ``fn()`` runs the cell's step on DTensor arguments
    placed as the rules say (``arguments``: name -> nested tensors, for the
    byte counts), with gradients only for a train cell."""
    kind = _shape(shape_name)["kind"]
    model = get_model(cfg)
    p_shard = shardlib.tree_shardings(param_specs(cfg), mesh, rules)
    params = shardlib.distribute_module(abstract_init(cfg), p_shard)
    ins = input_specs(cfg, shape_name)

    if kind == "train":
        opt_cfg = optim_mod.OptConfig(state_dtype=cfg.optimizer_state_dtype)
        opt_init, _ = optim_mod.make_optimizer(opt_cfg, cfg)
        opt_plain = opt_init(abstract_init(cfg))
        layouts = {n: leaf.transposed for n, leaf in reference_leaves(cfg).items()}
        opt = shardlib.distribute(opt_plain, shardlib.opt_state_shardings(p_shard, opt_plain, mesh, layouts))
        batch = shardlib.distribute(ins, shardlib.batch_shardings(ins, mesh))
        step = make_train_step(cfg, opt_cfg)
        return (lambda: step(params, opt, batch)), {"params": params, "opt_state": opt, "batch": batch}

    s_len = _shape(shape_name)["seq_len"]
    if kind == "prefill":
        batch = shardlib.distribute(ins, shardlib.batch_shardings(ins, mesh))

        def prefill():
            with torch.no_grad():
                if cfg.arch == "encdec":
                    return model.prefill(params, cfg, batch["frames"], max_len=s_len)
                return model.prefill(params, cfg, batch["tokens"], max_len=s_len,
                                     patch_embeds=batch.get("patch_embeds"))

        return prefill, {"params": params, "batch": batch}

    cache = shardlib.distribute(ins["cache"], shardlib.cache_shardings(ins["cache"], mesh))
    cur = shardlib.distribute(ins["cur_tokens"], shardlib.batch_shardings(ins["cur_tokens"], mesh))

    def decode():
        with torch.no_grad():
            return model.decode_step(params, cfg, cache, cur)

    return decode, {"params": params, "cache": cache, "cur_tokens": cur}


def roofline(flops: float, hbm_bytes: float, coll_axis: dict, mesh, peak: str = "bf16_dense_flops") -> dict:
    """The three times (seconds) of one device and the dominant one, the
    operations at the ``peak`` rate of ``H100`` (the LMs compute in
    bfloat16; the clustering planes in float32)."""
    t_coll, links = 0.0, {}
    for axis, nbytes in coll_axis.items():
        rate, link = link_rate(mesh, axis) if axis in mesh.mesh_dim_names else (H100["infiniband_bytes_per_s"], "infiniband")
        t_coll += nbytes / rate
        links[axis] = link
    terms = {"t_compute_s": flops / H100[peak], "t_memory_s": hbm_bytes / H100["hbm3_bytes_per_s"],
             "t_collective_s": t_coll}
    dominant = max(("compute", terms["t_compute_s"]), ("memory", terms["t_memory_s"]),
                   ("collective", t_coll), key=lambda kv: kv[1])[0]
    return {**terms, "dominant": dominant, "links": links, "peak": peak, "peaks": H100}


def depth_units(cfg) -> int:
    """The repeating units of a model's depth: layers (the transformers,
    mamba2), periods (griffin, its remainder apart) or encoder + decoder
    layer pairs (the encoder-decoder)."""
    if cfg.arch == "griffin":
        pat = cfg.block_pattern or ("R", "R", "A")
        return cfg.n_layers // len(pat)
    if cfg.arch == "encdec":
        if cfg.n_enc_layers != cfg.n_dec_layers:
            raise ValueError(f"{cfg.name}: {cfg.n_enc_layers} encoder and {cfg.n_dec_layers} decoder layers")
        return cfg.n_enc_layers
    return cfg.n_layers


def at_depth(cfg, units: int):
    """``cfg`` cut to ``units`` of ``depth_units`` (griffin keeps its
    remainder)."""
    if cfg.arch == "griffin":
        pat = cfg.block_pattern or ("R", "R", "A")
        return dataclasses.replace(cfg, n_layers=units * len(pat) + cfg.n_layers % len(pat))
    if cfg.arch == "encdec":
        return dataclasses.replace(cfg, n_enc_layers=units, n_dec_layers=units)
    return dataclasses.replace(cfg, n_layers=units)


def _trace(cfg, shape_name: str, mesh, rules, keep_ops: bool) -> dict:
    """One traced step of ``cfg`` on ``mesh``: the tally's counts and its
    outputs' local bytes."""
    fn, arguments = build_step(cfg, shape_name, mesh, rules)
    tally = Tally({mesh.get_group(a).group_name: a for a in mesh.mesh_dim_names}, keep_ops=keep_ops)
    t0 = time.monotonic()
    with shardlib.activation_context(mesh, rules), tally:
        out = fn()
    t_trace = time.monotonic() - t0
    if _shape(shape_name)["kind"] == "train":  # (params, states, metrics): the first two updated in place
        out = (dict(out[0].named_parameters()), out[1], out[2])
    out_leaves = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
    arg_ids = {id(t) for t in tree_leaves(arguments)} | {id(p) for p in arguments["params"].parameters()}
    counts = {"flops": tally.flops, "hbm_bytes": tally.hbm_bytes, "temp_bytes": tally.peak,
              "output_bytes": local_bytes(out_leaves),
              "alias_bytes": local_bytes([t for t in out_leaves if id(t) in arg_ids]),
              **{f"coll/{k}": v for k, v in tally.coll_bytes.items()},
              **{f"axis/{k}": v for k, v in tally.coll_axis.items()}}
    return {"counts": counts, "t_trace_s": t_trace, "ops": tally.ops}


def reckon(cfg, shape, mesh, rules, keep_ops: bool = False) -> dict:
    """The record of one cell of ``cfg`` (``shape``: a name of
    ``configs.SHAPES`` or its dict) on ``mesh`` under ``rules``.  The
    arguments are placed at full depth (their bytes are exact).  A decode
    step is traced at full depth; a train or prefill step, whose layers
    repeat (and whose trace is long: a prefill_32k layer runs 2048
    attention tiles), at 1 and 2 units of ``depth_units`` and its counts
    are extended linearly to the full depth (``traced_units``), as the
    reference's cost analysis multiplies a scanned layer by its trip
    count."""
    t0 = time.monotonic()
    _, arguments = build_step(cfg, shape, mesh, rules)
    arg_bytes = {k: local_bytes(v) for k, v in arguments.items()}
    del arguments
    t_setup = time.monotonic() - t0

    full = depth_units(cfg)
    units = [full] if _shape(shape)["kind"] == "decode" else [1, 2]
    traces = [_trace(at_depth(cfg, u), shape, mesh, rules, keep_ops) for u in units]
    if len(traces) == 1:
        counts = traces[0]["counts"]
    else:
        c1, c2 = traces[0]["counts"], traces[1]["counts"]
        counts = {k: c1.get(k, 0.0) + (full - 1) * (c2.get(k, 0.0) - c1.get(k, 0.0)) for k in c1.keys() | c2.keys()}
    coll = {k[5:]: v for k, v in counts.items() if k.startswith("coll/")}
    by_axis = {k[5:]: v for k, v in counts.items() if k.startswith("axis/")}
    return {
        "status": "ok",
        "t_setup_s": round(t_setup, 2),
        "t_trace_s": round(sum(t["t_trace_s"] for t in traces), 2),
        "traced_units": units,
        "full_units": full,
        "memory": {
            "argument_bytes_per_device": sum(arg_bytes.values()),
            "output_bytes_per_device": int(counts["output_bytes"]),
            "temp_bytes_per_device": int(counts["temp_bytes"]),
            "alias_bytes_per_device": int(counts["alias_bytes"]),
            "arguments": arg_bytes,
        },
        "trace_stats": {
            "flops_per_device": counts["flops"],
            "hbm_bytes_per_device": counts["hbm_bytes"],
            "collective_bytes_per_device": float(sum(coll.values())),
            "collectives": coll,
            "collective_bytes_by_axis": by_axis,
            "unknown_trip_counts": 0,
        },
        "roofline": roofline(counts["flops"], counts["hbm_bytes"], by_axis, mesh),
        "ops": [(u, t["ops"]) for u, t in zip(units, traces)] if keep_ops else None,
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str | None, rules_override=None,
             keep_hlo: bool = False, tag: str = "") -> dict:
    """One cell of the grid on the production mesh (``reckon``)."""
    cfg = get_config(arch)
    mesh_name = "multi" if multi_pod else "single"
    if shape_name == "long_500k" and not cfg.run_long_500k:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name, "status": "skipped", "note": cfg.skip_note}
    start_fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           **reckon(cfg, shape_name, mesh, shardlib.resolve_rules(mesh, rules_override), keep_hlo)}
    ops = rec.pop("ops")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        name = f"{arch}__{shape_name}__{mesh_name}{tag}"
        with open(os.path.join(out_dir, name + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
        if keep_hlo:
            with gzip.open(os.path.join(out_dir, name + ".ops.gz"), "wt") as f:
                for u, lines in ops:
                    f.write(f"# {u} units\n" + "\n".join(lines) + "\n")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--rules", default=None, help="JSON sharding-rule overrides")
    ap.add_argument("--keep-hlo", action="store_true", help="keep the traced op list (the port has no HLO)")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else [args.arch.replace("-", "_")]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    rules_override = json.loads(args.rules) if args.rules else None

    t_all = time.monotonic()
    results = []
    try:
        for arch in archs:
            for shape in shapes:
                for mp in meshes:
                    label = f"{arch} x {shape} x {'multi' if mp else 'single'}"
                    try:
                        rec = run_cell(arch, shape, mp, args.out, rules_override, keep_hlo=args.keep_hlo,
                                       tag=args.tag)
                    except Exception as e:  # noqa: BLE001 - a failed cell is recorded, the grid goes on
                        rec = {"arch": arch, "shape": shape, "mesh": "multi" if mp else "single",
                               "status": "FAILED", "error": f"{type(e).__name__}: {e}"}
                        traceback.print_exc()
                    results.append(rec)
                    if rec["status"] == "ok":
                        r, mem = rec["roofline"], rec["memory"]
                        print(f"[OK] {label}: trace {rec['t_trace_s']}s  args "
                              f"{mem['argument_bytes_per_device'] / 2**30:.2f} GiB/dev  temp "
                              f"{mem['temp_bytes_per_device'] / 2**30:.2f} GiB/dev  t_comp "
                              f"{r['t_compute_s'] * 1e3:.2f}ms t_mem {r['t_memory_s'] * 1e3:.2f}ms "
                              f"t_coll {r['t_collective_s'] * 1e3:.2f}ms -> {r['dominant']}", flush=True)
                    else:
                        print(f"[{rec['status']}] {label}: {rec.get('note') or rec.get('error', '')}", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_fail = sum(r["status"] == "FAILED" for r in results)
    print(f"\n=== dry-run: {n_ok} ok / {n_skip} skipped / {n_fail} failed "
          f"({time.monotonic() - t_all:.1f} s) ===")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump(results, f, indent=1)
    sys.exit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
