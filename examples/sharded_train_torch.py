"""Sharded LM training on the PyTorch port across several GPUs: the train
step with its parameters, AdamW states and batch as DTensors on a mesh of
cards, one process a card, held to the single-card step.

  PYTHONPATH=src python examples/sharded_train_torch.py --ranks 4                   # four cards, NCCL
  PYTHONPATH=src python examples/sharded_train_torch.py --ranks 4 --device cpu --reduced  # gloo on the CPU

Each rank starts the process group itself (a ``file://`` store in a
temporary directory), builds ``launch.mesh.make_mesh_compat`` meshes over
the ranks and runs ``train.step`` in a ``dist.sharding.activation_context``
(the reference launcher's pattern, ``repro/launch/train.py:57-68``):

  1. qwen2-1.5b (published width and depth, bfloat16 compute, float32
     masters and AdamW states) on a (2, 2) and a (1, 4) mesh for
     ``--steps`` steps of ``train_batch`` (B = 4, S = 1024), against the
     same steps on rank 0's card alone from the same init: losses within
     ``LOSS_RTOL`` (the sharded products sum their partial products in
     another order and, in bfloat16, reduce them across the cards in
     bfloat16), and 2 layers in float32 with the updated masters to
     ``DELTA_RTOL`` in relative Frobenius distance of each update;
  2. qwen2.5-14b on (1, 4): 1.48e10 parameters, 236 GB of float32 masters,
     gradients and AdamW states, which no single 80 GB card holds.  Its
     gated MLPs' ``wi`` (46% of it) has no rule in the reference's
     ``DEFAULT_RULES`` (``ff2``) and stays whole on every card, so the run
     adds ``{"ff2": "model"}`` (59 GB a card).  Its peak is first reckoned
     by the port's own dry run (``launch.dryrun.reckon`` on a fake (1, 4)
     world); above 80 GB at B = 4 the run takes B = 1 (microbatch 1, where
     the config has 2) and says so.

Each step's seconds, tokens/s and each rank's peak memory are printed; the
summary goes to ``--out`` as JSON.
"""

import argparse
import dataclasses
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SMALL, LARGE = "qwen2_1_5b", "qwen2_5_14b"
MESHES = ((2, 2), (1, 4))
LARGE_MESH = (1, 4)
LARGE_RULES = {"ff2": "model"}
LOSS_RTOL = 1e-2      # bfloat16 compute: the loss over 4096 tokens of sums in another order
F32_LOSS_RTOL = 1e-5  # float32 at 2 layers
DELTA_RTOL = 1e-2     # each master's update in relative Frobenius distance (Adam's first steps are ~lr sign(g))
CARD_BYTES = 80e9
SEED, LR, WARMUP = 0, 3e-4, 2


def _cfg(arch: str, reduced: bool, **kw):
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return dataclasses.replace(cfg.reduced() if reduced else cfg, **kw)


def _steps(cfg, dev, mesh, rules, batches, keep_init: bool = False):
    """Train ``len(batches)`` steps from the seeded init, on ``mesh``
    (DTensors) or, with no mesh, on ``dev`` alone.  Returns (losses,
    seconds a step, masters on the host (whole), peak bytes, the initial
    masters on the host where ``keep_init``)."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.dist import sharding as sh
    from repro_torch.models import init_params, param_specs, reference_leaves
    from repro_torch.train import optim, step as step_lib

    ocfg = optim.OptConfig(lr=LR, warmup_steps=WARMUP, total_steps=10 * len(batches))
    init, _ = optim.make_optimizer(ocfg, cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(cfg, gen, device=dev)
    first = {n: t.detach().to("cpu", copy=True) for n, t in params.named_parameters()} if keep_init else None
    if mesh is not None:  # the states made on the shards: qwen2.5-14b's whole would not fit a card
        shard = sh.tree_shardings(param_specs(cfg), mesh, rules)
        layouts = {n: leaf.transposed for n, leaf in reference_leaves(cfg).items()}
        sh.distribute_module(params, shard)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        state = init(params)
        state = sh.distribute(state, sh.opt_state_shardings(shard, state, mesh, layouts))
    else:
        state = init(params)
    step = step_lib.make_train_step(cfg, ocfg)
    card = dev.type == "cuda"
    if card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    for b in batches:
        t0 = time.monotonic()
        if mesh is None:
            _, _, m = step(params, state, b)
        else:
            with sh.activation_context(mesh, rules):
                _, _, m = step(params, state, sh.distribute(b, sh.batch_shardings(b, mesh)))
        if card:
            torch.cuda.synchronize()
        secs.append(time.monotonic() - t0)
        losses.append(m["loss"].item())
    peak = torch.cuda.max_memory_allocated() if card else 0
    del state
    masters = {n: (t.full_tensor() if isinstance(t, DTensor) else t).detach().cpu()
               for n, t in params.named_parameters()}
    return losses, secs, masters, peak, first


def _rel_fro(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def reckon_large(args, batch: int) -> dict:
    """The dry run's reckoning of the large model's step on LARGE_MESH, in a
    subprocess (a fake world of that many ranks on the CPU)."""
    code = (
        "import json, sys\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "import torch.distributed as dist\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.dist import sharding as sh\n"
        "from repro_torch.launch import dryrun\n"
        "from repro_torch.launch.mesh import make_mesh_compat\n"
        "import dataclasses\n"
        "shape, rules, arch, mesh_shape, reduced, micro = json.loads(sys.argv[2])\n"
        "cfg = get_config(arch)\n"
        "cfg = dataclasses.replace(cfg.reduced() if reduced else cfg, microbatch=micro or cfg.microbatch)\n"
        "dryrun.start_fake_world(mesh_shape[0] * mesh_shape[1])\n"
        "mesh = make_mesh_compat(mesh_shape, ('data', 'model'), device='cpu')\n"
        "rec = dryrun.reckon(cfg, shape, mesh, sh.resolve_rules(mesh, rules))\n"
        "rec.pop('ops')\n"
        "dist.destroy_process_group()\n"
        "print(json.dumps(rec))\n")
    spec = json.dumps([{"seq_len": args.seq, "global_batch": batch, "kind": "train"}, LARGE_RULES, LARGE,
                       list(LARGE_MESH), args.reduced, 1 if batch == 1 else None])
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")  # the dry run touches no card
    r = subprocess.run([sys.executable, "-c", code, str(ROOT / "src"), spec], capture_output=True, text=True,
                       timeout=900, env=env)
    if r.returncode:
        raise SystemExit(f"sharded_train_torch: the dry run failed:\n{r.stderr[-3000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def rank_main(args) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.dist import sharding as sh
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.train import data as data_lib

    card = args.device == "cuda"
    if card:
        torch.cuda.set_device(args.rank)
        dev = torch.device("cuda", args.rank)
    else:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)  # each run reproducible, so the comparisons are of the sharding alone

    def batches(cfg, b):
        dcfg = data_lib.DataConfig(seed=SEED, vocab=cfg.vocab, seq_len=args.seq, global_batch=b)
        return [{k: v.to(dev) for k, v in data_lib.train_batch(dcfg, i).items()} for i in range(args.steps)]

    small = _cfg(SMALL, args.reduced)
    small32 = _cfg(SMALL, args.reduced, n_layers=2, dtype="float32")
    result = {"rank": args.rank}
    if args.rank == 0:  # the single-card steps, before the group starts
        for key, cfg in (("single", small), ("single_f32", small32)):
            losses, secs, masters, peak, first = _steps(cfg, dev, None, None, batches(cfg, args.batch),
                                                        keep_init=key == "single_f32")
            result[key] = {"losses": losses, "step_s": secs, "peak_bytes": peak}
            torch.save(masters, Path(args.out_dir, f"{key}.pt"))
            if first is not None:
                torch.save(first, Path(args.out_dir, "init_f32.pt"))
        if card:
            torch.cuda.empty_cache()
    dist.init_process_group("nccl" if card else "gloo", init_method=f"file://{args.store}", rank=args.rank,
                            world_size=args.ranks, timeout=datetime.timedelta(seconds=args.timeout))
    try:
        for shape in MESHES:
            mesh = make_mesh_compat(shape, ("data", "model"), device=args.device)
            rules = sh.resolve_rules(mesh)
            row = {}
            for key, cfg in (("bf16", small), ("f32", small32)):
                losses, secs, masters, peak, _ = _steps(cfg, dev, mesh, rules, batches(cfg, args.batch))
                row[key] = {"losses": losses, "step_s": secs, "peak_bytes": peak}
                if args.rank == 0:
                    torch.save(masters, Path(args.out_dir, f"mesh{shape[0]}x{shape[1]}_{key}.pt"))
                del masters
                if card:
                    torch.cuda.empty_cache()
            result[f"mesh{shape[0]}x{shape[1]}"] = row
        large = _cfg(LARGE, args.reduced)
        if args.large_batch == 1:  # one row does not split into the config's microbatches
            large = dataclasses.replace(large, microbatch=1)
        mesh = make_mesh_compat(LARGE_MESH, ("data", "model"), device=args.device)
        rules = sh.resolve_rules(mesh, LARGE_RULES)
        losses, secs, _, peak, _ = _steps(large, dev, mesh, rules, batches(large, args.large_batch))
        result["large"] = {"losses": losses, "step_s": secs, "peak_bytes": peak, "batch": args.large_batch}
    finally:
        dist.destroy_process_group()
        torch.use_deterministic_algorithms(deterministic)
    Path(args.out_dir, f"rank{args.rank}.json").write_text(json.dumps(result))


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"sharded_train_torch: check failed: {msg}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default; NCCL, one card a rank) or cpu (gloo)")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--reduced", action="store_true", help="the reduced configs (a CPU rehearsal)")
    ap.add_argument("--steps", type=int, default=3, help="steps a run; the first is its warm-up")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--timeout", type=int, default=600, help="seconds for the ranks and each collective")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "sharded_train.json"))
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out-dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--large-batch", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        rank_main(args)
        return {}

    import torch

    card = args.device == "cuda"
    if card and not torch.cuda.is_available():
        raise SystemExit("sharded_train_torch: no CUDA device is available; pass --device cpu")
    check(args.ranks == 4, "the meshes (2, 2) and (1, 4) need 4 ranks")
    summary = {"device": args.device, "ranks": args.ranks, "reduced": args.reduced, "batch": args.batch,
               "seq": args.seq, "steps": args.steps}
    if card:
        check(torch.cuda.device_count() >= args.ranks, f"{args.ranks} ranks need as many cards; "
              f"{torch.cuda.device_count()} here")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()
        print("\n".join(smi), flush=True)
        summary["cards"] = smi
    # the large model's peak, reckoned before any card is touched
    t0 = time.monotonic()
    rec = reckon_large(args, args.batch)
    peak = rec["memory"]["argument_bytes_per_device"] + rec["memory"]["temp_bytes_per_device"]
    large_batch = args.batch
    if peak > CARD_BYTES:
        large_batch = 1
        rec1 = reckon_large(args, 1)
        peak1 = rec1["memory"]["argument_bytes_per_device"] + rec1["memory"]["temp_bytes_per_device"]
        print(f"dry run: {LARGE} on {LARGE_MESH} reckons {peak / 1e9:.2f} GB a card at B = {args.batch} (over "
              f"{CARD_BYTES / 1e9:.0f} GB): the run takes B = 1 ({peak1 / 1e9:.2f} GB reckoned)", flush=True)
        summary["large_reckoned_b1"] = {"peak_bytes": peak1, "memory": rec1["memory"]}
    summary["large_reckoned"] = {"batch": args.batch, "peak_bytes": peak, "memory": rec["memory"],
                                 "dryrun_s": time.monotonic() - t0}
    print(f"dry run: {LARGE} on {LARGE_MESH} with rules {LARGE_RULES}: {rec['memory']['arguments']} bytes of "
          f"arguments a card, temp {rec['memory']['temp_bytes_per_device']}; reckoned peak {peak / 1e9:.2f} GB "
          f"a card at B = {args.batch}, S = {args.seq}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        common = [f"--{k}={v}" for k, v in (("device", args.device), ("ranks", args.ranks), ("steps", args.steps),
                                             ("batch", args.batch), ("seq", args.seq), ("timeout", args.timeout),
                                             ("large-batch", large_batch))]
        common += ["--reduced"] if args.reduced else []
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        if card:
            env.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # deterministic algorithms' cuBLAS workspace
            env.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")  # qwen2.5-14b fills a card
        t0 = time.monotonic()
        procs = [subprocess.Popen([sys.executable, __file__, *common, f"--rank={r}", f"--store={tmp}/store",
                                   f"--out-dir={tmp}"], env=env) for r in range(args.ranks)]
        try:
            for p in procs:
                p.wait(timeout=args.timeout)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        check(all(p.returncode == 0 for p in procs), f"rank exit codes {[p.returncode for p in procs]}")
        summary["wall_s"] = time.monotonic() - t0
        ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text()) for r in range(args.ranks)]
        single = {k: torch.load(Path(tmp, f"{k}.pt")) for k in ("single", "single_f32", "init_f32")}
        r0 = ranks[0]
        tokens = args.batch * args.seq
        print(f"{SMALL} on one card: losses {r0['single']['losses']}, {sum(r0['single']['step_s'][1:]) / (args.steps - 1):.4f} "
              f"s a warm step, peak {r0['single']['peak_bytes'] / 1e9:.2f} GB", flush=True)
        for shape in MESHES:
            name = f"mesh{shape[0]}x{shape[1]}"
            row = r0[name]
            for r in ranks:
                check(r[name]["bf16"]["losses"] == row["bf16"]["losses"], f"{name}: the ranks' losses differ")
            rel = max(abs(a - b) / abs(b) for a, b in zip(row["bf16"]["losses"], r0["single"]["losses"]))
            rel32 = max(abs(a - b) / abs(b) for a, b in zip(row["f32"]["losses"], r0["single_f32"]["losses"]))
            got32 = torch.load(Path(tmp, f"{name}_f32.pt"))
            init32 = single["init_f32"]
            delta = max(_rel_fro(got32[n] - init32[n], single["single_f32"][n] - init32[n]) for n in got32)
            warm = sum(row["bf16"]["step_s"][1:]) / (args.steps - 1)
            summary[name] = {"loss_rel": rel, "f32_loss_rel": rel32, "f32_delta_rel_fro_max": delta,
                             "warm_s_per_step": warm, "tokens_per_s": tokens / warm,
                             "peak_bytes": [r[name]["bf16"]["peak_bytes"] for r in ranks], "losses": row["bf16"]["losses"]}
            check(rel <= LOSS_RTOL, f"{name}: bfloat16 losses {row['bf16']['losses']} vs one card's "
                  f"{r0['single']['losses']} ({rel:.3g} > {LOSS_RTOL})")
            check(rel32 <= F32_LOSS_RTOL, f"{name}: float32 losses relative {rel32:.3g} > {F32_LOSS_RTOL}")
            check(delta <= DELTA_RTOL, f"{name}: float32 updates relative Frobenius {delta:.3g} > {DELTA_RTOL}")
            print(f"{SMALL} on {shape}: losses {row['bf16']['losses']} (one card's to {rel:.3g} relative, "
                  f"<= {LOSS_RTOL}); 2 layers in float32: losses to {rel32:.3g} (<= {F32_LOSS_RTOL}), every update "
                  f"to {delta:.3g} relative Frobenius (<= {DELTA_RTOL}); {warm:.4f} s a warm step, "
                  f"{tokens / warm:.0f} tokens/s, peak {max(summary[name]['peak_bytes']) / 1e9:.2f} GB a card",
                  flush=True)
        large = r0["large"]
        warm = sum(large["step_s"][1:]) / (args.steps - 1)
        finite = all(x == x and abs(x) != float("inf") for x in large["losses"])
        check(finite, f"{LARGE}: losses {large['losses']}")
        summary["large"] = {"losses": large["losses"], "batch": large["batch"], "warm_s_per_step": warm,
                            "tokens_per_s": large["batch"] * args.seq / warm,
                            "peak_bytes": [r["large"]["peak_bytes"] for r in ranks]}
        print(f"{LARGE} on {LARGE_MESH} with {LARGE_RULES}, B = {large['batch']}: losses {large['losses']}, "
              f"{warm:.4f} s a warm step, peak {max(summary['large']['peak_bytes']) / 1e9:.2f} GB a card "
              f"(reckoned {peak / 1e9:.2f} GB at B = {args.batch})", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(summary, indent=1))
    print(json.dumps({"ok": True, "ranks": args.ranks, "device": args.device}), flush=True)
    return summary


if __name__ == "__main__":
    main()
