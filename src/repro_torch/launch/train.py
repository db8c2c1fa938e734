"""Training launcher, the port of ``repro/launch/train.py``: real steps on
one device or sharded over the host mesh, the full fault-tolerance loop.

  * --arch <id> reduced or full configs of any decoder family (the
    transformers, mamba2_780m, recurrentgemma_2b), synthetic
    deterministic data
  * checkpoint/auto-resume (atomic commit, async save)
  * --preempt-after N: a hard exit (code 42) after N steps; a relaunch
    resumes bit-exact from the last checkpoint (the data pipeline is
    (seed, step)-pure)
  * straggler detection log (metrics.StepTimer)
  * --device: ``cuda`` by default, which raises without a card; ``cpu``
    when asked for
  * under ``torchrun`` (``WORLD_SIZE`` in the environment) the process
    group starts from the environment (NCCL on the card, gloo where
    ``--device cpu`` is given), each rank on its own card
    (``LOCAL_RANK``), and the step runs sharded as the reference's
    (:57-68): the host mesh (``make_host_mesh()``: every rank on ``data``), the
    resolved rules and an activation context; the parameters, optimizer
    states and batches are DTensors placed by ``dist.sharding``, rank 0
    prints and writes the checkpoints, and a restart re-distributes them
    onto its own mesh.  Without ``torchrun`` the single-process path runs
    as before.

Bit-exact resume needs run-to-run determinism, so the loop runs under
``torch.use_deterministic_algorithms(True)`` (restored on return), with
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set before cuBLAS starts when the
caller has not set it.

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_1_5b --reduced \\
      --steps 30 --ckpt-dir /tmp/ckpt --ckpt-every 10 --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch qwen2_1_5b --reduced --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.dist import sharding as shardlib
from repro_torch.engine.plan import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import get_model, init_params, param_specs, reference_leaves
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import data as data_lib
from repro_torch.train import metrics as metrics_lib
from repro_torch.train import optim as optim_mod
from repro_torch.train.step import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log", default=None)
    ap.add_argument("--preempt-after", type=int, default=0,
                    help="simulate preemption: hard-exit after N steps")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    started = False
    try:
        if "WORLD_SIZE" in os.environ and not dist.is_initialized():
            if dev.type == "cuda":
                dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
                torch.cuda.set_device(dev)
            dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
            started = True
        return _run(args, dev)
    finally:
        if started:
            dist.destroy_process_group()
        torch.use_deterministic_algorithms(deterministic)


class _Sharded:
    """The host mesh, its resolved rules and every placement of the run."""

    def __init__(self, cfg, dev: torch.device):
        self.mesh = make_host_mesh(device=dev.type)
        self.rules = shardlib.resolve_rules(self.mesh)
        self.params = shardlib.tree_shardings(param_specs(cfg), self.mesh, self.rules)
        self.layouts = {n: leaf.transposed for n, leaf in reference_leaves(cfg).items()}

    def state(self, opt_state: dict) -> dict:
        return {"params": self.params,
                "opt": shardlib.opt_state_shardings(self.params, opt_state, self.mesh, self.layouts)}

    def batch(self, batch: dict) -> dict:
        return shardlib.distribute(batch, shardlib.batch_shardings(batch, self.mesh))


def _run(args, dev: torch.device) -> list[float]:
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, microbatch=1)

    opt_cfg = optim_mod.OptConfig(
        lr=args.lr, warmup_steps=max(2, args.steps // 10),
        total_steps=args.steps, state_dtype=cfg.optimizer_state_dtype,
    )
    opt_init, _ = optim_mod.make_optimizer(opt_cfg, cfg)
    train_step = make_train_step(cfg, opt_cfg)

    dcfg = data_lib.DataConfig(
        seed=args.seed, vocab=cfg.vocab, seq_len=args.seq_len,
        global_batch=args.global_batch,
    )

    sharded = _Sharded(cfg, dev) if dist.is_initialized() else None
    lead = not dist.is_initialized() or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    context = (lambda: shardlib.activation_context(sharded.mesh, sharded.rules)) if sharded else contextlib.nullcontext

    start_step = 0
    if args.ckpt_dir and ckpt_lib.latest_step(args.ckpt_dir) is not None:
        shardings = None
        if sharded:  # the placements of a fresh state of this run's shapes
            shardings = sharded.state(opt_init(get_model(cfg).skeleton(cfg)))
        state, start_step = ckpt_lib.restore(args.ckpt_dir, shardings=shardings, device=dev)
        params = get_model(cfg).skeleton(cfg)
        params.load_state_dict(state["params"], assign=True, strict=True)
        opt_state = state["opt"]
        say(f"[resume] from step {start_step}", flush=True)
    else:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
        if sharded:  # the states made on the shards, not on the whole parameters
            shardlib.distribute_module(params, sharded.params)
        opt_state = opt_init(params)
        if sharded:
            opt_state = shardlib.distribute(opt_state, sharded.state(opt_state)["opt"])

    def snapshot():
        return {"params": dict(params.named_parameters()), "opt": opt_state}

    logger = metrics_lib.JsonlLogger(args.log if lead else None)
    timer = metrics_lib.StepTimer()
    losses = []
    for step in range(start_step, args.steps):
        batch = {k: v.to(dev) for k, v in data_lib.train_batch(dcfg, step).items()}
        if sharded:
            batch = sharded.batch(batch)
        with timer:
            with context():
                params, opt_state, m = train_step(params, opt_state, batch)
            loss = float(m["loss"])
        losses.append(loss)
        logger.log(step, loss=loss, lr=m["lr"], grad_norm=m["grad_norm"],
                   step_time=timer.last, straggler=timer.is_straggler)
        if step % 5 == 0 or step == args.steps - 1:
            say(f"step {step}: loss {loss:.4f} ({timer.last:.2f}s)", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt_lib.save(args.ckpt_dir, step + 1, snapshot(), blocking=False, meta={"arch": args.arch})
        if args.preempt_after and (step + 1 - start_step) >= args.preempt_after:
            ckpt_lib.wait_pending()
            if dist.is_initialized():
                dist.barrier()  # rank 0's checkpoint is on disk before any rank exits
            say(f"[preempt] hard exit at step {step + 1}", flush=True)
            os._exit(42)

    ckpt_lib.wait_pending()
    if args.ckpt_dir:
        ckpt_lib.save(args.ckpt_dir, args.steps, snapshot())
    logger.close()
    say(f"final loss: {losses[-1]:.4f} (first: {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
