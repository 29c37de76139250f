"""Training launcher: data pipeline -> microbatched train_step -> async
checkpoints -> crash-restart supervision.

A port of ``repro/launch/train.py`` with an explicit ``--device`` (the
card by default; ``--device cpu`` runs every kernel's plain version).
``--reduced`` trains a small config of the same family in minutes on
the CPU:

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
      --reduced --steps 200 --ckpt-dir ckpts/run1 --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.ckpt import CheckpointManager, available_steps
from repro_torch.configs import RunConfig, get_config, reduced
from repro_torch.data.lm import LMDataPipeline
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as model_lib
from repro_torch.optim import adamw
from repro_torch.runtime.ft import StragglerDetector, TrainSupervisor
from repro_torch.sharding.rules import ShardingContext


def build(cfg, run: RunConfig, seq_len: int, global_batch: int,
          device="cuda"):
    """(state, data, step_fn): parameters drawn from ``run.seed`` in the
    config's dtype, their float32 training state on ``device``, the data
    pipeline and the train step."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(run.seed)
    params = model_lib.init_params(cfg, gen, device)
    state = adamw.init_train_state(params, run.grad_compression)
    del params
    data = LMDataPipeline(cfg.vocab, seq_len, global_batch, seed=run.seed,
                          microbatches=run.microbatches)
    step_fn = make_train_step(cfg, run, ShardingContext())
    return state, data, step_fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg, n_layers=2, d_model=128, vocab=256, seq=args.seq)
    run = RunConfig(microbatches=args.microbatches, learning_rate=args.lr,
                    warmup_steps=max(10, args.steps // 10),
                    total_steps=args.steps, remat="none",
                    grad_compression=args.grad_compression,
                    checkpoint_every=args.ckpt_every)
    state, data, step_fn = build(cfg, run, args.seq, args.batch, args.device)
    mgr = CheckpointManager(args.ckpt_dir, run.keep_checkpoints) \
        if args.ckpt_dir else None

    start = 0
    if args.resume and mgr and available_steps(args.ckpt_dir):
        state, extra = mgr.restore_latest(state)
        data.load_state_dict(extra["data"])
        start = int(extra["step"])
        print(f"[train] resumed from step {start}")

    holder = {"state": state}
    straggler = StragglerDetector(["host0"])
    losses = []

    def one_step(i):
        t0 = time.perf_counter()
        holder["state"], metrics = step_fn(holder["state"], data.next_batch())
        loss = float(metrics["loss"])
        losses.append(loss)
        straggler.record("host0", time.perf_counter() - t0)
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"[train] step={i:5d} loss={loss:.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"({time.perf_counter() - t0:.2f}s)", flush=True)
        if mgr and (i + 1) % run.checkpoint_every == 0:
            mgr.save(i + 1, holder["state"],
                     {"step": i + 1, "data": data.state_dict()})

    def restore():
        if not mgr:
            raise RuntimeError("no checkpoint dir: cannot restart")
        holder["state"], extra = mgr.restore_latest(holder["state"])
        data.load_state_dict(extra["data"])
        return int(extra["step"])

    sup = TrainSupervisor(one_step, restore, args.steps)
    report = sup.run(start)
    if mgr:
        mgr.save(args.steps, holder["state"],
                 {"step": args.steps, "data": data.state_dict()},
                 blocking=True)
    print(f"[train] done: {report.steps_run} steps, "
          f"{report.restarts} restarts; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
