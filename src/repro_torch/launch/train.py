"""Training launcher: the end-to-end driver on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --smoke --device cpu --steps 200 --batch 8 --seq 128 \\
        --ckpt-dir /tmp/run1

The counterpart of ``repro/launch/train.py``, with the same flags and
printout plus ``--device`` (default: the card) and ``--dtype`` (default:
the config's).  It runs the single-device path: the reference's mesh and
parameter shardings wait for the port's sharding.  Restart the same
command after a kill: it resumes from the newest atomic checkpoint under
``--ckpt-dir`` (and takes no step when that checkpoint is at ``--steps``).
Weights are random, drawn from seed 0 on the device; batches are the
step-seeded synthetic tokens of ``training/data.py``.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import torch

from repro_torch.configs.registry import get_config
from repro_torch.device import resolve_device
from repro_torch.models.nn import count_params
from repro_torch.training import (TrainConfig, TrainState, checkpoint as ckpt,
                                  data, init_state, optimizer as O)
from repro_torch.training.fault_tolerance import Watchdog
from repro_torch.training.train_step import train_step


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default=None,
                    help="parameter and activation dtype (default: the "
                         "config's)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain torch path)")
    return ap.parse_args(argv)


def configs(args: argparse.Namespace):
    """``(ModelConfig, TrainConfig, DataConfig)`` of the parsed flags."""
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.dtype:
        cfg = cfg.scaled(dtype=args.dtype)
    tc = TrainConfig(microbatches=args.microbatches,
                     opt=O.OptConfig(lr=args.lr, warmup_steps=20,
                                     total_steps=args.steps))
    dc = data.DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                         global_batch=args.batch)
    return cfg, tc, dc


def main(argv=None, on_metrics: Optional[Callable] = None) -> TrainState:
    """Train as the flags say; returns the final state.  ``on_metrics(step,
    metrics, seconds)`` is called after every step with its metrics (0-d
    tensors) and its host time, synchronised."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg, tc, dc = configs(args)
    state = init_state(cfg, 0, device=device)
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    print(f"arch={cfg.name} params={count_params(state.params):,} "
          f"devices={n_dev}")

    start = 0
    saver = None
    if args.ckpt_dir:
        saver = ckpt.AsyncCheckpointer(args.ckpt_dir)
        last = ckpt.latest_step(args.ckpt_dir)
        if last is not None:
            tree, extra = ckpt.restore(args.ckpt_dir, state.tree(),
                                       device=device)
            state = TrainState.from_tree(tree)
            start = int(extra["step"])
            print(f"resumed from step {start}")

    wd = Watchdog()
    t_start = time.monotonic()
    for step in range(start, args.steps):
        t0 = time.monotonic()
        state, m = train_step(cfg, tc, state,
                              data.device_batch(dc, step, device))
        loss = float(m["loss"])
        dt_step = time.monotonic() - t0
        straggle = wd.record(dt_step)
        if on_metrics:
            on_metrics(step, m, dt_step)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(m['grad_norm']):.3f} "
                  f"lr {float(m['lr']):.2e} {dt_step*1e3:.0f}ms"
                  + (" STRAGGLER" if straggle else ""), flush=True)
        if saver and (step + 1) % args.ckpt_every == 0:
            saver.save(step + 1, state.tree(), extra={"step": step + 1})
    if saver and start < args.steps:
        saver.save(args.steps, state.tree(), extra={"step": args.steps})
    if saver:
        saver.wait()
    print(f"done in {time.monotonic()-t_start:.1f}s")
    return state


if __name__ == "__main__":
    main()
