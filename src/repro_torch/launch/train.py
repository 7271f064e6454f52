"""Training launcher: the end-to-end driver over the host mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --smoke --device cpu --steps 200 --batch 8 --seq 128 \\
        --ckpt-dir /tmp/run1

    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --arch qwen3-1.7b --smoke --device cpu --steps 20

The counterpart of ``repro/launch/train.py``, with the same flags and
printout plus ``--device`` (default: the card) and ``--dtype`` (default:
the config's).  The state is laid out on ``launch.mesh.make_host_mesh``'s
``("data",)`` mesh: the ranks ``torchrun`` started (``gloo`` on the CPU,
``nccl`` on the cards, one card per rank), or this process alone, a mesh
of one rank.  There is one path, whatever the number of ranks: DTensor
parameters and optimizer state laid out by ``param_shardings`` (every
parameter replicated: the rules keep no FSDP split and the mesh has no
'model' axis), each step's tokens split over 'data', and the gradients
all-reduced by DTensor.  Only rank 0 prints.  Restart the same command
after a kill: it resumes from the newest atomic checkpoint under
``--ckpt-dir`` (and takes no step when that checkpoint is at ``--steps``);
a checkpoint holds full arrays, so it restores on any number of ranks.
Weights are random, drawn from seed 0 on every rank alike; batches are the
step-seeded synthetic tokens of ``training/data.py``.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.registry import get_config
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (NamedSharding, default_rules,
                                              distribute, is_dtensor,
                                              param_shardings, use_mesh_rules)
from repro_torch.launch import mesh as MS
from repro_torch.models import model as M
from repro_torch.models.nn import count_params, tree_map
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


def full(x):
    """``x`` whole on this rank: a DTensor gathered (a collective), any
    other value as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def host_rules():
    """The host mesh's rules: data parallel, no FSDP split of the
    parameters (the reference's ``make_world`` rules)."""
    return default_rules(fsdp=False, multi_pod=False)


def mesh_step(cfg, tc: TrainConfig, mesh) -> Callable:
    """``step(state, tokens) -> (state, metrics)``: the train step of a
    state laid out on ``mesh``, under ``use_mesh_rules`` with
    :func:`host_rules`, its metrics gathered whole."""
    from torch.distributed.tensor.experimental import implicit_replication
    rules = host_rules()

    def step(state: TrainState, tokens):
        with use_mesh_rules(mesh, rules), implicit_replication():
            state, m = train_step(cfg, tc, state, tokens)
        return state, {k: full(v) for k, v in m.items()}
    return step


def make_world(cfg, tc: TrainConfig, dc: data.DataConfig, mesh
               ) -> Dict[str, Any]:
    """Mesh-bound state, step and batch function for the present fleet
    (``repro/launch/train.py:31-62``): ``state`` (DTensors laid out by
    ``state_shardings``: ``mu``, ``nu`` and ``master`` as the params,
    ``step`` replicated), ``step(state, tokens)`` (:func:`mesh_step`),
    ``batch(step)`` (``data.sharded_batch``) and ``mesh``.  Every rank
    draws the same weights from seed 0 and keeps its own shard: no rank
    sends weights."""
    rules = host_rules()
    p_shapes, p_axes = M.init_params(cfg, device="meta", with_axes=True)
    psh = param_shardings(p_axes, p_shapes, rules, mesh)
    st_sh = TrainState(params=psh, opt=O.OptState(
        step=NamedSharding(mesh, ()), mu=psh, nu=psh, master=psh))
    device = resolve_device(mesh.device_type)
    gen = torch.Generator(device=device).manual_seed(0)
    state = TrainState.from_tree(tree_map(
        distribute, init_state(cfg, gen, device=device).tree(),
        st_sh.tree()))

    def batch(s: int):
        with use_mesh_rules(mesh, rules):
            return data.sharded_batch(dc, s, mesh)

    return {"state": state, "state_shardings": st_sh,
            "step": mesh_step(cfg, tc, mesh), "batch": batch, "mesh": mesh}


def main(argv=None, on_metrics: Optional[Callable] = None) -> TrainState:
    """Train as the flags say over the host mesh; returns the final state.
    ``on_metrics(step, metrics, seconds)`` is called after every step with
    its metrics (0-d tensors, whole) and its host time, synchronised.

    The process group is the caller's when one is alive (the state then
    comes back as the DTensors it trained, on the caller's mesh), else
    this call's own: it is released before the return, and the state
    comes back whole, as plain tensors on this rank's device."""
    args = parse_args(argv)
    own = not dist.is_initialized()
    mesh = MS.make_host_mesh(args.device)
    try:
        state = _train(args, mesh, on_metrics)
        if own:
            state = TrainState.from_tree(tree_map(full, state.tree()))
    finally:
        if own:
            MS.release()
    return state


def _train(args: argparse.Namespace, mesh, on_metrics) -> TrainState:
    cfg, tc, dc = configs(args)
    world = make_world(cfg, tc, dc, mesh)
    state = world.pop("state")
    rank0 = dist.get_rank() == 0

    def say(line: str) -> None:
        if rank0:
            print(line, flush=True)
    say(f"arch={cfg.name} params={count_params(state.params):,} "
        f"devices={mesh.size()}")

    start = 0
    saver = None
    if args.ckpt_dir:
        saver = ckpt.AsyncCheckpointer(args.ckpt_dir)
        last = ckpt.latest_step(args.ckpt_dir)
        if last is not None:
            sh = world["state_shardings"]
            tree, extra = ckpt.restore(
                args.ckpt_dir, state.tree(),
                shardings={"params": sh.params, "opt": sh.opt._asdict()})
            state = TrainState.from_tree(tree)
            start = int(extra["step"])
            say(f"resumed from step {start}")

    wd = Watchdog()
    t_start = time.monotonic()
    for step in range(start, args.steps):
        t0 = time.monotonic()
        state, m = world["step"](state, world["batch"](step))
        loss = float(m["loss"])
        dt_step = time.monotonic() - t0
        straggle = wd.record(dt_step)
        if on_metrics:
            on_metrics(step, m, dt_step)
        if step % args.log_every == 0 or step == args.steps - 1:
            say(f"step {step:5d} loss {loss:.4f} "
                f"gnorm {float(m['grad_norm']):.3f} "
                f"lr {float(m['lr']):.2e} {dt_step*1e3:.0f}ms"
                + (" STRAGGLER" if straggle else ""))
        if saver and (step + 1) % args.ckpt_every == 0:
            saver.save(step + 1, state.tree(), extra={"step": step + 1})
    if saver and start < args.steps:
        saver.save(args.steps, state.tree(), extra={"step": args.steps})
    if saver:
        saver.wait()
    say(f"done in {time.monotonic()-t_start:.1f}s")
    return state


if __name__ == "__main__":
    main()
