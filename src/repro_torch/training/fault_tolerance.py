"""Fault tolerance: the step-time straggler watchdog and the
restart-survivable training loop.

The counterpart of ``repro/training/fault_tolerance.py``.  What it rests
on: atomic resumable checkpoints (``training/checkpoint.py``) and the
stateless step-seeded data (``training/data.py``), so a resumed job needs
only the step counter.  :class:`Supervisor` rebuilds its world and
restores the newest checkpoint whenever the fleet (the number of visible
CUDA devices, 1 without a card) changes.  Elastic re-meshing across a
changed device count waits for the port's sharding.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.training import checkpoint as ckpt


def fleet_size() -> int:
    """Visible CUDA devices, 1 on the CPU."""
    return torch.cuda.device_count() or 1


@dataclasses.dataclass
class Watchdog:
    """Step-time straggler detector (host-side, zero device overhead)."""
    straggler_factor: float = 2.0
    window: int = 50
    _times: List[float] = dataclasses.field(default_factory=list)

    def record(self, seconds: float) -> bool:
        """Record a step time; True if this step is a straggler outlier."""
        self._times.append(seconds)
        if len(self._times) > self.window:
            self._times.pop(0)
        if len(self._times) < 5:
            return False
        med = sorted(self._times)[len(self._times) // 2]
        return seconds > self.straggler_factor * med


def _tree(state: Any) -> Any:
    return state.tree() if hasattr(state, "tree") else state


def _restore(ckpt_dir: str, world: Dict) -> tuple:
    """The newest checkpoint restored into ``world``'s state (a
    ``TrainState`` or a plain tree) on ``world["device"]``."""
    state = world["state"]
    tree, extra = ckpt.restore(ckpt_dir, _tree(state),
                               device=world.get("device"))
    if hasattr(state, "tree"):
        tree = type(state).from_tree(tree)
    return tree, extra


@dataclasses.dataclass
class Supervisor:
    """Restart-survivable training driver.

    ``make_world()`` builds ``{"state", "step", "batch", "device"}`` for
    the CURRENT fleet: the state (a ``TrainState`` or a tree of tensors),
    ``step(state, batch) -> (state, metrics)``, ``batch(step)`` and the
    device to restore onto.  On a fleet change the loop rebuilds the world
    and restores the newest checkpoint into it.
    """
    ckpt_dir: str
    make_world: Callable[[], Dict]
    save_every: int = 100
    keep: int = 3

    def run(self, total_steps: int, step_fn_key: str = "step",
            on_metrics: Optional[Callable] = None) -> Dict:
        world = self.make_world()
        saver = ckpt.AsyncCheckpointer(self.ckpt_dir, keep=self.keep)
        state = world["state"]
        start = ckpt.latest_step(self.ckpt_dir)
        if start is not None:
            state, extra = _restore(self.ckpt_dir, world)
            start = int(extra.get("step", start))
        else:
            start = 0
        wd = Watchdog()
        n_devices = fleet_size()
        step = start
        while step < total_steps:
            if fleet_size() != n_devices:           # fleet change
                saver.wait()
                world = self.make_world()
                state, extra = _restore(self.ckpt_dir, world)
                step = int(extra.get("step", step))
                n_devices = fleet_size()
            t0 = time.monotonic()
            state, metrics = world[step_fn_key](state, world["batch"](step))
            float(next(iter(metrics.values())))     # waits for the step
            if wd.record(time.monotonic() - t0):
                metrics = dict(metrics)
                metrics["straggler_flag"] = True
            if on_metrics:
                on_metrics(step, metrics)
            step += 1
            if step % self.save_every == 0 or step == total_steps:
                saver.save(step, _tree(state), extra={"step": step})
        saver.wait()
        return {"state": state, "final_step": step}
