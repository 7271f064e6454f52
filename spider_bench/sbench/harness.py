"""One run of one cell: set up, measure a window, read the metrics, check.

``run_cell`` builds the cell's stencil from its configuration and weights
drawn from the seed, hands set-up and the timed window to the traffic's
kind (``kinds/<kind>.py``), reads the memory peak once the window has
closed, frees the program's state, then compares the answers the window
kept with the plain reference and reads each metric the cell reports.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import check, trace
from .layout import Layout, readers


@dataclasses.dataclass
class Cell:
    """What a traffic kind gets: the cell's data and its seeded sources."""

    name: str
    seed: int
    device: torch.device
    dtype: torch.dtype
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    spec: Any                      # repro_torch's StencilSpec
    weights: np.ndarray            # the reference's own normalised weights
    reference: Any                 # the configuration's reference module
    control: Optional[str] = None  # a lower precision put in the program's place

    def rng(self, stream: int) -> np.random.Generator:
        """Host randomness of ``stream``, from the seed."""
        return np.random.default_rng(np.random.SeedSequence([self.seed, stream]))

    def generator(self, stream: int) -> torch.Generator:
        """A device generator of ``stream``, from the seed."""
        state = np.random.SeedSequence([self.seed, stream]).generate_state(
            1, np.uint64)[0]
        g = torch.Generator(device=self.device)
        g.manual_seed(int(state) >> 1)
        return g

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def span(self, name: str, on: bool):
        """A benchmark span around a call into a layer (traced runs only)."""
        return (torch.profiler.record_function(name) if on
                else contextlib.nullcontext())


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""

    cell: Cell
    setup_s: float
    counters: Dict[str, Any]
    trace: Optional[trace.Trace]


def make_cell(layout: Layout, workload: str, seed: int, device,
              overrides: Optional[dict] = None,
              control: Optional[str] = None) -> Cell:
    """The cell's data with ``overrides`` applied, and its stencil built
    from weights drawn from the seed: the program gets them through
    ``make_stencil``, the reference normalises its own copy."""
    from repro_torch.core.stencil import make_stencil
    overrides = overrides or {}
    w = layout.workload(workload)
    cfg = {**layout.config(w["config"]), **overrides.get("config", {})}
    mix = {**layout.traffic(w["traffic"]), **overrides.get("traffic", {})}
    ref = layout.reference(cfg["reference"])
    k = 2 * cfg["radius"] + 1
    raw = np.random.default_rng(np.random.SeedSequence([seed, 0])).uniform(
        0.1, 1.0, size=(k,) * cfg["ndim"])
    return Cell(name=workload, seed=seed, device=torch.device(device),
                dtype=getattr(torch, cfg["dtype"]), config=cfg, traffic=mix,
                spec=make_stencil(cfg["stencil"], cfg["ndim"], cfg["radius"],
                                  weights=raw),
                weights=ref.normalised_weights(raw, cfg["stencil"]),
                reference=ref, control=control)


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             traced: bool, *, device="cuda", overrides: Optional[dict] = None,
             control: Optional[str] = None,
             t_start: Optional[float] = None) -> Dict[str, Any]:
    """One run; returns the result line's fields, the checks last."""
    t0 = time.perf_counter() if t_start is None else t_start
    layout = Layout(root)
    cell = make_cell(layout, workload, seed, device, overrides, control)
    kind = importlib.import_module(f"{__package__}.kinds."
                                   f"{cell.traffic['kind']}")
    limits = layout.limits(workload)
    to_read = readers(layout, workload, traced)
    on_card = cell.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(cell.device)

    state = kind.setup(cell, seconds)
    cell.sync()
    setup_s = time.perf_counter() - t0
    tr = None
    if traced:
        tr, counters = trace.record(
            lambda: kind.window(cell, state, seconds, True), cell.device)
    else:
        counters = kind.window(cell, state, seconds, False)
    peak = torch.cuda.max_memory_allocated(cell.device) if on_card else 0

    pairs = kind.answers(cell, state)      # frees the program's state
    del state
    values = {name: check.worst(p) for name, p in pairs.items()}
    correct, checks = check.verdict(values, limits)
    correct = correct and counters["failed"] == 0

    run = Run(cell=cell, setup_s=setup_s, counters=counters, trace=tr)
    metrics = {}
    for m, read in to_read:
        v = read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info: Dict[str, Any] = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(cell.device) if on_card else "cpu",
        "count": 1, "memory_peak_bytes": peak}
    out: Dict[str, Any] = {"correct": correct,
                           "attempted": counters["attempted"],
                           "failed": counters["failed"], "metrics": metrics,
                           "device": device_info}
    if tr is not None:
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        out["breakdown"] = tr.breakdown(kind.SPANS)
        if not tr.lead_kept:
            out["trace_lost_head"] = True
    out["checks"] = checks
    return out
