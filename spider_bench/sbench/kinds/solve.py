"""Traffic kind ``solve``: one grid time-stepped in a closed loop.

A PDE user's time loop: the window repeats ``u = entry.iterate(u, chunk)``
and synchronises after each chunk only to read the clock.  The rate is
interior points times steps completed over the time from the first
dispatch to the final synchronise.

Parameters (``traffic/<name>.json``):
  entry            "engine" (``StencilEngine(spec, backend=...)``) or
                   "tuned" (``tuned_engine(spec, shape, mode=tuner_mode)``)
  backend          the engine's backend, for "engine"
  tuner_mode       the tuner's mode, for "tuned"
  steps_per_chunk  steps per ``iterate`` call
  temporal_steps   steps per engine call (the grid then carries k*r of halo)
  warmup_chunks    chunks run in set-up
  sampled_chunks   chunks of the window whose input and output are kept
                   for the check: the first, and the rest drawn from the seed
"""
from __future__ import annotations

import math
import time
import types

import torch
import torch.nn.functional as F

SPANS = ("solve.chunk",)


class _Control:
    """The reference in a lower precision, put in the program's place."""

    def __init__(self, cell, k: int):
        self.cell, self.k = cell, k

    def iterate(self, u: torch.Tensor, steps: int) -> torch.Tensor:
        return self.cell.reference.iterate(
            self.cell.weights, u, steps, self.k,
            precision=self.cell.control).to(u.dtype)


def _entry(cell, grid, k: int):
    mix = cell.traffic
    if cell.control:
        return _Control(cell, k)
    if mix["entry"] == "engine":
        from repro_torch.core.engine import StencilEngine
        return StencilEngine(cell.spec, backend=mix["backend"],
                             temporal_steps=k, device=cell.device,
                             dtype=cell.dtype)
    if mix["entry"] == "tuned":
        from repro_torch.tuner import tuned_engine
        return tuned_engine(cell.spec, grid, cell.dtype, device=cell.device,
                            mode=mix["tuner_mode"], temporal_steps=k)
    raise ValueError(f"unknown solve entry {mix['entry']!r}")


def setup(cell, seconds: float):
    mix = cell.traffic
    k = mix.get("temporal_steps", 1)
    halo = k * cell.config["radius"]
    grid = tuple(cell.config["grid"])
    interior = tuple(g - 2 * halo for g in grid)
    u0 = F.pad(torch.randn(interior, generator=cell.generator(1),
                           device=cell.device).to(cell.dtype),
               (halo,) * (2 * len(grid)))
    entry = _entry(cell, grid, k)
    chunk = mix["steps_per_chunk"]
    u, chunk_s = u0, None
    for _ in range(mix["warmup_chunks"]):
        t = time.perf_counter()
        u = entry.iterate(u, chunk)
        cell.sync()
        chunk_s = time.perf_counter() - t
    del u
    # the first chunk starts from u0; the others are drawn from the chunks
    # the window is expected to reach, judged by the last warm-up chunk
    expect = max(2, int(0.8 * seconds / chunk_s)) if chunk_s else 2
    drawn = 1 + cell.rng(3).choice(
        expect - 1, size=min(mix["sampled_chunks"] - 1, expect - 1),
        replace=False)
    snaps = {int(i): (torch.empty_like(u0), torch.empty_like(u0))
             for i in [0, *drawn]}
    return types.SimpleNamespace(entry=entry, u0=u0, chunk=chunk, k=k,
                                 grid=grid, interior=interior, snaps=snaps,
                                 reached=0)


def window(cell, st, seconds: float, spans: bool) -> dict:
    entry, chunk, snaps = st.entry, st.chunk, st.snaps
    u = st.u0
    n = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        with cell.span("solve.chunk", spans):
            snap = snaps.get(n)
            if snap is not None:
                snap[0].copy_(u)
            u = entry.iterate(u, chunk)
            if snap is not None:
                snap[1].copy_(u)
            cell.sync()
        n += 1
        t = time.perf_counter()
        if t >= deadline:
            break
    st.reached = n
    return {"kind": "solve", "steps": n * chunk, "chunks": n,
            "elapsed_s": t - t0, "temporal_steps": st.k,
            "grid_points": math.prod(st.grid),
            "interior_points": math.prod(st.interior),
            "itemsize": st.u0.element_size(), "attempted": n * chunk,
            "failed": 0}


def answers(cell, st) -> dict:
    """The kept chunks, each beside the reference's run of the same steps
    from the same input; the program's engine is freed first."""
    st.entry = None
    kept = [snap for i, snap in sorted(st.snaps.items()) if i < st.reached]
    st.snaps = None
    ref = cell.reference

    def pairs():
        for x, y in kept:
            yield y, ref.iterate(cell.weights, x, st.chunk, st.k)
    return {"chunk_rel_err": pairs()}
