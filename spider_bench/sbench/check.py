"""The comparison that decides ``correct``.

Each number compared is the widest gap between an answer of the timed path
and the plain reference's answer for the same input, over the field's
largest magnitude: ``max|y - ref| / max|ref|``.  The limits of a cell are
data (``limits/<workload>.json``), each set between the readings of sound
runs and of the lower-precision control (PERF.md gives both).
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch


def rel_err(y: torch.Tensor, ref: torch.Tensor) -> float:
    """``max|y - ref| / max|ref|``, in float64; inf if the shapes differ."""
    if tuple(y.shape) != tuple(ref.shape):
        return float("inf")
    ref = ref.to(torch.float64)
    gap = (y.to(torch.float64) - ref).abs().max()
    scale = ref.abs().max()
    return float(gap / scale) if float(scale) > 0 else float(gap)


def verdict(values: Dict[str, float], limits: Dict[str, dict]
            ) -> Tuple[bool, Dict[str, dict]]:
    """Every limited number within its limit; a number with no reading
    (no answer was compared) fails."""
    checks, ok = {}, True
    for name, lim in limits.items():
        v = values.get(name)
        checks[name] = {"value": v, "limit": lim["limit"]}
        ok = ok and v is not None and v <= lim["limit"]
    return ok, checks


def worst(pairs: Iterable[Tuple[torch.Tensor, torch.Tensor]]) -> float | None:
    """The largest ``rel_err`` over ``(answer, reference)`` pairs."""
    errs = [rel_err(y, r) for y, r in pairs]
    return max(errs) if errs else None
