"""The traced run: ``torch.profiler`` over the measured window, reduced to
device-op intervals and host spans.

The window is one host span (``WINDOW_SPAN``) around the traffic's timed
loop.  Short marker spins run on the stream before it and after it, so a
trace that lost its head (the profiler has been seen to drop the first
events of a trace) shows it: ``lead_kept`` is False then.  Device ops are
kernels, copies and fills; the profiler's device-side copies of host
annotations are not work and are left out.  Everything is read from the
raw event list, not the profiler's event tree, because a window holds
hundreds of thousands of events.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

WINDOW_SPAN = "bench.window"
MARKER = "spin_kernel"              # torch.cuda._sleep's kernel
LEAD_SPINS = 16
SPIN_CYCLES = 2_000
TOP = 10


def short_name(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    name = name.removeprefix("void ")
    cut = name.find("(")
    return (name[:cut] if cut > 0 else name)[:120]


def union_ns(intervals: Iterable[Tuple[int, int]]) -> int:
    """Length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps_ns(intervals: Iterable[Tuple[int, int]],
            window: Tuple[int, int]) -> List[Tuple[int, int]]:
    """The stretches of ``window`` that no interval covers."""
    out, cursor = [], window[0]
    for s, e in sorted(intervals):
        if s > cursor:
            out.append((cursor, min(s, window[1])))
        cursor = max(cursor, e)
        if cursor >= window[1]:
            break
    if cursor < window[1]:
        out.append((cursor, window[1]))
    return [(s, e) for s, e in out if e > s]


@dataclasses.dataclass
class Trace:
    """What the traced window holds, times in ns of the profiler's clock."""

    window: Tuple[int, int]
    device_ops: List[Tuple[str, int, int]]      # (name, start, end)
    host_ops: List[Tuple[str, int, int]]        # (name, start, end)
    lead_kept: bool = True

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def busy_s(self) -> float:
        """Seconds of the window in which some device op ran."""
        return union_ns((s, e) for _, s, e in self.device_ops) / 1e9

    def device_s(self) -> float:
        """Summed device-op time (overlapping ops counted each)."""
        return sum(e - s for _, s, e in self.device_ops) / 1e9

    def kernel_s(self, names: Sequence[str]) -> float:
        """Summed time of the device ops whose name holds one of ``names``."""
        return sum(e - s for n, s, e in self.device_ops
                   if any(k in n for k in names)) / 1e9

    def launches(self) -> int:
        return len(self.device_ops)

    def breakdown(self, spans: Sequence[str]) -> Dict[str, list]:
        """The device ops that took most time, and the longest idle gaps,
        each labelled by the benchmark spans (``spans``) and the innermost
        other host op that were open at its middle."""
        by_name: Dict[str, float] = {}
        for n, s, e in self.device_ops:
            key = short_name(n)
            by_name[key] = by_name.get(key, 0.0) + (e - s) / 1e9
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(gaps_ns(((s, e) for _, s, e in self.device_ops),
                              self.window),
                      key=lambda g: g[0] - g[1])[:TOP]
        return {"device_ops": [[n, v] for n, v in top],
                "idle_gaps": [[self._label(s, e, spans), (e - s) / 1e9]
                              for s, e in gaps]}

    def _label(self, start: int, end: int, spans: Sequence[str]) -> str:
        """What the host was in at the gap's middle, and where the gap
        starts in the window."""
        t = (start + end) // 2
        open_spans, inner = set(), None
        for n, s, e in self.host_ops:
            if s <= t < e and n != WINDOW_SPAN:
                if n in spans:
                    open_spans.add(n)
                elif inner is None or s > inner[1]:
                    inner = (n, s)
        parts = sorted(open_spans) + ([inner[0]] if inner else [])
        at = (start - self.window[0]) / 1e9
        return f"{' > '.join(parts) if parts else 'host'} at {at:.3f} s"


def reduce_events(events) -> Trace:
    """A :class:`Trace` from the profiler's raw events (``_KinetoEvent``).

    A host annotation (a ``record_function`` span) also appears on the
    device's timeline, spanning its kernels; such a copy is left out by
    its flag and, where a build of torch does not flag it, by its name."""
    from torch.autograd import DeviceType
    events = list(events)
    spans = {ev.name() for ev in events
             if ev.device_type() != DeviceType.CUDA and ev.is_user_annotation()}
    window: Optional[Tuple[int, int]] = None
    dev, host, marks = [], [], []
    for ev in events:
        name = ev.name()
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            if ev.is_user_annotation() or name in spans:
                continue
            if MARKER in name:
                marks.append(s)
                continue
            dev.append((name, s, e))
        else:
            if name == WINDOW_SPAN:
                window = (s, e)
            host.append((name, s, e))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    dev = [(n, max(s, window[0]), min(e, window[1])) for n, s, e in dev
           if e > window[0] and s < window[1]]
    host = [(n, s, e) for n, s, e in host
            if e > window[0] and s < window[1]]
    return Trace(window=window, device_ops=dev, host_ops=host,
                 lead_kept=any(s < window[0] for s in marks))


def record(fn: Callable[[], object], device) -> Tuple[Trace, object]:
    """Run ``fn`` (the timed loop, which ends synchronised) under the
    profiler inside the window span; returns its trace and result."""
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    with warnings.catch_warnings(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        warnings.filterwarnings("ignore", message=".*clears events")
        with torch.cuda.device(device):
            for _ in range(LEAD_SPINS):
                torch.cuda._sleep(SPIN_CYCLES)
        torch.cuda.synchronize(device)
        with record_function(WINDOW_SPAN):
            out = fn()
        with torch.cuda.device(device):
            torch.cuda._sleep(SPIN_CYCLES)
        torch.cuda.synchronize(device)
    return reduce_events(prof.profiler.kineto_results.events()), out
