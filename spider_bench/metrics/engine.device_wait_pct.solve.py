"""engine.device_wait_pct.solve: the share of the traced window in which no
device op ran while the host was inside one of repro_torch's engine spans
(``engine.*``: ``engine.iterate``, ``engine.apply``, ``engine.pad``).

Every idle gap of the window (``sbench.trace.gaps_ns``) is intersected with
the union of those spans; the rest of ``device.idle_pct.solve`` is idle
time with the host outside the port.  None where the program opens no
such span."""
from sbench.trace import gaps_ns

PREFIX = "engine."


def _merged(intervals):
    """The union of ``(start, end)`` intervals as sorted disjoint ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap_ns(a, b):
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(run):
    t = run.trace
    if t is None or run.counters["kind"] != "solve" or t.window_s <= 0:
        return None
    spans = _merged((s, e) for n, s, e in t.host_ops if n.startswith(PREFIX))
    if not spans:
        return None
    idle = gaps_ns(((s, e) for _, s, e in t.device_ops), t.window)
    return 100.0 * _overlap_ns(idle, spans) / (t.window[1] - t.window[0])
