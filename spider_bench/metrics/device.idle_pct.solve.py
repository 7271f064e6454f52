"""device.idle_pct.solve: the share of the traced window in which no device op
ran, from the union of the device ops' intervals."""


def read(run):
    t = run.trace
    if t is None or run.counters["kind"] != "solve" or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
