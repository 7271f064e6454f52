"""gstencil_per_s: interior points times steps completed in the window, over
the time from its first dispatch to its final synchronise (host clock)."""


def read(run):
    c = run.counters
    if c["kind"] != "solve":
        return None
    return c["interior_points"] * c["steps"] / c["elapsed_s"] / 1e9
