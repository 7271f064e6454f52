"""engine.launches_per_step: device ops (kernels, copies, fills) in the
traced window per stencil step."""


def read(run):
    t, c = run.trace, run.counters
    if t is None or c["kind"] != "solve" or not c["steps"]:
        return None
    return t.launches() / c["steps"]
