"""engine.host_us_per_step.solve: the host's time to dispatch one step, in us:
the summed duration of the traced window's ``engine.iterate`` spans
(repro_torch's ``StencilEngine.iterate``) over the window's steps.

None where the program opens no such span."""
SPAN = "engine.iterate"


def read(run):
    t, c = run.trace, run.counters
    if t is None or c["kind"] != "solve" or not c["steps"]:
        return None
    ns = [e - s for n, s, e in t.host_ops if n == SPAN]
    if not ns:
        return None
    return sum(ns) / 1e3 / c["steps"]
