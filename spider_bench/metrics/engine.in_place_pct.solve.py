"""engine.in_place_pct.solve: the share of repro_torch's
``StencilEngine.iterate`` steps written straight into the interior of the
next haloed grid, with no re-pad: ``iterate.steps_in_place`` over
``iterate.steps``, counters of the whole process (set-up's chunks and the
window's) read once the window has closed.

None where the program keeps no such counter or ran no step."""
from repro_torch.core.engine import StencilEngine


def read(run):
    if run.counters["kind"] != "solve":
        return None
    steps = getattr(StencilEngine.iterate, "steps", None)
    done = getattr(StencilEngine.iterate, "steps_in_place", None)
    if not steps or done is None:
        return None
    return 100.0 * done / steps
