"""engine.row_op_glue_per_step.solve: the spans of the engine's per-RowOp
glue in the traced window per stencil step: repro_torch's
``engine.layout_copy`` (a copy made to give a kernel a unit column stride)
and ``engine.accumulate`` (the accumulator's zero fill, each ``acc + y``).

0.0 where the program declares both spans but the window holds none; None
without a trace, outside a solve run, or where the program does not
declare them (``repro_torch.kernels.common.ENGINE_SPANS``)."""
from repro_torch.kernels import common

SPANS = ("engine.layout_copy", "engine.accumulate")


def read(run):
    t, c = run.trace, run.counters
    if t is None or c["kind"] != "solve" or not c["steps"]:
        return None
    if not set(SPANS) <= set(common.ENGINE_SPANS):
        return None
    return sum(n in SPANS for n, _, _ in t.host_ops) / c["steps"]
