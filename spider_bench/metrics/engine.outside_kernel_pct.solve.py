"""engine.outside_kernel_pct.solve: the share of the window's device time
spent outside the port's own CUDA kernels (copies, fills, torch's
elementwise kernels: the engine's glue), from the trace.

The port's kernels are the ones its wrappers name
(``repro_torch.kernels.common.KERNEL_REGIONS``), so a kernel a later change
adds to the port is counted as the port's."""
from repro_torch.kernels.common import KERNEL_REGIONS


def read(run):
    t = run.trace
    if t is None or run.counters["kind"] != "solve" or t.device_s() <= 0:
        return None
    port = t.kernel_s(tuple(KERNEL_REGIONS.values()))
    return 100.0 * (1.0 - port / t.device_s())
