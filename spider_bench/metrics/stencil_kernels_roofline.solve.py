"""stencil_kernels_roofline.solve: the stencil's least time for the steps
of the traced window over the summed device time of the port's kernels.

The least time counts the stencil's own work, whatever kernel does it:
per engine call the grid (halo included) read once, the interior written
once, and 2 * taps FLOP per interior point per step (``sbench.roofline``)."""
from repro_torch.kernels.common import KERNEL_REGIONS
from sbench.roofline import share_pct, stencil_least_seconds


def read(run):
    t, c = run.trace, run.counters
    if t is None or c["kind"] != "solve":
        return None
    k = c["temporal_steps"]
    taps = run.cell.reference.taps(run.cell.weights)
    per_call = stencil_least_seconds(c["grid_points"], c["interior_points"],
                                     taps * k, c["itemsize"])
    return share_pct(per_call * c["steps"] / k,
                     t.kernel_s(tuple(KERNEL_REGIONS.values())))
