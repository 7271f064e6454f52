"""kernels.rows2d_us_per_row_op.solve: microseconds of repro_torch's rows
kernel (``sptc_rows2d_kernel``, the device ops of the ``sptc_spmm_rows2d``
region) in the traced window, over the row ops those launches summed.

The launches are counted in the trace; the row ops a launch sums are
``sptc_spmm_rows2d.row_ops / .launches``, counters of the whole process,
read once the window has closed.  It puts kernels that sum different
numbers of row ops (a 3 x 3 box's three, a 7 x 7 box's seven) on one
scale.

None without a trace, outside a solve run, where no rows kernel ran in
the window, or where the program keeps no ``row_ops`` counter."""
from repro_torch.kernels.common import KERNEL_REGIONS
from repro_torch.kernels.sptc_spmm.ops import sptc_spmm_rows2d as rows2d


def read(run):
    t, c = run.trace, run.counters
    row_ops = getattr(rows2d, "row_ops", None)
    if t is None or c["kind"] != "solve" or not row_ops:
        return None
    kernel = KERNEL_REGIONS[rows2d.__name__]
    times = [e - s for n, s, e in t.device_ops if kernel in n]
    if not times:
        return None
    return sum(times) / 1e3 / (len(times) * row_ops / rows2d.launches)
