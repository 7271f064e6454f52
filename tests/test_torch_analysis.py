"""The port's Table 1 cost models and kernel roofline against the reference.

``repro_torch.core.analysis`` is a hardware-free copy of
``repro.core.analysis``; its rows must equal the reference's exactly.  The
reference's TPU row (``tpu_im2col``) is the port's ``cuda_direct`` row.
"""
import pytest

from repro.core import analysis as ref
from repro_torch.core import analysis
from repro_torch import roofline

ROWS = ("lower_bound", "tcstencil", "convstencil", "lorastencil",
        "sptcstencil")


@pytest.mark.parametrize("c", [8, 16])
@pytest.mark.parametrize("r", [1, 2, 3])
def test_table1_equals_reference(r, c):
    got, want = analysis.table1(r, c), ref.table1(r, c)
    assert set(got) == set(ROWS) | {"cuda_direct"}
    for name in ROWS:
        assert got[name].as_tuple() == want[name].as_tuple(), name
    assert got["cuda_direct"].as_tuple() == want["tpu_im2col"].as_tuple()


@pytest.mark.parametrize("r", [1, 2, 3])
def test_cuda_direct_row_hits_the_mac_lower_bound(r):
    row = analysis.cuda_direct(r)
    assert row.macs == analysis.lower_bound(r).macs == (2 * r + 1) ** 2
    assert row.input_access == analysis.lower_bound(r).input_access
    # the matrix formulations all execute more MACs than the bound
    for name in ("tcstencil", "convstencil", "lorastencil", "sptcstencil"):
        assert analysis.table1(r)[name].macs > row.macs, name


def test_paper_table1_values():
    t = analysis.table1(3, 8)
    assert t["lower_bound"].macs == 49
    assert t["sptcstencil"].as_tuple() == (56, 14, 7)
    assert t["tcstencil"].macs == pytest.approx(286.72)


def test_kernel_roofline_on_h100_constants():
    # 1 GB moved and 1 GFLOP of float32: bytes bind at 3.35 TB/s
    t = roofline.kernel_roofline_time(1e9, 1e9)
    assert t == pytest.approx(1e9 / 3.35e12)
    # 1 TFLOP of float32 outside the tensor cores binds at 67 TFLOP/s
    assert roofline.kernel_roofline_time(1e12, 1e6) == pytest.approx(1 / 67)
    assert roofline.kernel_roofline_time(
        1e12, 1e6, peak_flops=roofline.BF16_TC_FLOPS) == \
        pytest.approx(1e12 / 989.4e12)
    assert roofline.attained_fraction(2 * t, 1e9, 1e9) == pytest.approx(0.5)
    assert roofline.attained_fraction(0.0, 1e9, 1e9) == 0.0
