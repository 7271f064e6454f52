"""The benchmark's yardstick on the CPU: the plain reference, the roofline
arithmetic, the trace reduction and the import check."""
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]


def _sbench():
    """The harness package, loaded from this folder by its path."""
    if "sbench" not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            "sbench", BENCH / "sbench" / "__init__.py",
            submodule_search_locations=[str(BENCH / "sbench")])
        mod = importlib.util.module_from_spec(spec)
        sys.modules["sbench"] = mod
        spec.loader.exec_module(mod)
    return sys.modules["sbench"]


def _reference():
    _sbench()
    from sbench.layout import _load
    return _load(BENCH / "reference" / "stencil.py", "spider_bench_reference_")


def test_reference_1d_by_hand():
    ref = _reference()
    w = ref.normalised_weights(np.array([1.0, 2.0, 1.0]), "box")
    np.testing.assert_allclose(w, [0.25, 0.5, 0.25])
    x = torch.tensor([0.0, 4.0, 8.0, 0.0, 4.0])
    y = ref.apply_valid(w, x)
    # y[i] = (x[i] + 2 x[i+1] + x[i+2]) / 4
    np.testing.assert_allclose(y.numpy(), [4.0, 5.0, 3.0])
    assert y.dtype == torch.float64
    # one solver step re-pads the interior with a zero halo
    np.testing.assert_allclose(ref.iterate(w, x, 1).numpy(),
                               [0.0, 4.0, 5.0, 3.0, 0.0])
    # two steps: the second reads the zero halo
    np.testing.assert_allclose(ref.iterate(w, x, 2).numpy(),
                               [0.0, 3.25, 4.25, 2.75, 0.0])


def test_reference_2d_by_hand():
    ref = _reference()
    raw = np.arange(1.0, 10.0).reshape(3, 3)
    box = ref.normalised_weights(raw, "box")
    np.testing.assert_allclose(box, raw / 45.0)
    star = ref.normalised_weights(raw, "star")
    # the star keeps the centre row and column: 4 + 5 + 6 + 2 + 8 = 25
    np.testing.assert_allclose(
        star, np.array([[0, 2, 0], [4, 5, 6], [0, 8, 0]]) / 25.0)
    assert ref.taps(box) == 9 and ref.taps(star) == 5
    x = torch.zeros(4, 4)
    x[1, 2] = 1.0
    y = ref.apply_valid(box, x)
    # a unit impulse at (1, 2) reaches output (i, j) through w[1-i, 2-j]
    want = np.array([[box[1, 2], box[1, 1]], [box[0, 2], box[0, 1]]])
    np.testing.assert_allclose(y.numpy(), want)


def test_reference_temporal_block():
    """k steps on a k*r halo, re-padded once, as the engine's temporal
    blocking defines them."""
    ref = _reference()
    w = ref.normalised_weights(np.array([1.0, 2.0, 1.0]), "box")
    x = torch.arange(8.0)
    two = ref.iterate(w, x, 2, temporal_steps=2)
    inner = ref.apply_valid(w, ref.apply_valid(w, x))
    np.testing.assert_allclose(two[2:-2].numpy(), inner.numpy())
    assert float(two[:2].abs().sum() + two[-2:].abs().sum()) == 0.0
    with pytest.raises(ValueError):
        ref.iterate(w, x, 3, temporal_steps=2)


@pytest.mark.parametrize("precision,bits", [("tf32", 10), ("bfloat16", 7)])
def test_control_rounds_to_its_precision(precision, bits):
    ref = _reference()
    x = torch.randn(1000, generator=torch.Generator().manual_seed(3))
    r = ref._round(x, precision)
    mant = r.view(torch.int32) & ((1 << 23) - 1)
    assert int((mant & ((1 << (23 - bits)) - 1)).abs().sum()) == 0
    rel = ((r - x).abs() / x.abs()).max()
    assert 0 < float(rel) <= 2.0 ** -(bits + 1) * 1.01
    w = ref.normalised_weights(np.ones(5), "box")
    lo = ref.apply_valid(w, x, precision)
    hi = ref.apply_valid(w, x)
    assert lo.dtype == torch.float32
    gap = float((lo.double() - hi).abs().max() / hi.abs().max())
    assert 1e-6 < gap < 2.0 ** -bits


def test_roofline_least_time():
    _sbench()
    from sbench import roofline as rl
    # box-2d1r at 10240^2: bytes bound, 0.2504 ms
    t = rl.stencil_least_seconds(10242 ** 2, 10240 ** 2, 9, 4)
    assert t == pytest.approx((10242 ** 2 + 10240 ** 2) * 4 / 3.35e12)
    # a wide stencil is bound by its FLOP
    t = rl.stencil_least_seconds(100, 100, 10 ** 6, 4)
    assert t == pytest.approx(2 * 10 ** 6 * 100 / 67e12)
    assert rl.share_pct(1.0, 0.0) is None


@pytest.mark.parametrize("factor", [1.0, 1.0001, 2.0, 37.5, 1e6])
def test_roofline_share_never_over_100(factor):
    _sbench()
    from sbench import roofline as rl
    least = rl.stencil_least_seconds(4098 * 4098, 4096 * 4096, 9, 4)
    share = rl.share_pct(least, least * factor)
    assert 0 < share <= 100.0


def test_union_and_gaps_of_overlapping_intervals():
    _sbench()
    from sbench.trace import gaps_ns, union_ns
    iv = [(10, 20), (15, 30), (40, 50), (45, 46), (60, 60)]
    assert union_ns(iv) == 30
    assert gaps_ns(iv, (0, 100)) == [(0, 10), (30, 40), (50, 60), (60, 100)]
    assert union_ns([]) == 0 and gaps_ns([], (5, 9)) == [(5, 9)]


class _Ev:
    """Stands for torch's raw profiler event."""

    def __init__(self, name, dev, s, d, ann=False):
        from torch.autograd import DeviceType
        self._n, self._s, self._d, self._a = name, s, d, ann
        self._t = DeviceType.CUDA if dev else DeviceType.CPU

    def name(self):
        return self._n

    def device_type(self):
        return self._t

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def is_user_annotation(self):
        return self._a


def test_trace_reduction_idle_share_and_breakdown():
    _sbench()
    from sbench.trace import WINDOW_SPAN, reduce_events
    events = [
        _Ev("spin_kernel", True, 0, 10),                 # lead marker
        _Ev(WINDOW_SPAN, False, 100, 1000, ann=True),
        _Ev("solve.chunk", False, 100, 900, ann=True),
        _Ev("aten::constant_pad_nd", False, 500, 300),
        _Ev("solve.chunk", True, 120, 800),              # unflagged copy
        _Ev("void spider::k<1>(float*)", True, 150, 200),
        _Ev("void spider::k<1>(float*)", True, 300, 100),
        _Ev("Memcpy DtoD", True, 350, 100),
        _Ev("fill", True, 900, 300),                     # cut at the end
        _Ev("spin_kernel", True, 1200, 10),
    ]
    tr = reduce_events(events)
    assert tr.lead_kept and tr.window == (100, 1100)
    assert tr.launches() == 4
    assert tr.busy_s == pytest.approx(500e-9)           # 150-450, 900-1100
    assert 1 - tr.busy_s / tr.window_s == pytest.approx(0.5)
    assert tr.kernel_s(["spider::k"]) == pytest.approx(300e-9)
    bd = tr.breakdown(("solve.chunk",))
    assert bd["device_ops"][0] == ["spider::k<1>", pytest.approx(300e-9)]
    # the longest gap, 450-900, is inside the chunk span and the pad
    assert bd["idle_gaps"][0][0] == "solve.chunk > aten::constant_pad_nd at 0.000 s"
    assert bd["idle_gaps"][0][1] == pytest.approx(450e-9)
    assert not reduce_events(events[1:]).lead_kept


def test_forbidden_modules_compares_whole_top_level_names():
    _sbench()
    from sbench.layout import forbidden_modules
    ok = ["repro_torch", "repro_torch.core.engine", "jaxtyping", "flaxen",
          "reprox.y", "torch"]
    assert forbidden_modules(ok) == []
    assert forbidden_modules(ok + ["repro.core", "jax.numpy", "jaxlib",
                                   "flax.linen"]) == ["flax", "jax",
                                                      "jaxlib", "repro"]


def test_verdict_and_gap():
    _sbench()
    from sbench import check
    ref = torch.tensor([1.0, -2.0, 4.0])
    assert check.rel_err(ref.clone(), ref) == 0.0
    assert check.rel_err(ref + torch.tensor([0, 0, 0.04]), ref) == \
        pytest.approx(0.01)
    assert check.rel_err(ref[:2], ref) == float("inf")
    ok, checks = check.verdict({"a": 1e-6}, {"a": {"limit": 1e-5}})
    assert ok and checks == {"a": {"value": 1e-6, "limit": 1e-5}}
    assert not check.verdict({"a": 2e-5}, {"a": {"limit": 1e-5}})[0]
    assert not check.verdict({"a": None}, {"a": {"limit": 1e-5}})[0]
    assert check.worst(iter(())) is None
