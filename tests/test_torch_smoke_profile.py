"""``chip_smoke.py``'s ``_profile`` on a stub of the launch audit's trace.

``_profile`` takes its trace from ``vet.lowering.trace_device`` (marker
spins, a retake of a trace that lost them) and holds the kernels in it to
the wrappers' launch counters.  Here ``trace_device`` is replaced by a stub
that runs the profiled call and returns hand-made events, so the checks run
on the CPU: a trace that lost its kernels, or some of the counted ones,
raises; markers and annotations are not kernels; a retaken trace is held to
the kept call's launches.  The card test profiles the conv1d kernel for
real.
"""
import dataclasses
import importlib.util
import types
from pathlib import Path

import pytest
import torch
from torch.autograd import DeviceType

from repro_torch.vet import lowering

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Event:
    name: str
    device_type: DeviceType
    start: float = 0.0
    end: float = 0.0
    is_user_annotation: bool = False
    device_time_total: float = 0.0

    @property
    def time_range(self):
        return types.SimpleNamespace(start=self.start, end=self.end)


class Trace(list):
    """Events as ``trace_device`` returns them (an ``EventList``): with
    ``key_averages``, each name's device time summed."""

    def key_averages(self):
        sums = {}
        for e in self:
            k = (e.name, e.device_type)
            sums[k] = sums.get(k, 0.0) + e.device_time_total
        return [types.SimpleNamespace(key=n, device_type=d,
                                      device_time_total=t)
                for (n, d), t in sums.items()]


def kernel(name, us):
    return Event(name, DeviceType.CUDA, 0.0, us)


def conv1d_causal():
    """A stand-in wrapper: its name is a ``KERNEL_REGIONS`` key."""


@pytest.fixture
def traced(monkeypatch):
    """``traced(events, runs=1)``: the next trace runs the profiled call
    ``runs`` times (``runs - 1`` retakes) and returns ``events``."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    conv1d_causal.launches = 0

    def arm(events, runs=1):
        def stub(fn, device):
            for _ in range(runs):
                out = fn()
            return Trace(events), out, runs
        monkeypatch.setattr(lowering, "trace_device", stub)
    return arm


def _prefill(n):
    """A profiled call that launches the conv kernel ``n`` times."""
    def fn():
        conv1d_causal.launches += n
    return fn


FULL = [Event(lowering.MARKER_KERNEL, DeviceType.CUDA, 0, 900),
        Event("conv1d_causal", DeviceType.CUDA, 0, 50,
              is_user_annotation=True),
        Event("attention", DeviceType.CPU, device_time_total=300.0),
        kernel("void conv1d_causal_kernel<bf16>(...)", 20),
        kernel("void conv1d_causal_kernel<bf16>(...)", 20),
        kernel("ampere_bf16_gemm", 500),
        kernel("Memcpy DtoD", 10)]


def test_profile_counts_kernels_and_skips_markers(smoke, traced):
    traced(FULL)
    prof = smoke._profile(_prefill(2), "prefill", "card", regions=(
        "attention",), counters=(conv1d_causal,))
    assert prof["kernels"] == 4 and prof["device_ms"] == pytest.approx(0.55)
    assert prof["counted"] == {"conv1d_causal": 2}
    assert prof["by_region"] == {"attention": pytest.approx(0.3)}
    assert prof["attempts"] == 1 and prof["wall_ms"] > 0
    names = [key for _, _, key in prof["rows"]]
    assert lowering.MARKER_KERNEL not in names and "conv1d_causal" not in names


def test_profile_that_lost_its_kernels_raises(smoke, traced):
    traced([Event(lowering.MARKER_KERNEL, DeviceType.CUDA, 0, 900),
            Event("attention", DeviceType.CPU)])
    with pytest.raises(AssertionError, match="no device time"):
        smoke._profile(_prefill(0), "prefill", "card")


def test_profile_that_lost_counted_kernels_raises(smoke, traced):
    traced(FULL)                       # 2 conv kernels in the trace
    with pytest.raises(AssertionError, match="holds 2 conv1d_causal_kernel "
                                             "launches, conv1d_causal "
                                             "counted 3"):
        smoke._profile(_prefill(3), "prefill", "card",
                       counters=(conv1d_causal,))


def test_profile_counts_stray_kernels_too(smoke, traced):
    traced(FULL)                       # kernels no wrapper counted
    with pytest.raises(AssertionError, match="counted 0"):
        smoke._profile(_prefill(0), "decode", "card",
                       counters=(conv1d_causal,))


def test_retaken_trace_holds_the_kept_call(smoke, traced):
    """A retake runs the call again: the trace is held to the kept call's
    launches, not to every run's."""
    traced(FULL, runs=3)
    prof = smoke._profile(_prefill(2), "prefill", "card",
                          counters=(conv1d_causal,))
    assert prof["attempts"] == 3 and prof["counted"] == {"conv1d_causal": 2}
    assert conv1d_causal.launches == 2 * (1 + 3)        # warm-up + 3 runs


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs compute capability 9.0 (kernels built for sm_90a)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("got,lost", [
    (["k", "memset", "copy", "k2"], []),
    (["memset", "copy", "k2"], [(0, "k")]),
    (["k", "copy", "k2"], [(1, "memset")]),
    (["k", "memset", "copy"], [(3, "k2")]),
    (["k", "k2"], [(1, "memset"), (2, "copy")]),
    (["k", "gemm", "copy", "k2"], [(1, "memset")])])
def test_lost_ops_names_each_lost_op_by_its_place(smoke, got, lost):
    """The late trace check's report: every op of the first audit's call
    that a trace lacks, by its place in the call's device order, at the
    head, in the middle or at the tail."""
    assert smoke._lost_ops(["k", "memset", "copy", "k2"], got) == lost


def test_device_sequence_keeps_only_device_ops(smoke):
    audit = types.SimpleNamespace(sequence=(
        "aten::add", "sptc_spmm_fused", "void spider::sptc_mma_kernel",
        "Memset (Device)", "aten::copy_"))
    assert smoke._device_sequence(audit) == [
        "void spider::sptc_mma_kernel", "Memset (Device)"]


@pytest.mark.cuda
def test_profile_of_the_conv_kernel_on_the_card(smoke, cuda_device):
    from repro_torch.kernels.conv1d import ops as conv_ops
    x = torch.randn(4, 512, 5376, device=cuda_device, dtype=torch.bfloat16)
    w = torch.randn(4, 5376, device=cuda_device, dtype=torch.bfloat16)
    prof = smoke._profile(lambda: conv_ops.conv1d_causal(x, w), "conv1d",
                          "card", counters=(conv_ops.conv1d_causal,))
    assert prof["counted"] == {"conv1d_causal": 1}
    assert prof["kernels"] >= 1 and prof["device_ms"] > 0
