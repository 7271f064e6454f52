"""The launch audit of ``repro_torch.vet`` on a Hopper card (skipped
elsewhere).

Imports nothing of JAX, so it collects where JAX is not installed:
``python -m pytest -q -m cuda tests/test_torch_vet_card.py``.
"""
import ctypes

import pytest
import torch

from repro_torch.core.engine import StencilEngine, kernel_launches
from repro_torch.core.stencil import make_stencil, paper_suite
from repro_torch.kernels import dispatch
from repro_torch.vet import lowering
from repro_torch.vet.config import VetConfig


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) < dispatch.MIN_CAPABILITY:
        pytest.skip("needs compute capability 9.0 (kernels built for sm_90a)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_sptc_probes_certify_the_fused_program(cuda_device):
    findings, probes = lowering.analyze_fused(VetConfig(), cuda_device)
    assert [f for f in findings if f.rule == "pallas-fused-program"] == [], \
        [f.format() for f in findings]
    assert findings == [], [f.format() for f in findings]
    for sym, c in probes.items():
        # star-2d1r: one star-kernel program for its two axis ops;
        # box-2d1r: one rows-kernel program for its three row ops
        assert c["programs"] == c["kernels"] == 1, (sym, c)
        assert c["gathers"] == 0 and c["uploads"] == 0, (sym, c)


@pytest.mark.cuda
@pytest.mark.parametrize("shape_kind", ["star", "box"])
def test_planted_gather_and_v1_path_are_flagged(cuda_device, shape_kind):
    spec = make_stencil(shape_kind, 2, 1, seed=7)
    x = lowering.probe_input((22, 22), cuda_device)
    for in_region in (False, True):
        fs, got, _ = lowering.audit_fused(
            VetConfig(), lowering.planted_gather(spec, cuda_device, in_region),
            spec, x, "p")
        assert {f.rule for f in fs} & {"pallas-fused-gather",
                                       "pallas-fused-overhead"}, got.counts
        assert "launch-output-mismatch" not in {f.rule for f in fs}
    fs, got, _ = lowering.audit_fused(VetConfig(), lowering.v1_path(spec),
                                      spec, x, "v1")
    assert "pallas-fused-program" in {f.rule for f in fs}, got.counts
    assert got.counts["uploads"] > 0       # v1 builds its tables per call


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["cuda_sptc", "cuda_gemm"])
def test_counts_do_not_change_with_the_probe_size(cuda_device, backend):
    for spec in paper_suite():
        r = spec.radius
        eng = StencilEngine(spec, backend, device=cuda_device)
        shapes = ([(200,), (40_001,)] if spec.ndim == 1
                  else [(16, 16), (257, 1030)])
        audits = [lowering.audit_call(eng, lowering.probe_input(
            tuple(s + 2 * r for s in dims), cuda_device)) for dims in shapes]
        assert audits[0].counts == audits[1].counts, (spec.name, audits)
        want = sum(kernel_launches(eng.plan_ir, eng.device).values())
        assert audits[1].counts["kernels"] == want
        assert 0 < audits[1].kernel_share <= 1


def _cudart():
    """The CUDA runtime this process already loaded (torch's), else the
    toolkit's."""
    for name in ("libcudart.so.12", "/usr/local/cuda/lib64/libcudart.so"):
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    pytest.skip("no CUDA runtime library to call cudaMemsetAsync from")


@pytest.mark.cuda
@pytest.mark.parametrize("shape_kind", ["star", "box"])
def test_outside_device_ops_flags_a_memset_and_a_raw_launch(cuda_device,
                                                            shape_kind):
    spec = make_stencil(shape_kind, 2, 1, seed=7)
    x = lowering.probe_input((22, 22), cuda_device)
    eng = StencilEngine(spec, "cuda_sptc", device=cuda_device)
    fs, got, dense = lowering.audit_fused(VetConfig(), eng, spec, x, "ok")
    assert fs == [], [f.format() for f in fs]
    assert lowering.check_device_ops(VetConfig(), "gemm", dense.counts) == []
    # 0 on both: star-2d1r's one star-kernel launch, box-2d1r's one
    # rows-kernel launch
    c = got.counts
    assert c["device_ops"] == c["copies"] + c["adds"] + c["fills"], c

    cudart = _cudart()
    scratch = torch.empty(1 << 16, device=cuda_device)

    def memset(x):
        y = eng(x)
        status = cudart.cudaMemsetAsync(
            ctypes.c_void_p(scratch.data_ptr()), 0,
            ctypes.c_size_t(scratch.numel() * 4),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        assert status == 0, status
        return y

    for label, fn in (("memset", memset),
                      ("launch", lowering.planted_outside_launch(
                          spec, cuda_device))):
        fs, got, _ = lowering.audit_fused(VetConfig(), fn, spec, x, label)
        rules = [f.rule for f in fs]
        assert "outside-device-ops" in rules, (label, rules, got.counts)
        assert "launch-output-mismatch" not in rules
    # the raw launch is also a region kernel no region asked for
    assert rules == ["pallas-fused-program", "outside-device-ops"]


@pytest.mark.cuda
def test_audit_traces_keep_every_device_op(cuda_device):
    # a bare trace loses the device ops at its head now and then; the
    # audit's traces open with markers and are retaken when they lost them
    eng = StencilEngine(make_stencil("box", 2, 1, seed=7), "cuda_sptc",
                        device=cuda_device)
    x = lowering.probe_input((18, 18), cuda_device)
    want = lowering.audit_call(eng, x).counts
    # the box's three row ops: one rows-kernel program
    assert want["programs"] == want["kernels"] == 1, want
    for _ in range(100):
        a = lowering.profile_call(eng, x)
        assert a.counts == want, (a.counts, want)
        assert not any(lowering.MARKER_KERNEL in s for s in a.sequence)


@pytest.mark.cuda
def test_planted_retake_counts_every_launch(cuda_device):
    # the first trace's markers hidden: the trace is retaken, the call runs
    # once more, and the wrapper's counter sees every launch
    from repro_torch.kernels.sptc_spmm import ops as sptc_ops
    eng = StencilEngine(make_stencil("box", 2, 1, seed=7), "cuda_sptc",
                        device=cuda_device)
    x = lowering.probe_input((18, 18), cuda_device)
    per_call = 1                 # the box's row ops in one rows-kernel launch
    want = lowering.audit_call(eng, x)
    n0 = sptc_ops.sptc_spmm_rows2d.launches
    with lowering.planted_lost_head():
        got = lowering.audit_call(eng, x)
    launches = sptc_ops.sptc_spmm_rows2d.launches - n0
    assert got.attempts >= 2, got.attempts
    assert launches == (1 + got.attempts) * per_call, (launches, got.attempts)
    assert got.counts == want.counts, (got.counts, want.counts)
    assert torch.equal(got.out, want.out)
