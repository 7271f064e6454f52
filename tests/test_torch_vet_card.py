"""The launch audit of ``repro_torch.vet`` on a Hopper card (skipped
elsewhere).

Imports nothing of JAX, so it collects where JAX is not installed:
``python -m pytest -q -m cuda tests/test_torch_vet_card.py``.
"""
import pytest
import torch

from repro_torch.core.engine import StencilEngine
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
        napps = 2 if "star" in sym else 3
        assert c["programs"] == c["kernels"] == napps, (sym, c)
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
        assert audits[1].counts["kernels"] == len(eng.plan_ir.decompose.ops)
        assert 0 < audits[1].kernel_share <= 1
