"""The halo-exchange engine on a Hopper card (skipped elsewhere).

Every shard of a ``(2, 2)`` mesh on ``cuda:0`` (``LocalTransport``): one
fused step of box-2d1r through ``cuda_sptc`` against the single-device
``direct`` engine, the kernel launches of the interior and rim calls
counted, and the verifier's sharded probes on the card.  Imports nothing
of JAX, so it collects where JAX is not installed:
``python -m pytest -q -m cuda tests/test_torch_distributed_card.py``.
"""
import pytest
import torch
import torch.nn.functional as F

from repro_torch.core.engine import StencilEngine
from repro_torch.core.stencil import make_stencil
from repro_torch.distributed import ShardedStencilEngine, grid_mesh
from repro_torch.kernels import dispatch
from repro_torch.kernels.sptc_spmm import ops as sptc_ops
from repro_torch.vet import lowering
from repro_torch.vet.config import VetConfig

TOL = 3e-5                     # f32: |got - want| <= TOL * (1 + |want|)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) < dispatch.MIN_CAPABILITY:
        pytest.skip("needs compute capability 9.0 (kernels built for sm_90a)")
    return torch.device("cuda", 0)


def _close(got, want):
    bad = (got - want).abs() > TOL * (1 + want.abs())
    assert got.shape == want.shape and not bool(bad.any()), \
        float((got - want).abs().max())


@pytest.mark.cuda
def test_box_2d1r_cuda_sptc_step_on_a_2x2_mesh(cuda_device):
    spec = make_stencil("box", 2, 1, seed=3)
    eng = ShardedStencilEngine(spec, grid_mesh((2, 2),
                                               devices=[cuda_device] * 4),
                               backend="cuda_sptc")
    g = torch.Generator(device=cuda_device).manual_seed(0)
    u = torch.randn((517, 389), generator=g, device=cuda_device)
    direct = StencilEngine(spec, "direct", device=cuda_device)
    sptc_ops.sptc_spmm_fused.launches = 0
    sptc_ops.sptc_spmm_rows2d.launches = 0
    got = eng.step(u)
    torch.cuda.synchronize()
    # one batched interior call and two rims per partitioned axis, each one
    # rows-kernel launch for all the box's row ops
    assert sptc_ops.sptc_spmm_rows2d.launches == 1 + 2 * 2
    assert sptc_ops.sptc_spmm_fused.launches == 0
    assert eng.transport.calls == 4
    _close(got, direct(F.pad(u, (1,) * 4)))
    _close(eng(F.pad(u, (1,) * 4)), direct(F.pad(u, (1,) * 4)))


@pytest.mark.cuda
def test_sharded_probes_certify_on_the_card(cuda_device):
    findings, probes = lowering.analyze_sharded(VetConfig(), cuda_device)
    assert findings == [], [f.format() for f in findings]
    for symbol, counts in probes.items():
        assert counts["gather-like"] == 0, symbol
        assert counts["collective-permute"] == (
            4 if "mesh2x2" in symbol else 2), symbol
