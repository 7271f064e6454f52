"""The tuner and the stencil driver on a Hopper card (skipped elsewhere).

Imports nothing of JAX, so it collects where JAX is not installed:
``python -m pytest -q -m cuda tests/test_torch_tuner_card.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.engine import StencilEngine, kernel_launches
from repro_torch.core.stencil import make_stencil, paper_suite
from repro_torch.kernels import dispatch
from repro_torch.kernels.sptc_spmm import ops as sptc_ops
from repro_torch.kernels.stencil_direct import ops as direct_ops
from repro_torch.kernels.stencil_gemm import ops as gemm_ops
from repro_torch.serving import BatchPolicy, StencilDriver
from repro_torch.tuner import (PlanCache, autotune, plan_for, tuned_apply,
                               tuned_apply_batched)

TOL = 3e-5
#: the stencil kernels' wrappers, by name
WRAPPERS = {fn.__name__: fn for fn in (
    sptc_ops.sptc_spmm_fused, sptc_ops.sptc_spmm_rows2d,
    gemm_ops.windows_gemm, direct_ops.stencil2d)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) < dispatch.MIN_CAPABILITY:
        pytest.skip("needs compute capability 9.0 (kernels built for sm_90a)")
    return torch.device("cuda", 0)


def _close(got, want):
    d = (got.float() - want.float()).abs()
    assert bool((d <= TOL * (1 + want.float().abs())).all()), float(d.max())


def _x(spec, dims, device, batch=None, seed=0):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    shape = tuple(s + 2 * spec.radius for s in dims)
    return torch.randn(((batch,) if batch else ()) + shape, generator=g,
                       device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["time", "cost"])
def test_tuned_apply_picks_a_kernel_and_matches_direct(cuda_device, mode):
    cache = PlanCache()
    for spec in paper_suite():
        dims = (100_003,) if spec.ndim == 1 else (301, 257)
        x = _x(spec, dims, cuda_device)
        got = tuned_apply(spec, x, cache=cache, mode=mode, iters=2)
        plan = plan_for(spec, x.shape, x.dtype, device=cuda_device,
                        cache=cache)
        assert plan.backend in dispatch.CUDA_BACKENDS, spec.name
        _close(got, StencilEngine(spec, "direct", device=cuda_device)(x))
    assert cache.stats.tunes == len(paper_suite())


@pytest.mark.cuda
def test_time_mode_times_every_kernel_candidate(cuda_device):
    spec = make_stencil("box", 2, 2, seed=1)
    res = autotune(spec, (260, 260), device=cuda_device, mode="time",
                   iters=2)
    assert res.mode == "time"
    assert {c.plan.backend for c in res.candidates} == \
        set(dispatch.CUDA_BACKENDS)
    assert all(c.error is None and c.score > 0 for c in res.candidates)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", dispatch.CUDA_BACKENDS)
@pytest.mark.parametrize("shape,ndim,r", [("box", 1, 1), ("star", 2, 2),
                                          ("box", 2, 1)])
def test_batch_of_four_launches_once_per_row_op(cuda_device, backend, shape,
                                                ndim, r):
    spec = make_stencil(shape, ndim, r, seed=2)
    eng = StencilEngine(spec, backend, device=cuda_device)
    dims = (4099,) if ndim == 1 else (67, 131)
    xs = _x(spec, dims, cuda_device, batch=4)
    eng.apply_batched(xs)                      # builds the library
    for fn in WRAPPERS.values():
        fn.launches = 0
    got = eng.apply_batched(xs)
    torch.cuda.synchronize()
    # as many launches as one job: one of the direct kernel, and of the
    # rows kernel for a 2-D box on cuda_sptc; one a row op of the other
    # matrix kernels
    want = kernel_launches(eng.plan_ir, eng.device)
    assert {n: fn.launches for n, fn in WRAPPERS.items()} == \
        {n: want.get(n, 0) for n in WRAPPERS}
    direct = StencilEngine(spec, "direct", device=cuda_device)
    for i in range(4):
        _close(got[i], direct(xs[i]))


@pytest.mark.cuda
def test_batched_and_driver_match_direct_on_the_card(cuda_device):
    spec = make_stencil("star", 2, 1, seed=1)
    cache = PlanCache()
    xs = _x(spec, (90, 70), cuda_device, batch=3, seed=4)
    got = tuned_apply_batched(spec, list(xs), cache=cache, mode="cost")
    direct = StencilEngine(spec, "direct", device=cuda_device)
    for i in range(3):
        _close(got[i], direct(xs[i]))
    rng = np.random.default_rng(0)
    jobs = [_x(spec, tuple(int(d) for d in rng.integers(40, 62, size=2)),
               cuda_device, seed=i) for i in range(10)]
    with StencilDriver(cache=cache, mode="time",
                       policy=BatchPolicy(max_batch=4, max_wait_ms=5.0)) as drv:
        out = drv.map([(spec, x) for x in jobs], timeout=300)
        metrics = drv.metrics()
    for x, y in zip(jobs, out):
        assert y.device == cuda_device
        _close(y, direct(x))
    assert metrics["overall"]["completed"] == 10
