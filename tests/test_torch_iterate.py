"""``StencilEngine.iterate`` on the CPU: each step written straight into the
next haloed grid where the engine's step takes an output (the rows
kernel's plain version, a line on ``cuda_sptc``, 1-D and 2-D
``cuda_direct``), a re-pad a step on every other path, and the kernel
wrappers' checks of the ``out`` they write into.

Imports nothing of JAX.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.core.convert import coefficients_from_array
from repro_torch.core.engine import StencilEngine, grid_operand
from repro_torch.core.sparsify import sparsify_stencil_kernel
from repro_torch.core.stencil import make_stencil
from repro_torch.kernels.sptc_spmm import ops as sptc_ops
from repro_torch.kernels.stencil_direct import ops as direct_ops

DIMS = {1: (61,), 2: (13, 17), 3: (7, 8, 9)}


def _var(spec):
    """A coefficient field of a 2-D spec on ``DIMS[2]``, from a seed."""
    rng = np.random.default_rng(spec.radius)
    return coefficients_from_array(
        rng.normal(size=DIMS[spec.ndim] + np.asarray(spec.weights).shape))


#: path -> (spec, backend, engine keywords, written in place)
PATHS = {
    "rows2d": (("box", 2, 1), "cuda_sptc", {}, True),
    "rows2d_r3": (("box", 2, 3), "cuda_sptc", {}, True),
    "line_sptc": (("box", 1, 2), "cuda_sptc", {}, True),
    "line_direct": (("box", 1, 2), "cuda_direct", {}, True),
    "grid_direct": (("star", 2, 3), "cuda_direct", {}, True),
    "star2d_row_op_loop": (("star", 2, 3), "cuda_sptc", {}, False),
    "box3d": (("box", 3, 1), "cuda_sptc", {}, False),
    "temporal_steps_2": (("box", 2, 1), "cuda_sptc", {"temporal_steps": 2},
                         False),
    "var_coefficients": (("box", 2, 1), "sptc", {"coefficients": _var},
                         False),
    "cuda_gemm": (("box", 2, 1), "cuda_gemm", {}, False),
}


def _repad_loop(eng, x, steps):
    """The reference: ``y = F.pad(eng(y), pad)``, ``steps / k`` times."""
    h = eng.temporal_steps * eng.spec.radius
    for _ in range(steps // eng.temporal_steps):
        x = F.pad(eng(x), (h,) * (2 * x.dim()))
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("steps", [1, 2, 3, 10])
@pytest.mark.parametrize("path", list(PATHS))
def test_iterate_equals_the_repad_loop(path, steps, dtype):
    """``iterate`` equals the re-pad loop bit for bit, its halo is exactly
    zero, its argument is left as it was, and its counters advance by every
    step on an in-place path and by none on a fallback."""
    (shape, ndim, r), backend, kw, in_place = PATHS[path]
    dt = getattr(torch, dtype)
    spec = make_stencil(shape, ndim, r, seed=ndim + r)
    kw = {k: v(spec) if callable(v) else v for k, v in kw.items()}
    eng = StencilEngine(spec, backend, device="cpu", dtype=dt, **kw)
    k = eng.temporal_steps
    h, n = k * r, steps * k
    gen = torch.Generator().manual_seed(steps)
    x = torch.randn([s + 2 * h for s in DIMS[ndim]], generator=gen).to(dt)
    x0 = x.clone()
    counts = StencilEngine.iterate
    before = (counts.steps, counts.steps_in_place)
    got = eng.iterate(x, n)
    assert (counts.steps - before[0], counts.steps_in_place - before[1]) \
        == (n, n if in_place else 0)
    assert torch.equal(x, x0)
    assert got.shape == x.shape and got.dtype == dt
    assert torch.equal(got, _repad_loop(eng, x, n))
    halo = got.clone()
    halo[tuple(slice(h, s - h) for s in got.shape)] = 0
    assert not halo.any()


@pytest.mark.cuda
def test_cuda_rows2d_r3_iterate_equals_the_repad_loop():
    """On the card the 7 x 7 box's rows kernel (R = 7 row ops, L = 8)
    writes each step into ``iterate``'s pitched grid: bit for bit the
    re-pad loop, every step counted in place."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import dispatch
    if torch.cuda.get_device_capability(0) < dispatch.MIN_CAPABILITY:
        pytest.skip("needs compute capability 9.0 (kernels built for sm_90a)")
    dev = torch.device("cuda", 0)
    eng = StencilEngine(make_stencil("box", 2, 3, seed=5), "cuda_sptc",
                        device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    x = F.pad(torch.randn(1024, 1024, generator=gen, device=dev), (3,) * 4)
    done = StencilEngine.iterate.steps_in_place
    got = eng.iterate(x, 10)
    assert StencilEngine.iterate.steps_in_place - done == 10
    torch.cuda.synchronize()
    assert torch.equal(got, _repad_loop(eng, x, 10))


def _line_operand():
    """The fused kernel's tables of a radius-2 line, on the CPU."""
    sk = sparsify_stencil_kernel(np.array([0.1, 0.2, 0.4, 0.2, 0.1]))
    return sptc_ops.fused_operand(sk.sparse, sk.perm, sk.L, device="cpu")


def _grid_case(kind):
    """(wrapper applied to (x, out), x) of a 2-D box or star on cuda_sptc,
    or of the direct kernel, on the CPU."""
    cpu = torch.device("cpu")
    x = torch.randn(1, 12, 14)
    if kind == "stencil2d":
        taps = direct_ops.stencil_taps(np.ones((3, 3)), cpu)
        return lambda xs, out: direct_ops.stencil2d(taps, xs, out=out), x
    spec = make_stencil("box" if kind == "rows2d" else "star", 2, 1, seed=1)
    plan = StencilEngine(spec, "cuda_sptc", device="cpu").plan_ir
    gop = grid_operand(plan, cpu, torch.float32)
    wrapper = getattr(sptc_ops, f"sptc_spmm_{kind}")
    return lambda xs, out: wrapper(gop, xs, out=out), x


@pytest.mark.parametrize("fault,error,match", [
    ("shape", ValueError, "shape"),
    ("dtype", TypeError, "out dtype"),
    ("column_stride", ValueError, "unit column stride"),
    ("overlaps_x", ValueError, "overlaps"),
])
@pytest.mark.parametrize("kind", ["rows2d", "star2d", "stencil2d", "fused"])
def test_wrappers_refuse_a_bad_out(kind, fault, error, match):
    """Each wrapper that writes into ``out`` refuses one of another shape
    or dtype, without a unit column stride, or sharing bytes with its
    input (the interior of the input itself), and writes a sound one."""
    if kind == "fused":
        op = _line_operand()
        x = torch.randn(40, 3)

        def fn(xs, out):
            return sptc_ops.sptc_spmm_fused(op, xs, n_out=36, out=out)
        good = torch.empty(36, 3)
        inner = (slice(2, 38), slice(None))
    else:
        fn, x = _grid_case(kind)
        good = torch.empty(1, 10, 12)
        inner = (slice(None), slice(1, 11), slice(1, 13))
    bad = {"shape": good[..., :-1],
           "dtype": good.to(torch.bfloat16),
           "column_stride": torch.empty(good.shape[::-1]).transpose(0, -1),
           "overlaps_x": x[inner]}[fault]
    with pytest.raises(error, match=match):
        fn(x, bad)
    assert fn(x, good) is good
    assert torch.equal(good, fn(x, None))


def test_fused_wrapper_refuses_a_strided_out():
    """The fused kernel writes whole (n_out, C) rows: ``out`` must be
    contiguous, and a line's interior viewed as (n_out, 1) is."""
    op = _line_operand()
    x = torch.randn(40, 3)
    with pytest.raises(ValueError, match="contiguous"):
        sptc_ops.sptc_spmm_fused(op, x, n_out=36,
                                 out=torch.empty(36, 5)[:, :3])
    line = torch.zeros(44)
    got = sptc_ops.sptc_spmm_fused(op, x[:, :1], n_out=36,
                                   out=line[4:40, None])
    assert torch.equal(line[4:40], got[:, 0])
    assert torch.equal(got, sptc_ops.sptc_spmm_fused(op, x[:, :1], n_out=36))
    assert not line[:4].any() and not line[40:].any()
