"""The port's kernels: plain versions against the JAX Pallas kernels
(interpret mode), the ``cuda_*`` engine backends on the CPU against the
reference's ``pallas_*`` backends, the package's import hygiene, and — on a
Hopper card only — every CUDA kernel against its plain version.

The JAX reference is imported inside the tests that use it, so the card-only
tests also collect where JAX is not installed:
``python -m pytest -q -m cuda tests/test_torch_kernels.py``.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import sparsify
from repro_torch.core.engine import StencilEngine, apply_stencil
from repro_torch.core.stencil import make_stencil
from repro_torch.kernels import dispatch
from repro_torch.kernels.sptc_spmm import ops as sptc_ops
from repro_torch.kernels.sptc_spmm.ref import (sptc_fused_ref,
                                               sptc_spmm_windows_ref,
                                               unpack_meta, window_sources)
from repro_torch.kernels.stencil_direct import ops as direct_ops
from repro_torch.kernels.stencil_direct.ref import stencil2d_ref
from repro_torch.kernels.stencil_gemm import ops as gemm_ops
from repro_torch.kernels.stencil_gemm.ref import windows_gemm_ref

F32_TOL = dict(rtol=3e-5, atol=3e-5)      # f32: summation order only
#: bf16 compute rounds window and values to 8 mantissa bits in both
#: packages; they then differ only in f32 summation order, but a bf16-stored
#: result can land one bf16 rounding step (2^-8 relative) apart
BF16_TOL = dict(rtol=3e-2, atol=3e-2)


def _np(t):
    return t.float().numpy()


def _direct_1d(w, x, n_out):
    return np.stack([np.tensordot(w, x[i:i + len(w)], axes=(0, 0))
                     for i in range(n_out)])


# ---------------------------------------------------------------------------
# plain versions against the JAX Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r,c", [(1, 1), (1, 37), (2, 64), (3, 5)])
@pytest.mark.parametrize("star_fast", [True, False])
def test_sptc_fused_ref_matches_pallas(r, c, star_fast):
    import jax.numpy as jnp
    from repro.kernels.sptc_spmm.kernel import sptc_fused_call
    rng = np.random.default_rng(r * 100 + c)
    w = rng.normal(size=2 * r + 1)
    sk = sparsify.sparsify_stencil_kernel(w)
    n_out = 3 * sk.L + 2
    x = rng.normal(size=(n_out + 2 * r, c)).astype(np.float32)
    vals = sparsify.contiguous_band_values(sk.sparse, sk.perm) \
        if star_fast else sk.values
    vals = vals.astype(np.float32)
    words = sk.sparse.meta_bits()
    want = sptc_fused_call(jnp.asarray(vals), jnp.asarray(words),
                           jnp.asarray(x), n_out=n_out, L=sk.L,
                           star_fast=star_fast, interpret=True)
    got = sptc_fused_ref(torch.as_tensor(vals),
                         torch.as_tensor(words.view(np.int32)),
                         torch.as_tensor(x), n_out=n_out, L=sk.L,
                         star_fast=star_fast)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(_np(got), _direct_1d(w, x, n_out), **F32_TOL)


@pytest.mark.parametrize("star_fast", [True, False])
def test_sptc_fused_bf16_compute_matches_pallas(star_fast):
    import jax.numpy as jnp
    from repro.kernels.sptc_spmm.ops import sptc_spmm_fused as ref_fused
    rng = np.random.default_rng(7)
    w = rng.normal(size=5)                                         # r = 2
    sk = sparsify.sparsify_stencil_kernel(w)
    n_out = 2 * sk.L + 1
    x = rng.normal(size=(n_out + 4, 19)).astype(np.float32)
    want = ref_fused(sk.sparse, sk.perm, jnp.asarray(x), n_out=n_out,
                     L=sk.L, star_fast=star_fast, compute_dtype="bfloat16",
                     interpret=True)
    op = sptc_ops.fused_operand(sk.sparse, sk.perm, sk.L, star_fast=star_fast,
                                device="cpu")
    got = sptc_ops.sptc_spmm_fused(op, torch.as_tensor(x), n_out=n_out,
                                   compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(_np(got), _direct_1d(w, x, n_out),
                               **BF16_TOL)


@pytest.mark.parametrize("L,t,c", [(4, 1, 1), (6, 4, 37), (8, 3, 130),
                                   (16, 2, 5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_windows_gemm_ref_matches_pallas(L, t, c, dtype):
    import jax.numpy as jnp
    from repro.kernels.stencil_gemm.kernel import windows_gemm_call
    rng = np.random.default_rng(L + t + c)
    km = rng.normal(size=(L, 2 * L)).astype(np.float32)
    win = rng.normal(size=(t, 2 * L, c)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = windows_gemm_call(jnp.asarray(km, jd), jnp.asarray(win, jd),
                             interpret=True)
    got = gemm_ops.windows_gemm(torch.as_tensor(km).to(td),
                                torch.as_tensor(win).to(td))
    assert got.dtype == td and tuple(got.shape) == (t, L, c)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **(F32_TOL if dtype == "float32" else BF16_TOL))
    np.testing.assert_allclose(_np(windows_gemm_ref(
        torch.as_tensor(km).to(td), torch.as_tensor(win).to(td))), _np(got),
        rtol=0, atol=0)


@pytest.mark.parametrize("shape,r", [("box", 1), ("box", 3), ("star", 2)])
@pytest.mark.parametrize("dims", [(16, 16), (37, 91)])
def test_stencil2d_ref_matches_pallas(shape, r, dims):
    import jax.numpy as jnp
    from repro.kernels.stencil_direct.ops import _taps
    from repro.kernels.stencil_direct.kernel import stencil2d_call
    spec = make_stencil(shape, 2, r, seed=13)
    x = np.random.default_rng(r).normal(
        size=(dims[0] + 2 * r, dims[1] + 2 * r)).astype(np.float32)
    want = stencil2d_call(jnp.asarray(x), taps=_taps(spec.weights), rh=r,
                          rw=r, th=8, interpret=True)
    taps = direct_ops.stencil_taps(spec.weights, "cpu")
    assert len(taps.host) == len(_taps(spec.weights))       # star zeros pruned
    got = direct_ops.stencil2d(taps, torch.as_tensor(x))
    assert tuple(got.shape) == dims
    np.testing.assert_allclose(_np(got), np.asarray(want)[:dims[0]],
                               **F32_TOL)
    batched = direct_ops.stencil2d(taps, torch.as_tensor(np.stack([x, 2 * x])))
    np.testing.assert_allclose(_np(batched[1]), 2 * _np(got), **F32_TOL)


@pytest.mark.parametrize("n,r", [(100, 1), (1000, 2), (257, 3)])
def test_stencil1d_matches_pallas(n, r):
    import jax.numpy as jnp
    from repro.kernels.stencil_direct.ops import stencil1d as ref_stencil1d
    spec = make_stencil("box", 1, r, seed=3)
    x = np.random.default_rng(n).normal(size=(n + 2 * r,)).astype(np.float32)
    want = ref_stencil1d(spec.weights, jnp.asarray(x), interpret=True)
    got = direct_ops.stencil1d(direct_ops.stencil_taps(spec.weights, "cpu"),
                               torch.as_tensor(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)


def _v1_operand(r, seed):
    sk = sparsify.sparsify_stencil_kernel(
        np.random.default_rng(seed).normal(size=2 * r + 1))
    return sk, sk.values.astype(np.float32), sk.meta.astype(np.int32)


@pytest.mark.parametrize("r,n", [(1, 64), (1, 200), (2, 1), (3, 384),
                                 (7, 513)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sptc_spmm_v1_matches_pallas(r, n, dtype):
    """v1 compressed SpMM (plain version on the CPU) against the reference's
    ``_sptc_kernel`` in interpret mode and its jnp oracle."""
    import jax.numpy as jnp
    from repro.kernels.sptc_spmm.ops import sptc_spmm as ref_spmm
    from repro.kernels.sptc_spmm.ref import sptc_spmm_ref as jnp_ref
    sk, vals, meta = _v1_operand(r, seed=r + n)
    x = np.random.default_rng(n).normal(size=(2 * sk.L, n)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = ref_spmm(jnp.asarray(vals, jd), jnp.asarray(meta),
                    jnp.asarray(x, jd), interpret=True)
    got = sptc_ops.sptc_spmm(torch.as_tensor(vals).to(td),
                             torch.as_tensor(meta), torch.as_tensor(x).to(td))
    assert got.dtype == td and tuple(got.shape) == (sk.L, n)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)
    np.testing.assert_allclose(
        _np(got), np.asarray(jnp_ref(jnp.asarray(vals, jd), jnp.asarray(meta),
                                     jnp.asarray(x, jd)), np.float32), **tol)


@pytest.mark.parametrize("t", [1, 3, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sptc_spmm_windows_v1_matches_pallas(t, dtype):
    import jax.numpy as jnp
    from repro.kernels.sptc_spmm.ops import sptc_spmm_windows as ref_windows
    sk, vals, meta = _v1_operand(2, seed=t)
    big = np.random.default_rng(t).normal(
        size=(t, 2 * sk.L, 140)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = ref_windows(jnp.asarray(vals, jd), jnp.asarray(meta),
                       jnp.asarray(big[:, :, 5:135], jd), interpret=True)
    win = torch.as_tensor(big).to(td)[:, :, 5:135]        # row stride > N
    got = sptc_ops.sptc_spmm_windows(torch.as_tensor(vals),
                                     torch.as_tensor(meta), win)
    assert got.dtype == td and tuple(got.shape) == (t, sk.L, 130)
    np.testing.assert_allclose(
        _np(got), np.asarray(want, np.float32),
        **(F32_TOL if dtype == "float32" else BF16_TOL))
    # the windows form is the single-tile form over the tile axis
    for i in range(t):
        np.testing.assert_array_equal(_np(got[i]), _np(sptc_ops.sptc_spmm(
            torch.as_tensor(vals), torch.as_tensor(meta), win[i])))


def test_sptc_spmm_v1_applies_the_stencil():
    """Swapped windows through the compressed operand give the 1-D stencil,
    as the paper's pipeline composes them (pre-swapped RHS, §3.3)."""
    from repro_torch.core.engine import tile_windows
    w = np.random.default_rng(5).normal(size=5)
    sk = sparsify.sparsify_stencil_kernel(w)
    n_out = 4 * sk.L + 3
    x = torch.as_tensor(np.random.default_rng(1).normal(
        size=(n_out + 4, 6)).astype(np.float32))
    win, ntiles = tile_windows(
        x, n_out, sk.L, order=torch.as_tensor(sk.perm, dtype=torch.int64))
    y = sptc_ops.sptc_spmm_windows(
        torch.as_tensor(sk.values, dtype=torch.float32),
        torch.as_tensor(sk.meta), win.contiguous())
    got = y.reshape(ntiles * sk.L, -1)[:n_out]
    np.testing.assert_allclose(_np(got), _direct_1d(w, x.numpy(), n_out),
                               **F32_TOL)


@pytest.mark.parametrize("shape,ndim,r", [("box", 1, 2), ("star", 2, 1),
                                          ("box", 2, 1), ("box", 2, 3),
                                          ("star", 3, 1)])
def test_apply_sptc_v1_matches_reference_sptc(shape, ndim, r):
    """The v1 entry (plain version on the CPU) applies the whole stencil as
    the reference's simulated-SpTC backend does."""
    import jax.numpy as jnp
    from repro.core.engine import apply_stencil as ref_apply
    from repro.core.stencil import make_stencil as ref_make
    from repro_torch.core.engine import apply_sptc_v1
    spec = make_stencil(shape, ndim, r, seed=4 * ndim + r)
    dims = {1: (53,), 2: (19, 27), 3: (7, 9, 11)}[ndim]
    x = np.random.default_rng(r).normal(
        size=tuple(s + 2 * r for s in dims)).astype(np.float32)
    want = ref_apply(ref_make(shape, ndim, r, seed=4 * ndim + r),
                     jnp.asarray(x), backend="sptc")
    before = sptc_ops.sptc_spmm_windows.launches
    got = apply_sptc_v1(spec, torch.as_tensor(x))
    assert sptc_ops.sptc_spmm_windows.launches == before      # CPU: plain
    assert tuple(got.shape) == dims
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)


def test_sptc_spmm_v1_wrapper_checks():
    vals, meta = torch.ones(4, 4), torch.zeros(4, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="values and meta"):
        sptc_ops.sptc_spmm(vals, meta[:, :2], torch.ones(8, 3))
    with pytest.raises(ValueError, match="K=8"):
        sptc_ops.sptc_spmm_windows(vals, meta, torch.ones(2, 6, 3))
    with pytest.raises(ValueError, match=r"\(K, N\)"):
        sptc_ops.sptc_spmm(vals, meta, torch.ones(2, 8, 3))
    with pytest.raises(TypeError, match="dtype"):
        sptc_ops.sptc_spmm(vals, meta, torch.ones(8, 3, dtype=torch.float64))
    with pytest.raises(TypeError, match="integer"):
        sptc_ops.sptc_spmm(vals, meta.float(), torch.ones(8, 3))
    with pytest.raises(ValueError, match="unit column stride"):
        sptc_ops.sptc_spmm(vals, meta, torch.ones(3, 8).T)
    with pytest.raises(ValueError, match="shared memory"):
        sptc_ops.sptc_spmm(torch.ones(64, 128),
                           torch.zeros(64, 128, dtype=torch.int32),
                           torch.ones(256, 3))
    # meta 0 everywhere: slot j reads RHS row 4*(j//2), so each output is
    # x[0] + x[0] + x[4] + x[4]
    x = torch.arange(24.0).reshape(8, 3)
    y = sptc_ops.sptc_spmm(vals, meta.long(), x)
    np.testing.assert_array_equal(_np(y), np.tile(2 * (_np(x[0]) + _np(x[4])),
                                                  (4, 1)))


# ---------------------------------------------------------------------------
# the cuda_* engine backends on the CPU (plain versions) vs pallas_* backends
# ---------------------------------------------------------------------------

RADII = (1, 2, 3)
POINTS = (("box", 1), ("star", 1), ("box", 2), ("star", 2))
PAIRS = (("pallas_direct", "cuda_direct"), ("pallas_mxu", "cuda_gemm"),
         ("pallas_sptc", "cuda_sptc"))


@pytest.mark.parametrize("radius", RADII)
@pytest.mark.parametrize("shape,ndim", POINTS)
def test_cuda_backends_on_cpu_match_pallas(shape, ndim, radius):
    """The grid of tests/test_pallas_equivalence.py, both packages."""
    import jax.numpy as jnp
    from repro.core.engine import apply_stencil as ref_apply
    spec = make_stencil(shape, ndim, radius, seed=10 * ndim + radius)
    n = 26 + 2 * radius
    grid = (n,) if ndim == 1 else (n, n + 6)
    x = np.random.default_rng(radius).normal(size=grid).astype(np.float32)
    from repro.core.stencil import make_stencil as ref_make
    ref_spec = ref_make(shape, ndim, radius, seed=10 * ndim + radius)
    for ref_b, port_b in PAIRS:
        want = np.asarray(ref_apply(ref_spec, jnp.asarray(x), backend=ref_b))
        got = apply_stencil(spec, torch.as_tensor(x), backend=port_b)
        assert tuple(got.shape) == want.shape, port_b
        np.testing.assert_allclose(_np(got), want, **F32_TOL,
                                   err_msg=f"{port_b} vs {ref_b}")


def test_cuda_direct_3d_zero_kernel_returns_zeros():
    """Port of the reference's regression: every slab skipped -> zeros."""
    from repro_torch.core.stencil import StencilSpec
    spec = StencilSpec(shape="box", ndim=3, radius=1,
                       weights=np.zeros((3, 3, 3)))
    fn = dispatch.build(spec, "cuda_direct", 4, "cpu")
    y = fn(torch.ones((2, 8, 10, 12)))             # a batch of two grids
    assert tuple(y.shape) == (2, 6, 8, 10) and y.dtype == torch.float32
    assert not y.any()


def test_cuda_direct_3d_matches_direct():
    for shape, r in (("box", 1), ("star", 2)):
        spec = make_stencil(shape, 3, r, seed=1)
        x = torch.as_tensor(np.random.default_rng(r).normal(
            size=(9 + 2 * r, 12 + 2 * r, 20 + 2 * r)).astype(np.float32))
        want = apply_stencil(spec, x, backend="direct")
        got = apply_stencil(spec, x, backend="cuda_direct")
        np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


def test_applicable_backends_on_cpu():
    spec = make_stencil("box", 2, 1)
    assert dispatch.applicable_backends(spec, "cpu") == \
        ("direct", "gemm", "sptc")
    with pytest.raises(ValueError, match="cuda_direct"):
        dispatch.build(spec, "cuda_gemm", 4, "cpu")


# ---------------------------------------------------------------------------
# tables, wrappers' checks, import hygiene
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r,L_extra", [(1, 0), (2, 2), (3, 10), (7, 0)])
def test_meta_unpack_and_swap_match_gather_schedule(r, L_extra):
    """The ref's in-kernel decode (packed words -> meta -> swapped rows) is
    the plan's composed gather ``perm[4*seg + meta]``."""
    sk = sparsify.sparsify_stencil_kernel(
        np.random.default_rng(r).normal(size=2 * r + 1), L=2 * r + 2 + L_extra)
    words = torch.as_tensor(sk.sparse.meta_bits().view(np.int32))
    kh = sk.values.shape[1]
    np.testing.assert_array_equal(unpack_meta(words, kh).numpy(), sk.meta)
    np.testing.assert_array_equal(
        window_sources(words, sk.L, kh, star_fast=False).numpy(),
        sk.perm[sk.sparse.gather_indices()])


def test_fused_operand_checks():
    sk = sparsify.sparsify_stencil_kernel(np.ones(3))
    with pytest.raises(ValueError, match="strided-swap"):
        sptc_ops.fused_operand(sk.sparse, np.arange(2 * sk.L), sk.L,
                               device="cpu")
    op = sptc_ops.fused_operand(sk.sparse, sk.perm, sk.L, device="cpu")
    assert op.star_fast and op.meta_words.dtype == torch.int32
    x = torch.ones((20, 6))
    with pytest.raises(TypeError, match="dtype"):
        sptc_ops.sptc_spmm_fused(op, x.double(), n_out=8)
    with pytest.raises(TypeError, match="values dtype"):
        sptc_ops.sptc_spmm_fused(op, x.bfloat16(), n_out=8)
    with pytest.raises(ValueError, match="unit column stride"):
        sptc_ops.sptc_spmm_fused(op, torch.ones((6, 20)).T, n_out=8)
    with pytest.raises(ValueError, match="compute_dtype"):
        sptc_ops.sptc_spmm_fused(op, x, n_out=8, compute_dtype=torch.float16)
    y = sptc_ops.sptc_spmm_fused(op, x, n_out=8)
    assert tuple(y.shape) == (8, 6)
    np.testing.assert_allclose(_np(y), 1.0 * 3, rtol=1e-6)


def test_gemm_and_direct_wrapper_checks():
    with pytest.raises(ValueError, match="windows"):
        gemm_ops.windows_gemm(torch.ones(4, 8), torch.ones(2, 6, 3))
    with pytest.raises(TypeError, match="dtype"):
        gemm_ops.windows_gemm(torch.ones(4, 8), torch.ones(2, 8, 3).bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        gemm_ops.windows_gemm(torch.ones(4, 8),
                              torch.ones(2, 3, 8).transpose(1, 2))
    taps = direct_ops.stencil_taps(np.ones((3, 3)), "cpu")
    with pytest.raises(ValueError, match="halo"):
        direct_ops.stencil2d(taps, torch.ones(1, 5))
    with pytest.raises(TypeError, match="dtype"):
        direct_ops.stencil2d(taps, torch.ones(5, 5, dtype=torch.float64))
    np.testing.assert_allclose(
        _np(stencil2d_ref(taps.host, torch.ones(5, 6), 1, 1)), 9.0)


def test_port_imports_neither_jax_nor_reference():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.core.engine,"
            " repro_torch.kernels.dispatch, repro_torch.kernels.build,"
            " repro_torch.kernels.sptc_spmm, repro_torch.kernels.stencil_gemm,"
            " repro_torch.kernels.stencil_direct, repro_torch.models,"
            " repro_torch.serving, repro_torch.configs,"
            " repro_torch.launch.serve, repro_torch.kernels.conv1d,"
            " repro_torch.models.layers, repro_torch.models.model,"
            " repro_torch.models.convert, repro_torch.serving.cache,"
            " repro_torch.serving.engine, repro_torch.configs.zamba2_2_7b\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'repro' or m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env=env)


@pytest.mark.parametrize("module", [
    "repro_torch.kernels.sptc_spmm", "repro_torch.kernels.conv1d",
    "repro_torch.models", "repro_torch.serving", "repro_torch.launch.serve",
    "repro_torch.distributed"])
def test_port_module_imports_alone(module):
    """Each package imports first in a fresh interpreter (``core``'s
    package imports the engine, which imports ``kernels.sptc_spmm``)."""
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p))
    subprocess.run([sys.executable, "-c", f"import {module}"], check=True,
                   timeout=120, env=env)


# ---------------------------------------------------------------------------
# card only: every CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) < dispatch.MIN_CAPABILITY:
        pytest.skip("needs compute capability 9.0 (kernels built for sm_90a)")
    return torch.device("cuda", 0)


def _close(got, want, dtype):
    tol = 3e-5 if dtype == torch.float32 else 1e-2
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), rtol=tol,
                               atol=tol)


def _fused_input(n_out, r, c, dt, device):
    """(n_out + 2r, c) view with a row stride > c: odd (41) and 4-byte
    aligned for c = 37, a multiple of 16 bytes and 16-byte aligned (the
    kernel's vector staging) for c = 300; c = 1 is the 1-D (tile-walking)
    variant."""
    off = 8 if c == 300 else 1
    big = torch.randn(n_out + 2 * r, c + off + 4, device=device).to(dt)
    return big[:, off:off + c]


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 2, 3])
@pytest.mark.parametrize("L_kind", ["2r+2", "16"])
@pytest.mark.parametrize("c", [1, 37, 300])
@pytest.mark.parametrize("star_fast", [True, False])
@pytest.mark.parametrize("dtype,compute", [("float32", None),
                                           ("float32", "bfloat16"),
                                           ("bfloat16", None)])
def test_cuda_sptc_fused_matches_plain(cuda_device, r, L_kind, c, star_fast,
                                       dtype, compute):
    dt = getattr(torch, dtype)
    comp = None if compute is None else getattr(torch, compute)
    L = 2 * r + 2 if L_kind == "2r+2" else 16
    sk = sparsify.sparsify_stencil_kernel(
        np.random.default_rng(r).normal(size=2 * r + 1), L=L)
    n_out = 5 * sk.L + 3
    op = sptc_ops.fused_operand(sk.sparse, sk.perm, sk.L, star_fast=star_fast,
                                dtype=dt, device=cuda_device)
    x2d = _fused_input(n_out, r, c, dt, cuda_device)
    before = sptc_ops.sptc_spmm_fused.launches
    got = sptc_ops.sptc_spmm_fused(op, x2d, n_out=n_out, compute_dtype=comp)
    assert sptc_ops.sptc_spmm_fused.launches == before + 1
    want = sptc_fused_ref(op.values, op.meta_words, x2d, n_out=n_out,
                          L=sk.L, star_fast=star_fast, compute_dtype=comp)
    torch.cuda.synchronize()
    _close(got, want, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("L,c,n_out", [(20, 37, 203), (20, 1, 1003),
                                       (80, 37, 250), (80, 1, 4001),
                                       (4, 1, 100_003), (16, 1, 100_003),
                                       (6, 3000, 61)])
@pytest.mark.parametrize("dtype,compute", [("float32", None),
                                           ("float32", "bfloat16"),
                                           ("bfloat16", None)])
def test_cuda_sptc_fused_blocks_and_long_rows(cuda_device, L, c, n_out,
                                              dtype, compute):
    """L > 16 (several M blocks; L = 80 is the largest the kernel takes),
    long one-column inputs over many blocks, many column blocks."""
    dt = getattr(torch, dtype)
    comp = None if compute is None else getattr(torch, compute)
    r = min(2, (L - 2) // 2)                      # L >= 2r + 2
    sk = sparsify.sparsify_stencil_kernel(
        np.random.default_rng(L).normal(size=2 * r + 1), L=L)
    op = sptc_ops.fused_operand(sk.sparse, sk.perm, L, star_fast=False,
                                dtype=dt, device=cuda_device)
    x2d = _fused_input(n_out, r, c, dt, cuda_device)
    got = sptc_ops.sptc_spmm_fused(op, x2d, n_out=n_out, compute_dtype=comp)
    want = sptc_fused_ref(op.values, op.meta_words, x2d, n_out=n_out, L=L,
                          star_fast=False, compute_dtype=comp)
    torch.cuda.synchronize()
    _close(got, want, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 8])
@pytest.mark.parametrize("dtype,compute", [("float32", None),
                                           ("float32", "bfloat16"),
                                           ("bfloat16", None)])
def test_cuda_sptc_fused_one_tile_layout(cuda_device, c, dtype, compute):
    """One tile, one non-zero per row at a known window position: pins the
    A-fragment, metadata and B-fragment layouts.  Small integers are exact
    in every route, so the kernel must equal its plain version exactly."""
    dt = getattr(torch, dtype)
    comp = None if compute is None else getattr(torch, compute)
    L = 16
    dense = np.zeros((L, 2 * L))
    for m in range(L):
        dense[m, (5 * m + 3) % (2 * L)] = m + 1     # every pair, both halves
    operand = sparsify.encode_24(dense)
    op = sptc_ops.fused_operand(operand, sparsify.strided_swap_perm(L), L,
                                star_fast=False, dtype=dt, device=cuda_device)
    x2d = (torch.arange(2 * L * c, device=cuda_device) % 61).reshape(
        2 * L, c).to(dt)
    got = sptc_ops.sptc_spmm_fused(op, x2d, n_out=L, compute_dtype=comp)
    want = sptc_fused_ref(op.values, op.meta_words, x2d, n_out=L, L=L,
                          star_fast=False, compute_dtype=comp)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("L", [4, 6, 8, 16])
@pytest.mark.parametrize("c", [1, 37, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_windows_gemm_matches_plain(cuda_device, L, c, dtype):
    dt = getattr(torch, dtype)
    km = torch.randn(L, 2 * L, device=cuda_device).to(dt)
    win = torch.randn(7, 2 * L, c, device=cuda_device).to(dt)
    got = gemm_ops.windows_gemm(km, win)
    torch.cuda.synchronize()
    _close(got, windows_gemm_ref(km, win), dt)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,ndim,r", [("box", 1, 1), ("box", 1, 2),
                                          ("star", 2, 1), ("star", 2, 3),
                                          ("box", 2, 2), ("box", 2, 3)])
@pytest.mark.parametrize("layout", ["contiguous", "strided"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_stencil2d_matches_plain(cuda_device, shape, ndim, r, layout,
                                      dtype):
    """1-D (H = 1, the flat tile), batched 2-D slabs with odd H and W that
    fill no tile, and inputs whose rows start at an odd column offset."""
    dt = getattr(torch, dtype)
    spec = make_stencil(shape, ndim, r, seed=5)
    taps = direct_ops.stencil_taps(spec.weights, cuda_device)
    off = 0 if layout == "contiguous" else 3
    if ndim == 1:
        big = torch.randn(1000 + 2 * r + off, device=cuda_device).to(dt)
        x = big[off:]
        got = direct_ops.stencil1d(taps, x)
        want = stencil2d_ref(taps.host, x[None], 0, r)[0]
    else:
        big = torch.randn(3, 37 + 2 * r, 301 + 2 * r + off,
                          device=cuda_device).to(dt)
        x = big[:, :, off:]
        got = direct_ops.stencil2d(taps, x)
        want = stencil2d_ref(taps.host, x, r, r)
    torch.cuda.synchronize()
    _close(got, want, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("kh,kw", [(1, 5), (3, 7), (7, 1), (5, 3), (7, 7)])
@pytest.mark.parametrize("h,w", [(1, 33), (67, 1500)])
def test_cuda_stencil2d_uneven_extents(cuda_device, kh, kw, h, w):
    """rh != rw, a single-row tap array on a many-row grid (the flat tile
    over rows), zero taps inside a box, and 2-D slabs of one row."""
    rng = np.random.default_rng(kh * 10 + kw)
    weights = rng.normal(size=(kh, kw))
    weights[rng.random(size=weights.shape) < 0.3] = 0.0
    taps = direct_ops.stencil_taps(weights, cuda_device)
    x = torch.randn(2, h + kh - 1, w + kw - 1, device=cuda_device)
    got = direct_ops.stencil2d(taps, x)
    want = stencil2d_ref(taps.host, x, taps.rh, taps.rw)
    torch.cuda.synchronize()
    _close(got, want, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,ndim,r", [("box", 1, 2), ("star", 2, 1),
                                          ("box", 2, 2), ("star", 3, 1)])
def test_cuda_engine_backends_match_direct(cuda_device, shape, ndim, r):
    spec = make_stencil(shape, ndim, r, seed=3)
    dims = {1: (5003,), 2: (301, 203), 3: (21, 33, 45)}[ndim]
    x = torch.randn(tuple(s + 2 * r for s in dims), device=cuda_device)
    want = StencilEngine(spec, "direct")(x)
    for b in dispatch.CUDA_BACKENDS:
        got = StencilEngine(spec, b)(x)
        torch.cuda.synchronize()
        _close(got, want, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 16])
@pytest.mark.parametrize("n", [1, 37, 1000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_sptc_spmm_v1_matches_plain(cuda_device, m, n, dtype):
    dt = getattr(torch, dtype)
    sk = sparsify.sparsify_stencil_kernel(
        np.random.default_rng(m).normal(size=m - 1), L=m)     # (m, m) operand
    vals = torch.as_tensor(sk.values, device=cuda_device).to(dt)
    meta = torch.as_tensor(sk.meta, device=cuda_device)
    big = torch.randn(5, 2 * m, n + 3, device=cuda_device).to(dt)
    win = big[:, :, 2:2 + n]                               # row stride > N
    before = sptc_ops.sptc_spmm_windows.launches
    got = sptc_ops.sptc_spmm_windows(vals, meta, win)
    one = sptc_ops.sptc_spmm(vals, meta, win[3])
    assert sptc_ops.sptc_spmm_windows.launches == before + 2
    want = sptc_spmm_windows_ref(vals, meta, win)
    torch.cuda.synchronize()
    _close(got, want, dt)
    _close(one, want[3], dt)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,ndim,r", [("box", 1, 2), ("box", 2, 1),
                                          ("star", 2, 3)])
def test_cuda_apply_sptc_v1_matches_direct(cuda_device, shape, ndim, r):
    from repro_torch.core.engine import apply_sptc_v1
    spec = make_stencil(shape, ndim, r, seed=6)
    dims = {1: (5003,), 2: (301, 203)}[ndim]
    x = torch.randn(tuple(s + 2 * r for s in dims), device=cuda_device)
    before = sptc_ops.sptc_spmm_windows.launches
    got = apply_sptc_v1(spec, x)
    assert sptc_ops.sptc_spmm_windows.launches > before
    want = StencilEngine(spec, "direct")(x)
    torch.cuda.synchronize()
    _close(got, want, torch.float32)
