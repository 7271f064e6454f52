"""The port's ahead-of-time front end against the JAX reference package.

Both packages lower the same stencils (the reference spec's fields are
carried across with ``repro_torch.core.convert``); every table the plans
hold must be equal bit for bit — matrices, permutation, compressed values
and metadata, packed meta words, banded fast-path values, gather slots and
taps — and ``describe()`` must agree up to the backend names.
"""
import numpy as np
import pytest
import torch

import repro.core.sptc as ref_sptc
from repro.core import sparsify as ref_sparsify
from repro.core import stencil as ref_stencil
from repro.core import transform as ref_transform
from repro_torch.core import sparsify, sptc, stencil, transform
from repro_torch.core.convert import coefficients_from_array, spec_from_arrays
from repro_torch.core.ir import BACKENDS, MATRIX_BACKENDS, SPARSE_BACKENDS

#: reference backend -> its counterpart in the port
BACKEND_PAIRS = (("direct", "direct"), ("gemm", "gemm"), ("sptc", "sptc"),
                 ("pallas_direct", "cuda_direct"), ("pallas_mxu", "cuda_gemm"),
                 ("pallas_sptc", "cuda_sptc"))
SPECS = ref_stencil.PAPER_SUITE + (("box", 3, 1), ("star", 3, 2))
L_CHOICES = ("default", "2r+4", 16)
#: (variant, temporal_steps): constant, fused rows, temporal k=2, var-coeff
VARIANTS = (("const", 1), ("fused", 1), ("const", 2), ("var", 1))


def _L(choice, r):
    return {"default": None, "2r+4": 2 * r + 4}.get(choice, choice)


def _coefficients(spec, rng):
    out_shape = {1: (9,), 2: (5, 6), 3: (3, 4, 5)}[spec.ndim]
    c = rng.normal(size=out_shape + spec.weights.shape)
    if spec.shape == "star":
        c[..., ~ref_stencil.star_mask(spec.ndim, spec.radius)] = 0.0
    return c


def _cases():
    for shape, ndim, r in SPECS:
        for ref_b, port_b in BACKEND_PAIRS:
            for L in L_CHOICES:
                for variant, k in VARIANTS:
                    if variant == "var" and port_b not in ("direct", "gemm",
                                                           "sptc"):
                        continue
                    yield pytest.param(
                        shape, ndim, r, ref_b, port_b, L, variant, k,
                        id=f"{shape}-{ndim}d{r}r-{port_b}-L{L}-{variant}{k}")


def _eq(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert np.array_equal(a, b), what


def _assert_same_plan(ref, port, backend_map):
    assert port.L == ref.L
    assert port.stage_names() == ref.stage_names()
    rd, pd = ref.decompose, port.decompose
    assert pd.mode == rd.mode
    assert [(o.axis, o.lead, o.operand) for o in pd.ops] == \
        [(o.axis, o.lead, o.operand) for o in rd.ops]
    assert len(pd.kernels) == len(rd.kernels)
    for i, (a, b) in enumerate(zip(rd.kernels, pd.kernels)):
        _eq(a, b, f"kernel {i}")
    assert (pd.coefficients is None) == (rd.coefficients is None)
    for i, (a, b) in enumerate(zip(rd.coefficients or (),
                                   pd.coefficients or ())):
        _eq(a, b, f"coefficient slab {i}")
    assert (port.kernel is None) == (ref.kernel is None)
    if ref.kernel is not None:
        assert port.kernel.L == ref.kernel.L
        for i, (a, b) in enumerate(zip(ref.kernel.matrices,
                                       port.kernel.matrices)):
            _eq(a, b, f"matrix {i}")
    assert (port.sparsify is None) == (ref.sparsify is None)
    if ref.sparsify is not None:
        rs, ps = ref.sparsify, port.sparsify
        _eq(rs.perm, ps.perm, "perm")
        assert ps.shared_pattern == rs.shared_pattern
        for i, (a, b) in enumerate(zip(rs.operands, ps.operands)):
            _eq(a.values, b.values, f"values {i}")
            _eq(a.meta, b.meta, f"meta {i}")
            assert a.k == b.k
            _eq(a.meta_bits(), b.meta_bits(), f"meta_bits {i}")
            _eq(a.gather_indices(), b.gather_indices(), f"gather {i}")
            fa = ref_sparsify.contiguous_band_values(a, rs.perm)
            fb = sparsify.contiguous_band_values(b, ps.perm)
            assert (fa is None) == (fb is None)
            if fa is not None:
                _eq(fa, fb, f"band values {i}")
    assert (port.gather is None) == (ref.gather is None)
    if ref.gather is not None:
        _eq(ref.gather.window, port.gather.window, "window")
        for i in range(len(ref.gather.slots)):
            _eq(ref.gather.slots[i], port.gather.slots[i], f"slots {i}")
            _eq(ref.gather.taps[i], port.gather.taps[i], f"taps {i}")
    re_, pe = ref.emit, port.emit
    assert pe.backend == backend_map[re_.backend]
    assert (pe.fuse_rows, pe.temporal_steps, pe.coefficient_mode) == \
        (re_.fuse_rows, re_.temporal_steps, re_.coefficient_mode)
    want = ref.describe()
    for a, b in backend_map.items():
        want = want.replace(f"emit[{a}", f"emit[{b}")
    assert port.describe() == want


@pytest.mark.parametrize("shape,ndim,r,ref_b,port_b,L,variant,k", _cases())
def test_lower_spec_tables_match_reference(shape, ndim, r, ref_b, port_b, L,
                                           variant, k):
    ref_spec = ref_stencil.make_stencil(shape, ndim, r, seed=17 * ndim + r)
    spec = spec_from_arrays(ref_spec.shape, ref_spec.ndim, ref_spec.radius,
                            ref_spec.weights)
    kw = dict(L=_L(L, r), temporal_steps=k, fuse_rows=variant == "fused")
    c = _coefficients(ref_spec, np.random.default_rng(r)) \
        if variant == "var" else None
    ref = ref_transform.lower_spec(ref_spec, backend=ref_b, coefficients=c,
                                   **kw)
    port = transform.lower_spec(
        spec, backend=port_b,
        coefficients=None if c is None else coefficients_from_array(c), **kw)
    _assert_same_plan(ref, port, dict(BACKEND_PAIRS))


def test_backend_sets():
    assert BACKENDS == ("direct", "gemm", "sptc", "cuda_direct", "cuda_gemm",
                        "cuda_sptc")
    assert MATRIX_BACKENDS == ("gemm", "sptc", "cuda_gemm", "cuda_sptc")
    assert SPARSE_BACKENDS == ("sptc", "cuda_sptc")


@pytest.mark.parametrize("backend", ["cuda_direct", "cuda_gemm", "cuda_sptc"])
def test_var_coefficients_rejected_on_kernel_backends(backend):
    """Like the reference's Pallas backends, the kernels take constant
    coefficients only."""
    spec = stencil.make_stencil("box", 2, 1, seed=0)
    c = _coefficients(spec, np.random.default_rng(0))
    with pytest.raises(ValueError, match="variable coefficients"):
        transform.lower_spec(spec, backend=backend, coefficients=c)


def test_paper_suite_matches_reference():
    assert stencil.PAPER_SUITE == ref_stencil.PAPER_SUITE
    for a, b in zip(ref_stencil.paper_suite(), stencil.paper_suite()):
        assert (a.name, a.taps) == (b.name, b.taps)
        _eq(a.weights, b.weights, a.name)
    for ndim in (1, 2, 3):
        for r in (1, 2, 3):
            _eq(ref_stencil.star_mask(ndim, r), stencil.star_mask(ndim, r),
                "star mask")


def test_spec_from_arrays_round_trip():
    ref_spec = ref_stencil.make_stencil("star", 3, 2, seed=4)
    spec = spec_from_arrays(ref_spec.shape, ref_spec.ndim, ref_spec.radius,
                            ref_spec.weights)
    assert (spec.shape, spec.ndim, spec.radius, spec.name) == \
        (ref_spec.shape, ref_spec.ndim, ref_spec.radius, ref_spec.name)
    _eq(spec.weights, ref_spec.weights, "weights")
    assert spec.weights is not ref_spec.weights          # copied
    with pytest.raises(ValueError, match="star-shaped"):
        spec_from_arrays("star", 2, 1, np.ones((3, 3)))
    with pytest.raises(ValueError, match="weights shape"):
        spec_from_arrays("box", 2, 1, np.ones((3, 4)))


def test_coefficients_from_array_validates():
    c = np.arange(2 * 3 * 3 * 3, dtype=np.float32).reshape(2, 3, 3, 3)
    out = coefficients_from_array(c)
    assert out.dtype == np.float64 and np.array_equal(out, c)
    with pytest.raises(ValueError, match="2\\*d axes"):
        coefficients_from_array(np.ones((2, 3, 3)))
    with pytest.raises(ValueError, match="non-finite"):
        coefficients_from_array(np.full((2, 3), np.nan))


@pytest.mark.parametrize("r", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("L_extra", [0, 2, 6])
def test_sparsify_stencil_kernel_matches_reference(r, L_extra):
    w = np.random.default_rng(r).normal(size=2 * r + 1)
    L = 2 * r + 2 + L_extra
    a = ref_sparsify.sparsify_stencil_kernel(w, L=L)
    b = sparsify.sparsify_stencil_kernel(w, L=L)
    _eq(a.perm, b.perm, "perm")
    _eq(a.values, b.values, "values")
    _eq(a.meta, b.meta, "meta")
    _eq(a.sparse.meta_bits(), b.sparse.meta_bits(), "meta_bits")
    assert (a.L, a.radius, a.window) == (b.L, b.radius, b.window)
    _eq(sparsify.decode_24(b.sparse),
        sparsify.apply_col_perm(transform.kernel_matrix(w, L=L), b.perm),
        "decode o encode")
    _eq(transform.kernel_matrix(w, L=L, pad_width=False),
        ref_transform.kernel_matrix(w, L=L, pad_width=False), "unpadded")
    assert transform.band_density(r, L) == ref_transform.band_density(r, L)


def test_strided_swap_perm_and_24_checks():
    for L in range(2, 34, 2):
        _eq(sparsify.strided_swap_perm(L), ref_sparsify.strided_swap_perm(L),
            f"perm L={L}")
    with pytest.raises(ValueError, match="even"):
        sparsify.strided_swap_perm(5)
    dense = np.ones((2, 8))
    assert not sparsify.is_24_sparse(dense)
    with pytest.raises(ValueError, match="not 2:4"):
        sparsify.encode_24(dense)


@pytest.mark.parametrize("r", [1, 2, 3])
def test_sptc_semantics_match_reference(r):
    import jax.numpy as jnp
    rng = np.random.default_rng(10 + r)
    sk = sparsify.sparsify_stencil_kernel(rng.normal(size=2 * r + 1))
    x = rng.normal(size=(2 * sk.L, 13)).astype(np.float32)
    vals = sk.values.astype(np.float32)
    want = ref_sptc.sptc_matmul(jnp.asarray(vals), jnp.asarray(sk.meta),
                                jnp.asarray(x))
    got = sptc.sptc_matmul(torch.as_tensor(vals), torch.as_tensor(sk.meta),
                           torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5,
                               atol=3e-5)
    dense_ref = ref_sptc.sptc_matmul_dense_equiv(
        jnp.asarray(vals), jnp.asarray(sk.meta), 2 * sk.L)
    dense = sptc.sptc_matmul_dense_equiv(torch.as_tensor(vals),
                                         torch.as_tensor(sk.meta), 2 * sk.L)
    np.testing.assert_array_equal(dense.numpy(), np.asarray(dense_ref))
    np.testing.assert_array_equal(
        sptc.swap_rows(torch.as_tensor(x), sk.perm).numpy(),
        np.asarray(ref_sptc.swap_rows(jnp.asarray(x), sk.perm)))
    with pytest.raises(ValueError, match="K/2"):
        sptc.sptc_matmul(torch.as_tensor(vals), torch.as_tensor(sk.meta),
                         torch.as_tensor(x[:-2]))
