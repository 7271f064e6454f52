"""The port's StencilEngine on the CPU against the JAX reference engine.

Inputs are made once with numpy and handed to both packages.  Tolerances:
float32 ``rtol = atol = 3e-5`` (the packages sum in different orders);
bfloat16 ``5e-2``, because both round every intermediate of the direct
backend to 8 mantissa bits (about 4e-3 relative per rounding) and may round
at different places.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.core import stencil as ref_stencil
from repro_torch.core import engine
from repro_torch.core.convert import coefficients_from_array, spec_from_arrays

F32 = dict(rtol=3e-5, atol=3e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)
SHAPES = [("box", 1, 1), ("box", 1, 2), ("star", 2, 1), ("star", 2, 3),
          ("box", 2, 1), ("box", 2, 2), ("box", 2, 3), ("box", 3, 1),
          ("star", 3, 2)]
DIMS = {1: (203,), 2: (37, 41), 3: (13, 15, 17)}
VAR_SWEEP = [("box", 1, 1), ("box", 1, 2), ("box", 1, 3),
             ("star", 2, 1), ("star", 2, 2), ("star", 2, 3),
             ("box", 2, 1), ("box", 2, 2), ("box", 2, 3)]


def _specs(shape, ndim, r, seed):
    ref = ref_stencil.make_stencil(shape, ndim, r, seed=seed)
    return ref, spec_from_arrays(ref.shape, ref.ndim, ref.radius, ref.weights)


def _port(spec, x, backend="direct", **kw):
    eng = engine.StencilEngine(spec, backend, device="cpu", **kw)
    return eng(torch.as_tensor(x)).numpy()


def _ref(spec, x, backend="direct", **kw):
    return np.asarray(ref_engine.StencilEngine(spec, backend, **kw)(
        jnp.asarray(x)))


@pytest.mark.parametrize("backend", ["direct", "gemm", "sptc"])
@pytest.mark.parametrize("shape,ndim,r", SHAPES)
def test_engine_matches_reference(backend, shape, ndim, r):
    ref_spec, spec = _specs(shape, ndim, r, seed=11)
    x = np.random.default_rng(r).normal(
        size=tuple(s + 2 * r for s in DIMS[ndim])).astype(np.float32)
    got = _port(spec, x, backend)
    assert got.shape == DIMS[ndim] and got.dtype == np.float32
    np.testing.assert_allclose(got, _ref(ref_spec, x, backend), **F32)


@pytest.mark.parametrize("backend", ["gemm", "sptc"])
@pytest.mark.parametrize("r", [1, 2, 3])
def test_fuse_rows_matches_reference(backend, r):
    ref_spec, spec = _specs("box", 2, r, seed=4)
    x = np.random.default_rng(r).normal(
        size=(41 + 2 * r, 57 + 2 * r)).astype(np.float32)
    eng = engine.StencilEngine(spec, backend, fuse_rows=True, device="cpu")
    assert eng.plan_ir.decompose.mode == "fused-rows"
    np.testing.assert_allclose(eng(torch.as_tensor(x)).numpy(),
                               _ref(ref_spec, x, backend, fuse_rows=True),
                               **F32)


@pytest.mark.parametrize("shape,ndim,r", VAR_SWEEP)
def test_variable_coefficients_match_reference(shape, ndim, r):
    """Every port backend against the reference's sptc var-coeff engine."""
    ref_spec, spec = _specs(shape, ndim, r, seed=13)
    rng = np.random.default_rng(r + ndim)
    dims = {1: (53,), 2: (13, 17)}[ndim]
    c = rng.normal(size=dims + ref_spec.weights.shape)
    if shape == "star":
        c[..., ~ref_stencil.star_mask(ndim, r)] = 0.0
    x = rng.normal(size=tuple(s + 2 * r for s in dims)).astype(np.float32)
    want = _ref(ref_spec, x, "sptc", coefficients=c)
    for backend in ("direct", "gemm", "sptc"):
        eng = engine.StencilEngine(spec, backend, device="cpu",
                                   coefficients=coefficients_from_array(c))
        np.testing.assert_allclose(eng(torch.as_tensor(x)).numpy(), want,
                                   rtol=1e-4, atol=1e-4, err_msg=backend)
    with pytest.raises(ValueError, match="fixed-shape"):
        eng(torch.zeros(tuple(s + 2 * r + 1 for s in dims)))


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("shape,ndim,r", VAR_SWEEP)
def test_temporal_block_matches_reference(shape, ndim, r, k):
    """A k-step engine on a k·r-halo input, every backend, against the
    reference's k-step sptc engine."""
    ref_spec, spec = _specs(shape, ndim, r, seed=17)
    dims = {1: (45,), 2: (11, 13)}[ndim]
    x = np.random.default_rng(k * 10 + r).normal(
        size=tuple(s + 2 * k * r for s in dims)).astype(np.float32)
    want = _ref(ref_spec, x, "sptc", temporal_steps=k)
    for backend in ("direct", "gemm", "sptc", "cuda_direct", "cuda_gemm",
                    "cuda_sptc"):
        got = _port(spec, x, backend, temporal_steps=k)
        assert got.shape == dims
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                   err_msg=f"{backend} k={k}")


@pytest.mark.parametrize("backend,k", [("direct", 1), ("gemm", 2),
                                       ("cuda_sptc", 2)])
def test_iterate_matches_reference(backend, k):
    ref_spec, spec = _specs("star", 2, 1, seed=0)
    x = np.random.default_rng(k).uniform(0, 1, size=(20, 22)
                                         ).astype(np.float32)
    ref_b = {"cuda_sptc": "pallas_sptc"}.get(backend, backend)
    want = np.asarray(ref_engine.StencilEngine(
        ref_spec, ref_b, temporal_steps=k).iterate(jnp.asarray(x), steps=4))
    eng = engine.StencilEngine(spec, backend, temporal_steps=k, device="cpu")
    got = eng.iterate(torch.as_tensor(x), steps=4).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, **F32)
    if k > 1:
        with pytest.raises(ValueError, match="multiple"):
            eng.iterate(torch.as_tensor(x), steps=3)


@pytest.mark.parametrize("backend", ["direct", "gemm", "sptc", "cuda_gemm",
                                     "cuda_sptc"])
def test_apply_1d_matches_reference(backend):
    ref_b = {"cuda_gemm": "pallas_mxu", "cuda_sptc": "pallas_sptc"}.get(
        backend, backend)
    rng = np.random.default_rng(3)
    w = rng.normal(size=5)                                     # r = 2
    x = rng.normal(size=(9, 30)).astype(np.float32)
    want = np.asarray(ref_engine.apply_1d(w, jnp.asarray(x), 26, 1, ref_b))
    got = engine.apply_1d(w, torch.as_tensor(x), 26, 1, backend).numpy()
    np.testing.assert_allclose(got, want, **F32)
    with pytest.raises(ValueError, match="unknown 1-D backend"):
        engine.apply_1d(w, torch.as_tensor(x), 26, 1, "cuda_direct")


@pytest.mark.parametrize("backend", ["direct", "gemm", "sptc", "cuda_direct",
                                     "cuda_gemm", "cuda_sptc"])
def test_bf16_inputs_match_reference(backend):
    """Direct accumulates in bf16 like the reference; the matrix backends and
    the kernels accumulate in f32 and cast."""
    ref_b = {"cuda_direct": "pallas_direct", "cuda_gemm": "pallas_mxu",
             "cuda_sptc": "pallas_sptc"}.get(backend, backend)
    ref_spec, spec = _specs("box", 2, 1, seed=2)
    x = np.random.default_rng(5).normal(size=(20, 24)).astype(np.float32)
    want = np.asarray(ref_engine.apply_stencil(
        ref_spec, jnp.asarray(x, jnp.bfloat16), backend=ref_b), np.float32)
    got = engine.apply_stencil(spec, torch.as_tensor(x).bfloat16(),
                               backend=backend)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16)


def test_engine_without_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, s = _specs("box", 2, 1, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.StencilEngine(s)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.resolve_device(None)


def test_engine_checks_input_device_dtype_and_rank():
    _, spec = _specs("box", 2, 1, seed=0)
    eng = engine.StencilEngine(spec, "sptc", device="cpu")
    assert eng.device == torch.device("cpu") and eng.L == 4
    with pytest.raises(ValueError, match="float32"):
        eng(torch.zeros(6, 6, dtype=torch.float64))
    with pytest.raises(ValueError, match="2-D input"):
        eng(torch.zeros(6))
    with pytest.raises(ValueError, match="backend must be one of"):
        engine.StencilEngine(spec, "pallas_sptc", device="cpu")


def test_no_module_imports_a_private_name_of_the_engine():
    """The engine's seam holds: no module of the port but ``core/engine.py``
    imports a ``_``-prefixed name from ``repro_torch.core.engine``, or
    reads one off the module imported whole."""
    import ast
    from pathlib import Path

    import repro_torch
    root = Path(repro_torch.__file__).resolve().parent
    found = []
    for path in sorted(root.rglob("*.py")):
        if path == root / "core" / "engine.py":
            continue
        tree = ast.parse(path.read_text(), filename=str(path))
        aliases = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.level == 0:
                if node.module == "repro_torch.core.engine":
                    found += [f"{path.name}:{node.lineno} {a.name}"
                              for a in node.names if a.name.startswith("_")]
                elif node.module == "repro_torch.core":
                    aliases |= {a.asname or a.name for a in node.names
                                if a.name == "engine"}
            elif isinstance(node, ast.Import):
                aliases |= {a.asname for a in node.names
                            if a.name == "repro_torch.core.engine"
                            and a.asname}
        for node in ast.walk(tree):
            if (isinstance(node, ast.Attribute) and node.attr.startswith("_")
                    and isinstance(node.value, ast.Name)
                    and node.value.id in aliases):
                found.append(f"{path.name}:{node.lineno} {node.attr}")
    assert found == []
