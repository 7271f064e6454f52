"""The port's depthwise causal conv1d: its plain versions against the JAX
reference (the Pallas kernel in interpret mode, and the jnp oracle), its
wrapper's checks, and — on a Hopper card only — the CUDA kernel against its
plain version.

The JAX reference is imported inside the tests that use it, so the
card-only tests also collect where JAX is not installed:
``python -m pytest -q -m cuda tests/test_torch_conv1d.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.conv1d import ops as conv_ops
from repro_torch.kernels.conv1d.ref import (conv1d_causal_plain,
                                            conv1d_causal_ref)

F32_TOL = dict(rtol=2e-5, atol=2e-5)      # f32: summation order only
#: bf16 storage: both packages round the output to 8 mantissa bits, and a
#: sum that lands near a rounding boundary can come out one bf16 step
#: (2^-8 relative) apart
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
#: (B, T, D, K): D not a multiple of 128, T = 1, T not a multiple of the
#: reference's 256-step block, and the model's K = 4
SHAPES = [(1, 16, 8, 4), (2, 100, 64, 4), (3, 257, 130, 4), (1, 1, 37, 4),
          (2, 5, 200, 2), (1, 32, 1, 3)]


def _np(t):
    return t.float().numpy()


def _inputs(b, t, d, k, seed=0, width=None):
    """x (B, T, D) as a column slice of a wider array when ``width``."""
    rng = np.random.default_rng(seed)
    wide = rng.normal(size=(b, t, width or d)).astype(np.float32)
    off = 0 if width is None else (width - d) // 2
    x = wide[:, :, off:off + d]
    w = rng.normal(size=(k, d)).astype(np.float32)
    return wide, off, x, w


@pytest.mark.parametrize("b,t,d,k", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv1d_plain_matches_pallas(b, t, d, k, dtype):
    """The wrapper on a CPU tensor (the kernel's plain version) against the
    reference's Pallas kernel in interpret mode: both sum in float32."""
    import jax.numpy as jnp
    from repro.kernels.conv1d.ops import conv1d_causal as ref_conv
    _, _, x, w = _inputs(b, t, d, k, seed=b * t + d)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(ref_conv(jnp.asarray(x, jd), jnp.asarray(w, jd),
                               interpret=True), np.float32)
    got = conv_ops.conv1d_causal(torch.as_tensor(x).to(td),
                                 torch.as_tensor(w).to(td))
    assert got.dtype == td and tuple(got.shape) == (b, t, d)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), want, **tol)
    if dtype == "float32":          # and the jnp oracle (it sums in x.dtype)
        from repro.kernels.conv1d.ref import conv1d_causal_ref as jnp_ref
        np.testing.assert_allclose(
            _np(got), np.asarray(jnp_ref(jnp.asarray(x), jnp.asarray(w))),
            **tol)


@pytest.mark.parametrize("b,t,d,k", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv1d_ref_matches_jnp_ref(b, t, d, k, dtype):
    """The port's ``conv1d_causal_ref`` is the reference's oracle: it sums
    in ``x.dtype``, rounding after every tap, like the jnp version."""
    import jax.numpy as jnp
    from repro.kernels.conv1d.ref import conv1d_causal_ref as jnp_ref
    _, _, x, w = _inputs(b, t, d, k, seed=7 + d)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jnp_ref(jnp.asarray(x, jd), jnp.asarray(w, jd)),
                      np.float32)
    got = conv1d_causal_ref(torch.as_tensor(x).to(td),
                            torch.as_tensor(w).to(td))
    assert got.dtype == td
    np.testing.assert_allclose(_np(got), want,
                               **(F32_TOL if dtype == "float32" else BF16_TOL))


def test_conv1d_strided_input_matches_contiguous():
    """The model's x is a column slice of the input projection (unit channel
    stride, row stride wider than D): no copy, same result."""
    import jax.numpy as jnp
    from repro.kernels.conv1d.ops import conv1d_causal as ref_conv
    wide, off, x, w = _inputs(3, 257, 37, 4, seed=3, width=101)
    xs = torch.as_tensor(wide)[:, :, off:off + 37]
    assert xs.stride() == (257 * 101, 101, 1)
    got = conv_ops.conv1d_causal(xs, torch.as_tensor(w))
    np.testing.assert_array_equal(
        _np(got), _np(conv1d_causal_plain(torch.as_tensor(x),
                                          torch.as_tensor(w))))
    want = ref_conv(jnp.asarray(x), jnp.asarray(w), interpret=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("fn", [conv_ops.conv1d_causal, conv1d_causal_ref,
                                conv1d_causal_plain])
def test_conv1d_is_causal(fn):
    """Output at t must not depend on inputs after t."""
    _, _, x, w = _inputs(1, 20, 8, 4, seed=11)
    x2 = x.copy()
    x2[:, 10:, :] = 999.0
    y1 = fn(torch.as_tensor(x), torch.as_tensor(w))
    y2 = fn(torch.as_tensor(x2), torch.as_tensor(w))
    np.testing.assert_array_equal(_np(y1)[:, :10], _np(y2)[:, :10])
    assert not np.allclose(_np(y1)[:, 10:], _np(y2)[:, 10:])


def test_conv1d_first_steps_see_zero_history():
    x = torch.ones(1, 3, 2)
    w = torch.tensor([[1.0, 10.0], [2.0, 20.0], [3.0, 30.0], [4.0, 40.0]])
    y = conv_ops.conv1d_causal(x, w)
    np.testing.assert_array_equal(_np(y)[0, :, 0], [4.0, 7.0, 9.0])
    np.testing.assert_array_equal(_np(y)[0, :, 1], [40.0, 70.0, 90.0])


def test_conv1d_wrapper_checks():
    x = torch.ones(2, 5, 6)
    with pytest.raises(ValueError, match=r"\(B, T, D\)"):
        conv_ops.conv1d_causal(x[0], torch.ones(4, 6))
    with pytest.raises(ValueError, match="does not match"):
        conv_ops.conv1d_causal(x, torch.ones(4, 5))
    with pytest.raises(TypeError, match="dtype"):
        conv_ops.conv1d_causal(x.double(), torch.ones(4, 6))
    with pytest.raises(ValueError, match="unit channel stride"):
        conv_ops.conv1d_causal(torch.ones(2, 6, 5).transpose(1, 2),
                               torch.ones(4, 6))
    y = conv_ops.conv1d_causal(x.bfloat16(), torch.ones(4, 6))  # w cast
    assert y.dtype == torch.bfloat16
    assert conv_ops.conv1d_causal(torch.ones(2, 0, 6),
                                  torch.ones(4, 6)).shape == (2, 0, 6)


# ---------------------------------------------------------------------------
# card only: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs compute capability 9.0 (kernels built for sm_90a)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("t", [1, 3, 257])
@pytest.mark.parametrize("d", [1, 37, 160, 5376])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("strided", [False, True])
def test_cuda_conv1d_matches_plain(cuda_device, b, t, d, dtype, strided):
    dt = getattr(torch, dtype)
    width = 2 * d + 7 if strided else d
    wide = torch.randn(b, t, width, device=cuda_device).to(dt)
    x = wide[:, :, 3:3 + d] if strided else wide
    w = torch.randn(4, d, device=cuda_device).to(dt)
    before = conv_ops.conv1d_causal.launches
    got = conv_ops.conv1d_causal(x, w)
    assert conv_ops.conv1d_causal.launches == before + 1
    want = conv1d_causal_plain(x, w)
    torch.cuda.synchronize()
    tol = 3e-5 if dt == torch.float32 else 1e-2
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), rtol=tol,
                               atol=tol)
