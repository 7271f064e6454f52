"""The windows GEMM on the tensor cores (``csrc/windows_gemm.cu``).

The kernel runs ``mma.sync`` with the window slab as A and the kernel
matrix as B: float32 as 3xTF32 (both operands split into a TF32 high part
and a TF32 residual, one fresh accumulator per k-step added in float32),
bfloat16 as bf16 operands with float32 sums.  On the CPU its arithmetic is
emulated in plain torch and held to the plain version and to the JAX
package's Pallas kernel (interpret mode); its shared memory (the B table)
is checked for every L the engine and tuner produce.  The kernel itself is
held to its plain version on the card (``-m cuda``) in each of its modes
and at the paper's 1-D shapes.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import dispatch
from repro_torch.kernels.build import SMEM_OPT_IN
from repro_torch.kernels.sptc_spmm.fragments import tf32_split
from repro_torch.kernels.stencil_gemm import kernel as gemm_kernel
from repro_torch.kernels.stencil_gemm import ops as gemm_ops
from repro_torch.kernels.stencil_gemm.ref import windows_gemm_ref
from repro_torch.tuner.search import l_candidates

F32_TOL = dict(rtol=3e-5, atol=3e-5)      # f32: summation order only
#: bf16 storage: the kernel's and the reference's sums differ in order, so a
#: bf16-stored result can land one bf16 rounding step (2^-8 relative) apart
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
LS = (4, 6, 8, 10, 16)


def _emulate(km: torch.Tensor, win: torch.Tensor, *, lo: bool = True):
    """The kernel's arithmetic in plain torch: K padded to whole k-steps
    with zeros; per k-step, float32 windows·km as 3xTF32 (``lo=False``: the
    hi·hi term alone) summed apart and added in float32; bfloat16 operands
    with float32 sums.  Returns the result in the windows' dtype."""
    L, K = km.shape
    step = 8 if win.dtype == torch.float32 else 16
    pad = -K % step
    kmp = F.pad(km.float(), (0, pad))
    wp = F.pad(win.float(), (0, 0, 0, pad))
    d = torch.zeros(win.shape[0], L, win.shape[2])
    for s in range(0, K + pad, step):
        a, b = wp[:, s:s + step], kmp[:, s:s + step]
        if win.dtype == torch.float32:
            (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
            e = torch.einsum("lk,tkc->tlc", bh, ah)
            if lo:
                e = (torch.einsum("lk,tkc->tlc", bl, ah)
                     + torch.einsum("lk,tkc->tlc", bh, al)) + e
        else:
            e = torch.einsum("lk,tkc->tlc", b, a)
        d = d + e
    return d.to(win.dtype)


def _inputs(L, t, c, dtype, seed):
    rng = np.random.default_rng(seed)
    km = rng.normal(size=(L, 2 * L)).astype(np.float32)
    win = rng.normal(size=(t, 2 * L, c)).astype(np.float32)
    td = getattr(torch, dtype)
    return km, win, torch.as_tensor(km).to(td), torch.as_tensor(win).to(td)


@pytest.mark.parametrize("L", LS)
@pytest.mark.parametrize("c", [1, 3, 37])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_emulated_kernel_matches_plain_and_pallas(L, c, dtype):
    import jax.numpy as jnp
    from repro.kernels.stencil_gemm.kernel import windows_gemm_call
    km, win, tkm, twin = _inputs(L, 5, c, dtype, seed=10 * L + c)
    got = _emulate(tkm, twin)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               windows_gemm_ref(tkm, twin).float().numpy(),
                               **tol)
    jd = getattr(jnp, dtype)
    want = windows_gemm_call(jnp.asarray(km, jd), jnp.asarray(win, jd),
                             interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("L", LS)
def test_dropping_the_lo_terms_misses_the_f32_tolerance(L):
    """The smoke's planted fault: TF32 alone (no lo terms) is not float32
    accuracy, so the f32 check must flag a kernel that drops them."""
    _, _, km, win = _inputs(L, 64, 37, "float32", seed=L)
    want = windows_gemm_ref(km, win)
    err = ((_emulate(km, win, lo=False) - want).abs()
           / (1 + want.abs())).max()
    assert float(err) > F32_TOL["rtol"]
    ok = ((_emulate(km, win) - want).abs() / (1 + want.abs())).max()
    assert float(ok) < F32_TOL["rtol"] / 3


def _every_l():
    """The tuner's L for radii 1-4 (2r+2, its rounding to 8, 16) and every
    L the wrapper took before the kernel ran on the tensor cores: a (L, 2L)
    float32 matrix in 48 KB of shared memory."""
    tuned = {L for r in range(1, 5) for L in l_candidates(r)}
    assert tuned == {4, 6, 8, 10, 16}
    return sorted(tuned | set(range(1, 79)))


@pytest.mark.parametrize("itemsize", [4, 2])
def test_b_table_fits_every_l(itemsize):
    """The kernel's only shared memory is the B table: one 8-byte word a
    lane for each k-step and block of 8 outputs."""
    for L in _every_l():
        assert gemm_kernel.table_bytes(L, 2 * L, itemsize) <= SMEM_OPT_IN, L
    assert gemm_kernel.table_bytes(4, 8, 4) == 256          # 1 k-step, 1 block
    assert gemm_kernel.table_bytes(6, 12, 4) == 2 * 256
    assert gemm_kernel.table_bytes(16, 32, 4) == 4 * 2 * 256
    assert gemm_kernel.table_bytes(16, 32, 2) == 2 * 2 * 256


def test_wrapper_raises_past_the_shared_memory_it_needs():
    km = torch.ones(200, 400)
    with pytest.raises(ValueError, match="shared memory"):
        gemm_ops.windows_gemm(km, torch.ones(2, 400, 16))
    y = gemm_ops.windows_gemm(torch.ones(78, 156), torch.ones(2, 156, 16))
    assert tuple(y.shape) == (2, 78, 16)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) < dispatch.MIN_CAPABILITY:
        pytest.skip("needs compute capability 9.0 (kernels built for sm_90a)")
    return torch.device("cuda", 0)


def _card_close(got, want, dtype):
    tol = 3e-5 if dtype == torch.float32 else 1e-2
    d = (got.float() - want.float()).abs()
    assert bool(got.isfinite().all())
    assert float((d / (1 + want.float().abs())).max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("L", [4, 6, 8, 10, 16, 24])
@pytest.mark.parametrize("c", [1, 2, 3, 4, 8, 37, 1024])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_windows_gemm_edges(cuda_device, L, c, dtype):
    """Every mode (C = 1; 1 < C < 16; C >= 16), a ragged last item of
    several blocks, and windows one element past an 8-byte boundary."""
    dt = getattr(torch, dtype)
    km = torch.randn(L, 2 * L, device=cuda_device).to(dt)
    for t in (7, 1541 if c < 16 else 77):
        n = t * 2 * L * c
        big = torch.randn(n + 1, device=cuda_device).to(dt)
        for win in (big[:n].view(t, 2 * L, c), big[1:].view(t, 2 * L, c)):
            got = gemm_ops.windows_gemm(km, win)
            torch.cuda.synchronize()
            _card_close(got, windows_gemm_ref(km, win), dt)


@pytest.mark.cuda
@pytest.mark.parametrize("L,t", [(4, 26_214_400), (6, 17_476_267)])
def test_cuda_windows_gemm_paper_1d(cuda_device, L, t):
    """The paper's 1-D windows (104,857,600 points), float32."""
    km = torch.randn(L, 2 * L, device=cuda_device)
    win = torch.randn(t, 2 * L, 1, device=cuda_device)
    got = gemm_ops.windows_gemm(km, win)
    torch.cuda.synchronize()
    _card_close(got, windows_gemm_ref(km, win), torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_windows_gemm_largest_l(cuda_device, dtype):
    """L = 78, the largest L of a (L, 2L) float32 matrix in 48 KB: 20
    float32 k-steps and a B table past the default 48 KB of shared
    memory."""
    dt = getattr(torch, dtype)
    km = torch.randn(78, 156, device=cuda_device).to(dt)
    for c in (1, 37):
        win = torch.randn(41, 156, c, device=cuda_device).to(dt)
        got = gemm_ops.windows_gemm(km, win)
        torch.cuda.synchronize()
        _card_close(got, windows_gemm_ref(km, win), dt)
