"""The v1 compressed SpMM on the sparse tensor cores (``csrc/sptc_spmm.cu``).

The kernel canonicalises the (M, K/2) operand on the card, in its prologue,
into ``mma.sp`` tables of two passes (``fragments.v1_tables`` is the plain
torch version), then runs ``mma.sp`` with the operand as A and the windows
as B: float32 as 3xTF32 on 1:2 pairs (one fresh accumulator per k-step,
added in float32), bfloat16 on sorted 2:4 chunks with float32 sums.  On the
CPU the canonicalisation is held to the dense operand bit for bit on random
metadata, and the kernel's arithmetic, emulated in plain torch from those
tables, to the plain version and to the JAX package's Pallas kernel
(interpret mode); the tables are checked to fit shared memory for every
operand the wrapper accepts.  The kernel itself is held to its plain
version on the card (``-m cuda``).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.core import sparsify
from repro_torch.kernels import dispatch
from repro_torch.kernels.build import SMEM_LIMIT, SMEM_OPT_IN
from repro_torch.kernels.sptc_spmm import fragments as fr
from repro_torch.kernels.sptc_spmm import kernel as spmm_kernel
from repro_torch.kernels.sptc_spmm import ops as sptc_ops
from repro_torch.kernels.sptc_spmm.ref import sptc_spmm_windows_ref
from repro_torch.tuner.search import l_candidates

F32_TOL = dict(rtol=3e-5, atol=3e-5)      # f32: summation order only
#: bf16 storage: the kernel's and the reference's sums differ in order, so a
#: bf16-stored result can land one bf16 rounding step (2^-8 relative) apart
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
#: (M, K/2): M not a multiple of 16, several M blocks, odd K/2
SHAPES = ((4, 4), (6, 6), (6, 7), (17, 12), (40, 20), (1, 1))


def _operand(m, kh, seed, *, past_k: bool = False, eighths: bool = False):
    """Random values (a tenth of them zero) and random 2:4 metadata in
    [0, 4): duplicates, descending slots, (0, 1) and (2, 3) segments.  With
    an odd K/2 the last segment's field stays in {0, 1} (positions inside
    K) unless ``past_k``.  ``eighths``: values on a 1/8 grid, whose sums of
    two are exact in bfloat16."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(m, kh)).astype(np.float32)
    if eighths:
        v = np.round(v * 8) / 8
    v[rng.random((m, kh)) < 0.1] = 0
    meta = rng.integers(0, 4, size=(m, kh))
    if kh % 2 and not past_k:
        meta[:, -1] = rng.integers(0, 2, size=m)
    return v, meta


def _dense(v, meta):
    """The reference's one-hot decompression in float32: each slot's value
    added at position 4 (j // 2) + meta, positions past K matching nothing."""
    m, kh = v.shape
    out = np.zeros((m, 2 * kh), np.float32)
    for j in range(kh):
        pos = 4 * (j // 2) + meta[:, j]
        for i in np.nonzero(pos < 2 * kh)[0]:
            out[i, pos[i]] += v[i, j]
    return out


def _emulate(values, meta, win, *, lo: bool = True):
    """The kernel's arithmetic in plain torch, from its canonical tables:
    per k-step and pass, float32 as 3xTF32 (``lo=False``: the hi·hi term
    alone) summed in a fresh accumulator and added in float32; bfloat16
    operands with float32 sums.  Pass 1 only in M blocks whose flag is set.
    Returns the result in the windows' dtype."""
    tb = fr.v1_tables(values, meta)
    tf32 = values.dtype == torch.float32
    m, kh = values.shape
    step = fr.TF32_K if tf32 else fr.BF16_K
    ks = tb.words.shape[1]
    dense = F.pad(fr.decode_v1(tb, kh, tf32=tf32), (0, ks * step - 2 * kh))
    rows2 = tb.second.repeat_interleave(fr.ROWS)[:m]
    assert not bool(dense[1, ~rows2].any())      # pass 1 only where flagged
    passes = (0, 1) if bool(tb.second.any()) else (0,)
    w = F.pad(win.float(), (0, 0, 0, ks * step - 2 * kh))
    d = torch.zeros(win.shape[0], m, win.shape[2])
    for s in range(0, ks * step, step):
        b = w[:, s:s + step]
        e = torch.zeros_like(d)
        for p in passes:
            a = dense[p, :, s:s + step]
            if tf32:
                (ah, al), (bh, bl) = fr.tf32_split(a), fr.tf32_split(b)
                if lo:
                    e = e + torch.einsum("mk,tkn->tmn", al, bh)
                    e = e + torch.einsum("mk,tkn->tmn", ah, bl)
                e = e + torch.einsum("mk,tkn->tmn", ah, bh)
            else:
                e = e + torch.einsum("mk,tkn->tmn", a, b)
        d = d + e
    return d.to(win.dtype)


@pytest.mark.parametrize("m,kh", SHAPES + ((64, 96), (3, 5)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("past_k", [False, True])
def test_v1_tables_decode_to_the_dense_operand(m, kh, dtype, past_k):
    """Pass 0 plus pass 1 is the reference's dense operand bit for bit, every
    field is one the instruction takes (decode_v1 raises otherwise)."""
    v, meta = _operand(m, kh, seed=m * 100 + kh, past_k=past_k)
    values = torch.as_tensor(v).to(getattr(torch, dtype))
    tb = fr.v1_tables(values, torch.as_tensor(meta))
    ks = -(-2 * kh // (fr.TF32_K if dtype == "float32" else fr.BF16_K))
    assert tuple(tb.words.shape) == (2, ks, m, 4)
    assert tuple(tb.second.shape) == (-(-m // 16),)
    got = fr.decode_v1(tb, kh, tf32=dtype == "float32")
    want = _dense(values.float().numpy(), meta)
    np.testing.assert_array_equal(got.sum(dim=0).numpy(), want)
    np.testing.assert_array_equal((got[0] + got[1]).numpy(), want)


def test_random_metadata_has_every_kind():
    """The random operands above hold what the canonicalisation must handle:
    both slots on one position, slots in descending order, and (0, 1) and
    (2, 3) segments."""
    _, meta = _operand(40, 20, seed=40 * 100 + 20)
    a, b = meta[:, 0::2], meta[:, 1::2]
    assert (a == b).any() and (a > b).any()
    assert ((a == 0) & (b == 1)).any() and ((a == 2) & (b == 3)).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_duplicates_and_tf32_pairs_take_pass_1(dtype):
    """Both slots on one position take pass 1 in both routes; two slots in
    one aligned pair (positions 0 and 1) only in the TF32 one."""
    values = torch.ones(2, 2, dtype=getattr(torch, dtype))
    dup = fr.v1_tables(values, torch.tensor([[2, 2], [1, 3]]))
    assert dup.second.tolist() == [True]
    pair = fr.v1_tables(values, torch.tensor([[0, 1], [3, 2]]))
    assert pair.second.tolist() == [dtype == "float32"]
    # a zero value takes no slot: nothing to split
    zero = fr.v1_tables(torch.tensor([[1.0, 0.0]]).to(values.dtype),
                        torch.tensor([[1, 1]]))
    assert zero.second.tolist() == [False]


@pytest.mark.parametrize("r", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spider_operands_take_one_pass(r, dtype):
    """The strided-swapped operands are 1:2 at pair granularity for
    L >= 2r+2, so no M block of the main path runs pass 1."""
    for L in l_candidates(r):
        sk = sparsify.sparsify_stencil_kernel(
            np.random.default_rng(r).normal(size=2 * r + 1), L=L)
        values = torch.as_tensor(sk.values, dtype=getattr(torch, dtype))
        tb = fr.v1_tables(values, torch.as_tensor(sk.meta))
        assert not bool(tb.second.any()), L


@pytest.mark.parametrize("m,kh", SHAPES)
@pytest.mark.parametrize("n", [1, 3, 37])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_emulated_kernel_matches_plain_and_pallas(m, kh, n, dtype):
    import jax.numpy as jnp
    from repro.kernels.sptc_spmm.ops import sptc_spmm_windows as ref_windows
    # bfloat16: values on a 1/8 grid, as the reference sums both slots of a
    # position in the values' dtype before its dot (its one-hot) where the
    # plain version and the kernel sum their products in float32
    v, meta = _operand(m, kh, seed=m + kh + n, eighths=dtype == "bfloat16")
    win = np.random.default_rng(n).normal(size=(5, 2 * kh, n)).astype(
        np.float32)
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    values, twin = torch.as_tensor(v).to(td), torch.as_tensor(win).to(td)
    tmeta = torch.as_tensor(meta)
    got = _emulate(values, tmeta, twin)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(
        got.float().numpy(),
        sptc_spmm_windows_ref(values, tmeta, twin).float().numpy(), **tol)
    want = ref_windows(jnp.asarray(v, jd), jnp.asarray(meta),
                       jnp.asarray(win, jd), interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_positions_past_k_match_nothing_as_in_pallas(dtype):
    """An odd K/2 whose last segment names positions 2 or 3 (past K): the
    kernel drops them, as the reference's one-hot matches no row there (the
    plain version indexes past the windows and raises)."""
    import jax.numpy as jnp
    from repro.kernels.sptc_spmm.ops import sptc_spmm_windows as ref_windows
    v, meta = _operand(6, 7, seed=5, past_k=True, eighths=True)
    meta[:, -1] = 3
    win = np.random.default_rng(7).normal(size=(4, 14, 9)).astype(np.float32)
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    got = _emulate(torch.as_tensor(v).to(td), torch.as_tensor(meta),
                   torch.as_tensor(win).to(td))
    want = ref_windows(jnp.asarray(v, jd), jnp.asarray(meta),
                       jnp.asarray(win, jd), interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **(F32_TOL if dtype == "float32" else BF16_TOL))
    with pytest.raises(IndexError):
        sptc_spmm_windows_ref(torch.as_tensor(v), torch.as_tensor(meta),
                              torch.as_tensor(win))


@pytest.mark.parametrize("m,kh", [(4, 4), (6, 6), (17, 12), (40, 20)])
def test_dropping_the_lo_terms_misses_the_f32_tolerance(m, kh):
    """TF32 alone (no lo terms) is not float32 accuracy, so the f32 check
    must flag a kernel that drops them."""
    v, meta = _operand(m, kh, seed=kh)
    values, tmeta = torch.as_tensor(v), torch.as_tensor(meta)
    win = torch.as_tensor(np.random.default_rng(m).normal(
        size=(64, 2 * kh, 37)).astype(np.float32))
    want = sptc_spmm_windows_ref(values, tmeta, win)
    err = ((_emulate(values, tmeta, win, lo=False) - want).abs()
           / (1 + want.abs())).max()
    assert float(err) > F32_TOL["rtol"]
    ok = ((_emulate(values, tmeta, win) - want).abs() / (1 + want.abs())).max()
    assert float(ok) < F32_TOL["rtol"] / 3


@pytest.mark.parametrize("itemsize", [4, 2])
def test_tables_fit_every_operand_the_wrapper_accepts(itemsize):
    """The wrapper takes M * K/2 <= 6144 slots; the kernel's tables (two
    passes, rows past M not stored) fit a block's shared memory for every
    such operand, the largest being (6144, 1)."""
    limit = SMEM_LIMIT // 8
    sizes = [spmm_kernel.table_bytes(m, limit // m, itemsize)
             for m in range(1, limit + 1)]
    assert max(sizes) <= SMEM_OPT_IN
    assert max(sizes) == spmm_kernel.table_bytes(limit, 1, itemsize)
    # one k-step: two passes of 16 + 2 bytes per row, a flag per M block
    assert spmm_kernel.table_bytes(4, 4, 4) == 2 * 4 * 18 + 4
    assert spmm_kernel.table_bytes(17, 12, 4) == 2 * 3 * 17 * 18 + 8
    assert spmm_kernel.table_bytes(17, 12, 2) == 2 * 2 * 17 * 18 + 8


def test_wrapper_takes_the_largest_operands():
    for m, kh in ((64, 96), (1, 6144), (6144, 1)):
        y = sptc_ops.sptc_spmm_windows(
            torch.ones(m, kh), torch.zeros(m, kh, dtype=torch.int32),
            torch.ones(2, 2 * kh, 3))
        assert tuple(y.shape) == (2, m, 3)
    with pytest.raises(ValueError, match="shared memory"):
        sptc_ops.sptc_spmm(torch.ones(65, 96),
                           torch.zeros(65, 96, dtype=torch.int32),
                           torch.ones(192, 3))


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
@pytest.mark.parametrize("m,kh", SHAPES)
@pytest.mark.parametrize("n", [1, 3, 37, 1000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_v1_random_metadata_edges(cuda_device, m, kh, n, dtype):
    """Random 2:4 metadata, M not a multiple of 16 and several M blocks,
    windows with a row stride other than N and contiguous ones, one launch
    per call."""
    dt = getattr(torch, dtype)
    v, meta = _operand(m, kh, seed=m + kh + n)
    vals = torch.as_tensor(v, device=cuda_device).to(dt)
    tmeta = torch.as_tensor(meta, device=cuda_device)
    big = torch.randn(7, 2 * kh, n + 3, device=cuda_device).to(dt)
    for win in (big[:, :, 2:2 + n], big[:, :, :n].contiguous()):
        before = sptc_ops.sptc_spmm_windows.launches
        got = sptc_ops.sptc_spmm_windows(vals, tmeta, win)
        assert sptc_ops.sptc_spmm_windows.launches == before + 1
        torch.cuda.synchronize()
        _card_close(got, sptc_spmm_windows_ref(vals, tmeta, win), dt)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_v1_more_tiles_than_a_grid_axis(cuda_device, n, dtype):
    """70,001 tiles, past the 65,535 of a grid's y axis."""
    dt = getattr(torch, dtype)
    v, meta = _operand(6, 6, seed=n)
    vals = torch.as_tensor(v, device=cuda_device).to(dt)
    tmeta = torch.as_tensor(meta, device=cuda_device)
    win = torch.randn(70_001, 12, n, device=cuda_device).to(dt)
    got = sptc_ops.sptc_spmm_windows(vals, tmeta, win)
    torch.cuda.synchronize()
    _card_close(got, sptc_spmm_windows_ref(vals, tmeta, win), dt)


@pytest.mark.cuda
@pytest.mark.parametrize("m,kh", [(64, 96), (1, 6144), (6144, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_v1_largest_operands(cuda_device, m, kh, dtype):
    """The largest operands the wrapper accepts: (6144, 1) takes 217.5 KB of
    tables, past the default 48 KB of shared memory."""
    dt = getattr(torch, dtype)
    v, meta = _operand(m, kh, seed=m)
    vals = torch.as_tensor(v, device=cuda_device).to(dt)
    tmeta = torch.as_tensor(meta, device=cuda_device)
    for n in (1, 3):
        win = torch.randn(5, 2 * kh, n, device=cuda_device).to(dt)
        got = sptc_ops.sptc_spmm_windows(vals, tmeta, win)
        torch.cuda.synchronize()
        _card_close(got, sptc_spmm_windows_ref(vals, tmeta, win), dt)


@pytest.mark.cuda
@pytest.mark.parametrize("r,t", [(1, 26_214_400), (2, 17_476_267)])
def test_cuda_v1_paper_1d(cuda_device, r, t):
    """The paper's 1-D windows (104,857,600 points) through SPIDER's
    operand at L = 2r+2, float32."""
    L = 2 * r + 2
    sk = sparsify.sparsify_stencil_kernel(
        np.random.default_rng(r).normal(size=2 * r + 1), L=L)
    vals = torch.as_tensor(sk.values, dtype=torch.float32, device=cuda_device)
    meta = torch.as_tensor(sk.meta, device=cuda_device)
    win = torch.randn(t, 2 * L, 1, device=cuda_device)
    got = sptc_ops.sptc_spmm_windows(vals, meta, win)
    torch.cuda.synchronize()
    _card_close(got, sptc_spmm_windows_ref(vals, meta, win), torch.float32)


def test_timing_tool_needs_a_card():
    """``tools/time_v1_spmm.py`` times the kernel on the card only: without
    a CUDA device it exits non-zero and prints no time."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, str(root / "tools" / "time_v1_spmm.py"), "--one",
         str(root / "src")], capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 2, out.stderr
    assert "ms" not in out.stdout
