"""The fused SpTC kernel's ``mma.sp`` tables against the JAX reference.

The kernel (``csrc/sptc_fused.cu``) reads its operand from per-lane
fragment tables (``kernels/sptc_spmm/fragments.py``): a pair-aligned 1:2
encoding for the TF32 instruction, the ``encode_24`` 2:4 encoding for the
bf16 one.  Decoded by the plain inverse of the fragment map, every table of
every paper-suite operand must give back, bit for bit, the dense swapped
(L, 2L) matrix that the JAX package's operand decodes to.  The 3xTF32 split
the kernel applies is checked here in its plain torch form.  All of this
runs on the CPU; the kernel itself is held to its plain version on the card
(``tests/test_torch_kernels.py``, ``-m cuda``).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import sparsify
from repro_torch.core import transform as port_transform
from repro_torch.core.stencil import make_stencil
from repro_torch.kernels.sptc_spmm import fragments as fr
from repro_torch.kernels.sptc_spmm import ops as sptc_ops

PAPER_SUITE = (("box", 1, 1), ("box", 1, 2), ("star", 2, 1), ("star", 2, 2),
               ("star", 2, 3), ("box", 2, 1), ("box", 2, 2), ("box", 2, 3))
L_CHOICES = ("2r+2", "2r+4", 16)


def _operands(shape, ndim, r, L_choice):
    """(port operands, reference operands) of one spec's sptc plan."""
    from repro.core import stencil as ref_stencil
    from repro.core import transform as ref_transform
    L = {"2r+2": 2 * r + 2, "2r+4": 2 * r + 4}.get(L_choice, L_choice)
    seed = 17 * ndim + r
    port = port_transform.lower_spec(make_stencil(shape, ndim, r, seed=seed),
                                     backend="sptc", L=L)
    ref = ref_transform.lower_spec(ref_stencil.make_stencil(shape, ndim, r,
                                                            seed=seed),
                                   backend="sptc", L=L)
    return port.sparsify.operands, ref.sparsify.operands, L


@pytest.mark.parametrize("L_choice", L_CHOICES)
@pytest.mark.parametrize("shape,ndim,r", PAPER_SUITE)
def test_tf32_tables_decode_to_reference_operand(shape, ndim, r, L_choice):
    from repro.core.sparsify import decode_24 as ref_decode
    ports, refs, L = _operands(shape, ndim, r, L_choice)
    assert len(ports) == len(refs)
    for port, ref in zip(ports, refs):
        a, e = fr.tf32_tables(fr.swapped_dense(port))
        mb, ks = -(-L // 16), -(-(2 * L) // fr.TF32_K)
        assert a.shape == (mb, ks, 2, 32) and a.dtype == np.float32
        assert e.shape == (mb, ks, 32) and e.dtype == np.int32
        want = np.asarray(ref_decode(ref)).astype(np.float32)
        np.testing.assert_array_equal(fr.decode_tf32(a, e, L), want)
        # every lane of a group carries its group's word
        np.testing.assert_array_equal(e, np.repeat(e[:, :, ::4], 4, axis=2))


@pytest.mark.parametrize("L_choice", L_CHOICES)
@pytest.mark.parametrize("shape,ndim,r", PAPER_SUITE)
def test_bf16_tables_decode_to_reference_operand(shape, ndim, r, L_choice):
    from repro.core.sparsify import decode_24 as ref_decode
    ports, refs, L = _operands(shape, ndim, r, L_choice)
    for port, ref in zip(ports, refs):
        vals = torch.as_tensor(np.asarray(port.values), dtype=torch.float32)
        a, e = fr.bf16_tables(vals, port.meta)
        assert a.shape == (-(-L // 16), -(-L // 8), 2, 32)
        want = torch.as_tensor(np.asarray(ref_decode(ref)),
                               dtype=torch.float32).bfloat16().float().numpy()
        np.testing.assert_array_equal(fr.decode_bf16(a, e, L), want)


def test_tables_hold_the_metadata_the_instructions_take():
    """Fields of a known operand: TF32 0b0100 / 0b1110 by pair position,
    bf16 ``idx0 | idx1 << 2`` as ``encode_24`` ordered them."""
    L = 4
    dense = np.zeros((L, 2 * L))
    dense[0, 1] = 1.0          # pair 0, position 1; 4-chunk 0, index 1
    dense[1, 6] = 2.0          # pair 3, position 0; 4-chunk 1, index 2
    a, e = fr.tf32_tables(dense)
    words = e.view(np.uint32)
    assert words[0, 0, 0] & 0xFFFF == 0x444E          # row 0: pair 0 at 1
    assert words[0, 0, 4] & 0xFFFF == 0x4444          # row 1: pair 3 at 0
    assert a[0, 0, 0, 0] == 1.0 and a[0, 0, 0, 7] == 2.0
    op = sparsify.encode_24(dense)
    a16, e16 = fr.bf16_tables(torch.as_tensor(op.values, dtype=torch.float32),
                              op.meta)
    w16 = e16.view(np.uint32)
    assert w16[0, 0, 0] & 0xF == 1 | 3 << 2            # (1, 3): value, pad
    assert (w16[0, 0, 4] >> 4) & 0xF == 2 | 3 << 2     # (2, 3)
    np.testing.assert_array_equal(fr.decode_bf16(a16, e16, L), dense)


def test_encoder_raises_on_24_operand_that_is_not_12():
    dense = np.zeros((4, 8))
    dense[2, 4] = dense[2, 5] = 1.0       # 2:4 (one 4-chunk, two non-zeros)
    assert sparsify.is_24_sparse(dense)
    with pytest.raises(ValueError, match="not 1:2"):
        fr.encode_12(dense)
    with pytest.raises(ValueError, match="not 1:2"):
        fr.tf32_tables(dense)
    # the same operand still encodes for the bf16 (2:4) route
    op = sparsify.encode_24(dense)
    a, e = fr.bf16_tables(torch.as_tensor(op.values, dtype=torch.float32),
                          op.meta)
    np.testing.assert_array_equal(fr.decode_bf16(a, e, 4), dense)


def test_fields_that_the_instruction_rejects_fail_to_decode():
    a, e = fr.tf32_tables(np.eye(4, 8))
    bad = e.copy()
    bad[0, 0, :4] = 0x5                     # not 0b0100 / 0b1110
    with pytest.raises(ValueError, match="TF32"):
        fr.decode_tf32(a, bad, 4)


def _tf32_reference(x: np.ndarray) -> np.ndarray:
    """Round to 11 significant bits, ties away from zero, in float64."""
    m, ex = np.frexp(x.astype(np.float64))              # x = m 2^ex
    r = np.sign(m) * np.floor(np.abs(m) * 2.0 ** 11 + 0.5) / 2.0 ** 11
    return np.ldexp(r, ex).astype(np.float32)


def test_tf32_round_is_round_to_nearest_ties_away():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=20000) * 10.0 ** rng.integers(-30, 30, 20000)
         ).astype(np.float32)
    # exact ties: 11 significant bits plus a half
    ties = (np.ldexp(rng.integers(1024, 2048, 64) + 0.5, -8)
            * rng.choice([-1, 1], 64)).astype(np.float32)
    x = np.concatenate([x, ties, [0.0, -0.0, np.inf, -np.inf]]).astype(
        np.float32)
    got = fr.tf32_round(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, _tf32_reference(x))
    assert not np.any(got.view(np.int32) & 0x1FFF)
    assert torch.isnan(fr.tf32_round(torch.tensor([float("nan")]))).all()


@pytest.mark.parametrize("scale", [1e-20, 1.0, 3e7])
def test_3xtf32_split_reconstructs_float32(scale):
    x = torch.as_tensor(np.random.default_rng(1).normal(size=50000) * scale,
                        dtype=torch.float32)
    hi, lo = fr.tf32_split(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    rel = ((hi.double() + lo.double() - x.double()).abs() / x.double().abs())
    assert float(rel.max()) <= 2.0 ** -21


def test_3xtf32_products_keep_float32_accuracy():
    """hi·hi + hi·lo + lo·hi of two split operands against the float64
    product: the terms the kernel drops are below float32's limit."""
    rng = np.random.default_rng(2)
    a = torch.as_tensor(rng.normal(size=10000), dtype=torch.float32)
    b = torch.as_tensor(rng.normal(size=10000), dtype=torch.float32)
    (ah, al), (bh, bl) = fr.tf32_split(a), fr.tf32_split(b)
    got = ah.double() * bh.double() + ah.double() * bl.double() \
        + al.double() * bh.double()
    want = a.double() * b.double()
    assert float(((got - want).abs() / want.abs()).max()) < 3e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("star_fast", [True, False])
def test_fused_operand_carries_both_routes(dtype, star_fast):
    sk = sparsify.sparsify_stencil_kernel(
        np.random.default_rng(3).normal(size=5))
    op = sptc_ops.fused_operand(sk.sparse, sk.perm, sk.L, star_fast=star_fast,
                                dtype=dtype, device="cpu")
    dense = fr.swapped_dense(sk.sparse)
    assert op.bf16.k_step == fr.BF16_K
    np.testing.assert_array_equal(
        fr.decode_bf16(op.bf16.a.numpy(), op.bf16.e.numpy(), sk.L),
        torch.as_tensor(dense).to(dtype).bfloat16().float().numpy())
    if dtype == torch.float32:
        assert op.tf32.k_step == fr.TF32_K
        np.testing.assert_array_equal(
            fr.decode_tf32(op.tf32.a.numpy(), op.tf32.e.numpy(), sk.L),
            dense.astype(np.float32))
    else:
        assert op.tf32 is None


def test_fused_wrapper_bounds_L_by_the_register_budget():
    w = np.random.default_rng(4).normal(size=3)
    for L, ok in ((fr.MAX_L, True), (fr.MAX_L + 2, False)):
        sk = sparsify.sparsify_stencil_kernel(w, L=L)
        op = sptc_ops.fused_operand(sk.sparse, sk.perm, L, device="cpu")
        x = torch.ones((3 * L, 2))
        if ok:
            y = sptc_ops.sptc_spmm_fused(op, x, n_out=L)
            np.testing.assert_allclose(y.numpy(), w.sum(), rtol=1e-5)
        else:
            with pytest.raises(ValueError, match="registers"):
                sptc_ops.sptc_spmm_fused(op, x, n_out=L)
