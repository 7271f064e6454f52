"""The port's hybrid family (Zamba2) against the JAX reference.

The reference runs ``zamba2-2.7b``'s ``smoke()`` config with
``use_pallas=True`` (its Pallas conv1d in interpret mode on the CPU) and
weights from ``init_params(PRNGKey(0))``; the port gets the same config
through ``config_from_fields`` (``use_kernels=True``: on the CPU the
kernel's plain version) and the same weights through ``params_from_numpy``.
Both sides run ``attn_block_kv = 8``, so the blocked attention crosses
several KV blocks and pads the last one (the full config's 1024 would make
one block of these short prompts).  The layer tests feed both packages
the same seeded NumPy inputs.

Tolerances: float32 ``rtol = atol = 1e-4`` — the two packages sum their
einsums in different orders.  bfloat16 ``5e-2`` — both round to 8 mantissa
bits, but at different places (XLA fuses element-wise chains that torch
rounds step by step; a bf16 matmul's sum order differs), and those
one-step differences propagate through the layers into the logits.

The whole model's bf16 prefill logits go through six blocks whose residual
stream grows, and a bf16 step with it: one-ulp differences between the
packages' matmuls then exceed 5e-2 at a few logits, and
the reference's own bf16 logits lie as far from its float32 ones.  So
the bf16 forward is held to the reference's bf16 logits within
``BF16_MODEL`` (0.25, the bf16 bound ``chip_smoke.py`` sets for the
kernel against ``use_kernels=False``) and, against the reference's
float32 logits, to no more than 1.25 times the reference's own bf16
error.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels.conv1d import ops as conv_ops
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.convert import config_from_fields, params_from_numpy
from repro_torch.models.nn import ParamBuilder, count_params, tree_leaves
from repro_torch.serving import BatchPolicy, GenerateDriver
from repro_torch.serving import cache as C
from repro_torch.serving import engine as E

F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=5e-2, atol=5e-2)
BF16_MODEL = dict(rtol=0.25, atol=0.25)
ARCH = "zamba2-2.7b"
BLOCK_KV = 8


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _ref_cfg(dtype="float32", **kw):
    from repro.configs.registry import get_config as ref_get
    return ref_get(ARCH, smoke=True).scaled(use_pallas=True, dtype=dtype,
                                           attn_block_kv=BLOCK_KV, **kw)


def _pair(dtype="float32", **kw):
    """(reference cfg, reference params, port cfg, port params)."""
    import jax
    from repro.models import model as RM
    rcfg = _ref_cfg(dtype, **kw)
    rparams, _ = RM.init_params(rcfg, jax.random.PRNGKey(0))
    cfg = config_from_fields(dataclasses.asdict(rcfg))
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), cfg,
                               device="cpu")
    return rcfg, rparams, cfg, params


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(b, s)).astype(np.int32)


def _both(a, dtype="float32"):
    """One NumPy array as (JAX array, torch tensor) of ``dtype``."""
    import jax.numpy as jnp
    if dtype == "bfloat16":
        return jnp.asarray(a, jnp.bfloat16), \
            torch.as_tensor(a).to(torch.bfloat16)
    return jnp.asarray(a), torch.as_tensor(a)


def _tree_t(tree):
    """A reference parameter tree as float32 tensors."""
    return {k: _tree_t(v) if isinstance(v, dict)
            else torch.as_tensor(np.asarray(v, np.float32))
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# configs and weights carried across
# ---------------------------------------------------------------------------

def test_config_fields_match_the_reference():
    from repro.configs.registry import get_config as ref_get
    assert ARCH in ARCHS
    for smoke in (False, True):
        rcfg = ref_get(ARCH, smoke=smoke)
        cfg = config_from_fields(dataclasses.asdict(rcfg))
        assert cfg == get_config(ARCH, smoke=smoke)
        assert (cfg.d_head, cfg.d_inner, cfg.ssm_heads) == \
            (rcfg.d_head, rcfg.d_inner, rcfg.ssm_heads)
    full = get_config(ARCH)
    assert (full.family, full.n_layers, full.attn_every, full.d_model,
            full.n_heads, full.n_kv_heads, full.d_head, full.d_ff,
            full.vocab, full.ssm_state, full.tie_embeddings) == \
        ("hybrid", 54, 6, 2560, 32, 32, 80, 10240, 32000, 64, False)
    assert M.n_groups(full) == 9


def test_params_carried_across_exactly(pair):
    """Every leaf equal, in the port's nested lists; the shared block is one
    dict (no group axis), so the counts agree."""
    import jax
    from repro.models.nn import count_params as ref_count
    rcfg, rparams, cfg, params = pair
    assert count_params(params) == ref_count(rparams)
    ref = jax.tree.map(np.asarray, rparams)
    assert len(params["groups"]) == M.n_groups(cfg) == 2
    assert all(len(gp) == cfg.attn_every for gp in params["groups"])

    def walk(port, want, idx):
        for k, v in want.items():
            if isinstance(v, dict):
                walk(port[k], v, idx)
            else:
                np.testing.assert_array_equal(_np(port[k]), v[idx], err_msg=k)
    for g, gp in enumerate(params["groups"]):
        for j, pl in enumerate(gp):
            walk(pl, ref["groups"], (g, j))
    walk(params["shared"], ref["shared"], ())
    assert params["shared"]["attn"]["wq"].shape == (64, 4, 16)
    for k in ("embed", "lm_head"):
        np.testing.assert_array_equal(_np(params[k]), ref[k])


def test_init_params_shapes_and_shared_once():
    import jax
    from repro.models import model as RM
    from repro.models.nn import count_params as ref_count
    cfg = get_config(ARCH, smoke=True)
    a = M.init_params(cfg, 3, device="cpu")
    b = M.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)
    rp, _ = RM.init_params(_ref_cfg(), jax.random.PRNGKey(0))
    assert count_params(a) == ref_count(rp)
    sh = a["shared"]
    assert set(sh) == {"attn_norm", "attn", "mlp_norm", "mlp"}
    assert set(sh["mlp"]) == {"w1", "w3", "w2"}
    assert tuple(sh["attn"]["wo"].shape) == (4, 16, 64)
    with pytest.raises(ValueError, match="divide"):
        M.init_params(cfg.scaled(attn_every=3), 0, device="cpu")
    # a shared block with experts gets an MoE in place of its MLP
    pb = ParamBuilder(torch.Generator(), torch.float32, torch.device("cpu"))
    moe = M._init_dense_layer(pb, cfg.scaled(n_experts=4, top_k=2))
    assert "mlp" not in moe and tuple(moe["moe"]["w1"].shape) == (4, 64, 128)
    for fam in ("encdec", "vlm"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            M.init_params(cfg.scaled(family=fam), 0, device="cpu")


def test_other_families_still_raise():
    """The enc-dec and VLM families and learned position embeddings raise,
    and their archs are not registered; dense and MoE now build."""
    cfg = get_config(ARCH, smoke=True)
    for fam in ("encdec", "vlm"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            M.init_params(cfg.scaled(family=fam), 0, device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            C.init_cache(cfg.scaled(family=fam), 1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        C.init_cache(cfg.scaled(pos_emb="learned"), 1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        M.init_params(cfg.scaled(pos_emb="learned"), 0, device="cpu")
    for arch in ("whisper-large-v3", "llama-3.2-vision-11b"):
        assert arch not in ARCHS
        with pytest.raises(KeyError, match="ROADMAP"):
            get_config(arch)
    for fam in ("dense", "moe"):
        p = M.init_params(cfg.scaled(family=fam, n_experts=4 * (fam == "moe"),
                                     top_k=2), 0, device="cpu")
        assert len(p["layers"]) == cfg.n_layers


# ---------------------------------------------------------------------------
# layers against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_head_norm(dtype):
    from repro.models import layers as RL
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    sc = rng.normal(size=16).astype(np.float32)
    (jx, tx), (js, ts) = _both(x, dtype), _both(sc, dtype)
    got = L.rms_head_norm(ts, tx, 1e-5)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(RL.rms_head_norm(js, jx, 1e-5)),
                               **(F32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_apply_rope(fraction, dtype):
    """Interleaved pairs (not rotate-half); half the lanes at 0.5; a
    batch of shifted, unordered positions."""
    from repro.models import layers as RL
    rcfg = _ref_cfg(rope_fraction=fraction, rope_theta=500.0)
    cfg = config_from_fields(dataclasses.asdict(rcfg))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = rng.permutation(40)[:14].reshape(2, 7).astype(np.int32)
    jx, tx = _both(x, dtype)
    want = RL.apply_rope(jx, _both(pos)[0], rcfg)
    got = L.apply_rope(tx, torch.as_tensor(pos), cfg)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(want),
                               **(F32 if dtype == "float32" else BF16))
    if fraction == 0.5:                     # the other half passes through
        np.testing.assert_array_equal(_np(got)[..., 8:], _np(tx)[..., 8:])
    np.testing.assert_allclose(
        _np(L.rope_freqs(cfg, 16, "cpu")),
        np.asarray(RL.rope_freqs(rcfg, 16)), rtol=1e-7)


def _qkv_inputs(b, s, t, h, kh, d, dtype, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, t, kh, d)).astype(np.float32)
    v = rng.normal(size=(b, t, kh, d)).astype(np.float32)
    return [_both(a, dtype) for a in (q, k, v)]


BLOCKED_CASES = [
    # (s, t, h, kh, causal, window, block_kv, q_offset)
    (13, 13, 4, 4, True, None, 4, 0),          # 4 blocks, 3 padded slots
    (13, 13, 4, 4, True, 5, 4, 0),             # window
    (13, 13, 4, 2, True, None, 4, 0),          # GQA, g = 2
    (12, 12, 4, 2, True, 3, 8, 0),             # GQA + window, 2 blocks
    (6, 17, 4, 4, True, None, 8, 11),          # queries at the end
    (13, 9, 4, 4, False, None, 4, 0),          # non-causal, t != s
    (5, 5, 4, 4, True, None, 1024, 0),         # the default: one block
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", BLOCKED_CASES)
def test_blocked_attention(case, dtype):
    from repro.models import layers as RL
    s, t, h, kh, causal, window, bk, off = case
    (jq, tq), (jk, tk), (jv, tv) = _qkv_inputs(2, s, t, h, kh, 16, dtype,
                                               seed=s + t + kh)
    qp = np.broadcast_to(np.arange(off, off + s, dtype=np.int32), (2, s))
    kp = np.broadcast_to(np.arange(t, dtype=np.int32), (2, t))
    want = RL.blocked_attention(jq, jk, jv, _both(qp)[0], _both(kp)[0],
                                causal=causal, window=window, block_kv=bk)
    got = L.blocked_attention(tq, tk, tv, torch.as_tensor(qp.copy()),
                              torch.as_tensor(kp.copy()), causal=causal,
                              window=window, block_kv=bk)
    assert got.dtype == tq.dtype and tuple(got.shape) == (2, s, h, 16)
    np.testing.assert_allclose(_np(got), _np(want),
                               **(F32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,block_q,window,kh", [
    (13, 4, 3, 4),          # s not a multiple of block_q, t >= L
    (16, 8, 5, 2),          # GQA, exact chunks
    (5, 8, 4, 4),           # t < L: left-padded keys
])
def test_banded_attention(s, block_q, window, kh, dtype):
    from repro.models import layers as RL
    (jq, tq), (jk, tk), (jv, tv) = _qkv_inputs(2, s, s, 4, kh, 16, dtype,
                                               seed=s)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    want = RL.banded_attention(jq, jk, jv, _both(pos)[0], _both(pos)[0],
                               window=window, block_q=block_q)
    tp = torch.as_tensor(pos.copy())
    got = L.banded_attention(tq, tk, tv, tp, tp, window=window,
                             block_q=block_q)
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    # the same band through the blocked path
    np.testing.assert_allclose(
        _np(got), _np(L.blocked_attention(tq, tk, tv, tp, tp, causal=True,
                                          window=window, block_kv=4)), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window,kh", [
    (True, None, 4), (True, 4, 2), (False, None, 4)])
def test_decode_attention(causal, window, kh, dtype):
    """A ring of 8 slots holding positions 9..14 out of order, two empty."""
    from repro.models import layers as RL
    (jq, tq), (jk, tk), (jv, tv) = _qkv_inputs(2, 1, 8, 4, kh, 16, dtype,
                                               seed=kh + 7)
    kp = np.array([[13, 14, -1, 9, 10, 11, 12, -1]] * 2, np.int32)
    qp = np.full((2, 1), 14, np.int32)
    want = RL.decode_attention(jq, jk, jv, _both(qp)[0], _both(kp)[0],
                               window=window, causal=causal)
    got = L.decode_attention(tq, tk, tv, torch.as_tensor(qp),
                             torch.as_tensor(kp), window=window, causal=causal)
    assert tuple(got.shape) == (2, 1, 4, 16) and got.dtype == tq.dtype
    np.testing.assert_allclose(_np(got), _np(want),
                               **(F32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("mode", ["self", "self-qknorm-half-rope", "cross",
                                  "banded"])
def test_attention(mode):
    """``attention`` from initialised weights: self-attention with RoPE,
    with qk-norm and RoPE on half the lanes, gated cross-attention over a
    memory, and the banded sliding-window dispatch."""
    import jax
    from repro.models import layers as RL
    from repro.models.nn import ParamBuilder as RefBuilder
    kw = {"self-qknorm-half-rope": dict(qk_norm=True, rope_fraction=0.5),
          "banded": dict(sliding_window=4, banded_attention=True,
                         attn_block_q=4)}.get(mode, {})
    rcfg = _ref_cfg(n_kv_heads=2, **kw)
    cfg = config_from_fields(dataclasses.asdict(rcfg))
    rp = RL.init_attention(RefBuilder(jax.random.PRNGKey(5)).sub("attn"),
                           rcfg, cross=mode == "cross")
    if mode == "cross":
        rp["gate"] = rp["gate"] + 0.3
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 11, 64)).astype(np.float32)
    qp = np.broadcast_to(np.arange(11, dtype=np.int32), (2, 11)).copy()
    args = dict(q_pos=qp)
    if mode == "cross":
        mem = rng.normal(size=(2, 7, 64)).astype(np.float32)
        args.update(ctx=mem, causal=False, rope=False,
                    kv_pos=np.broadcast_to(np.arange(7, dtype=np.int32),
                                           (2, 7)).copy())
    want = RL.attention(rp, _both(x)[0], rcfg, block_kv=BLOCK_KV,
                        **{k: _both(v)[0] if isinstance(v, np.ndarray) else v
                           for k, v in args.items()})
    got = L.attention(_tree_t(rp), torch.as_tensor(x), cfg, block_kv=BLOCK_KV,
                      **{k: torch.as_tensor(v) if isinstance(v, np.ndarray)
                         else v for k, v in args.items()})
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_apply_mlp(act, dtype):
    import jax
    from repro.models import layers as RL
    from repro.models.nn import ParamBuilder as RefBuilder
    rcfg = _ref_cfg(act=act, dtype=dtype)
    cfg = config_from_fields(dataclasses.asdict(rcfg))
    rp = RL.init_mlp(RefBuilder(jax.random.PRNGKey(8)).sub("mlp"), rcfg)
    port = L.init_mlp(ParamBuilder(torch.Generator(), torch.float32,
                                   torch.device("cpu")), cfg)
    assert set(port) == set(rp)
    x = np.random.default_rng(9).normal(size=(2, 5, 64)).astype(np.float32)
    jx, tx = _both(x, dtype)
    got = L.apply_mlp(_tree_t(rp), tx, cfg)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(RL.apply_mlp(rp, jx, rcfg)),
                               **(F32 if dtype == "float32" else BF16))


# ---------------------------------------------------------------------------
# the ring KV cache
# ---------------------------------------------------------------------------

def test_ring_len():
    from repro.serving import cache as RC
    for kw, cache_len in (({}, 40), ({"decode_window": 8}, 40),
                          ({"decode_window": 8}, 5),
                          ({"sliding_window": 6}, 40),
                          ({"sliding_window": 6, "decode_window": 9}, 40)):
        rcfg = _ref_cfg(**kw)
        cfg = config_from_fields(dataclasses.asdict(rcfg))
        assert C.ring_len(cfg, cache_len) == RC.ring_len(rcfg, cache_len)


@pytest.mark.parametrize("s", [3, 8, 11, 21])
def test_ring_pack_and_positions(s):
    """ring 8: s < ring (padded), s == ring, s > ring (rolled), s > 2 ring."""
    from repro.serving import cache as RC
    ring = 8
    k = np.random.default_rng(s).normal(size=(2, 3, s, 2, 4)).astype(
        np.float32)
    want = np.asarray(RC.ring_pack(_both(k)[0], ring))
    got = C.ring_pack(torch.as_tensor(k), ring)
    np.testing.assert_array_equal(got.numpy(), want)
    pos = C.ring_positions(s, ring, device="cpu")
    assert pos.dtype == torch.int32
    np.testing.assert_array_equal(pos.numpy(),
                                  np.asarray(RC.ring_positions(s, ring)))
    for slot, p in enumerate(pos.tolist()):     # slot p % ring holds p
        if p >= 0:
            assert slot == p % ring
            np.testing.assert_array_equal(got[:, :, slot].numpy(),
                                          k[:, :, p])


def test_write_token():
    import jax.numpy as jnp
    from repro.serving import cache as RC
    rng = np.random.default_rng(3)
    kc = rng.normal(size=(2, 8, 2, 4)).astype(np.float32)
    new = rng.normal(size=(2, 1, 2, 4)).astype(np.float32)
    tk = torch.as_tensor(kc)
    for slot in (0, 5, 7):
        got = C.write_token(tk, torch.as_tensor(new).double(),
                            torch.tensor(slot, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(RC.write_token(jnp.asarray(kc),
                                                   jnp.asarray(new), slot)))
    np.testing.assert_array_equal(tk.numpy(), kc)       # left as it was


@pytest.mark.parametrize("kw", [{}, {"decode_window": 8},
                                {"dtype": "bfloat16"}])
def test_init_cache_layout(kw):
    from repro.serving import cache as RC
    rcfg = _ref_cfg(**kw)
    cfg = config_from_fields(dataclasses.asdict(rcfg))
    want = RC.init_cache(rcfg, 3, 20)
    got = C.init_cache(cfg, 3, 20, device="cpu")
    assert set(got) == set(want) == {"pos", "kv_pos", "ssm", "conv", "shared"}
    dt = {"float32": torch.float32, "int32": torch.int32,
          "bfloat16": torch.bfloat16}
    for k in ("pos", "kv_pos", "ssm", "conv"):
        assert tuple(got[k].shape) == want[k].shape, k
        assert got[k].dtype == dt[str(want[k].dtype)], k
        np.testing.assert_array_equal(_np(got[k]), _np(want[k]))
    for k in ("k", "v"):
        assert tuple(got["shared"][k].shape) == want["shared"][k].shape
        assert got["shared"][k].dtype == dt[str(want["shared"][k].dtype)]
    assert got["shared"]["k"].shape[:3] == (2, 3, kw.get("decode_window", 20))


# ---------------------------------------------------------------------------
# the serving path against the reference
# ---------------------------------------------------------------------------

def test_forward_logits_match(pair):
    import jax.numpy as jnp
    from repro.models import model as RM
    rcfg, rparams, cfg, params = pair
    toks = _tokens(cfg, 2, 21, seed=1)           # 3 KV blocks, 3 padded
    want, _, _ = RM.forward(rparams, rcfg, jnp.asarray(toks))
    before = conv_ops.conv1d_causal.launches
    got, _, _ = M.forward(params, cfg, torch.as_tensor(toks))
    assert conv_ops.conv1d_causal.launches == before  # CPU: plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 21, 256)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


def test_prefill_cache_matches(pair):
    """Key by key: SSM states group-major (54 = 9 x 6 on the full config),
    the shared block's K/V packed into rings, kv_pos."""
    import jax.numpy as jnp
    from repro.serving import engine as RE
    rcfg, rparams, cfg, params = pair
    toks = _tokens(cfg, 3, 19, seed=2)
    rl, rc = RE.prefill(rparams, rcfg, jnp.asarray(toks), 32)
    pl, pc = E.prefill(params, cfg, torch.as_tensor(toks), 32)
    empty = C.init_cache(cfg, 3, 32, device="cpu")
    assert set(pc) == set(rc) == set(empty)
    assert int(pc["pos"]) == int(rc["pos"]) == 19
    np.testing.assert_array_equal(pc["kv_pos"].numpy(),
                                  np.asarray(rc["kv_pos"]))
    for k in ("ssm", "conv"):
        assert tuple(pc[k].shape) == rc[k].shape == tuple(empty[k].shape), k
        assert pc[k].dtype == empty[k].dtype
        np.testing.assert_allclose(_np(pc[k]), np.asarray(rc[k]), **F32,
                                   err_msg=k)
    for k in ("k", "v"):
        got, want = pc["shared"][k], rc["shared"][k]
        assert tuple(got.shape) == want.shape == \
            tuple(empty["shared"][k].shape) == (2, 3, 32, 4, 16)
        np.testing.assert_allclose(_np(got), np.asarray(want), **F32,
                                   err_msg=k)
    np.testing.assert_allclose(_np(pl), np.asarray(rl), **F32)


def _decode_against_reference(pair_, prompt, steps, seed):
    import jax.numpy as jnp
    from repro.serving import engine as RE
    rcfg, rparams, cfg, params = pair_
    toks = _tokens(cfg, 2, prompt + steps, seed=seed)
    _, rc = RE.prefill(rparams, rcfg, jnp.asarray(toks[:, :prompt]), 32)
    _, pc = E.prefill(params, cfg, torch.as_tensor(toks[:, :prompt]), 32)
    for i in range(prompt, prompt + steps):
        step = toks[:, i:i + 1]
        rl, rc = RE.decode_step(rparams, rcfg, rc, jnp.asarray(step))
        kept = {k: v.clone() for k, v in _flat(pc).items()}
        pl, pc2 = E.decode_step(params, cfg, pc, torch.as_tensor(step))
        for k, v in _flat(pc).items():           # the input cache is kept
            assert torch.equal(kept[k], v), k
        pc = pc2
        assert tuple(pl.shape) == (2, 1, cfg.vocab) and int(pc["pos"]) == i + 1
        np.testing.assert_allclose(_np(pl), np.asarray(rl), **F32)
        np.testing.assert_array_equal(pc["kv_pos"].numpy(),
                                      np.asarray(rc["kv_pos"]))
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(_np(pc[k]), np.asarray(rc[k]), **F32)
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(pc["shared"][k]),
                                   np.asarray(rc["shared"][k]), **F32)


def _flat(cache):
    """A cache's tensors by path (``shared/k``)."""
    out = {}
    for k, v in cache.items():
        if isinstance(v, dict):
            out.update({f"{k}/{kk}": vv for kk, vv in v.items()})
        else:
            out[k] = v
    return out


def test_teacher_forced_decode_matches(pair):
    _decode_against_reference(pair, 13, 4, seed=3)


def test_decode_window_ring_wraps_like_the_reference():
    """decode_window 8 under a 13-token prompt: the ring wraps at prefill
    and again while decoding; slots, masks and logits as the reference's."""
    _decode_against_reference(_pair(decode_window=8), 13, 5, seed=4)


def test_greedy_generate_matches(pair):
    import jax.numpy as jnp
    from repro.serving import engine as RE
    rcfg, rparams, cfg, params = pair
    toks = _tokens(cfg, 3, 9, seed=4)
    rt, rc = RE.generate(rparams, rcfg, jnp.asarray(toks), 6, 32)
    pt, pc = E.generate(params, cfg, torch.as_tensor(toks), 6, 32)
    assert pt.dtype == torch.int32 and tuple(pt.shape) == (3, 6)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(rt))
    assert int(pc["pos"]) == int(rc["pos"]) == 9 + 6


def test_generate_driver_matches(pair):
    """The same 6-request mix (two prompt lengths) through both drivers."""
    import jax.numpy as jnp
    from repro.serving import BatchPolicy as RefPolicy
    from repro.serving import GenerateDriver as RefDriver
    rcfg, rparams, cfg, params = pair
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, 8 if i % 3 else 12).astype(np.int32)
               for i in range(6)]
    outs = []
    for drv in (RefDriver(rparams, rcfg, cache_len=32, autostart=False,
                          policy=RefPolicy(max_batch=3, max_wait_ms=1.0)),
                GenerateDriver(params, cfg, cache_len=32, autostart=False,
                               policy=BatchPolicy(max_batch=3,
                                                  max_wait_ms=1.0))):
        futs = [drv.submit(jnp.asarray(p) if isinstance(drv, RefDriver)
                           else torch.as_tensor(p), 5) for p in prompts]
        drv.start()
        outs.append(([np.asarray(f.result()) for f in futs],
                     drv.metrics()["overall"]))
        drv.close()
    (ref_toks, ref_m), (got_toks, got_m) = outs
    for r, g in zip(ref_toks, got_toks):
        np.testing.assert_array_equal(g, r)
    for k in ("groups", "submitted", "completed", "failed", "rejected",
              "batches", "batch_occupancy"):
        assert got_m[k] == ref_m[k], k
    assert got_m["batches"] == 3 and got_m["latency"]["count"] == 6


def test_bf16_forward_and_decode_match(pair):
    import jax.numpy as jnp
    from repro.models import model as RM
    from repro.serving import engine as RE
    rcfg, rparams, cfg, params = _pair("bfloat16")
    assert params["shared"]["attn"]["wq"].dtype == torch.bfloat16
    toks = _tokens(cfg, 2, 19, seed=6)
    want = np.asarray(RM.forward(rparams, rcfg, jnp.asarray(toks))[0])
    got, _, _ = M.forward(params, cfg, torch.as_tensor(toks))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), want, **BF16_MODEL)
    exact = np.asarray(RM.forward(pair[1], pair[0], jnp.asarray(toks))[0])
    ref_err = np.abs(want - exact).max()
    assert np.abs(_np(got) - exact).max() <= 1.25 * ref_err, ref_err
    _, rc = RE.prefill(rparams, rcfg, jnp.asarray(toks[:, :18]), 32)
    _, pc = E.prefill(params, cfg, torch.as_tensor(toks[:, :18]), 32)
    assert pc["conv"].dtype == pc["shared"]["k"].dtype == torch.bfloat16
    rl, _ = RE.decode_step(rparams, rcfg, rc, jnp.asarray(toks[:, 18:]))
    pl, _ = E.decode_step(params, cfg, pc, torch.as_tensor(toks[:, 18:]))
    np.testing.assert_allclose(_np(pl), np.asarray(rl), **BF16)


# ---------------------------------------------------------------------------
# port-only checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,window", [(12, None), (16, None), (33, None),
                                      (20, 8), (13, 13)])
def test_prefill_then_decode_matches_forward(pair, s, window):
    """Prefill S tokens, then decode token S: the full forward's logits at
    position S.  With a window W (sliding_window = decode_window = W) the
    forward masks to the last W positions and the ring holds W slots, so
    S = 20, W = 8 wraps the ring (S = 13, W = 13 fills it exactly)."""
    _, _, cfg, params = pair
    if window:
        cfg = cfg.scaled(sliding_window=window, decode_window=window)
    toks = torch.as_tensor(_tokens(cfg, 2, s + 1, seed=s))
    full, _, _ = M.forward(params, cfg, toks)
    _, cc = E.prefill(params, cfg, toks[:, :s], 64)
    assert cc["shared"]["k"].shape[2] == (window or 64)
    step, cc2 = E.decode_step(params, cfg, cc, toks[:, s:s + 1])
    assert int(cc2["pos"]) == s + 1
    np.testing.assert_allclose(_np(step[:, 0]), _np(full[:, s]), **F32)


def test_kernel_flag_matches_plain_reference_conv(pair):
    _, _, cfg, params = pair
    toks = torch.as_tensor(_tokens(cfg, 2, 20, seed=8))
    on, _, _ = M.forward(params, cfg, toks)
    off, _, _ = M.forward(params, cfg.scaled(use_kernels=False), toks)
    np.testing.assert_allclose(_np(on), _np(off), **F32)


def test_serve_launcher_runs_on_cpu():
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--requests", "6", "--max-batch", "4",
         "--prompt-len", "8", "--new-tokens", "4"],
        check=True, timeout=300, env=env, capture_output=True, text=True)
    lines = out.stdout.splitlines()
    assert lines[0] == f"arch={ARCH}-smoke params=186,528"
    assert "served 6 requests (24 new tokens)" in lines[1]
    assert lines[2].startswith("batches=2 occupancy=3.0")
    assert lines[3].startswith("generated[0,:16] = [")


# ---------------------------------------------------------------------------
# card only: the model with the CUDA conv kernel against the plain conv
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_prefill_with_kernel_matches_plain(dtype, monkeypatch):
    """Smoke config on the card: one conv1d launch per Mamba layer per
    prefill, logits within 1e-4 of the same model whose conv is the
    kernel's plain version, a planted fault (taps shifted by one) outside
    it, and prefill-then-decode through a wrapping ring against forward."""
    tol = 1e-4
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs a CUDA device of compute capability 9.0")
    from repro_torch.kernels.conv1d.ref import conv1d_causal_plain
    from repro_torch.models import ssm
    cfg = get_config(ARCH, smoke=True).scaled(dtype=dtype, use_kernels=True)
    params = M.init_params(cfg, 0)
    toks = torch.as_tensor(_tokens(cfg, 3, 41, seed=10), device="cuda")
    before = conv_ops.conv1d_causal.launches
    on, cc = E.prefill(params, cfg, toks, 64)
    assert conv_ops.conv1d_causal.launches == before + cfg.n_layers
    toks_out, _ = E.generate(params, cfg, toks, 4, 64)
    assert tuple(toks_out.shape) == (3, 4)
    if dtype == "float32":
        wcfg = cfg.scaled(sliding_window=16, decode_window=16)
        full, _, _ = M.forward(params, wcfg, toks)
        _, wc = E.prefill(params, wcfg, toks[:, :40], 64)
        step, _ = E.decode_step(params, wcfg, wc, toks[:, 40:])
        np.testing.assert_allclose(_np(step[:, 0].cpu()),
                                   _np(full[:, 40].cpu()), rtol=2e-2,
                                   atol=2e-2)
    monkeypatch.setattr(ssm, "conv1d_causal", conv1d_causal_plain)
    plain, _, _ = M.forward(params, cfg, toks)
    monkeypatch.setattr(ssm, "conv1d_causal", lambda x, w: conv1d_causal_plain(
        x, torch.roll(w, 1, dims=0)))
    fault, _, _ = M.forward(params, cfg, toks)
    torch.cuda.synchronize()
    on, plain, fault = _np(on.cpu()), _np(plain.cpu()), _np(fault.cpu())
    np.testing.assert_allclose(on, plain, rtol=tol, atol=tol)
    assert not np.allclose(fault, plain, rtol=tol, atol=tol)
