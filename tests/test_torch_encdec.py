"""The port's enc-dec family (``whisper-large-v3``) against the JAX reference.

Whisper: a 32-layer bidirectional encoder over stubbed frame embeddings
(the model's ``memory``), a 32-layer decoder with causal self-attention
and ungated cross-attention over the encoder's output, learned positions
(no RoPE), LayerNorm and GELU.  The reference runs the ``smoke()`` config
(2 + 2 layers, 16 frames) with ``attn_block_kv = 8`` and its weights from
``init_params(PRNGKey(0))``; the port gets both carried across
(``tests/_torch_memory_models.py``).  Tokens and memories come from NumPy
seeds.

Tolerances (``_torch_memory_models``): float32 ``1e-5`` relative and
absolute (the logits land within 3e-6); bf16 as ``test_torch_dense.py``
states it; prefill-then-decode against forward ``1e-2``, the reference's
own.  Each float32 comparison with a memory also runs a planted fault:
another seed's memory must move the logits past the tolerance.
"""
import dataclasses

import numpy as np
import pytest
import torch

import _torch_memory_models as MM
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.models.convert import config_from_fields
from repro_torch.models.nn import count_params, tree_leaves
from repro_torch.serving import cache as C

ARCH = "whisper-large-v3"
#: the full config's parameters, as the reference counts them
#: (``jax.eval_shape`` of its ``init_params``)
FULL_PARAMS = 1_645_061_120


@pytest.fixture(scope="module")
def pair():
    return MM.pair(ARCH)


# ---------------------------------------------------------------------------
# config and weights
# ---------------------------------------------------------------------------

def test_config_fields_match_the_reference():
    MM.check_config_fields(ARCH)


def test_full_config_as_published():
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.n_enc_layers, cfg.n_layers, cfg.d_model,
            cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab) == (
        "encdec", 32, 32, 1280, 20, 20, 5120, 51866)
    assert (cfg.n_frames, cfg.pos_emb, cfg.act, cfg.norm, cfg.max_seq) == (
        1500, "learned", "gelu", "ln", 32768)


def test_full_size_parameter_count(monkeypatch):
    MM.check_full_param_count(ARCH, FULL_PARAMS, monkeypatch)


def test_params_carried_across_exactly(pair):
    """Every leaf equal: the encoder and decoder stacks split into lists
    of layers, ``pos``, ``enc_pos`` and ``enc_norm`` leaf for leaf."""
    import jax
    from repro.models.nn import count_params as ref_count
    rcfg, rparams, cfg, params = pair
    assert count_params(params) == ref_count(rparams)
    ref = jax.tree.map(np.asarray, rparams)
    assert set(params) == set(ref) == {
        "embed", "final_norm", "lm_head", "pos", "enc_pos", "enc_layers",
        "enc_norm", "dec_layers"}
    assert len(params["enc_layers"]) == cfg.n_enc_layers
    assert len(params["dec_layers"]) == cfg.n_layers
    assert MM.leaves_equal(params, ref) == len(tree_leaves(params))
    dec = params["dec_layers"][0]
    assert set(dec) == {"attn_norm", "attn", "mlp_norm", "mlp", "cross_norm",
                        "cross"}
    assert "gate" not in dec["cross"] and set(dec["mlp"]) == {"w1", "w2"}
    assert set(dec["cross_norm"]) == {"scale", "bias"}          # LayerNorm
    assert tuple(params["pos"].shape) == (cfg.max_seq, cfg.d_model)
    assert tuple(params["enc_pos"].shape) == (cfg.n_frames, cfg.d_model)


def test_init_params_shapes_and_seed():
    import jax
    from repro.models import model as RM
    from repro.models.nn import count_params as ref_count
    cfg = get_config(ARCH, smoke=True)
    a = M.init_params(cfg, 3, device="cpu")
    b = M.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)
    rp, _ = RM.init_params(MM.ref_cfg(ARCH), jax.random.PRNGKey(0))
    assert count_params(a) == ref_count(rp)


@pytest.mark.parametrize("kw", [{}, {"decode_window": 8},
                                {"dtype": "bfloat16"}])
def test_init_cache_layout(kw):
    """The self-attention rings and the cross K/V of ``n_frames`` slots per
    decoder layer, as the reference lays them out."""
    from repro.serving import cache as RC
    rcfg = MM.ref_cfg(ARCH, **kw)
    cfg = config_from_fields(dataclasses.asdict(rcfg))
    want = RC.init_cache(rcfg, 3, 40)
    got = C.init_cache(cfg, 3, 40, device="cpu")
    assert set(got) == set(want) == {"pos", "kv_pos", "k", "v", "cross"}
    flat = [(k, got[k], want[k]) for k in ("pos", "kv_pos", "k", "v")] + \
        [(f"cross.{k}", got["cross"][k], want["cross"][k]) for k in "kv"]
    for name, g, w in flat:
        assert tuple(g.shape) == w.shape, name
        assert str(g.dtype).split(".")[-1] == str(w.dtype), name
        np.testing.assert_array_equal(MM.np_(g), MM.np_(w))
    assert tuple(got["cross"]["k"].shape) == (cfg.n_layers, 3, cfg.n_frames,
                                              cfg.n_kv_heads, cfg.d_head)
    assert got["k"].shape[2] == kw.get("decode_window", 40)


# ---------------------------------------------------------------------------
# the encoder and the forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches(dtype, pair):
    """The encoder's output over the same frames: float32 within ``F32``,
    bf16 within ``BF16`` (two layers, a LayerNorm last)."""
    import jax.numpy as jnp
    from repro.models import model as RM
    if dtype == "float32":
        rcfg, rparams, cfg, params = pair
    else:
        rcfg, rparams, cfg, params = MM.pair(ARCH, dtype)
    frames = MM.memory(cfg, 2, 3)
    jf, tf = MM.both(frames, dtype)
    want = np.asarray(RM.encode(rparams, rcfg, jf).astype(jnp.float32))
    got = M.encode(params, cfg, tf)
    assert got.dtype == cfg.torch_dtype
    assert tuple(got.shape) == (2, cfg.n_frames, cfg.d_model)
    np.testing.assert_allclose(MM.np_(got), want,
                               **(MM.F32 if dtype == "float32" else MM.BF16))


def test_encode_is_bidirectional(pair):
    """A frame's encoding depends on the frames after it (no causal mask)."""
    _, _, cfg, params = pair
    frames = torch.as_tensor(MM.memory(cfg, 1, 4))
    moved = frames.clone()
    moved[:, -1] = torch.as_tensor(MM.memory(cfg, 1, 5))[:, -1]
    a, b = M.encode(params, cfg, frames), M.encode(params, cfg, moved)
    assert float((a[:, 0] - b[:, 0]).abs().max()) > 1e-4


@pytest.mark.parametrize("seed", [1, 2])
def test_forward_with_memory_matches(pair, seed):
    MM.check_forward(pair, seed)


def test_forward_needs_a_memory(pair):
    _, _, cfg, params = pair
    toks = torch.as_tensor(MM.tokens(cfg, 1, 4))
    with pytest.raises(ValueError, match="requires a memory"):
        M.forward(params, cfg, toks)


def test_prefill_honours_a_sliding_window(pair):
    """With a window forced on, the port's prefill logits equal the
    reference's ``forward`` (which masks to the window), and its
    prefill-then-decode equals its forward.  The reference's own prefill
    attends with no window there (``collect_kv``), so its
    prefill-then-decode misses its forward: a fault of the reference the
    port does not copy."""
    import jax.numpy as jnp
    from repro.models import model as RM
    from repro.serving import engine as RE
    from repro_torch.serving import engine as E
    rcfg, rparams, cfg, params = pair
    rcfg = rcfg.scaled(sliding_window=8, decode_window=8)
    cfg = cfg.scaled(sliding_window=8, decode_window=8)
    toks, mem = MM.tokens(cfg, 2, 21, seed=8), MM.memory(cfg, 2, 8)
    want = np.asarray(RM.forward(rparams, rcfg, jnp.asarray(toks),
                                 memory=jnp.asarray(mem))[0])
    got, _ = E.prefill(params, cfg, torch.as_tensor(toks[:, :20]), 32,
                       memory=torch.as_tensor(mem))
    np.testing.assert_allclose(MM.np_(got), want[:, :20], **MM.F32)
    MM.check_prefill_then_decode(pair, 20, 8)
    _, rc = RE.prefill(rparams, rcfg, jnp.asarray(toks[:, :20]), 32,
                       memory=jnp.asarray(mem))
    rl, _ = RE.decode_step(rparams, rcfg, rc, jnp.asarray(toks[:, 20:]))
    assert np.abs(np.asarray(rl)[:, 0] - want[:, 20]).max() > 1e-2


def test_forward_collect_kv_keeps_the_encoder_output(pair):
    """Prefill's forward returns every decoder layer's K/V and the
    encoder's output, which its cross K/V are computed from."""
    _, _, cfg, params = pair
    toks = torch.as_tensor(MM.tokens(cfg, 2, 9))
    mem = torch.as_tensor(MM.memory(cfg, 2, 9))
    logits, _, kv = M.forward(params, cfg, toks, memory=mem, collect_kv=True)
    k, v = kv["self"]
    assert tuple(k.shape) == tuple(v.shape) == (cfg.n_layers, 2, 9,
                                                cfg.n_kv_heads, cfg.d_head)
    assert torch.equal(kv["memory"], M.encode(params, cfg, mem))
    plain, _, _ = M.forward(params, cfg, toks, memory=mem)
    np.testing.assert_allclose(MM.np_(logits), MM.np_(plain), **MM.F32)


# ---------------------------------------------------------------------------
# serving against the reference
# ---------------------------------------------------------------------------

def test_prefill_cache_matches(pair):
    MM.check_prefill_cache(pair)


@pytest.mark.parametrize("decode_window", [None, 8])
def test_teacher_forced_decode_matches(pair, decode_window):
    MM.check_teacher_forced_decode(pair, decode_window)


@pytest.mark.parametrize("s,window", [(12, None), (20, 8), (13, 13),
                                      (33, 16)])
def test_prefill_then_decode_matches_forward(pair, s, window):
    MM.check_prefill_then_decode(pair, s, window)


def test_greedy_generate_matches(pair):
    MM.check_generate(pair)


def test_generate_driver_matches(pair):
    MM.check_driver(pair)


def test_embed_one_clamps_at_max_seq(pair):
    MM.check_embed_clamp(pair)


def test_bf16_forward_and_decode_match(pair):
    MM.check_bf16(ARCH, pair)


def test_serve_launcher_runs_on_cpu():
    MM.check_launcher(ARCH)


# ---------------------------------------------------------------------------
# card only
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_prefill_then_decode_matches_forward():
    MM.check_on_card(ARCH)
