"""The port's VLM family (``llama-3.2-vision-11b``) against the JAX reference.

Llama-3.2-Vision: groups of ``cross_attn_every`` dense self-attention
layers (GQA, RoPE), each group opened by one tanh-gated cross-attention
layer (and its MLP) over stubbed patch embeddings, the model's
``memory``.  The reference runs the ``smoke()`` config (4 layers in 2
groups, 8 image tokens) with ``attn_block_kv = 8`` and its weights from
``init_params(PRNGKey(0))``, the cross gates set non-zero (they start at
zero, which would hide the whole cross path); the port gets both carried
across (``tests/_torch_memory_models.py``).  Tokens and memories come
from NumPy seeds.

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

ARCH = "llama-3.2-vision-11b"
#: the full config's parameters, as the reference counts them
#: (``jax.eval_shape`` of its ``init_params``)
FULL_PARAMS = 11_520_053_256


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
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.d_ff, cfg.vocab, cfg.rope_theta) == (
        "vlm", 40, 4096, 32, 8, 14336, 128256, 500_000.0)
    assert (cfg.cross_attn_every, cfg.n_img_tokens, cfg.pos_emb) == (
        5, 1600, "rope")
    assert M.n_groups(cfg) == 8


def test_full_size_parameter_count(monkeypatch):
    MM.check_full_param_count(ARCH, FULL_PARAMS, monkeypatch)


def test_params_carried_across_exactly(pair):
    """Every leaf equal: the (G, every, ...) self layers split into G lists
    of ``every`` layers, the (G, ...) cross layers into G dicts whose
    ``gate`` is a scalar."""
    import jax
    from repro.models.nn import count_params as ref_count
    rcfg, rparams, cfg, params = pair
    assert count_params(params) == ref_count(rparams)
    ref = jax.tree.map(np.asarray, rparams)
    assert set(params) == set(ref) == {"embed", "final_norm", "lm_head",
                                       "groups", "cross"}
    ng, every = M.n_groups(cfg), cfg.cross_attn_every
    assert [len(g) for g in params["groups"]] == [every] * ng
    assert len(params["cross"]) == ng
    assert MM.leaves_equal(params, ref) == len(tree_leaves(params))
    gates = [float(cp["attn"]["gate"]) for cp in params["cross"]]
    assert all(cp["attn"]["gate"].dim() == 0 for cp in params["cross"])
    np.testing.assert_array_equal(gates, MM.gates(ng))
    assert all(g != 0 for g in gates)
    assert set(params["cross"][0]) == {"attn_norm", "attn", "mlp_norm", "mlp"}


def test_init_params_shapes_and_seed():
    """Seeded draws repeat; the count is the reference's; every gate starts
    at zero, as the reference's does."""
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
    assert all(float(cp["attn"]["gate"]) == 0.0 for cp in a["cross"])
    with pytest.raises(ValueError, match="divide"):
        M.init_params(cfg.scaled(cross_attn_every=3), 0, device="cpu")


@pytest.mark.parametrize("kw", [{}, {"decode_window": 8},
                                {"dtype": "bfloat16"}])
def test_init_cache_layout(kw):
    """Every self layer's ring and one cross K/V of ``n_img_tokens`` slots
    per group, as the reference lays them out."""
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
    assert tuple(got["cross"]["k"].shape) == (
        M.n_groups(cfg), 3, cfg.n_img_tokens, cfg.n_kv_heads, cfg.d_head)
    assert got["k"].shape[:3] == (cfg.n_layers, 3,
                                  kw.get("decode_window", 40))


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [1, 2])
def test_forward_with_memory_matches(pair, seed):
    MM.check_forward(pair, seed)


def test_forward_needs_a_memory(pair):
    _, _, cfg, params = pair
    with pytest.raises(ValueError, match="requires a memory"):
        M.forward(params, cfg, torch.as_tensor(MM.tokens(cfg, 1, 4)))


def test_zero_gates_hide_the_memory(pair):
    """Under the default (zero) gates the cross layers add nothing, so the
    logits do not depend on the memory: why every comparison sets the gates
    non-zero.  With the gates set they do, and each gate counts."""
    _, _, cfg, params = pair
    toks = torch.as_tensor(MM.tokens(cfg, 2, 9, seed=3))
    mems = [torch.as_tensor(MM.memory(cfg, 2, s)) for s in (3, 4)]
    closed = {**params, "cross": [
        {**cp, "attn": {**cp["attn"], "gate": torch.zeros(())}}
        for cp in params["cross"]]}
    a, b = (M.forward(closed, cfg, toks, memory=m)[0] for m in mems)
    assert torch.equal(a, b)
    a, b = (M.forward(params, cfg, toks, memory=m)[0] for m in mems)
    assert float((a - b).abs().max()) > 1e-3
    for g in range(len(params["cross"])):
        one = {**params, "cross": [
            cp if i != g else {**cp, "attn": {**cp["attn"],
                                              "gate": torch.zeros(())}}
            for i, cp in enumerate(params["cross"])]}
        assert not torch.equal(M.forward(one, cfg, toks, memory=mems[0])[0],
                               a)


def test_forward_collect_kv_is_group_major(pair):
    """Prefill's forward returns every self layer's K/V in layer order,
    group by group (``g * every + j``), as the reference's flattened
    (G, every) stack, and the same logits."""
    import jax.numpy as jnp
    from repro.models import model as RM
    rcfg, rparams, cfg, params = pair
    toks, mem = MM.tokens(cfg, 2, 9), MM.memory(cfg, 2, 9)
    _, _, want = RM.forward(rparams, rcfg, jnp.asarray(toks),
                            memory=jnp.asarray(mem), collect_kv=True)
    toks, mem = torch.as_tensor(toks), torch.as_tensor(mem)
    logits, _, kv = M.forward(params, cfg, toks, memory=mem, collect_kv=True)
    assert set(kv) == set(want) == {"self"}
    k, v = kv["self"]
    assert tuple(k.shape) == tuple(v.shape) == (cfg.n_layers, 2, 9,
                                                cfg.n_kv_heads, cfg.d_head)
    for got, ref in zip((k, v), want["self"]):
        np.testing.assert_allclose(MM.np_(got), np.asarray(ref), **MM.F32)
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


def test_qk_norm_cross_path_matches():
    """With qk-norm on (no shipped config has it beside cross layers), the
    cross K/V take the k-norm at prefill and the decode query the q-norm,
    as in the reference."""
    p = MM.pair(ARCH, qk_norm=True)
    assert "k_norm" in p[3]["cross"][0]["attn"]
    MM.check_prefill_cache(p)
    MM.check_teacher_forced_decode(p, None)


def test_greedy_generate_matches(pair):
    MM.check_generate(pair)


def test_generate_driver_matches(pair):
    MM.check_driver(pair)


def test_decode_reads_no_learned_position(pair):
    """RoPE positions: ``_embed_one`` is the token's embedding alone, at
    any position, as the reference's."""
    import jax.numpy as jnp
    from repro.serving import engine as RE
    from repro_torch.serving import engine as E
    rcfg, rparams, cfg, params = pair
    tok = MM.tokens(cfg, 2, 1, seed=6)
    for pos in (0, cfg.max_seq + 3):
        want = np.asarray(RE._embed_one(rparams, rcfg, jnp.asarray(tok),
                                        jnp.asarray(pos, jnp.int32)))
        got = E._embed_one(params, cfg, torch.as_tensor(tok),
                           torch.tensor(pos, dtype=torch.int32))
        np.testing.assert_array_equal(MM.np_(got), want)


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
