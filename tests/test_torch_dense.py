"""The port's dense and MoE families against the JAX reference.

Six configs: the dense ``qwen3-1.7b`` (GQA, qk-norm, tied embeddings),
``phi3-mini-3.8b`` (MHA), ``starcoder2-7b`` (LayerNorm + GELU, a sliding
window), ``chatglm3-6b`` (RoPE on half the lanes) and the MoE
``granite-moe-3b-a800m`` and ``mixtral-8x22b`` (a sliding window).  The
reference runs each ``smoke()`` config with ``attn_block_kv = 8`` (so the
blocked attention crosses several KV blocks and pads the last one) and
weights from ``init_params(PRNGKey(0))``; the port gets the same config
through ``config_from_fields`` and the same weights through
``params_from_numpy``.  The layer tests feed both packages the same seeded
NumPy inputs.

Tolerances, and why they are that wide:

* float32 ``rtol = atol = 1e-4`` (``F32``): the two packages sum their
  einsums in different orders.
* bfloat16 layers ``5e-2`` (``BF16``): both round to 8 mantissa bits, at
  different places (XLA fuses element-wise chains that torch rounds step
  by step; a bf16 matmul's sum order differs).  The MoE layer's bf16
  output reaches |y| ~ 35-145 at the smoke widths on tokens of RMS 1 (the
  reference's init scales the (E, d, f) expert weights by 1/sqrt(E), its
  leading axis), where one bf16 step is 0.25-1: there the port is held
  within two bf16 steps of the reference's largest output (it lands
  within one) and against the reference's float32 output to no more than
  1.25 times the reference's own bf16 error.
* bfloat16 logits of a whole smoke model ``0.25`` (``BF16_MODEL``, as in
  ``tests/test_torch_hybrid.py``), and against the reference's float32
  logits no more than 1.25 times the reference's own bf16 error: one-ulp
  differences compound through the layers.  The smoke MoE models route the
  same experts in bf16 here (the layer test compares the routing first).
  Mixtral's smoke model flips a top-2 choice between the reference's own
  bf16 and f32 runs (its bf16 logits lie 3.19 from its f32 ones), and the
  port's bf16 flips the same way, so the 1.25x bound holds there too.
* prefill-then-decode against ``forward``: ``1e-2``, the reference's own
  dense/MoE tolerance (``tests/test_arch_smoke.py:83``); the port lands
  within 1e-5.
* The MoE keep mask, the chosen experts and every count are compared
  exactly.
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
DECODE_TOL = dict(rtol=1e-2, atol=1e-2)
BLOCK_KV = 8
DENSE = ("qwen3-1.7b", "phi3-mini-3.8b", "starcoder2-7b", "chatglm3-6b")
MOE = ("granite-moe-3b-a800m", "mixtral-8x22b")
ALL = DENSE + MOE
#: each full config's parameter count, as the reference counts it
#: (``jax.eval_shape`` of its ``init_params``); Mixtral also cut to 4 layers
FULL_PARAMS = {"qwen3-1.7b": 1_720_574_976, "phi3-mini-3.8b": 3_821_079_552,
               "starcoder2-7b": 7_399_351_296, "chatglm3-6b": 6_243_454_976,
               "granite-moe-3b-a800m": 3_298_793_472,
               "mixtral-8x22b": 140_630_071_296}
MIXTRAL_4_LAYERS = 10_418_903_040


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _ref_cfg(arch, dtype="float32", **kw):
    from repro.configs.registry import get_config as ref_get
    return ref_get(arch, smoke=True).scaled(dtype=dtype,
                                           attn_block_kv=BLOCK_KV, **kw)


def _pair(arch, dtype="float32", **kw):
    """(reference cfg, reference params, port cfg, port params)."""
    import jax
    from repro.models import model as RM
    rcfg = _ref_cfg(arch, dtype, **kw)
    rparams, _ = RM.init_params(rcfg, jax.random.PRNGKey(0))
    cfg = config_from_fields(dataclasses.asdict(rcfg))
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), cfg,
                               device="cpu")
    return rcfg, rparams, cfg, params


@pytest.fixture(scope="module")
def pairs():
    """``pairs(arch)``: the float32 smoke pair of ``arch``, built once."""
    built: dict = {}

    def get(arch):
        if arch not in built:
            built[arch] = _pair(arch)
        return built[arch]
    return get


@pytest.fixture(params=ALL)
def pair(request, pairs):
    return pairs(request.param)


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


def _tree_t(tree, dtype=torch.float32):
    """A reference parameter tree as tensors of ``dtype``."""
    return {k: _tree_t(v, dtype) if isinstance(v, dict)
            else torch.as_tensor(np.asarray(v, np.float32)).to(dtype)
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# configs and weights carried across
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ALL)
def test_config_fields_match_the_reference(arch):
    from repro.configs.registry import get_config as ref_get
    assert arch in ARCHS
    for smoke in (False, True):
        rcfg = ref_get(arch, smoke=smoke)
        cfg = config_from_fields(dataclasses.asdict(rcfg))
        assert cfg == get_config(arch, smoke=smoke)
        got, want = dataclasses.asdict(cfg), dataclasses.asdict(rcfg)
        assert got.pop("use_kernels") == want.pop("use_pallas")
        assert got == want
        assert cfg.d_head == rcfg.d_head
    assert get_config(arch).family == ("moe" if arch in MOE else "dense")


def test_full_configs_as_published():
    """The widths that each phase of the card's smoke run exercises."""
    g = {a: get_config(a) for a in ALL}
    assert (g["qwen3-1.7b"].n_heads, g["qwen3-1.7b"].n_kv_heads,
            g["qwen3-1.7b"].d_head, g["qwen3-1.7b"].qk_norm) == (16, 8, 128,
                                                                True)
    assert (g["phi3-mini-3.8b"].n_kv_heads, g["phi3-mini-3.8b"].d_head) == \
        (32, 96)
    assert (g["starcoder2-7b"].norm, g["starcoder2-7b"].act,
            g["starcoder2-7b"].n_heads, g["starcoder2-7b"].n_kv_heads,
            g["starcoder2-7b"].sliding_window) == ("ln", "gelu", 36, 4, 4096)
    assert (g["chatglm3-6b"].n_kv_heads, g["chatglm3-6b"].rope_fraction) == \
        (2, 0.5)
    assert (g["granite-moe-3b-a800m"].n_experts,
            g["granite-moe-3b-a800m"].top_k,
            g["granite-moe-3b-a800m"].capacity_factor) == (40, 8, 1.25)
    assert (g["mixtral-8x22b"].n_experts, g["mixtral-8x22b"].top_k,
            g["mixtral-8x22b"].sliding_window) == (8, 2, 4096)


@pytest.mark.parametrize("arch", ALL)
def test_full_size_parameter_count(arch, monkeypatch):
    """The port's full-size tree, built on the meta device (no memory),
    counts the reference's parameters (its ``jax.eval_shape``)."""
    import jax
    from repro.models import model as RM
    from repro.configs.registry import get_config as ref_get
    monkeypatch.setattr(ParamBuilder, "param", lambda self, shape, **kw:
                        torch.empty(shape, device="meta"))
    cuts = [None, 4] if arch == "mixtral-8x22b" else [None]
    for cut in cuts:
        rcfg = ref_get(arch)
        cfg = get_config(arch)
        if cut:
            rcfg, cfg = rcfg.scaled(n_layers=cut), cfg.scaled(n_layers=cut)
        shapes = jax.eval_shape(
            lambda: RM.init_params(rcfg, jax.random.PRNGKey(0))[0])
        want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
        got = count_params(M.init_params(cfg, 0, device="cpu"))
        assert got == want == (MIXTRAL_4_LAYERS if cut
                               else FULL_PARAMS[arch])


def test_params_carried_across_exactly(pair):
    """Every leaf equal, the (L, E, d, f) expert leaves split at L only."""
    import jax
    from repro.models.nn import count_params as ref_count
    rcfg, rparams, cfg, params = pair
    assert count_params(params) == ref_count(rparams)
    ref = jax.tree.map(np.asarray, rparams)
    assert len(params["layers"]) == cfg.n_layers

    def walk(port, want, idx):
        assert set(port) == set(want)
        for k, v in want.items():
            if isinstance(v, dict):
                walk(port[k], v, idx)
            else:
                assert tuple(port[k].shape) == v[idx].shape, k
                np.testing.assert_array_equal(_np(port[k]), v[idx], err_msg=k)
    for i, pl in enumerate(params["layers"]):
        walk(pl, ref["layers"], i)
    walk({k: v for k, v in params.items() if k != "layers"},
         {k: v for k, v in ref.items() if k != "layers"}, ())
    if cfg.family == "moe":
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        moe = params["layers"][1]["moe"]
        assert tuple(moe["w1"].shape) == (e, d, f)
        assert tuple(moe["w2"].shape) == (e, f, d)
        assert tuple(moe["router"].shape) == (d, e)
        assert "mlp" not in params["layers"][0]
    else:
        assert "moe" not in params["layers"][0]


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-3b-a800m"])
def test_init_params_shapes_and_seed(arch):
    import jax
    from repro.models import model as RM
    from repro.models.nn import count_params as ref_count
    cfg = get_config(arch, smoke=True)
    a = M.init_params(cfg, 3, device="cpu")
    b = M.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)
    rp, _ = RM.init_params(_ref_cfg(arch), jax.random.PRNGKey(0))
    assert count_params(a) == ref_count(rp)
    assert ("lm_head" in a) is (not cfg.tie_embeddings)
    if not torch.cuda.is_available():          # device=None is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            M.init_params(cfg, 0)


# ---------------------------------------------------------------------------
# layers against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm", ["rms", "ln"])
def test_apply_norm(norm, dtype):
    """RMSNorm and LayerNorm (starcoder2's, with a bias) against the
    reference's, on a shifted input so the LayerNorm's mean matters."""
    import jax
    from repro.models import layers as RL
    from repro.models.nn import ParamBuilder as RefBuilder
    rcfg = _ref_cfg("starcoder2-7b", dtype, norm=norm)
    cfg = config_from_fields(dataclasses.asdict(rcfg))
    rp = RL.init_norm(RefBuilder(jax.random.PRNGKey(1)).sub("n"), rcfg)
    assert set(L.init_norm(ParamBuilder(torch.Generator(), torch.float32,
                                        torch.device("cpu")), cfg)) == set(rp)
    rng = np.random.default_rng(2)
    rp = {k: np.asarray(v) + rng.normal(size=v.shape).astype(np.float32)
          for k, v in rp.items()}                    # non-trivial scale, bias
    x = (rng.normal(size=(2, 7, 64)) * 3 + 1.5).astype(np.float32)
    jx, tx = _both(x, dtype)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = RL.apply_norm({k: _both(v, dtype)[0] for k, v in rp.items()}, jx,
                         rcfg)
    got = L.apply_norm(_tree_t(rp, tdt), tx, cfg)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(want),
                               **(F32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("cf,group", [(1.25, 512), (1.25, 4), (8.0, 64),
                                      (1.0, 100), (2.0, 202)])
def test_moe_capacity(cf, group):
    from repro.models import layers as RL
    for arch in MOE:
        for smoke in (False, True):
            from repro.configs.registry import get_config as ref_get
            rcfg = ref_get(arch, smoke=smoke).scaled(capacity_factor=cf)
            cfg = config_from_fields(dataclasses.asdict(rcfg))
            assert L.moe_capacity(cfg, group) == RL.moe_capacity(rcfg, group)
    assert L.moe_capacity(get_config("granite-moe-3b-a800m"), 512) == 128


def _moe_case(arch, dtype, cf, seed=9):
    """A reference MoE layer, and tokens with a shared component that skews
    the routing toward a few experts (so cf 1.25 drops choices), each
    token scaled to RMS 1 as ``apply_norm`` hands it to the MoE in the
    model; 100 tokens in groups of 64, the tail group padded with 28."""
    import jax
    from repro.models import layers as RL
    from repro.models.nn import ParamBuilder as RefBuilder
    rcfg = _ref_cfg(arch, dtype, capacity_factor=cf)
    cfg = config_from_fields(dataclasses.asdict(rcfg))
    rp = RL.init_moe(RefBuilder(jax.random.PRNGKey(8)).sub("moe"), rcfg)
    rp = {k: np.asarray(v, np.float32) for k, v in rp.items()}
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 50, 64)) + 1.5 * rng.normal(size=64)
    x = (x / np.sqrt((x * x).mean(-1, keepdims=True))).astype(np.float32)
    return rcfg, cfg, rp, x


def _ref_moe(rp, x, rcfg, dtype, monkeypatch):
    """The reference's ``apply_moe``, and its routing as it computed it:
    the chosen experts and the keep mask, read from the arguments of its
    two ``jax.nn.one_hot`` calls (idx, then each choice's slot)."""
    import jax
    from repro.models import layers as RL
    calls = []
    one_hot = jax.nn.one_hot

    def record(a, n, **kw):
        calls.append((np.asarray(a), n))
        return one_hot(a, n, **kw)
    monkeypatch.setattr(jax.nn, "one_hot", record)
    y, aux = RL.apply_moe({k: _both(v, dtype)[0] for k, v in rp.items()},
                          _both(x, dtype)[0], rcfg)
    monkeypatch.setattr(jax.nn, "one_hot", one_hot)
    (idx, _), (slot, cap) = calls
    keep = np.take_along_axis(slot, idx[..., None].astype(np.int64),
                              -1)[..., 0] < cap
    return _np(y), float(aux), idx, keep, cap


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [8.0, 1.25])
@pytest.mark.parametrize("arch", MOE)
def test_apply_moe(arch, cf, dtype, monkeypatch):
    """The routing first (experts, gates' order, slots, the keep mask:
    identical, and at cf 1.25 some real token's choice dropped), then the
    output and the aux loss."""
    rcfg, cfg, rp, x = _moe_case(arch, dtype, cf)
    want, want_aux, idx, keep, cap = _ref_moe(rp, x, rcfg, dtype, monkeypatch)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tp = _tree_t(rp, tdt)
    tx = torch.as_tensor(x).to(tdt)
    xt = torch.nn.functional.pad(tx.reshape(100, 64), (0, 0, 0, 28))
    r = L.moe_route(tp, xt.reshape(2, 64, 64), cfg)
    assert r.cap == cap
    np.testing.assert_array_equal(r.idx.numpy(), idx)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    real = keep.reshape(-1, cfg.top_k)[:100]
    if cf == 1.25:
        assert not real.all(), "no real choice dropped at cf 1.25"
    else:
        assert keep.all()
    got, aux = L.apply_moe(tp, tx, cfg)
    assert got.dtype == tdt and tuple(got.shape) == (2, 50, 64)
    np.testing.assert_allclose(float(aux), want_aux, rtol=1e-5)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), want, **F32)
        return
    # bf16: within two ulps of the largest output, and no further from the
    # reference's float32 output than 1.25x the reference's own bf16 error
    top = np.abs(want).max()
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=2 * _bf16_ulp(top))
    rcfg32, _, _, _ = _moe_case(arch, "float32", cf)
    exact = _ref_moe(rp, x, rcfg32, "float32", monkeypatch)[0]
    ref_err = np.abs(want - exact).max()
    assert np.abs(_np(got) - exact).max() <= 1.25 * ref_err, ref_err


def _bf16_ulp(v: float) -> float:
    """The spacing of bfloat16 values (8 significant bits) at ``v``."""
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def test_apply_moe_drops_change_the_output():
    """The dropped choices are the ones the reference drops: the same
    layer at cf 8.0 and at 1.25 differ exactly at the tokens with a drop."""
    _, cfg, rp, x = _moe_case("granite-moe-3b-a800m", "float32", 1.25)
    tp, tx = _tree_t(rp), torch.as_tensor(x)
    low, _ = L.apply_moe(tp, tx, cfg)
    high, _ = L.apply_moe(tp, tx, cfg.scaled(capacity_factor=8.0))
    xt = torch.nn.functional.pad(tx.reshape(100, 64), (0, 0, 0, 28))
    keep = L.moe_route(tp, xt.reshape(2, 64, 64), cfg).keep
    dropped = (~keep).reshape(-1, cfg.top_k).any(-1)[:100].reshape(2, 50)
    differs = (low - high).abs().amax(-1) > 0
    assert bool(dropped.any())
    assert torch.equal(differs, dropped)


def test_moe_dispatch_dtype_bf16_rounds_the_gates(monkeypatch):
    """``moe_dispatch_dtype="bfloat16"`` as in the reference: the gates
    pass through bf16 on the way to the combine."""
    rcfg, cfg, rp, x = _moe_case("mixtral-8x22b", "float32", 8.0)
    rcfg = rcfg.scaled(moe_dispatch_dtype="bfloat16")
    cfg = cfg.scaled(moe_dispatch_dtype="bfloat16")
    want, want_aux, _, _, _ = _ref_moe(rp, x, rcfg, "float32", monkeypatch)
    got, aux = L.apply_moe(_tree_t(rp), torch.as_tensor(x), cfg)
    np.testing.assert_allclose(_np(got), want, **F32)
    np.testing.assert_allclose(float(aux), want_aux, rtol=1e-5)
    exact, _ = L.apply_moe(_tree_t(rp), torch.as_tensor(x),
                           cfg.scaled(moe_dispatch_dtype="float32"))
    assert not torch.equal(got, exact)


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kw", [("qwen3-1.7b", {}),
                                     ("qwen3-1.7b", {"decode_window": 8}),
                                     ("starcoder2-7b", {}),
                                     ("granite-moe-3b-a800m",
                                      {"dtype": "bfloat16"}),
                                     ("mixtral-8x22b", {})])
def test_init_cache_layout(arch, kw):
    from repro.serving import cache as RC
    rcfg = _ref_cfg(arch, **kw)
    cfg = config_from_fields(dataclasses.asdict(rcfg))
    want = RC.init_cache(rcfg, 3, 40)
    got = C.init_cache(cfg, 3, 40, device="cpu")
    assert set(got) == set(want) == {"pos", "kv_pos", "k", "v"}
    dt = {"float32": torch.float32, "int32": torch.int32,
          "bfloat16": torch.bfloat16}
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert got[k].dtype == dt[str(want[k].dtype)], k
        np.testing.assert_array_equal(_np(got[k]), _np(want[k]))
    ring = min(kw.get("decode_window") or cfg.sliding_window or 40, 40)
    assert tuple(got["k"].shape) == (cfg.n_layers, 3, ring, cfg.n_kv_heads,
                                     cfg.d_head)


# ---------------------------------------------------------------------------
# the serving path against the reference
# ---------------------------------------------------------------------------

def test_forward_logits_match(pair):
    import jax.numpy as jnp
    from repro.models import model as RM
    rcfg, rparams, cfg, params = pair
    toks = _tokens(cfg, 2, 21, seed=1)           # 3 KV blocks, 3 padded
    want, want_aux, _ = RM.forward(rparams, rcfg, jnp.asarray(toks))
    before = conv_ops.conv1d_causal.launches
    got, aux, _ = M.forward(params, cfg, torch.as_tensor(toks))
    assert conv_ops.conv1d_causal.launches == before
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 21, 256)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    assert (float(aux) > 0) is (cfg.family == "moe")


def test_prefill_cache_matches(pair):
    """Key by key: every layer's K/V packed into the rings, kv_pos, pos,
    and the logits (starcoder2's and Mixtral's ring: their window, 16,
    under a 19-token prompt, so it wraps)."""
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
    for k in ("k", "v"):
        assert tuple(pc[k].shape) == rc[k].shape == tuple(empty[k].shape)
        assert pc[k].dtype == empty[k].dtype
        np.testing.assert_allclose(_np(pc[k]), np.asarray(rc[k]), **F32,
                                   err_msg=k)
    np.testing.assert_allclose(_np(pl), np.asarray(rl), **F32)


def test_teacher_forced_decode_matches(pair):
    """Four decode steps after a 13-token prompt, against the reference's
    decode steps: logits, kv_pos and the rings; the input cache is kept."""
    import jax.numpy as jnp
    from repro.serving import engine as RE
    rcfg, rparams, cfg, params = pair
    toks = _tokens(cfg, 2, 17, seed=3)
    _, rc = RE.prefill(rparams, rcfg, jnp.asarray(toks[:, :13]), 32)
    _, pc = E.prefill(params, cfg, torch.as_tensor(toks[:, :13]), 32)
    for i in range(13, 17):
        step = toks[:, i:i + 1]
        rl, rc = RE.decode_step(rparams, rcfg, rc, jnp.asarray(step))
        kept = {k: v.clone() for k, v in pc.items()}
        pl, pc2 = E.decode_step(params, cfg, pc, torch.as_tensor(step))
        for k, v in pc.items():
            assert torch.equal(kept[k], v), k
        pc = pc2
        assert tuple(pl.shape) == (2, 1, cfg.vocab) and int(pc["pos"]) == i + 1
        np.testing.assert_allclose(_np(pl), np.asarray(rl), **F32)
        np.testing.assert_array_equal(pc["kv_pos"].numpy(),
                                      np.asarray(rc["kv_pos"]))
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(pc[k]), np.asarray(rc[k]), **F32)


#: (arch, prompt S, forced window): starcoder2's and Mixtral's own window
#: (16) wraps the ring under S = 20 and 33; qwen3 with sliding_window =
#: decode_window = 8 forced on it wraps too
DECODE_CASES = [(a, 12, None) for a in ALL] + [
    ("starcoder2-7b", 20, None), ("starcoder2-7b", 33, None),
    ("mixtral-8x22b", 20, None), ("mixtral-8x22b", 33, None),
    ("qwen3-1.7b", 20, 8), ("qwen3-1.7b", 13, 13),
    ("granite-moe-3b-a800m", 20, 8)]


@pytest.mark.parametrize("arch,s,window", DECODE_CASES)
def test_prefill_then_decode_matches_forward(arch, s, window, pairs):
    """Prefill S tokens, then decode token S: the full forward's logits at
    position S, within the reference's dense/MoE tolerance (1e-2).  With a
    window W the forward masks to the last W positions and the ring holds
    W slots (S = 13, W = 13 fills it exactly)."""
    _, _, cfg, params = pairs(arch)
    if window:
        cfg = cfg.scaled(sliding_window=window, decode_window=window)
    toks = torch.as_tensor(_tokens(cfg, 2, s + 1, seed=s))
    full, _, _ = M.forward(params, cfg, toks)
    _, cc = E.prefill(params, cfg, toks[:, :s], 64)
    ring = cfg.decode_window or cfg.sliding_window or 64
    assert cc["k"].shape[2] == ring
    step, cc2 = E.decode_step(params, cfg, cc, toks[:, s:s + 1])
    assert int(cc2["pos"]) == s + 1
    np.testing.assert_allclose(_np(step[:, 0]), _np(full[:, s]), **DECODE_TOL)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "starcoder2-7b",
                                  "granite-moe-3b-a800m", "mixtral-8x22b"])
def test_greedy_generate_matches(arch, pairs):
    import jax.numpy as jnp
    from repro.serving import engine as RE
    rcfg, rparams, cfg, params = pairs(arch)
    toks = _tokens(cfg, 3, 9, seed=4)
    rt, rc = RE.generate(rparams, rcfg, jnp.asarray(toks), 10, 32)
    pt, pc = E.generate(params, cfg, torch.as_tensor(toks), 10, 32)
    assert pt.dtype == torch.int32 and tuple(pt.shape) == (3, 10)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(rt))
    assert int(pc["pos"]) == int(rc["pos"]) == 9 + 10


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-3b-a800m"])
def test_generate_driver_matches(arch, pairs):
    """The same 6-request mix (two prompt lengths) through both drivers."""
    import jax.numpy as jnp
    from repro.serving import BatchPolicy as RefPolicy
    from repro.serving import GenerateDriver as RefDriver
    rcfg, rparams, cfg, params = pairs(arch)
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


@pytest.mark.parametrize("arch", ALL)
def test_bf16_forward_and_decode_match(arch, pairs):
    """bf16 logits within ``BF16_MODEL`` of the reference's bf16 logits and
    no further from its f32 logits than 1.25x its own bf16 error; one
    decode step within ``BF16``."""
    import jax.numpy as jnp
    from repro.models import model as RM
    from repro.serving import engine as RE
    rcfg32, rparams32 = pairs(arch)[:2]
    rcfg, rparams, cfg, params = _pair(arch, "bfloat16")
    assert params["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    toks = _tokens(cfg, 2, 19, seed=6)
    want = np.asarray(RM.forward(rparams, rcfg, jnp.asarray(toks))[0])
    got, _, _ = M.forward(params, cfg, torch.as_tensor(toks))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), want, **BF16_MODEL)
    exact = np.asarray(RM.forward(rparams32, rcfg32, jnp.asarray(toks))[0])
    ref_err = np.abs(want - exact).max()
    assert np.abs(_np(got) - exact).max() <= 1.25 * ref_err, ref_err
    _, rc = RE.prefill(rparams, rcfg, jnp.asarray(toks[:, :18]), 32)
    _, pc = E.prefill(params, cfg, torch.as_tensor(toks[:, :18]), 32)
    assert pc["k"].dtype == pc["v"].dtype == torch.bfloat16
    rl, _ = RE.decode_step(rparams, rcfg, rc, jnp.asarray(toks[:, 18:]))
    pl, _ = E.decode_step(params, cfg, pc, torch.as_tensor(toks[:, 18:]))
    np.testing.assert_allclose(_np(pl), np.asarray(rl), **BF16)


# ---------------------------------------------------------------------------
# the serve launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-3b-a800m"])
def test_serve_launcher_runs_on_cpu(arch):
    import jax
    from repro.models import model as RM
    from repro.models.nn import count_params as ref_count
    from repro.configs.registry import get_config as ref_get
    n = ref_count(RM.init_params(ref_get(arch, smoke=True),
                                 jax.random.PRNGKey(0))[0])
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--smoke", "--device", "cpu", "--requests", "6", "--max-batch", "4",
         "--prompt-len", "8", "--new-tokens", "4"],
        check=True, timeout=300, env=env, capture_output=True, text=True)
    lines = out.stdout.splitlines()
    assert lines[0] == f"arch={arch}-smoke params={n:,}"
    assert "served 6 requests (24 new tokens)" in lines[1]
    assert lines[2].startswith("batches=2 occupancy=3.0")
    assert lines[3].startswith("generated[0,:16] = [")


# ---------------------------------------------------------------------------
# card only: the MoE and a dense model on the card against the CPU
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_moe_and_decode_match_the_cpu():
    """The MoE layer at cf 1.25 in float32 on the card routes as on the CPU
    (experts, slots, the keep mask with its drops: the stable sort, the
    scan and the index dispatch are device kernels) and gives the same
    output; the granite and qwen3 smoke models' prefill-then-decode
    through a wrapped ring equals forward on the card.  (In bf16 a
    one-ulp difference between the two devices' router products may
    flip a near-tie, so routing is compared in float32.)"""
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs a CUDA device of compute capability 9.0")
    cfg = get_config("granite-moe-3b-a800m", smoke=True).scaled(
        capacity_factor=1.25)
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 50, 64)) + 1.5 * rng.normal(size=64)
    x = torch.as_tensor(x / np.sqrt((x * x).mean(-1, keepdims=True)),
                        dtype=torch.float32)
    p = L.init_moe(ParamBuilder(torch.Generator().manual_seed(8),
                                torch.float32, torch.device("cpu")), cfg)
    pc = {k: v.cuda() for k, v in p.items()}
    xt = torch.nn.functional.pad(x.reshape(100, 64), (0, 0, 0, 28))
    want_r = L.moe_route(p, xt.reshape(2, 64, 64), cfg)
    got_r = L.moe_route(pc, xt.reshape(2, 64, 64).cuda(), cfg)
    for f in ("idx", "slot", "keep"):
        assert torch.equal(getattr(got_r, f).cpu(), getattr(want_r, f)), f
    assert not bool(want_r.keep.all())
    want, want_aux = L.apply_moe(p, x, cfg)
    got, aux = L.apply_moe(pc, x.cuda(), cfg)
    np.testing.assert_allclose(_np(got.cpu()), _np(want), **F32)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    for arch in ("granite-moe-3b-a800m", "qwen3-1.7b"):
        cfg = get_config(arch, smoke=True).scaled(sliding_window=8,
                                                  decode_window=8)
        params = M.init_params(cfg, 0)
        toks = torch.as_tensor(_tokens(cfg, 2, 21, seed=5), device="cuda")
        full, _, _ = M.forward(params, cfg, toks)
        _, cc = E.prefill(params, cfg, toks[:, :20], 64)
        step, _ = E.decode_step(params, cfg, cc, toks[:, 20:])
        np.testing.assert_allclose(_np(step[:, 0].cpu()),
                                   _np(full[:, 20].cpu()), **DECODE_TOL)
