"""The port's LM serving path (Mamba2) against the JAX reference.

The reference runs ``mamba2-2.7b``'s ``smoke()`` config with
``use_pallas=True`` (its Pallas conv1d in interpret mode on the CPU) and
weights from ``init_params(PRNGKey(0))``; the port gets the same config
through ``config_from_fields`` (``use_kernels=True``: on the CPU the
kernel's plain version) and the same weights through ``params_from_numpy``.

Tolerances: float32 ``rtol = atol = 1e-4`` — the two packages sum their
einsums in different orders.  bfloat16 ``5e-2`` — both round to 8 mantissa
bits, but at different places (XLA fuses element-wise chains that torch
rounds step by step), and those one-step differences propagate through
the layers into the logits.
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
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.conv1d import ops as conv_ops
from repro_torch.models import model as M
from repro_torch.models.convert import config_from_fields, params_from_numpy
from repro_torch.models.ssm import mamba_init_state
from repro_torch.models.nn import count_params, tree_leaves
from repro_torch.serving import BatchPolicy, GenerateDriver
from repro_torch.serving import engine as E
from repro_torch.serving.cache import init_cache

F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=5e-2, atol=5e-2)
ARCH = "mamba2-2.7b"


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _pair(dtype="float32"):
    """(reference cfg, reference params, port cfg, port params)."""
    import jax
    from repro.configs.registry import get_config as ref_get
    from repro.models import model as RM
    rcfg = ref_get(ARCH, smoke=True).scaled(use_pallas=True, dtype=dtype)
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


# ---------------------------------------------------------------------------
# configs and weights carried across
# ---------------------------------------------------------------------------

def test_config_fields_match_the_reference():
    from repro.configs.base import ModelConfig as RefConfig
    from repro.configs.registry import get_config as ref_get
    ref = {f.name for f in dataclasses.fields(RefConfig)}
    port = {f.name for f in dataclasses.fields(ModelConfig)}
    assert port == (ref - {"use_pallas"}) | {"use_kernels"}
    for smoke in (False, True):
        rcfg = ref_get(ARCH, smoke=smoke)
        cfg = config_from_fields(dataclasses.asdict(rcfg))
        assert cfg == get_config(ARCH, smoke=smoke)
        assert (cfg.d_inner, cfg.ssm_heads) == (rcfg.d_inner, rcfg.ssm_heads)
    full = get_config(ARCH)
    assert (full.n_layers, full.d_model, full.d_inner, full.ssm_heads,
            full.ssm_state, full.conv_width, full.vocab) == \
        (64, 2560, 5120, 80, 128, 4, 50280)


def test_config_converter_renames_and_rejects():
    from repro.configs.registry import get_config as ref_get
    d = dataclasses.asdict(ref_get(ARCH, smoke=True).scaled(use_pallas=True))
    assert config_from_fields(d).use_kernels is True
    with pytest.raises(ValueError, match="unknown"):
        config_from_fields({**d, "bogus": 1})


def test_registry_lists_only_ported_families():
    """The enc-dec and VLM archs are not registered, and their families
    (and learned position embeddings) raise in init_params and init_cache;
    the dense and MoE archs are registered."""
    for arch in ("whisper-large-v3", "llama-3.2-vision-11b"):
        with pytest.raises(KeyError, match="ROADMAP"):
            get_config(arch)
    assert {"qwen3-1.7b", "granite-moe-3b-a800m"} <= set(ARCHS)
    base = get_config(ARCH, smoke=True).scaled(n_heads=4, n_kv_heads=4)
    for cfg in (base.scaled(family="encdec"), base.scaled(family="vlm"),
                base.scaled(family="dense", pos_emb="learned")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            M.init_params(cfg, 0, device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            init_cache(cfg, 1, 8, device="cpu")


def test_params_carried_across_exactly(pair):
    import jax
    from repro.models.nn import count_params as ref_count
    rcfg, rparams, cfg, params = pair
    assert count_params(params) == ref_count(rparams)
    layers = jax.tree.map(np.asarray, rparams["layers"])
    for i, pl in enumerate(params["layers"]):
        np.testing.assert_array_equal(_np(pl["mamba"]["in_proj"]),
                                      layers["mamba"]["in_proj"][i])
        np.testing.assert_array_equal(_np(pl["norm"]["scale"]),
                                      layers["norm"]["scale"][i])
    np.testing.assert_array_equal(_np(params["embed"]),
                                  np.asarray(rparams["embed"]))


def test_bf16_weights_carried_bit_for_bit():
    import jax
    import jax.numpy as jnp
    a = jnp.asarray(np.random.default_rng(0).normal(size=(3, 5)), jnp.bfloat16)
    cfg = get_config(ARCH, smoke=True).scaled(dtype="bfloat16")
    tree = {"embed": np.asarray(a), "final_norm": {"scale": np.ones(5)},
            "layers": {"w": np.asarray(a)[None].repeat(cfg.n_layers, 0)}}
    got = params_from_numpy(jax.tree.map(np.asarray, tree), cfg, device="cpu")
    assert got["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got["embed"]),
                                  np.asarray(a, np.float32))
    assert len(got["layers"]) == cfg.n_layers


def test_init_params_shapes_and_seed():
    cfg = get_config(ARCH, smoke=True)
    a = M.init_params(cfg, 3, device="cpu")
    b = M.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)
    lp = a["layers"][0]["mamba"]
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    assert tuple(lp["in_proj"].shape) == (cfg.d_model, 2 * di + 2 * n + h)
    assert tuple(lp["conv_w"].shape) == (cfg.conv_width, di + 2 * n)
    assert not lp["conv_b"].any() and not lp["a_log"].any()
    assert bool((lp["D"] == 1).all()) and bool((lp["norm"] == 1).all())
    # fan-in scale over the leading axis
    assert abs(float(lp["in_proj"].std()) - cfg.d_model ** -0.5) < 0.02
    assert abs(float(a["embed"].std()) - 0.02) < 0.002


def test_entry_points_need_a_card_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config(ARCH, smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mamba_init_state(cfg, 1)


# ---------------------------------------------------------------------------
# the serving path against the reference
# ---------------------------------------------------------------------------

def test_forward_logits_match(pair):
    import jax.numpy as jnp
    from repro.models import model as RM
    rcfg, rparams, cfg, params = pair
    toks = _tokens(cfg, 2, 37, seed=1)           # 37: not a multiple of 16
    want, _, _ = RM.forward(rparams, rcfg, jnp.asarray(toks))
    before = conv_ops.conv1d_causal.launches
    got, _, _ = M.forward(params, cfg, torch.as_tensor(toks))
    assert conv_ops.conv1d_causal.launches == before  # CPU: plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 37, 256)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


def test_prefill_cache_matches(pair):
    import jax.numpy as jnp
    from repro.serving import engine as RE
    rcfg, rparams, cfg, params = pair
    toks = _tokens(cfg, 3, 21, seed=2)           # ragged last chunk
    rl, rc = RE.prefill(rparams, rcfg, jnp.asarray(toks), 32)
    pl, pc = E.prefill(params, cfg, torch.as_tensor(toks), 32)
    assert int(pc["pos"]) == int(rc["pos"]) == 21
    empty = init_cache(cfg, 3, 32, device="cpu")
    per_layer = mamba_init_state(cfg, 3, dtype=cfg.torch_dtype, device="cpu")
    for k in ("ssm", "conv"):
        assert tuple(pc[k].shape) == rc[k].shape == tuple(empty[k].shape), k
        assert empty[k].shape[1:] == per_layer[k].shape
        assert pc[k].dtype == empty[k].dtype == per_layer[k].dtype
        np.testing.assert_allclose(_np(pc[k]), np.asarray(rc[k]), **F32,
                                   err_msg=k)
    np.testing.assert_allclose(_np(pl), np.asarray(rl), **F32)


def test_teacher_forced_decode_matches(pair):
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
        for k in kept:                           # the input cache is kept
            assert torch.equal(kept[k], pc[k])
        pc = pc2
        assert tuple(pl.shape) == (2, 1, cfg.vocab) and int(pc["pos"]) == i + 1
        np.testing.assert_allclose(_np(pl), np.asarray(rl), **F32)
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(_np(pc[k]), np.asarray(rc[k]), **F32)


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
    # lengths 12 (2 jobs) and 8 (4 jobs, max_batch 3): 1 + 2 batches
    assert got_m["batches"] == 3 and got_m["latency"]["count"] == 6


def test_bf16_forward_and_decode_match():
    import jax.numpy as jnp
    from repro.models import model as RM
    from repro.serving import engine as RE
    rcfg, rparams, cfg, params = _pair("bfloat16")
    assert params["embed"].dtype == torch.bfloat16
    toks = _tokens(cfg, 2, 19, seed=6)
    want, _, _ = RM.forward(rparams, rcfg, jnp.asarray(toks))
    got, _, _ = M.forward(params, cfg, torch.as_tensor(toks))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), **BF16)
    _, rc = RE.prefill(rparams, rcfg, jnp.asarray(toks[:, :18]), 32)
    _, pc = E.prefill(params, cfg, torch.as_tensor(toks[:, :18]), 32)
    assert pc["conv"].dtype == torch.bfloat16
    rl, _ = RE.decode_step(rparams, rcfg, rc, jnp.asarray(toks[:, 18:]))
    pl, _ = E.decode_step(params, cfg, pc, torch.as_tensor(toks[:, 18:]))
    np.testing.assert_allclose(_np(pl), np.asarray(rl), **BF16)


# ---------------------------------------------------------------------------
# port-only checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [12, 16, 33])
def test_prefill_then_decode_matches_forward(pair, s):
    """Prefill S tokens, then decode token S: the full forward's logits at
    position S (S = 33 leaves a ragged last chunk, whose padded tail must
    keep dt = 0 for the final state to be exact)."""
    _, _, cfg, params = pair
    toks = torch.as_tensor(_tokens(cfg, 2, s + 1, seed=s))
    full, _, _ = M.forward(params, cfg, toks)
    _, cc = E.prefill(params, cfg, toks[:, :s], 64)
    step, cc2 = E.decode_step(params, cfg, cc, toks[:, s:s + 1])
    assert int(cc2["pos"]) == s + 1
    np.testing.assert_allclose(_np(step[:, 0]), _np(full[:, s]), **F32)


def test_kernel_flag_matches_plain_reference_conv(pair):
    """use_kernels on (the kernel's plain version on the CPU) and off (the
    x.dtype-accumulating oracle) agree in float32."""
    _, _, cfg, params = pair
    toks = torch.as_tensor(_tokens(cfg, 2, 20, seed=8))
    on, _, _ = M.forward(params, cfg, toks)
    off, _, _ = M.forward(params, cfg.scaled(use_kernels=False), toks)
    np.testing.assert_allclose(_np(on), _np(off), **F32)


def test_sampled_generate_follows_the_generator(pair):
    _, _, cfg, params = pair
    toks = torch.as_tensor(_tokens(cfg, 2, 6, seed=9))
    runs = [E.generate(params, cfg, toks, 5, 16, greedy=False,
                       generator=torch.Generator().manual_seed(7))[0]
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert runs[0].dtype == torch.int32 and tuple(runs[0].shape) == (2, 5)
    assert int(runs[0].min()) >= 0 and int(runs[0].max()) < cfg.vocab


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
    assert lines[0].startswith(f"arch={ARCH}-smoke params=")
    assert "served 6 requests (24 new tokens)" in lines[1]
    assert lines[2].startswith("batches=2 occupancy=3.0")
    assert lines[3].startswith("generated[0,:16] = [")


# ---------------------------------------------------------------------------
# card only: the model with the CUDA conv kernel against the plain conv
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_prefill_with_kernel_matches_plain(dtype, monkeypatch):
    """Smoke config on the card: one conv1d launch per layer per prefill,
    logits within 1e-4 of the same model whose conv is the kernel's plain
    version (f32 sums in the same tap order, one rounding; only the f32
    products round differently under fused multiply-adds, bf16 products
    are exact), and a planted fault (taps shifted by one) outside it."""
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
    monkeypatch.setattr(ssm, "conv1d_causal", conv1d_causal_plain)
    plain, _, _ = M.forward(params, cfg, toks)
    monkeypatch.setattr(ssm, "conv1d_causal", lambda x, w: conv1d_causal_plain(
        x, torch.roll(w, 1, dims=0)))
    fault, _, _ = M.forward(params, cfg, toks)
    torch.cuda.synchronize()
    on, plain, fault = _np(on.cpu()), _np(plain.cpu()), _np(fault.cpu())
    np.testing.assert_allclose(on, plain, rtol=tol, atol=tol)
    assert not np.allclose(fault, plain, rtol=tol, atol=tol)
