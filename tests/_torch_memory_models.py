"""Helpers shared by ``test_torch_encdec.py`` and ``test_torch_vlm.py``.

Both families read a ``memory`` (Whisper's frame embeddings, the VLM's
patch embeddings).  The reference runs the arch's ``smoke()`` config with
``attn_block_kv = 8`` (so the blocked attention crosses several KV blocks
and pads the last one) and weights from ``init_params(PRNGKey(0))``; the
port gets the same config through ``config_from_fields`` and the same
weights through ``params_from_numpy``.

The VLM's cross-attention is tanh-gated and its ``gate`` starts at zero,
so under the default weights the cross path adds nothing and no
comparison could see it: :func:`pair` sets every gate to a non-zero value
drawn from a NumPy seed in the reference's parameters before they are
carried across.  Inputs (tokens, memories) are drawn from NumPy seeds.

JAX is imported inside the functions only, so the files that use these
helpers collect where JAX is not installed (their card tests run there).
"""
import dataclasses

import numpy as np
import torch

from repro_torch.models.convert import config_from_fields, params_from_numpy

BLOCK_KV = 8
#: float32: the two packages sum their einsums in different orders; the
#: logits of the smoke models land within 3e-6 of each other
F32 = dict(rtol=1e-5, atol=1e-5)
#: bfloat16, as ``tests/test_torch_dense.py`` states it: one layer's output
#: within 5e-2, a whole model's logits within 0.25 (one-ulp differences
#: compound through the layers), and no further from the reference's
#: float32 logits than 1.25 times the reference's own bf16 error
BF16 = dict(rtol=5e-2, atol=5e-2)
BF16_MODEL = dict(rtol=0.25, atol=0.25)
BF16_OF_REF = 1.25
#: prefill-then-decode against forward: the reference's own tolerance
#: (``tests/test_arch_smoke.py:83``)
DECODE_TOL = dict(rtol=1e-2, atol=1e-2)


def np_(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def ref_cfg(arch, dtype="float32", **kw):
    from repro.configs.registry import get_config as ref_get
    return ref_get(arch, smoke=True).scaled(dtype=dtype,
                                           attn_block_kv=BLOCK_KV, **kw)


def gates(n, seed=11):
    """``n`` non-zero gate values in [0.5, 1.5] with random signs."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.5, 1.5, n) * rng.choice([-1.0, 1.0], n)
            ).astype(np.float32)


def pair(arch, dtype="float32", **kw):
    """(reference cfg, reference params, port cfg, port params), the
    VLM's cross gates set non-zero on both sides."""
    import jax
    import jax.numpy as jnp
    from repro.models import model as RM
    rcfg = ref_cfg(arch, dtype, **kw)
    rparams, _ = RM.init_params(rcfg, jax.random.PRNGKey(0))
    if rcfg.family == "vlm":
        g = rparams["cross"]["attn"]["gate"]
        rparams["cross"]["attn"]["gate"] = jnp.asarray(gates(g.shape[0]),
                                                       g.dtype)
    cfg = config_from_fields(dataclasses.asdict(rcfg))
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), cfg,
                               device="cpu")
    return rcfg, rparams, cfg, params


def n_memory(cfg) -> int:
    """Rows of one request's memory: frames or image tokens."""
    return cfg.n_frames if cfg.family == "encdec" else cfg.n_img_tokens


def memory(cfg, b, seed=0):
    """(B, rows, d_model) float32 N(0, 1) embeddings from a NumPy seed."""
    rng = np.random.default_rng(1000 + seed)
    return rng.standard_normal((b, n_memory(cfg), cfg.d_model),
                               dtype=np.float32)


def tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(b, s)).astype(np.int32)


def both(a, dtype="float32"):
    """One NumPy array as (JAX array, torch tensor) of ``dtype``."""
    import jax.numpy as jnp
    if dtype == "bfloat16":
        return jnp.asarray(a, jnp.bfloat16), \
            torch.as_tensor(a).to(torch.bfloat16)
    return jnp.asarray(a), torch.as_tensor(a)


def leaves_equal(port, ref, path=""):
    """Every leaf of the port's tree equals the reference's (stacked)
    leaf; lists of layers are compared slice by slice.  Returns the number
    of leaves compared."""
    n = 0
    if isinstance(port, list):
        for i, p in enumerate(port):
            n += leaves_equal(p, _index(ref, i), f"{path}[{i}]")
        return n
    if isinstance(port, dict):
        assert set(port) == set(ref), (path, set(port), set(ref))
        for k in port:
            n += leaves_equal(port[k], ref[k], f"{path}.{k}")
        return n
    want = np.asarray(ref, np.float32)
    assert tuple(port.shape) == want.shape, path
    np.testing.assert_array_equal(np_(port), want, err_msg=path)
    return 1


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


# ---------------------------------------------------------------------------
# checks run by both families' test files
# ---------------------------------------------------------------------------

def check_config_fields(arch):
    """The port's full and smoke configs equal the reference's field for
    field (``use_pallas`` is ``use_kernels``)."""
    from repro.configs.registry import get_config as ref_get
    from repro_torch.configs import ARCHS, get_config
    assert arch in ARCHS
    for smoke in (False, True):
        rcfg = ref_get(arch, smoke=smoke)
        cfg = config_from_fields(dataclasses.asdict(rcfg))
        assert cfg == get_config(arch, smoke=smoke)
        got, want = dataclasses.asdict(cfg), dataclasses.asdict(rcfg)
        assert got.pop("use_kernels") == want.pop("use_pallas")
        assert got == want


def check_full_param_count(arch, want, monkeypatch):
    """The full-size tree, built on the meta device (no memory), counts
    the reference's parameters (its ``jax.eval_shape``)."""
    import jax
    from repro.configs.registry import get_config as ref_get
    from repro.models import model as RM
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.nn import ParamBuilder, count_params
    monkeypatch.setattr(ParamBuilder, "param", lambda self, shape, **kw:
                        torch.empty(shape, device="meta"))
    rcfg = ref_get(arch)
    shapes = jax.eval_shape(
        lambda: RM.init_params(rcfg, jax.random.PRNGKey(0))[0])
    ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    got = count_params(M.init_params(get_config(arch), 0, device="cpu"))
    assert got == ref == want


def check_forward(p, seed=1):
    """``forward`` with a memory against the reference's, float32; the same
    tokens with another seed's memory must move the logits past the
    tolerance (a planted fault the comparison has to catch)."""
    import jax.numpy as jnp
    from repro.models import model as RM
    from repro_torch.models import model as M
    rcfg, rparams, cfg, params = p
    toks = tokens(cfg, 2, 21, seed=seed)          # 3 KV blocks, 3 padded
    mem = memory(cfg, 2, seed)
    want, _, _ = RM.forward(rparams, rcfg, jnp.asarray(toks),
                            memory=jnp.asarray(mem))
    want = np.asarray(want)
    got, aux, kv = M.forward(params, cfg, torch.as_tensor(toks),
                             memory=torch.as_tensor(mem))
    assert kv is None and aux == 0.0
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 21,
                                                                cfg.vocab)
    np.testing.assert_allclose(np_(got), want, **F32)
    fault, _, _ = M.forward(params, cfg, torch.as_tensor(toks),
                            memory=torch.as_tensor(memory(cfg, 2, seed + 1)))
    bound = F32["atol"] + F32["rtol"] * np.abs(want)
    assert (np.abs(np_(fault) - want) > bound).any(), \
        "another memory leaves the logits within the tolerance"


def check_prefill_cache(p):
    """Key by key: every layer's K/V packed into the rings, kv_pos, pos,
    the cross K/V of the memory, and the logits."""
    import jax.numpy as jnp
    from repro.serving import engine as RE
    from repro_torch.serving import cache as C
    from repro_torch.serving import engine as E
    rcfg, rparams, cfg, params = p
    toks, mem = tokens(cfg, 3, 19, seed=2), memory(cfg, 3, 2)
    rl, rc = RE.prefill(rparams, rcfg, jnp.asarray(toks), 32,
                        memory=jnp.asarray(mem))
    pl, pc = E.prefill(params, cfg, torch.as_tensor(toks), 32,
                       memory=torch.as_tensor(mem))
    empty = C.init_cache(cfg, 3, 32, device="cpu")
    assert set(pc) == set(rc) == set(empty) == {"pos", "kv_pos", "k", "v",
                                                "cross"}
    assert int(pc["pos"]) == int(rc["pos"]) == 19
    np.testing.assert_array_equal(pc["kv_pos"].numpy(),
                                  np.asarray(rc["kv_pos"]))
    for name, got, want, like in (
            ("k", pc["k"], rc["k"], empty["k"]),
            ("v", pc["v"], rc["v"], empty["v"]),
            ("cross.k", pc["cross"]["k"], rc["cross"]["k"],
             empty["cross"]["k"]),
            ("cross.v", pc["cross"]["v"], rc["cross"]["v"],
             empty["cross"]["v"])):
        assert tuple(got.shape) == want.shape == tuple(like.shape), name
        assert got.dtype == like.dtype, name
        np.testing.assert_allclose(np_(got), np.asarray(want), **F32,
                                   err_msg=name)
    np.testing.assert_allclose(np_(pl), np.asarray(rl), **F32)


def check_teacher_forced_decode(p, decode_window):
    """Four decode steps after a 13-token prompt against the reference's:
    logits, kv_pos and the rings (``decode_window`` 8 < 13 wraps the
    ring); the input cache is left as it was and ``cross`` is carried."""
    import jax.numpy as jnp
    from repro.serving import engine as RE
    from repro_torch.serving import engine as E
    rcfg, rparams, cfg, params = p
    if decode_window:
        rcfg = rcfg.scaled(decode_window=decode_window)
        cfg = cfg.scaled(decode_window=decode_window)
    toks, mem = tokens(cfg, 2, 17, seed=3), memory(cfg, 2, 3)
    _, rc = RE.prefill(rparams, rcfg, jnp.asarray(toks[:, :13]), 32,
                       memory=jnp.asarray(mem))
    _, pc = E.prefill(params, cfg, torch.as_tensor(toks[:, :13]), 32,
                      memory=torch.as_tensor(mem))
    assert pc["k"].shape[2] == (decode_window or 32)
    for i in range(13, 17):
        step = toks[:, i:i + 1]
        rl, rc = RE.decode_step(rparams, rcfg, rc, jnp.asarray(step))
        kept = {k: v.clone() for k, v in pc.items() if k != "cross"}
        pl, pc2 = E.decode_step(params, cfg, pc, torch.as_tensor(step))
        for k, v in kept.items():
            assert torch.equal(pc[k], v), k
        assert pc2["cross"] is pc["cross"]
        pc = pc2
        assert tuple(pl.shape) == (2, 1, cfg.vocab) and int(pc["pos"]) == i + 1
        np.testing.assert_allclose(np_(pl), np.asarray(rl), **F32)
        np.testing.assert_array_equal(pc["kv_pos"].numpy(),
                                      np.asarray(rc["kv_pos"]))
    for k in ("k", "v"):
        np.testing.assert_allclose(np_(pc[k]), np.asarray(rc[k]), **F32)


def check_prefill_then_decode(p, s, window):
    """Prefill S tokens, then decode token S: the full forward's logits at
    position S with the same memory, within the reference's tolerance.
    With a window W the forward masks to the last W positions and the ring
    holds W slots."""
    from repro_torch.models import model as M
    from repro_torch.serving import engine as E
    _, _, cfg, params = p
    if window:
        cfg = cfg.scaled(sliding_window=window, decode_window=window)
    toks = torch.as_tensor(tokens(cfg, 2, s + 1, seed=s))
    mem = torch.as_tensor(memory(cfg, 2, s))
    full, _, _ = M.forward(params, cfg, toks, memory=mem)
    _, cc = E.prefill(params, cfg, toks[:, :s], 64, memory=mem)
    assert cc["k"].shape[2] == (window or 64)
    step, cc2 = E.decode_step(params, cfg, cc, toks[:, s:s + 1])
    assert int(cc2["pos"]) == s + 1
    np.testing.assert_allclose(np_(step[:, 0]), np_(full[:, s]),
                               **DECODE_TOL)


def check_generate(p):
    """Greedy ``generate`` gives the reference's tokens."""
    import jax.numpy as jnp
    from repro.serving import engine as RE
    from repro_torch.serving import engine as E
    rcfg, rparams, cfg, params = p
    toks, mem = tokens(cfg, 3, 9, seed=4), memory(cfg, 3, 4)
    rt, rc = RE.generate(rparams, rcfg, jnp.asarray(toks), 10, 32,
                         memory=jnp.asarray(mem))
    pt, pc = E.generate(params, cfg, torch.as_tensor(toks), 10, 32,
                        memory=torch.as_tensor(mem))
    assert pt.dtype == torch.int32 and tuple(pt.shape) == (3, 10)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(rt))
    assert int(pc["pos"]) == int(rc["pos"]) == 9 + 10


def check_driver(p):
    """The same 6-request mix (two prompt lengths, a memory each) through
    both drivers: tokens, groups and batches; a request without a memory
    is refused."""
    import jax.numpy as jnp
    import pytest
    from repro.serving import BatchPolicy as RefPolicy
    from repro.serving import GenerateDriver as RefDriver
    from repro_torch.serving import BatchPolicy, GenerateDriver
    rcfg, rparams, cfg, params = p
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, 8 if i % 3 else 12).astype(np.int32)
               for i in range(6)]
    mems = [memory(cfg, 1, 10 + i)[0] for i in range(6)]
    outs = []
    for drv in (RefDriver(rparams, rcfg, cache_len=32, autostart=False,
                          policy=RefPolicy(max_batch=3, max_wait_ms=1.0)),
                GenerateDriver(params, cfg, cache_len=32, autostart=False,
                               policy=BatchPolicy(max_batch=3,
                                                  max_wait_ms=1.0))):
        ref = isinstance(drv, RefDriver)
        conv = jnp.asarray if ref else torch.as_tensor
        futs = [drv.submit(conv(pr), 5, memory=conv(m))
                for pr, m in zip(prompts, mems)]
        drv.start()
        outs.append(([np.asarray(f.result()) for f in futs],
                     drv.metrics()["overall"],
                     sorted(drv.metrics_registry.keys())))
        drv.close()
    (ref_toks, ref_m, ref_keys), (got_toks, got_m, got_keys) = outs
    for r, g in zip(ref_toks, got_toks):
        np.testing.assert_array_equal(g, r)
    assert got_keys == ref_keys
    assert all(f"mem={n_memory(cfg)}x{cfg.d_model}" in k for k in got_keys)
    for k in ("groups", "submitted", "completed", "failed", "rejected",
              "batches", "batch_occupancy"):
        assert got_m[k] == ref_m[k], k
    assert got_m["batches"] == 3 and got_m["latency"]["count"] == 6
    drv = GenerateDriver(params, cfg, autostart=False)
    with pytest.raises(ValueError, match="requires a memory"):
        drv.submit(torch.as_tensor(prompts[0]), 5)
    drv.close()


def check_embed_clamp(p):
    """A decode token's learned position is row ``min(pos, max_seq - 1)``
    of the table, as in the reference: equal rows at every position, one
    row for every position past the table, and a decode step at such a
    position equal to the reference's."""
    import jax.numpy as jnp
    from repro.serving import engine as RE
    from repro_torch.serving import engine as E
    rcfg, rparams, cfg, params = p
    tok = tokens(cfg, 2, 1, seed=6)
    last = cfg.max_seq - 1
    rows = {}
    for pos in (0, 5, last, last + 1, 4 * cfg.max_seq):
        want = np.asarray(RE._embed_one(rparams, rcfg, jnp.asarray(tok),
                                        jnp.asarray(pos, jnp.int32)))
        got = E._embed_one(params, cfg, torch.as_tensor(tok),
                           torch.tensor(pos, dtype=torch.int32))
        np.testing.assert_array_equal(np_(got), want)
        rows[pos] = np_(got)
    np.testing.assert_array_equal(rows[last + 1], rows[last])
    np.testing.assert_array_equal(rows[4 * cfg.max_seq], rows[last])
    assert not np.array_equal(rows[last], rows[5])
    # decode past the table: a cache whose position is 2 * max_seq
    toks, mem = tokens(cfg, 2, 7, seed=7), memory(cfg, 2, 7)
    _, rc = RE.prefill(rparams, rcfg, jnp.asarray(toks[:, :6]), 16,
                       memory=jnp.asarray(mem))
    _, pc = E.prefill(params, cfg, torch.as_tensor(toks[:, :6]), 16,
                      memory=torch.as_tensor(mem))
    rc["pos"] = jnp.asarray(2 * cfg.max_seq, jnp.int32)
    pc["pos"] = torch.tensor(2 * cfg.max_seq, dtype=torch.int32)
    rl, _ = RE.decode_step(rparams, rcfg, rc, jnp.asarray(toks[:, 6:]))
    pl, _ = E.decode_step(params, cfg, pc, torch.as_tensor(toks[:, 6:]))
    np.testing.assert_allclose(np_(pl), np.asarray(rl), **F32)


def check_bf16(arch, p32):
    """bf16 logits within ``BF16_MODEL`` of the reference's bf16 logits
    and no further from its float32 logits than ``BF16_OF_REF`` times its
    own bf16 error; one decode step within ``BF16``."""
    import jax.numpy as jnp
    from repro.models import model as RM
    from repro.serving import engine as RE
    from repro_torch.models import model as M
    from repro_torch.serving import engine as E
    rcfg32, rparams32 = p32[:2]
    rcfg, rparams, cfg, params = pair(arch, "bfloat16")
    toks, mem = tokens(cfg, 2, 19, seed=6), memory(cfg, 2, 6)
    jm, tm = both(mem, "bfloat16")
    want = np.asarray(RM.forward(rparams, rcfg, jnp.asarray(toks),
                                 memory=jm)[0])
    got, _, _ = M.forward(params, cfg, torch.as_tensor(toks), memory=tm)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(np_(got), want, **BF16_MODEL)
    exact = np.asarray(RM.forward(rparams32, rcfg32, jnp.asarray(toks),
                                  memory=jnp.asarray(np_(tm)))[0])
    ref_err = np.abs(want - exact).max()
    assert np.abs(np_(got) - exact).max() <= BF16_OF_REF * ref_err, ref_err
    _, rc = RE.prefill(rparams, rcfg, jnp.asarray(toks[:, :18]), 32,
                       memory=jm)
    _, pc = E.prefill(params, cfg, torch.as_tensor(toks[:, :18]), 32,
                      memory=tm)
    for t in (pc["k"], pc["v"], pc["cross"]["k"], pc["cross"]["v"]):
        assert t.dtype == torch.bfloat16
    rl, _ = RE.decode_step(rparams, rcfg, rc, jnp.asarray(toks[:, 18:]))
    pl, _ = E.decode_step(params, cfg, pc, torch.as_tensor(toks[:, 18:]))
    np.testing.assert_allclose(np_(pl), np.asarray(rl), **BF16)


def check_launcher(arch):
    """``python -m repro_torch.launch.serve --smoke --device cpu`` serves
    the arch, each request with its own memory, and counts the
    reference's parameters."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    import jax
    from repro.configs.registry import get_config as ref_get
    from repro.models import model as RM
    from repro.models.nn import count_params as ref_count
    n = ref_count(RM.init_params(ref_get(arch, smoke=True),
                                 jax.random.PRNGKey(0))[0])
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        q for q in (src, os.environ.get("PYTHONPATH")) if q))
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


def check_on_card(arch):
    """The smoke model on the card (weights drawn there): prefill-then-
    decode through a wrapped ring equals forward, and the logits move
    with the memory."""
    import pytest
    from repro_torch.configs import get_config
    from repro_torch.kernels.conv1d import ops as conv_ops
    from repro_torch.models import model as M
    from repro_torch.serving import engine as E
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs a CUDA device of compute capability 9.0")
    cfg = get_config(arch, smoke=True).scaled(sliding_window=8,
                                              decode_window=8)
    params = M.init_params(cfg, 0)
    if cfg.family == "vlm":
        for cp, g in zip(params["cross"], gates(len(params["cross"]))):
            cp["attn"]["gate"].fill_(float(g))
    toks = torch.as_tensor(tokens(cfg, 2, 21, seed=5), device="cuda")
    mem = torch.as_tensor(memory(cfg, 2, 5), device="cuda")
    before = conv_ops.conv1d_causal.launches
    full, _, _ = M.forward(params, cfg, toks, memory=mem)
    _, cc = E.prefill(params, cfg, toks[:, :20], 64, memory=mem)
    step, _ = E.decode_step(params, cfg, cc, toks[:, 20:])
    np.testing.assert_allclose(np_(step[:, 0].cpu()), np_(full[:, 20].cpu()),
                               **DECODE_TOL)
    other, _, _ = M.forward(params, cfg, toks, memory=torch.as_tensor(
        memory(cfg, 2, 6), device="cuda"))
    assert float((other - full).abs().max()) > 1e-3
    assert conv_ops.conv1d_causal.launches == before
