"""The port's training substrate against the JAX reference: the schedule,
AdamW, the Zipf data, checkpoints, the train step, microbatching, gradient
compression, the watchdog and supervisor, kill-and-resume and the launcher
(the cases of ``tests/test_training.py`` and
``tests/test_fault_tolerance.py``, held to the reference where it has an
answer).

States start from the reference's ``init_state(PRNGKey(0))`` carried across
with ``train_state_from_numpy``; batches are ``data.global_batch``, the
same bytes in both packages.  Tolerances, all float32:

* the schedule and one AdamW ``apply`` on the same grads and state: to
  float32 rounding, ``rtol = 2e-6`` (``cos`` and ``pow`` may differ by an
  ulp between XLA and torch: the learning rate at step 3 lands one ulp
  apart);
* losses, grad norms and learning rates of three train steps: ``rtol =
  1e-5`` (they land within 3e-7);
* params after those steps: ``atol = 2 * lr * steps``.  AdamW moves an
  element by about ``lr * sign(g)`` whatever ``|g|``, so a gradient that is
  ~1e-9 in one package and of the other sign in the other moves that
  element a whole ``lr`` apart; no element can drift further.  Nearly all
  land within 1e-5: at most 1e-4 of the elements may exceed that.

Kill-and-resume and the launcher's restart are held bit for bit.
"""
import dataclasses
import importlib
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models.convert import (config_from_fields,
                                        train_state_from_numpy,
                                        tree_to_numpy)
from repro_torch.models.nn import tree_leaves, tree_map
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import data
from repro_torch.training import fault_tolerance as FT
from repro_torch.training import optimizer as O

T = importlib.import_module("repro_torch.training.train_step")

SCALAR = dict(rtol=2e-6, atol=0)
STEP = dict(rtol=1e-5, atol=0)
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def _ref_train():
    return importlib.import_module("repro.training.train_step")


def _pair_state(arch, **fields):
    """(reference cfg, reference state, port cfg, port state)."""
    import jax
    from repro.configs.registry import get_config as ref_get
    rcfg = ref_get(arch, smoke=True).scaled(attn_block_kv=8, **fields)
    rstate, _ = _ref_train().init_state(rcfg, jax.random.PRNGKey(0))
    cfg = config_from_fields(dataclasses.asdict(rcfg))
    state = train_state_from_numpy(jax.tree.map(np.asarray, rstate.tree()),
                                   cfg, "cpu")
    return rcfg, rstate, cfg, state


def _memory(cfg, b, seed=0):
    rows = {"encdec": cfg.n_frames, "vlm": cfg.n_img_tokens}.get(cfg.family)
    if rows is None:
        return None
    return np.random.default_rng(100 + seed).standard_normal(
        (b, rows, cfg.d_model), dtype=np.float32)


def _t(a):
    return None if a is None else torch.as_tensor(a)


# ---------------------------------------------------------------------------
# the schedule and AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("oc", [
    dict(lr=1.0, warmup_steps=10, total_steps=110, min_lr_frac=0.1),
    dict(lr=3e-3, warmup_steps=20, total_steps=8),
    dict(lr=3e-4, warmup_steps=0, total_steps=37, min_lr_frac=0.0)])
def test_schedule_matches_reference(oc):
    import jax.numpy as jnp
    from repro.training import optimizer as RO
    for step in range(0, oc["total_steps"] + 5):
        want = float(RO.schedule(RO.OptConfig(**oc), jnp.asarray(step)))
        got = O.schedule(O.OptConfig(**oc),
                         torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, **SCALAR)


def test_schedule_warmup_and_decay():
    oc = O.OptConfig(lr=1.0, warmup_steps=10, total_steps=110,
                     min_lr_frac=0.1)

    def lr(s):
        return float(O.schedule(oc, torch.tensor(s, dtype=torch.int32)))
    assert lr(0) == 0.0
    np.testing.assert_allclose(lr(10), 1.0)
    np.testing.assert_allclose(lr(110), 0.1, rtol=1e-5)
    assert 0.1 < lr(60) < 1.0


def _opt_inputs(seed, big=False):
    """A nested tree of grads and a mid-training optimizer state."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (3, 5), "b": [{"c": (7,)}, {"c": (7,)}], "d": ()}

    def draw(scale=1.0, positive=False):
        def leaf(shape):
            x = rng.standard_normal(shape).astype(np.float32) * scale
            return np.abs(x) if positive else x
        return tree_map(leaf, shapes)
    grads = draw(1e6 if big else 1.0)
    state = {"step": np.int32(3), "mu": draw(0.1), "nu": draw(0.01, True),
             "master": draw()}
    return grads, state


def _tensors(tree):
    """Copies of a tree of arrays as tensors (the optimizer writes in
    place)."""
    return tree_map(torch.tensor, tree)


@pytest.mark.parametrize("big", [False, True], ids=["unclipped", "clipped"])
def test_adamw_apply_matches_reference(big):
    """One ``apply`` on the same grads and state, in both packages."""
    import jax
    import jax.numpy as jnp
    from repro.training import optimizer as RO
    grads, st = _opt_inputs(1, big)
    oc = dict(lr=1e-2, warmup_steps=5, total_steps=20, weight_decay=0.1)
    rparams, rst, rm = RO.apply(
        RO.OptConfig(**oc),
        RO.OptState(step=jnp.asarray(st["step"]),
                    **{k: jax.tree.map(jnp.asarray, st[k])
                       for k in ("mu", "nu", "master")}),
        jax.tree.map(jnp.asarray, grads), jnp.float32)
    state = O.OptState(step=torch.tensor(3, dtype=torch.int32),
                       **{k: _tensors(st[k]) for k in ("mu", "nu", "master")})
    params, new, m = O.apply(O.OptConfig(**oc), state, _tensors(grads),
                             torch.float32)
    assert int(new.step) == 4 and new.step.dtype == torch.int32
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), float(rm[k]), **SCALAR)
    if big:
        assert float(m["grad_norm"]) > 1e5        # reported before the clip
    for got, want in ((params, rparams), (new.mu, rst.mu), (new.nu, rst.nu),
                      (new.master, rst.master)):
        for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-6,
                                       atol=1e-8)


def test_adamw_updates_the_state_in_place():
    """mu, nu and master are updated in place (the reference donates its
    state); the params come back as new compute-dtype copies, never
    aliases of master."""
    grads, st = _opt_inputs(2)
    state = O.OptState(step=torch.tensor(3, dtype=torch.int32),
                       **{k: _tensors(st[k]) for k in ("mu", "nu", "master")})
    before = [t.clone() for t in tree_leaves(state.master)]
    params, new, _ = O.apply(O.OptConfig(), state, _tensors(grads),
                             torch.bfloat16)
    for a, b in zip(tree_leaves(new.master), tree_leaves(state.master)):
        assert a is b
    assert any(not torch.equal(a, b)
               for a, b in zip(before, tree_leaves(state.master)))
    for p, m in zip(tree_leaves(params), tree_leaves(new.master)):
        assert p.dtype == torch.bfloat16
        assert p.data_ptr() != m.data_ptr()
        assert torch.equal(p, m.to(torch.bfloat16))
    f32, _, _ = O.apply(O.OptConfig(), new, _tensors(grads), torch.float32)
    for p, m in zip(tree_leaves(f32), tree_leaves(new.master)):
        assert p.data_ptr() != m.data_ptr() and torch.equal(p, m)


def test_adamw_converges_quadratic():
    oc = O.OptConfig(lr=0.1, warmup_steps=0, total_steps=200,
                     weight_decay=0.0, clip_norm=1e9)
    target = torch.tensor([3.0, -2.0, 0.5])
    params = {"w": torch.zeros(3)}
    st = O.init(params)
    for _ in range(200):
        params, st, m = O.apply(oc, st, {"w": params["w"] - target},
                                torch.float32)
    torch.testing.assert_close(params["w"], target, atol=1e-2, rtol=0)
    assert float(m["grad_norm"]) < 0.1


def test_grad_clip():
    oc = O.OptConfig(clip_norm=1.0, warmup_steps=0)
    st = O.init({"w": torch.zeros(4)})
    _, _, m = O.apply(oc, st, {"w": torch.full((4,), 1e6)}, torch.float32)
    assert float(m["grad_norm"]) > 1e5


def test_optimizer_chunks_cover_every_leaf(monkeypatch):
    """Leaves are updated in chunks: with a chunk smaller than the tree,
    the update equals the one-chunk update bit for bit."""
    grads, st = _opt_inputs(3)

    def run():
        state = O.OptState(step=torch.tensor(3, dtype=torch.int32),
                           **{k: _tensors(st[k])
                              for k in ("mu", "nu", "master")})
        return O.apply(O.OptConfig(), state, _tensors(grads), torch.float32)
    want = run()
    monkeypatch.setattr(O, "CHUNK", 8)
    assert len(list(O._chunks(tree_leaves(_tensors(grads))))) > 1
    got = run()
    for a, b in zip(tree_leaves(got[1].master), tree_leaves(want[1].master)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,batch,seed,step", [
    (128, 32, 4, 7, 3), (256, 16, 4, 1, 0), (151936, 12, 2, 5, 11),
    (51866, 31, 3, 0, 2)])
def test_batches_are_byte_identical_to_reference(vocab, seq, batch, seed,
                                                 step):
    from repro.training import data as RD
    want = RD.global_batch(RD.DataConfig(vocab=vocab, seq_len=seq,
                                         global_batch=batch, seed=seed),
                           step)
    dc = data.DataConfig(vocab=vocab, seq_len=seq, global_batch=batch,
                         seed=seed)
    got = data.global_batch(dc, step)
    assert got.dtype == want.dtype == np.int32
    assert got.tobytes() == want.tobytes()
    t = data.device_batch(dc, step, "cpu")
    assert t.dtype == torch.int32 and t.numpy().tobytes() == want.tobytes()


def test_data_deterministic_and_shifted():
    dc = data.DataConfig(vocab=128, seq_len=32, global_batch=4, seed=7)
    b1, b2 = data.global_batch(dc, 3), data.global_batch(dc, 3)
    np.testing.assert_array_equal(b1, b2)
    assert not np.array_equal(b1, data.global_batch(dc, 4))
    assert b1.shape == (4, 33) and b1.min() >= 0 and b1.max() < 128
    it = data.batch_iterator(dc, "cpu", start_step=3)
    for want_step in (3, 4):
        step, tok = next(it)
        assert step == want_step
        np.testing.assert_array_equal(tok.numpy(),
                                      data.global_batch(dc, want_step))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_and_atomicity(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.int32)},
            "l": [torch.zeros(2), torch.full((1,), 3.0)]}
    d = str(tmp_path / "ck")
    ckpt.save(d, 10, tree, extra={"step": 10})
    ckpt.save(d, 20, tree, extra={"step": 20})
    assert ckpt.latest_step(d) == 20
    os.makedirs(os.path.join(d, "step_00000030.tmp"))      # a crash
    assert ckpt.latest_step(d) == 20
    got, extra = ckpt.restore(d, tree, device="cpu")
    assert extra["step"] == 20
    for g, w in zip(tree_leaves(got), tree_leaves(tree)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert sorted(os.listdir(os.path.join(d, "step_00000020"))) == sorted(
        ["manifest.json", "a.npy", "b.c.npy", "l.__0.npy", "l.__1.npy"])


def test_checkpoint_retention(tmp_path):
    d = str(tmp_path / "ck")
    for s in (1, 2, 3, 4, 5):
        ckpt.save(d, s, {"x": torch.zeros(1)}, keep=2)
    kept = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    assert len(kept) == 2 and kept[-1] == "step_00000005"


def test_checkpoint_bf16_leaf_is_bit_exact(tmp_path):
    """A bfloat16 leaf is stored as its uint16 bits and comes back bit for
    bit, subnormals, infinities and NaN payloads included."""
    bits = np.array([0x0001, 0x8001, 0x7F80, 0xFF80, 0x7FC1, 0x3F80, 0xC2F7,
                     0x0000, 0x8000], np.uint16)
    x = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, {"w": x, "f": torch.ones(2)})
    import json
    with open(os.path.join(d, "step_00000001", ckpt.MANIFEST)) as f:
        meta = json.load(f)
    assert meta["leaves"]["/w"]["dtype"] == "bfloat16"
    assert meta["leaves"]["/f"]["dtype"] == "float32"
    got, _ = ckpt.restore(d, {"w": x, "f": torch.ones(2)}, device="cpu")
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w"].view(torch.int16).numpy()
                                  .view(np.uint16), bits)


def test_async_checkpointer_snapshots_before_returning(tmp_path):
    """``save`` copies every leaf before it returns: an in-place update
    right after it does not reach the checkpoint."""
    d = str(tmp_path / "ck")
    ac = ckpt.AsyncCheckpointer(d)
    x = torch.full((3,), 7.0)
    ac.save(5, {"x": x}, extra={"step": 5})
    x.add_(1.0)                                 # the next optimizer step
    ac.wait()
    got, extra = ckpt.restore(d, {"x": torch.zeros(3)}, device="cpu")
    assert extra == {"step": 5}
    np.testing.assert_array_equal(got["x"].numpy(), 7.0)


def test_train_state_tree_round_trips(tmp_path):
    """A bf16 model's TrainState: params bf16, moments and master float32,
    the step int32, each checkpointed and restored exactly; and
    ``tree_to_numpy`` gives back the reference's stacked arrays."""
    import jax
    rcfg, rstate, cfg, state = _pair_state("zamba2-2.7b")
    for got, want in zip(jax.tree.leaves(tree_to_numpy(state.opt.master,
                                                       cfg)),
                         jax.tree.leaves(rstate.opt.master)):
        np.testing.assert_array_equal(got, np.asarray(want))
    bcfg = cfg.scaled(dtype="bfloat16")
    bstate = train_state_from_numpy(
        jax.tree.map(np.asarray, rstate.tree()), bcfg, "cpu")
    assert {p.dtype for p in tree_leaves(bstate.params)} == {torch.bfloat16}
    for k in ("mu", "nu", "master"):
        assert {p.dtype for p in tree_leaves(getattr(bstate.opt, k))} == \
            {torch.float32}
    assert bstate.opt.step.dtype == torch.int32
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, bstate.tree(), extra={"step": 1})
    got, _ = ckpt.restore(d, bstate.tree(), device="cpu")
    for g, w in zip(tree_leaves(got), tree_leaves(bstate.tree())):
        assert g.dtype == w.dtype and torch.equal(g, w)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,micro,compress", [
    ("qwen3-1.7b", 1, False), ("granite-moe-3b-a800m", 2, False),
    ("whisper-large-v3", 2, False), ("mamba2-2.7b", 1, True)])
def test_three_train_steps_match_reference(arch, micro, compress):
    """Three steps of the port's ``train_step`` against the reference's
    jitted ``train_step`` from the same state on the same batches (a
    memory split per microbatch for Whisper; bf16 gradient compression
    for Mamba2)."""
    import jax
    import jax.numpy as jnp
    from repro.training import optimizer as RO
    RT = _ref_train()
    rcfg, rstate, cfg, state = _pair_state(arch)
    rstep = jax.jit(RT.make_train_step(rcfg, RT.TrainConfig(
        microbatches=micro, grad_compress=compress,
        opt=RO.OptConfig(**OPT))))
    tc = T.TrainConfig(microbatches=micro, grad_compress=compress,
                       opt=O.OptConfig(**OPT))
    dc = data.DataConfig(vocab=cfg.vocab, seq_len=20, global_batch=4, seed=5)
    mem = _memory(cfg, 4)
    for s in range(3):
        tok = data.global_batch(dc, s)
        rstate, rm = rstep(rstate, jnp.asarray(tok),
                           None if mem is None else jnp.asarray(mem))
        state, m = T.train_step(cfg, tc, state, torch.as_tensor(tok),
                                _t(mem))
        assert set(m) == set(rm)
        for k in ("loss", "nll", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(rm[k]), **STEP,
                                       err_msg=f"step {s} {k}")
    assert int(state.opt.step) == 3
    got = np.concatenate([x.ravel() for x in jax.tree.leaves(
        tree_to_numpy(state.params, cfg))])
    want = np.concatenate([np.asarray(x).ravel()
                           for x in jax.tree.leaves(rstate.params)])
    diff = np.abs(got - want)
    assert diff.max() <= 2 * OPT["lr"] * 3
    assert (diff > 1e-5).mean() <= 1e-4


@pytest.mark.parametrize("micro", [1, 2])
def test_train_step_decreases_loss(micro):
    cfg = get_config("qwen3-1.7b", smoke=True)
    tc = T.TrainConfig(microbatches=micro,
                       opt=O.OptConfig(lr=1e-2, warmup_steps=0,
                                       total_steps=50))
    state = T.init_state(cfg, 0, device="cpu")
    dc = data.DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=1)
    step = T.make_train_step(cfg, tc)
    tok = data.device_batch(dc, 0, "cpu")          # the same batch: memorise
    losses = []
    for _ in range(12):
        state, m = step(state, tok)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.8
    assert all(np.isfinite(losses))


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "whisper-large-v3"])
def test_microbatch_equals_full_batch_grads(arch):
    """Accumulation over 2 microbatches == one batch of 4 (Whisper's
    memory split with its tokens)."""
    cfg = get_config(arch, smoke=True)
    state = T.init_state(cfg, 2, device="cpu")
    dc = data.DataConfig(vocab=cfg.vocab, seq_len=12, global_batch=4, seed=3)
    tok, mem = data.device_batch(dc, 0, "cpu"), _t(_memory(cfg, 4))
    l1, _, g1 = T.loss_and_grads(cfg, T.TrainConfig(microbatches=1),
                                 state.params, tok, mem)
    l2, _, g2 = T.loss_and_grads(cfg, T.TrainConfig(microbatches=2),
                                 state.params, tok, mem)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-5)
    for a, b in zip(tree_leaves(g1), tree_leaves(g2)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="microbatches"):
        T.loss_and_grads(cfg, T.TrainConfig(microbatches=3), state.params,
                         tok, mem)


def test_grad_compress_rounds_the_grads_to_bf16(monkeypatch):
    """``grad_compress`` hands AdamW the averaged grads rounded to bf16."""
    cfg = get_config("qwen3-1.7b", smoke=True)
    tok = torch.ones((2, 9), dtype=torch.int32)
    seen = []
    apply = O.apply

    def recording(oc, st, grads, dt):
        seen.append([g.clone() for g in tree_leaves(grads)])
        return apply(oc, st, grads, dt)
    monkeypatch.setattr(O, "apply", recording)
    for compress in (False, True):
        state = T.init_state(cfg, 0, device="cpu")
        _, m = T.train_step(cfg, T.TrainConfig(grad_compress=compress),
                            state, tok)
        assert np.isfinite(float(m["loss"]))
    for raw, comp in zip(*seen):
        assert torch.equal(comp, raw.to(torch.bfloat16).float())


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------

def test_watchdog_flags_stragglers():
    wd = FT.Watchdog(straggler_factor=2.0)
    for _ in range(10):
        assert not wd.record(1.0)
    assert wd.record(5.0)
    assert not wd.record(1.1)


def _qwen_setup():
    cfg = get_config("qwen3-1.7b", smoke=True)
    tc = T.TrainConfig(opt=O.OptConfig(lr=1e-3, warmup_steps=2,
                                       total_steps=10))
    dc = data.DataConfig(vocab=cfg.vocab, seq_len=12, global_batch=4, seed=5)
    return cfg, tc, dc


def _run(cfg, tc, dc, state, start, stop, ckpt_dir=None, every=2):
    losses = {}
    for s in range(start, stop):
        state, m = T.train_step(cfg, tc, state,
                                data.device_batch(dc, s, "cpu"))
        losses[s] = float(m["loss"])
        if ckpt_dir and (s + 1) % every == 0:
            ckpt.save(ckpt_dir, s + 1, state.tree(), extra={"step": s + 1})
    return state, losses


def test_kill_and_resume_is_bit_identical(tmp_path):
    """4 steps with checkpoints, a crash, a restore into a fresh state, 2
    more steps: the losses and params of the uninterrupted 6 steps, bit
    for bit."""
    cfg, tc, dc = _qwen_setup()
    d = str(tmp_path / "ck")
    ref_state, ref_losses = _run(cfg, tc, dc,
                                 T.init_state(cfg, 0, device="cpu"), 0, 6)
    _, l1 = _run(cfg, tc, dc, T.init_state(cfg, 0, device="cpu"), 0, 4,
                 ckpt_dir=d)
    fresh = T.init_state(cfg, 0, device="cpu")        # a new process
    tree, extra = ckpt.restore(d, fresh.tree(), device="cpu")
    assert extra["step"] == 4
    st2, l2 = _run(cfg, tc, dc, T.TrainState.from_tree(tree), 4, 6)
    assert [l1[s] for s in range(4)] == [ref_losses[s] for s in range(4)]
    assert [l2[s] for s in (4, 5)] == [ref_losses[s] for s in (4, 5)]
    for a, b in zip(tree_leaves(ref_state.tree()), tree_leaves(st2.tree())):
        assert torch.equal(a, b)


def test_supervisor_resumes_from_its_checkpoint(tmp_path):
    """A supervised run of 3 steps, then a second supervisor over the same
    directory to 5: it restores step 3 and ends where one run of 5 does."""
    cfg, tc, dc = _qwen_setup()

    def world():
        return {"state": T.init_state(cfg, 0, device="cpu"),
                "step": T.make_train_step(cfg, tc),
                "batch": lambda s: data.device_batch(dc, s, "cpu"),
                "device": "cpu"}
    seen = []
    d = str(tmp_path / "ck")
    first = FT.Supervisor(d, world, save_every=2).run(
        3, on_metrics=lambda s, m: seen.append(s))
    assert first["final_step"] == 3 and ckpt.latest_step(d) == 3
    second = FT.Supervisor(d, world, save_every=2).run(
        5, on_metrics=lambda s, m: seen.append(s))
    assert seen == [0, 1, 2, 3, 4] and second["final_step"] == 5
    whole = FT.Supervisor(str(tmp_path / "one"), world).run(5)
    for a, b in zip(tree_leaves(second["state"].tree()),
                    tree_leaves(whole["state"].tree())):
        assert torch.equal(a, b)
    assert FT.fleet_size() == (torch.cuda.device_count() or 1)


def test_train_launcher_resumes(tmp_path, capsys):
    """``launch/train.py --device cpu --smoke --ckpt-dir``: the first run
    checkpoints its last step; a restart prints "resumed from step 6",
    takes no step and returns the same params."""
    from repro_torch.launch import train as TL
    d = str(tmp_path / "run")
    argv = ["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
            "--steps", "6", "--batch", "2", "--seq", "16", "--ckpt-dir", d,
            "--ckpt-every", "2", "--log-every", "1"]
    first = TL.main(argv)
    out = capsys.readouterr().out
    assert ckpt.latest_step(d) == 6
    assert out.count(" loss ") == 6 and "resumed" not in out
    steps = []
    second = TL.main(argv, on_metrics=lambda s, m, t: steps.append(s))
    out = capsys.readouterr().out
    assert "resumed from step 6" in out and " loss " not in out
    assert steps == []
    assert int(second.opt.step) == 6
    for a, b in zip(tree_leaves(first.tree()), tree_leaves(second.tree())):
        assert torch.equal(a, b)
    # and a run cut at 4 resumes to 6 with the uninterrupted run's params
    d2 = str(tmp_path / "cut")
    TL.main(argv[:-6] + ["--ckpt-dir", d2, "--ckpt-every", "2",
                         "--log-every", "1", "--steps", "4"])
    third = TL.main(argv[:-6] + ["--ckpt-dir", d2, "--ckpt-every", "2",
                                 "--log-every", "1"],
                    on_metrics=lambda s, m, t: steps.append(s))
    assert steps == [4, 5]
    for a, b in zip(tree_leaves(first.tree()), tree_leaves(third.tree())):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_train_steps_on_the_card_match_the_cpu(cuda_device):
    """Two steps of Qwen3's smoke config (float32, 2 microbatches) on the
    card and on the CPU from the same state: losses within 1e-5 and grad
    norms within 1e-4 of the CPU's (float32 sums in other orders)."""
    cfg, tc, dc = _qwen_setup()
    tc = dataclasses.replace(tc, microbatches=2)
    rows = {}
    for dev in ("cpu", cuda_device):
        state = T.TrainState.from_tree(tree_map(
            lambda t: t.to(dev), T.init_state(cfg, 0, device="cpu").tree()))
        out = []
        for s in range(2):
            state, m = T.train_step(cfg, tc, state,
                                    data.device_batch(dc, s, dev))
            out.append((float(m["loss"]), float(m["grad_norm"])))
        rows[str(dev)] = out
    for (lc, gc), (lg, gg) in zip(rows["cpu"], rows[str(cuda_device)]):
        np.testing.assert_allclose(lg, lc, rtol=1e-5)
        np.testing.assert_allclose(gg, gc, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_training_with_the_conv_kernel_raises_on_the_card(cuda_device, arch):
    """The conv1d kernel has no backward: with ``use_kernels`` on, a
    Mamba2 or Zamba2 model refuses to train on the card instead of giving
    the conv weights and the xBC columns of ``in_proj`` no gradient."""
    cfg = get_config(arch, smoke=True).scaled(use_kernels=True)
    state = T.init_state(cfg, 0, device=cuda_device)
    tok = torch.ones((2, 9), dtype=torch.int32, device=cuda_device)
    with pytest.raises(RuntimeError, match="no backward"):
        T.loss_and_grads(cfg, T.TrainConfig(), state.params, tok)
