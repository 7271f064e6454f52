"""The port's training loss and gradients against the JAX reference, for all
ten architectures (``tests/test_arch_smoke.py::test_train_loss_step``,
held to the reference leaf by leaf), and remat.

Each arch runs its ``smoke()`` config in float32 with ``attn_block_kv = 8``
(the blocked attention crosses KV blocks and pads the last) and weights
from the reference's ``init_params(PRNGKey(0))``, carried across with
``params_from_numpy`` (``tests/_torch_memory_models.pair``; the VLM's tanh
gates set non-zero, else its cross path would carry no gradient).  Tokens
(4 x 21: 20 predicted positions, so the Mamba2 models' 16-step SSD chunks
end in a padded tail, where ``jnp.clip`` and ``torch.clamp`` meet exact
ties) and memories come from NumPy seeds.  The reference's grads are
``jax.value_and_grad`` of its ``lm_loss``; the port's come from its
``loss_and_grads`` and go back to stacked arrays with ``tree_to_numpy``.

Tolerances (float32; both packages sum in different orders):

* loss, ``nll`` and ``aux``: ``rtol = 1e-5`` (they land within 2e-7);
* each grad leaf: ``|port - ref| <= 1e-4 * max|ref leaf| + 1e-7`` — a
  leaf's scale, since an element whose gradient cancels to ~0 has no
  relative precision in either package (they land within 5e-6 of each
  leaf's largest element).

The two clip ties (``jnp.clip`` passes half the gradient at a bound,
``torch.clamp`` all of it) sit on the SSD's diagonal ``li - lj = 0``, where
the two contributions to each ``cum`` element cancel, and on masked or
padded positions whose upstream gradient is 0: the Mamba2 and Zamba2
cases show the port's grads within the same tolerance.
"""
import importlib

import numpy as np
import pytest
import torch

import _torch_memory_models as MM
from repro_torch.configs import ARCHS
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.convert import tree_to_numpy
from repro_torch.models.nn import tree_leaves

T = importlib.import_module("repro_torch.training.train_step")

LOSS = dict(rtol=1e-5, atol=0)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
B, S = 4, 21
#: Granite's smoke config is drop-free (capacity_factor 8.0); at 0.5 its
#: experts drop (token, choice) pairs, whose gradient must be zero
DROPS = {"capacity_factor": 0.5}


@pytest.fixture(scope="module")
def pairs():
    """``pairs(arch, **fields)``: the float32 smoke pair, built once."""
    built: dict = {}

    def get(arch, **fields):
        key = (arch, tuple(sorted(fields.items())))
        if key not in built:
            built[key] = MM.pair(arch, **fields)
        return built[key]
    return get


def _inputs(cfg, seed=0):
    toks = MM.tokens(cfg, B, S, seed=seed)
    mem = MM.memory(cfg, B, seed) if cfg.family in ("encdec", "vlm") \
        else None
    return toks, mem


def _ref_loss_and_grads(rcfg, rparams, toks, mem):
    import jax
    import jax.numpy as jnp
    from repro.models import model as RM

    def lf(p):
        return RM.lm_loss(p, rcfg, jnp.asarray(toks),
                          memory=None if mem is None else jnp.asarray(mem))
    (loss, metrics), grads = jax.jit(jax.value_and_grad(lf, has_aux=True))(
        rparams)
    return loss, metrics, grads


def _port_loss_and_grads(cfg, params, toks, mem, **tc):
    return T.loss_and_grads(cfg, T.TrainConfig(**tc), params,
                            torch.as_tensor(toks),
                            None if mem is None else torch.as_tensor(mem))


def _assert_grads_match(got, want):
    """Every leaf of the port's grads (stacked) against the reference's."""
    import jax
    from jax.tree_util import keystr, tree_flatten_with_path
    want_l, _ = tree_flatten_with_path(jax.tree.map(np.asarray, want))
    got_l = jax.tree.leaves(got)
    assert len(got_l) == len(want_l)
    for (path, w), g in zip(want_l, got_l):
        assert g.shape == w.shape, keystr(path)
        bound = GRAD_RTOL * np.abs(w).max() + GRAD_ATOL
        err = np.abs(g - w).max()
        assert err <= bound, f"{keystr(path)}: |err| {err} > {bound}"


@pytest.mark.parametrize("arch,fields", [(a, {}) for a in ARCHS]
                         + [("granite-moe-3b-a800m", DROPS)],
                         ids=list(ARCHS) + ["granite-with-drops"])
def test_loss_and_grads_match_reference(arch, fields, pairs):
    rcfg, rparams, cfg, params = pairs(arch, **fields)
    toks, mem = _inputs(cfg)
    rloss, rmetrics, rgrads = _ref_loss_and_grads(rcfg, rparams, toks, mem)
    loss, metrics, grads = _port_loss_and_grads(cfg, params, toks, mem)
    assert set(metrics) == {"nll", "aux"}
    np.testing.assert_allclose(float(loss), float(rloss), **LOSS)
    for k in ("nll", "aux"):
        np.testing.assert_allclose(float(metrics[k]), float(rmetrics[k]),
                                   **LOSS)
    assert all(g.dtype == torch.float32 for g in tree_leaves(grads))
    _assert_grads_match(tree_to_numpy(grads, cfg), rgrads)
    if cfg.family == "vlm":            # the gates carry gradient
        assert all(float(c["attn"]["gate"].abs()) > 0
                   for c in grads["cross"])
    if cfg.family == "moe":            # the router learns through the aux
        assert all(float(lp["moe"]["router"].abs().max()) > 0
                   for lp in grads["layers"])


def test_dropped_choices_carry_no_gradient(monkeypatch, pairs):
    """With Granite's capacity drops, a dropped (token, choice) pair is
    copied into the dispatch buffer's spare row, which is sliced off, and
    combined with weight 0: a token whose every choice is dropped has a
    zero output and a zero input gradient, a kept token a non-zero one."""
    _, _, cfg, params = pairs("granite-moe-3b-a800m", **DROPS)
    keeps = []
    route = L.moe_route

    def recording(*a, **k):
        r = route(*a, **k)
        keeps.append(r.keep)
        return r
    monkeypatch.setattr(L, "moe_route", recording)
    x = torch.randn(B, S, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0), requires_grad=True)
    y, _ = L.apply_moe(params["layers"][0]["moe"], x, cfg)
    keep = keeps[0].reshape(-1, cfg.top_k)[:B * S]
    dropped, kept = ~keep.any(-1), keep.all(-1)
    assert bool(dropped.any()) and bool(kept.any())
    gx, = torch.autograd.grad(y.sum(), x)
    rows, gx = y.detach().reshape(-1, cfg.d_model), gx.reshape(-1, cfg.d_model)
    assert float(rows[dropped].abs().max()) == 0.0
    assert float(gx[dropped].abs().max()) == 0.0
    assert bool((gx[kept].abs().amax(-1) > 0).all())


#: each case's layer body, which remat checkpoints
BODIES = {"qwen3-1.7b": "_dense_block", "zamba2-2.7b": "_mamba_block",
          "whisper-large-v3": "_dec_block",
          "llama-3.2-vision-11b": "_cross_block"}


@pytest.mark.parametrize("arch", list(BODIES))
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gives_the_same_grads(arch, policy, monkeypatch, pairs):
    """Remat recomputes the same values: the grads with policy ``full`` or
    ``dots`` equal those without remat bit for bit, and the layer bodies
    run again in the backward pass only under remat."""
    _, _, cfg, params = pairs(arch)
    toks, mem = _inputs(cfg, seed=1)
    calls = []
    block = getattr(M, BODIES[arch])

    def counting(*a, **k):
        calls.append(torch.is_grad_enabled())
        return block(*a, **k)
    monkeypatch.setattr(M, BODIES[arch], counting)
    base = cfg.scaled(remat=False)
    _, _, want = _port_loss_and_grads(base, params, toks, mem)
    n_plain = len(calls)
    calls.clear()
    cfg_r = cfg.scaled(remat=True, remat_policy=policy)
    _, _, got = _port_loss_and_grads(cfg_r, params, toks, mem)
    assert n_plain > 0 and len(calls) == 2 * n_plain
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    # policy "none" is no remat, and serving (no parameter requiring
    # grad) is never rematerialised
    calls.clear()
    _port_loss_and_grads(cfg.scaled(remat=True, remat_policy="none"),
                         params, toks, mem)
    assert len(calls) == n_plain
    calls.clear()
    M.forward(params, cfg_r, torch.as_tensor(toks[:, :-1]),
              memory=None if mem is None else torch.as_tensor(mem))
    assert len(calls) == n_plain


def test_dots_policy_saves_products(pairs):
    """``dots`` keeps the matmul outputs: its backward recomputes fewer
    products than ``full``'s."""
    from torch.utils._python_dispatch import TorchDispatchMode
    _, _, cfg, params = pairs("qwen3-1.7b")
    toks, _ = _inputs(cfg)

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in M._DOTS:
                self.n += 1
            return func(*args, **(kwargs or {}))
    counts = {}
    for policy in ("none", "dots", "full"):
        with Count() as c:
            _port_loss_and_grads(cfg.scaled(remat=True,
                                            remat_policy=policy),
                                 params, toks, None)
        counts[policy] = c.n
    assert counts["none"] == counts["dots"] < counts["full"]
