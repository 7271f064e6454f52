"""The port's tuner (``repro_torch.tuner``) against the reference's
``repro.tuner`` on the CPU, on the same numpy inputs.

Keys, fingerprints, buckets and plans must equal the reference's (the
encoded key differs only in its ``dev`` and ``univ`` fields); cost-mode
tuning must pick the same plan; tuned outputs agree within float32
``rtol = atol = 3e-5`` (the packages sum in different orders), and
variable coefficients within ``1e-4`` as in the engine tests.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import tuner as rtuner
from repro.core import stencil as ref_stencil
from repro.tuner import plan as rplan
from repro_torch import tuner
from repro_torch.core import engine
from repro_torch.core.convert import coefficients_from_array, spec_from_arrays
from repro_torch.tuner import plan as tplan
from repro_torch.tuner import search

F32 = dict(rtol=3e-5, atol=3e-5)
CPU = "cpu"


def _specs(shape, ndim, r, seed):
    ref = ref_stencil.make_stencil(shape, ndim, r, seed=seed)
    return ref, spec_from_arrays(ref.shape, ref.ndim, ref.radius, ref.weights)


def _suite():
    return [(ref, spec_from_arrays(ref.shape, ref.ndim, ref.radius,
                                   ref.weights))
            for ref in ref_stencil.paper_suite()]


def _input(spec, dims, seed, extra_halo=0):
    h = spec.radius * (1 + extra_halo)
    return np.random.default_rng(seed).normal(
        size=tuple(s + 2 * h for s in dims)).astype(np.float32)


def _same_plan(port: tuner.Plan, ref: rtuner.Plan) -> bool:
    return port.to_dict() == ref.to_dict()


def _fields(encoded: str) -> dict:
    return dict(f.split("=", 1) for f in encoded.split(";")[1:])


# ---------------------------------------------------------------------------
# plans and keys equal the reference's
# ---------------------------------------------------------------------------

def test_fingerprints_buckets_and_plan_dicts_match_reference():
    for ref, spec in _suite() + [_specs("box", 3, 1, 4), _specs("star", 3, 2, 5)]:
        assert tuner.spec_fingerprint(spec) == rtuner.spec_fingerprint(ref)
    for shape in [(37, 41), (64,), (65, 1), (1,), (1025, 2048), (4194304,)]:
        assert tuner.shape_bucket(shape) == rtuner.shape_bucket(shape)
    c = np.random.default_rng(0).normal(size=(5, 6, 3, 3))
    assert tplan.coefficients_fingerprint(c) == \
        rplan.coefficients_fingerprint(c)
    for kw in [dict(backend="sptc", L=8, fuse_rows=True, star_fast_path=False),
               dict(backend="gemm", L=4, temporal_steps=3),
               dict(backend="direct", L=4)]:
        p, rp = tuner.Plan(**kw), rtuner.Plan(**kw)
        assert p.to_dict() == rp.to_dict() and p.describe() == rp.describe()
        assert tuner.Plan.from_dict(rp.to_dict()) == p
    assert tplan.PLAN_SCHEMA == rplan.PLAN_SCHEMA == 4


@pytest.mark.parametrize("mesh", [None, 1, (1,), (1, 1), "1", "1x1", 8, (4, 2),
                                  "4x2", (4, 1)])
def test_mesh_desc_matches_reference(mesh):
    assert tplan.mesh_desc(mesh) == rplan.mesh_desc(mesh)


def test_mesh_desc_rejects_what_the_reference_rejects():
    for bad, exc in [((4, 0), ValueError), ("4xpotato", ValueError),
                     (3.5, TypeError)]:
        with pytest.raises(exc):
            rplan.mesh_desc(bad)
        with pytest.raises(exc):
            tplan.mesh_desc(bad)


@pytest.mark.parametrize("kw", [{}, dict(temporal_steps=2),
                                dict(coefficients=np.ones((18, 18, 3, 3)))])
def test_plan_key_encode_differs_only_in_dev_and_univ(kw):
    ref, spec = _specs("box", 2, 1, seed=1)
    rk = rtuner.plan_key(ref, (20, 20), jnp.float32, **kw)
    pk = tuner.plan_key(spec, (20, 20), torch.float32, CPU, **kw)
    got, want = _fields(pk.encode()), _fields(rk.encode())
    assert pk.encode().split(";")[0] == rk.encode().split(";")[0] == "v4"
    assert got.pop("dev") == "cpu" and got.pop("univ") == "torch"
    assert want.pop("dev") == "cpu" and want.pop("univ") == "jnp"
    assert got == want
    assert tuner.PlanKey.decode(pk.encode()) == pk
    assert pk.dtype == "float32"
    assert tuner.plan_key(spec, (20, 20), torch.bfloat16, CPU).dtype == \
        rtuner.plan_key(ref, (20, 20), jnp.bfloat16).dtype == "bfloat16"


def test_plan_key_decode_matches_reference_on_old_and_odd_keys():
    for s in ["spec=abc;shape=64x32;dtype=float32;dev=cpu",
              "v2;spec=abc;shape=64x32;dtype=float32;dev=cpu;coeff=const;steps=1",
              "v3;spec=abc;shape=64x32;dtype=float32;dev=cpu;coeff=const;"
              "steps=1;univ=jnp",
              "v4;spec=abc;shape=64x32;dtype=float32;dev=cuda;coeff=var-x;"
              "steps=2;univ=torch+cuda;mesh=4x2;future=knob"]:
        p, r = tuner.PlanKey.decode(s), rplan.PlanKey.decode(s)
        assert p.encode() == r.encode()
    for bad in ["garbage", f"v{tplan.PLAN_SCHEMA + 1};spec=a;shape=1;"
                           f"dtype=float32;dev=cpu"]:
        with pytest.raises(ValueError):
            tuner.PlanKey.decode(bad)


def test_plan_key_takes_the_device_and_refuses_a_mesh(monkeypatch):
    _, spec = _specs("star", 2, 1, seed=0)
    with pytest.raises(NotImplementedError, match="item 8"):
        tuner.plan_key(spec, (20, 20), torch.float32, CPU, mesh=(4, 2))
    assert tuner.plan_key(spec, (20, 20), torch.float32, CPU,
                          mesh=(1, 1)).mesh == "1"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tuner.plan_key(spec, (20, 20), torch.float32)     # None: the card


# ---------------------------------------------------------------------------
# candidates and cost-mode tuning equal the reference's
# ---------------------------------------------------------------------------

def _cost_pair(ref, spec, shape, **kw):
    rres = rtuner.autotune(ref, shape, jnp.float32, mode="cost", **kw)
    pres = tuner.autotune(spec, shape, torch.float32, device=CPU,
                          mode="cost", **kw)
    return pres, rres


@pytest.mark.parametrize("k", [1, 2])
def test_cost_mode_picks_the_reference_plan_over_paper_suite(k):
    for ref, spec in _suite():
        dims = (131,) if spec.ndim == 1 else (24, 27)
        shape = tuple(s + 2 * k * spec.radius for s in dims)
        pres, rres = _cost_pair(ref, spec, shape, temporal_steps=k)
        assert _same_plan(pres.plan, rres.plan), spec.name
        assert [c.plan.to_dict() for c in pres.candidates] == \
            [c.plan.to_dict() for c in rres.candidates]
        assert [c.score for c in pres.candidates] == \
            [c.score for c in rres.candidates]


def test_cost_mode_picks_the_reference_plan_for_variable_coefficients():
    ref, spec = _specs("box", 2, 1, seed=13)
    c = np.random.default_rng(1).normal(size=(10, 12, 3, 3))
    pres, rres = _cost_pair(ref, spec, (12, 14), coefficients=c)
    assert _same_plan(pres.plan, rres.plan)
    assert {p.plan.backend for p in pres.candidates} <= {"direct", "gemm",
                                                         "sptc"}


def test_static_cost_charges_kernels_as_the_reference_charges_pallas():
    for ref, spec in _suite():
        for b, rb in [("cuda_direct", "pallas_direct"),
                      ("cuda_gemm", "pallas_mxu"),
                      ("cuda_sptc", "pallas_sptc")]:
            for L in search.l_candidates(spec.radius):
                assert search.static_cost(spec, tuner.Plan(b, L)) == \
                    rtuner.static_cost(ref, rtuner.Plan(rb, L))
    with pytest.raises(ValueError, match="unknown backend"):
        search.static_cost(spec, tuner.Plan("pallas_sptc", 4))


def test_candidates_on_the_cpu_are_the_plain_backends():
    for ref, spec in _suite():
        got = tuner.candidate_plans(spec, CPU)
        assert [p.to_dict() for p in got] == \
            [p.to_dict() for p in rtuner.candidate_plans(ref)]
        assert {p.backend for p in got} <= {"direct", "gemm", "sptc"}


def test_card_universe_tunes_among_the_kernels_only(monkeypatch):
    """Where the kernels run, the candidates are the three ``cuda_*``
    backends (no ``cuda_direct`` beyond its radius 3); variable coefficients
    keep the plain backends; a failing kernel candidate fails the tune."""
    from repro_torch.kernels import dispatch
    monkeypatch.setattr(dispatch, "backend_universe",
                        lambda device: "torch+cuda")
    _, spec = _specs("box", 2, 2, seed=1)
    got = tuner.candidate_plans(spec, CPU)
    assert [p.describe() for p in got] == [
        "cuda_direct/L6", "cuda_gemm/L6", "cuda_gemm/L8", "cuda_gemm/L16",
        "cuda_sptc/L6", "cuda_sptc/L8", "cuda_sptc/L16"]
    assert {p.backend for p in tuner.candidate_plans(
        spec, CPU, variable_coefficients=True)} == {"direct", "gemm", "sptc"}
    _, wide = _specs("box", 2, 4, seed=1)
    assert "cuda_direct" not in {p.backend for p in
                                 tuner.candidate_plans(wide, CPU)}
    assert tuner.plan_key(spec, (20, 20), torch.float32, CPU).univ == \
        "torch+cuda"

    def factory(s, p, coefficients=None, *, device, dtype):
        if p.backend == "cuda_gemm":
            raise RuntimeError("launch failed")
        return engine.StencilEngine(s, p.backend, L=p.L, device=device,
                                    dtype=dtype)
    with pytest.raises(RuntimeError, match="cuda_gemm/L6") as ei:
        tuner.autotune(spec, (30, 30), device=CPU, mode="time",
                       engine_factory=factory, iters=1)
    assert "launch failed" in str(ei.value.__cause__)


def test_autotune_rejects_bad_mode():
    _, spec = _specs("box", 1, 1, seed=0)
    with pytest.raises(ValueError):
        tuner.autotune(spec, (32,), device=CPU, mode="fastest")


# ---------------------------------------------------------------------------
# tuned outputs agree with the reference's
# ---------------------------------------------------------------------------

def test_tuned_apply_matches_reference_over_paper_suite():
    cache, rcache = tuner.PlanCache(), rtuner.PlanCache()
    for i, (ref, spec) in enumerate(_suite()):
        dims = (131,) if spec.ndim == 1 else (24, 27)
        x = _input(spec, dims, seed=i)
        got = tuner.tuned_apply(spec, torch.as_tensor(x), cache=cache,
                                mode="cost")
        want = rtuner.tuned_apply(ref, jnp.asarray(x), cache=rcache,
                                  mode="cost")
        assert got.shape == dims and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32,
                                   err_msg=spec.name)
    assert cache.stats.tunes == rcache.stats.tunes == 8


def test_tuned_apply_temporal_and_variable_coefficients_match_reference():
    ref, spec = _specs("star", 2, 1, seed=12)
    x = _input(spec, (20, 22), seed=3, extra_halo=1)
    cache, rcache = tuner.PlanCache(), rtuner.PlanCache()
    got = tuner.tuned_apply(spec, torch.as_tensor(x), cache=cache,
                            mode="cost", temporal_steps=2)
    want = rtuner.tuned_apply(ref, jnp.asarray(x), cache=rcache, mode="cost",
                              temporal_steps=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    ref, spec = _specs("box", 2, 1, seed=13)
    c = np.random.default_rng(2).normal(size=(10, 12, 3, 3))
    x = _input(spec, (10, 12), seed=4)
    got = tuner.tuned_apply(spec, torch.as_tensor(x), cache=cache,
                            mode="cost", coefficients=coefficients_from_array(c))
    want = rtuner.tuned_apply(ref, jnp.asarray(x), cache=rcache, mode="cost",
                              coefficients=c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    assert cache.stats.tunes == rcache.stats.tunes == 2


@pytest.mark.parametrize("form", ["stacked", "list", "generator"])
@pytest.mark.parametrize("shape,ndim,r", [("box", 1, 1), ("star", 2, 1),
                                          ("box", 2, 2), ("box", 3, 1)])
def test_tuned_apply_batched_matches_reference(form, shape, ndim, r):
    ref, spec = _specs(shape, ndim, r, seed=7)
    dims = {1: (61,), 2: (19, 23), 3: (7, 8, 9)}[ndim]
    xs = np.stack([_input(spec, dims, seed=10 + i) for i in range(3)])
    want = rtuner.tuned_apply_batched(ref, jnp.asarray(xs),
                                      cache=rtuner.PlanCache(), mode="cost")
    jobs = torch.as_tensor(xs)
    arg = {"stacked": jobs, "list": list(jobs),
           "generator": (x for x in jobs)}[form]
    got = tuner.tuned_apply_batched(spec, arg, cache=tuner.PlanCache(),
                                    mode="cost")
    assert tuple(got.shape) == (3,) + dims
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_batched_validation_names_the_fault():
    _, spec = _specs("star", 2, 1, seed=7)
    cache = tuner.PlanCache()
    with pytest.raises(ValueError) as ei:
        tuner.tuned_apply_batched(spec, [torch.zeros(34, 34),
                                         torch.zeros(34, 34),
                                         torch.zeros(36, 34)],
                                  cache=cache, mode="cost")
    assert "(34, 34)" in str(ei.value) and "job 2" in str(ei.value)
    with pytest.raises(ValueError, match="dtype"):
        tuner.tuned_apply_batched(spec, [torch.zeros(34, 34),
                                         torch.zeros(34, 34,
                                                     dtype=torch.bfloat16)],
                                  cache=cache, mode="cost")
    with pytest.raises(ValueError, match="empty"):
        tuner.tuned_apply_batched(spec, iter([]), cache=cache, mode="cost")
    with pytest.raises(ValueError, match="B, \\*spatial"):
        tuner.tuned_apply_batched(spec, torch.zeros(34, 34), cache=cache,
                                  mode="cost")
    with pytest.raises(ValueError, match="halo"):
        tuner.tuned_apply_batched(spec, torch.zeros(4, 2, 34), cache=cache,
                                  mode="cost")
    with pytest.raises(TypeError, match="iterable of per-job tensors"):
        tuner.tuned_apply_batched(spec, object(), cache=cache, mode="cost")
    with pytest.raises(TypeError, match="torch tensors"):
        tuner.tuned_apply_batched(spec, [np.zeros((34, 34))], cache=cache,
                                  mode="cost")


@pytest.mark.parametrize("backend", ["cuda_sptc", "cuda_gemm", "sptc",
                                     "gemm"])
@pytest.mark.parametrize("shape,ndim,r", [("box", 1, 2), ("star", 2, 2),
                                          ("box", 2, 1)])
def test_batch_runs_one_application_per_row_op(monkeypatch, backend, shape,
                                               ndim, r):
    """A (B, *spatial) batch costs as many 1-D applications as one job:
    the batch folds into the columns of each row op."""
    calls = []
    for name in ("_op_cuda_sptc", "_op_cuda_gemm", "_op_sptc", "_op_gemm"):
        fn = getattr(engine, name)
        monkeypatch.setattr(engine, name,
                            lambda *a, _fn=fn, **k: calls.append(1) or
                            _fn(*a, **k))
    _, spec = _specs(shape, ndim, r, seed=3)
    eng = engine.StencilEngine(spec, backend, device=CPU)
    dims = (70,) if ndim == 1 else (17, 21)
    xs = torch.as_tensor(np.stack([_input(spec, dims, seed=i)
                                   for i in range(4)]))
    got = eng.apply_batched(xs)
    assert len(calls) == len(eng.plan_ir.decompose.ops)
    want = torch.stack([engine.StencilEngine(spec, "direct", device=CPU)(x)
                        for x in xs])
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)


# ---------------------------------------------------------------------------
# cache: hits, engines keyed by device and dtype, timing mode
# ---------------------------------------------------------------------------

def test_repeat_tuned_apply_hits_cache_and_builds_once():
    _, spec = _specs("box", 2, 2, seed=3)
    x = torch.as_tensor(_input(spec, (30, 34), seed=0))
    cache = tuner.PlanCache()
    y1 = tuner.tuned_apply(spec, x, cache=cache, mode="cost")
    assert cache.stats.plan_misses == 1 and cache.stats.tunes == 1
    assert cache.stats.engine_builds == 1
    y2 = tuner.tuned_apply(spec, x, cache=cache, mode="cost")
    assert cache.stats.engine_builds == 1 and cache.stats.plan_hits >= 1
    assert torch.equal(y1, y2)
    xs = torch.stack([x, x])
    tuner.tuned_apply_batched(spec, xs, cache=cache, mode="cost")
    tuner.tuned_apply_batched(spec, xs, cache=cache, mode="cost")
    assert cache.stats.engine_builds == 1 and cache.stats.tunes == 1


def test_apply_stencil_builds_one_engine_per_device_and_dtype():
    from repro_torch.tuner.cache import default_cache
    _, spec = _specs("star", 2, 2, seed=8)
    x = torch.as_tensor(_input(spec, (26, 28), seed=1))
    engine.apply_stencil(spec, x, backend="gemm")
    builds = default_cache().stats.engine_builds
    y = engine.apply_stencil(spec, x, backend="gemm")
    assert default_cache().stats.engine_builds == builds
    yb = engine.apply_stencil(spec, x.bfloat16(), backend="gemm")
    assert default_cache().stats.engine_builds == builds + 1
    assert yb.dtype == torch.bfloat16
    np.testing.assert_allclose(yb.float().numpy(), y.numpy(), rtol=5e-2,
                               atol=5e-2)


def test_timing_mode_tunes_on_the_cpu_and_prunes_losers(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_TUNER_MODE", raising=False)
    _, spec = _specs("box", 1, 1, seed=11)
    x = torch.as_tensor(_input(spec, (96,), seed=2))
    res = tuner.autotune(spec, x.shape, x.dtype, device=CPU, mode="time",
                         warmup=1, iters=2)
    assert res.mode == "time" and res.plan in tuner.candidate_plans(spec, CPU)
    assert all(c.error is None and c.score > 0 for c in res.candidates)
    assert res.best_score == min(c.score for c in res.candidates)
    cache = tuner.PlanCache()
    plan = tuner.plan_for(spec, x.shape, x.dtype, device=CPU, cache=cache,
                          iters=2)                    # default mode: time
    assert cache.engine_plans(spec) == frozenset({plan})


def test_plain_candidate_failure_is_recorded_and_skipped():
    _, spec = _specs("box", 1, 1, seed=1)

    def factory(s, p, coefficients=None, *, device, dtype):
        if p.backend == "direct":
            raise RuntimeError("boom")
        return engine.StencilEngine(s, p.backend, L=p.L, device=device,
                                    dtype=dtype)
    res = tuner.autotune(spec, (40,), device=CPU, mode="time",
                         engine_factory=factory, iters=1)
    bad = [c for c in res.candidates if c.error is not None]
    assert [c.plan.backend for c in bad] == ["direct"]
    assert "boom" in bad[0].error and res.plan.backend != "direct"


def test_mode_env_var_sets_the_default(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNER_MODE", "cost")
    _, spec = _specs("box", 2, 1, seed=5)
    cache = tuner.PlanCache()
    plan = tuner.plan_for(spec, (22, 26), device=CPU, cache=cache)
    assert cache.stats.engine_builds == 0          # cost mode builds nothing
    ref, _ = _specs("box", 2, 1, seed=5)
    assert _same_plan(plan, rtuner.autotune(ref, (22, 26), mode="cost").plan)


# ---------------------------------------------------------------------------
# persistence
# ---------------------------------------------------------------------------

def _key(spec, shape=(40,)):
    return tuner.plan_key(spec, shape, torch.float32, CPU)


def test_plan_persistence_roundtrip(tmp_path):
    path = tmp_path / "plans.json"
    _, spec = _specs("box", 2, 1, seed=5)
    cache_a = tuner.PlanCache(path=path)
    plan = tuner.plan_for(spec, (24, 28), device=CPU, cache=cache_a,
                          mode="cost")
    assert path.exists() and cache_a.stats.saves >= 1
    cache_b = tuner.PlanCache(path=path)
    assert cache_b.stats.loads == 1 and len(cache_b) == 1
    assert tuner.plan_for(spec, (24, 28), device=CPU, cache=cache_b) == plan
    assert cache_b.stats.tunes == 0 and cache_b.stats.plan_hit_rate == 1.0


@pytest.mark.parametrize("text,match", [("{not json", "unreadable"),
                                        ("[1, 2]", "unreadable"),
                                        (json.dumps({"version": 99,
                                                     "plans": {}}),
                                         "version")])
def test_corrupt_or_future_file_is_ignored_whole(tmp_path, text, match):
    path = tmp_path / "plans.json"
    path.write_text(text)
    with pytest.warns(RuntimeWarning, match=match):
        cache = tuner.PlanCache(path=path)
    assert len(cache) == 0 and cache.stats.loads == 0


def test_cache_skips_corrupt_and_future_entries_with_warning(tmp_path):
    _, spec = _specs("box", 1, 1, seed=2)
    good = _key(spec).encode()
    payload = {"version": 2, "plans": {
        good: tuner.Plan("gemm", 4).to_dict(),
        "garbage-key": tuner.Plan("gemm", 4).to_dict(),
        f"v{tplan.PLAN_SCHEMA + 1};{good}": tuner.Plan("gemm", 4).to_dict(),
        good.replace("steps=1", "steps=2"):
            {"schema": tplan.PLAN_SCHEMA + 1, "backend": "gemm", "L": 4},
    }}
    path = tmp_path / "plans.json"
    path.write_text(json.dumps(payload))
    with pytest.warns(RuntimeWarning, match="skipping entry"):
        cache = tuner.PlanCache(path=path)
    assert len(cache) == 1 and cache.stats.skipped_entries == 3
    assert cache.lookup(_key(spec)) == tuner.Plan("gemm", 4)


def test_save_merges_concurrent_writers_and_memory_wins(tmp_path):
    path = tmp_path / "plans.json"
    _, spec_a = _specs("box", 1, 1, seed=3)
    _, spec_b = _specs("box", 1, 2, seed=4)
    cache_a = tuner.PlanCache(path=path)
    cache_b = tuner.PlanCache(path=path)
    cache_a.store(_key(spec_a), tuner.Plan("gemm", 4))
    cache_b.store(_key(spec_b), tuner.Plan("sptc", 6))   # merges, then writes
    assert len(cache_b) == 2 and cache_b.stats.merges == 1
    fresh = tuner.PlanCache(path=path)
    assert fresh.lookup(_key(spec_a)) == tuner.Plan("gemm", 4)
    assert fresh.lookup(_key(spec_b)) == tuner.Plan("sptc", 6)
    cache_a.store(_key(spec_b), tuner.Plan("direct", 6))  # conflict: a wins
    assert tuner.PlanCache(path=path).lookup(_key(spec_b)) == \
        tuner.Plan("direct", 6)


def test_reference_cache_file_never_hits_in_the_port(tmp_path, monkeypatch):
    """A file written by repro.tuner decodes, but no port key matches it:
    the universes differ, and the default caches read different env vars."""
    ref, spec = _specs("box", 2, 1, seed=6)
    path = tmp_path / "plans.json"
    rcache = rtuner.PlanCache(path=path)
    rtuner.plan_for(ref, (20, 20), jnp.float32, cache=rcache, mode="cost")
    cache = tuner.PlanCache(path=path)
    assert len(cache) == 1 and cache.stats.loads == 1
    assert cache.lookup(tuner.plan_key(spec, (20, 20), torch.float32,
                                       CPU)) is None
    tuner.plan_for(spec, (20, 20), device=CPU, cache=cache, mode="cost")
    assert cache.stats.tunes == 1
    from repro.tuner.cache import CACHE_ENV_VAR as REF_ENV
    from repro_torch.tuner.cache import CACHE_ENV_VAR, reset_default_cache
    assert CACHE_ENV_VAR == "REPRO_TORCH_TUNER_CACHE" != REF_ENV
    monkeypatch.setenv(REF_ENV, str(path))
    monkeypatch.delenv(CACHE_ENV_VAR, raising=False)
    reset_default_cache()
    try:
        assert tuner.default_cache().path is None
    finally:
        reset_default_cache()


def test_clear_cache_and_stats():
    _, spec = _specs("box", 1, 1, seed=2)
    cache = tuner.PlanCache()
    tuner.tuned_apply(spec, torch.as_tensor(_input(spec, (40,), seed=0)),
                      cache=cache, mode="cost")
    stats = tuner.cache_stats(cache)
    assert stats["tunes"] == 1 and stats["engine_builds"] == 1
    tuner.clear_cache(cache)
    assert len(cache) == 0 and cache.engine_plans(spec) == frozenset()
