"""The port's halo-exchange engine (``repro_torch.distributed``) against the
reference's ``repro.distributed.halo``, on the CPU.

Every shard lies on the CPU (``grid_mesh(parts, devices=["cpu"] * n)``,
one process, ``LocalTransport``).  The same numpy inputs go through:

* the reference's single-device ``StencilEngine`` (``direct``), in this
  process: ``__call__`` and ``iterate`` (center-cropped) agree within
  ``rtol = atol = 1e-5`` on box/star × r ∈ {1, 2} × k ∈ {1, 2} × meshes
  ``(8,)``/``(4, 2)`` at the reference's non-divisible shapes;
* the reference's ``ShardedStencilEngine`` itself, run once in a
  subprocess with 8 forced host devices (this process sees one JAX
  device): the same sweep, the matrix backends, a 1-D grid, the tuner and
  ``StencilDriver`` with a mesh, and ``analyze_sharded``'s probe counts.

Plus the tuner's and driver's mesh threading, and the verifier's sharded
analyzer with its planted controls.  The ``gloo`` transport is in
``test_torch_distributed_pg.py``.
"""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core import stencil as ref_stencil
from repro.core.engine import StencilEngine as RefEngine
from repro.tuner import plan as rplan
from repro_torch.core.convert import spec_from_arrays
from repro_torch.core.engine import StencilEngine
from repro_torch.distributed import (LocalTransport, ShardedStencilEngine,
                                     default_transport, grid_mesh)
from repro_torch.serving import StencilDriver
from repro_torch.tuner import (PlanCache, batch_group_key, plan_key,
                               tuned_apply, tuned_apply_batched)
from repro_torch.vet import lowering
from repro_torch.vet.config import VetConfig

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)
TOL_MATRIX = dict(rtol=1e-4, atol=1e-4)     # test_distributed.py's, GEMM sums
#: seconds the reference's 8-device subprocess may take (about 25 here)
REF_TIMEOUT = 300

SWEEP = [(kind, r, k, parts) for kind in ("box", "star") for r in (1, 2)
         for k in (1, 2) for parts in ((8,), (4, 2))]


def _tag(kind, r, k, parts):
    return f"{kind}{r}_k{k}_{'x'.join(map(str, parts))}"


def _interior_sizes(parts, h):
    """The reference's non-divisible interior extents (block > 2h)."""
    n0 = parts[0] * (2 * h + 1) + 3
    n1 = (parts[1] if len(parts) > 1 else 1) * (2 * h + 1) + 5
    return max(n0, 21), max(n1, 17)


def _pair(kind, ndim, r, seed=3):
    ref = ref_stencil.make_stencil(kind, ndim, r, seed=seed)
    return ref, spec_from_arrays(ref.shape, ref.ndim, ref.radius, ref.weights)


def _mesh(parts):
    return grid_mesh(parts, devices=[CPU] * int(np.prod(parts)))


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _inputs() -> dict:
    """Every input of the file, made with numpy from fixed seeds."""
    out = {}
    for kind, r, k, parts in SWEEP:
        h = k * r
        n0, n1 = _interior_sizes(parts, h)
        rng = np.random.default_rng(1000 * r + 10 * k + len(parts)
                                    + (0 if kind == "box" else 7))
        tag = _tag(kind, r, k, parts)
        out[tag + "_x"] = rng.normal(size=(n0 + 2 * h, n1 + 2 * h)
                                     ).astype(np.float32)
        out[tag + "_u"] = rng.normal(size=(n0, n1)).astype(np.float32)
    rng = np.random.default_rng(11)
    out["matrix_x"] = rng.normal(size=(44, 52)).astype(np.float32)
    out["oned_x"] = rng.normal(size=(103,)).astype(np.float32)
    out["tuned_x"] = rng.normal(size=(42, 34)).astype(np.float32)
    out["jobs"] = rng.normal(size=(4, 42, 34)).astype(np.float32)
    return out


_REFERENCE = textwrap.dedent("""
    import sys
    import jax, jax.numpy as jnp, numpy as np
    assert jax.device_count() == 8, jax.device_count()
    from repro.core.stencil import make_stencil
    from repro.distributed.halo import ShardedStencilEngine, grid_mesh
    from repro.serving.stencil_driver import StencilDriver
    from repro.tuner.api import tuned_apply
    from repro.tuner.cache import PlanCache
    from repro.vet.config import VetConfig
    from repro.vet.lowering import analyze_sharded
    inp = dict(np.load(sys.argv[1]))
    sweep = eval(sys.argv[3])
    out = {}
    for kind, r, k, parts in sweep:
        tag = f"{kind}{r}_k{k}_{'x'.join(map(str, parts))}"
        eng = ShardedStencilEngine(make_stencil(kind, 2, r, seed=3),
                                   grid_mesh(parts), temporal_steps=k)
        out[tag + "_call"] = np.asarray(eng(jnp.asarray(inp[tag + "_x"])))
        out[tag + "_iter"] = np.asarray(eng.iterate(
            jnp.asarray(inp[tag + "_u"]), 2 * k))
    box22 = make_stencil("box", 2, 2, seed=3)
    for b in ("gemm", "sptc"):
        for fuse in (False, True):
            eng = ShardedStencilEngine(box22, grid_mesh((4, 2)), backend=b,
                                       fuse_rows=fuse)
            out[f"matrix_{b}_{fuse}"] = np.asarray(
                eng(jnp.asarray(inp["matrix_x"])))
    eng = ShardedStencilEngine(make_stencil("star", 1, 2, seed=3),
                               grid_mesh(8))
    out["oned"] = np.asarray(eng(jnp.asarray(inp["oned_x"])))
    cache = PlanCache()
    box21 = make_stencil("box", 2, 1, seed=4)
    out["tuned"] = np.asarray(tuned_apply(
        box21, jnp.asarray(inp["tuned_x"]), cache=cache, mode="cost",
        mesh=(4, 2)))
    (key, plan), = cache._plans.items()
    out["tuned_key"] = np.asarray(key)
    out["tuned_plan"] = np.asarray(repr(plan.to_dict()))
    star21 = make_stencil("star", 2, 1, seed=4)
    jobs = [jnp.asarray(j) for j in inp["jobs"]]
    with StencilDriver(cache=PlanCache(), mode="cost",
                       mesh=grid_mesh((4, 2))) as driver:
        out["driver_key"] = np.asarray(driver.group_key(star21, jobs[0]))
        out["driver"] = np.stack([np.asarray(y) for y in driver.map(
            [(star21, x) for x in jobs])])
    findings, probes = analyze_sharded(VetConfig())
    assert findings == [], findings
    out["probes"] = np.asarray(repr(probes))
    np.savez(sys.argv[2], **out)
    print("REFERENCE-OK")
""")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return _inputs()


@pytest.fixture(scope="module")
def reference(tmp_path_factory, data):
    """The reference's sharded outputs on ``data``, from one subprocess
    with 8 forced host devices."""
    tmp = tmp_path_factory.mktemp("reference")
    np.savez(tmp / "inputs.npz", **data)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(tmp / "inputs.npz"),
         str(tmp / "out.npz"), repr(SWEEP)], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=REF_TIMEOUT)
    assert r.returncode == 0 and "REFERENCE-OK" in r.stdout, (
        r.stdout[-2000:] + r.stderr[-3000:])
    return dict(np.load(tmp / "out.npz"))


# ---------------------------------------------------------------------------
# the engine against the reference's single-device and sharded engines
# ---------------------------------------------------------------------------

def _sweep_outputs(data, kind, r, k, parts):
    ref, spec = _pair(kind, 2, r)
    h = k * r
    tag = _tag(kind, r, k, parts)
    eng = ShardedStencilEngine(spec, _mesh(parts), temporal_steps=k)
    assert eng.n_shards == 8
    x, u = data[tag + "_x"], data[tag + "_u"]
    return (ref, h, tag, x, u, eng(_t(x)).numpy(),
            eng.iterate(_t(u), 2 * k).numpy())


@pytest.mark.parametrize("kind,r,k,parts", SWEEP,
                         ids=[_tag(*c) for c in SWEEP])
def test_sharded_matches_the_reference_direct_engine(data, kind, r, k, parts):
    ref, h, _, x, u, call, it = _sweep_outputs(data, kind, r, k, parts)
    oracle = RefEngine(ref, backend="direct", temporal_steps=k)
    np.testing.assert_allclose(call, np.asarray(oracle(jnp.asarray(x))),
                               **TOL)
    want = oracle.iterate(jnp.pad(jnp.asarray(u), h), 2 * k)[h:-h, h:-h]
    np.testing.assert_allclose(it, np.asarray(want), **TOL)


@pytest.mark.parametrize("kind,r,k,parts", SWEEP,
                         ids=[_tag(*c) for c in SWEEP])
def test_sharded_matches_the_reference_sharded_engine(data, reference, kind,
                                                      r, k, parts):
    _, _, tag, _, _, call, it = _sweep_outputs(data, kind, r, k, parts)
    np.testing.assert_allclose(call, reference[tag + "_call"], **TOL)
    np.testing.assert_allclose(it, reference[tag + "_iter"], **TOL)


@pytest.mark.parametrize("backend,fuse", [
    ("gemm", False), ("gemm", True), ("sptc", False), ("sptc", True),
    ("cuda_gemm", False), ("cuda_sptc", False), ("cuda_direct", False)])
def test_sharded_matrix_backends_match(data, reference, backend, fuse):
    """The per-shard program is the same emission: every backend runs
    unchanged on the stacked blocks (the cuda_* wrappers take their plain
    versions on the CPU)."""
    ref, spec = _pair("box", 2, 2)
    x = data["matrix_x"]
    eng = ShardedStencilEngine(spec, _mesh((4, 2)), backend=backend,
                               fuse_rows=fuse)
    got = eng(_t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(RefEngine(ref)(
        jnp.asarray(x))), **TOL_MATRIX)
    plain = backend.removeprefix("cuda_")
    if plain in ("gemm", "sptc"):
        np.testing.assert_allclose(got, reference[f"matrix_{plain}_{fuse}"],
                                   **TOL_MATRIX)


@pytest.mark.parametrize("backend", ["direct", "sptc", "cuda_sptc",
                                     "cuda_direct"])
def test_sharded_1d_grid(data, reference, backend):
    ref, spec = _pair("star", 1, 2)
    x = data["oned_x"]
    got = ShardedStencilEngine(spec, _mesh(8), backend=backend)(_t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(RefEngine(ref)(
        jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(got, reference["oned"], **TOL)


def test_degenerate_single_device_mesh_matches(rng):
    ref, spec = _pair("box", 2, 1)
    eng = ShardedStencilEngine(spec, _mesh((1, 1)))
    assert eng.n_shards == 1 and eng.partition() == {}
    x = rng.normal(size=(26, 30)).astype(np.float32)
    np.testing.assert_allclose(eng(_t(x)).numpy(), np.asarray(
        RefEngine(ref)(jnp.asarray(x))), **TOL)
    u = rng.normal(size=(24, 28)).astype(np.float32)
    want = RefEngine(ref).iterate(jnp.pad(jnp.asarray(u), 1), 3)[1:-1, 1:-1]
    np.testing.assert_allclose(eng.iterate(_t(u), 3).numpy(),
                               np.asarray(want), **TOL)
    assert eng.transport.calls == 0


def test_apply_batched_partitions_every_job(rng):
    ref, spec = _pair("star", 2, 1)
    eng = ShardedStencilEngine(spec, _mesh((4, 2)))
    xs = rng.normal(size=(5, 42, 34)).astype(np.float32)
    got = eng.apply_batched(_t(xs)).numpy()
    for i in range(5):
        np.testing.assert_allclose(got[i], np.asarray(
            RefEngine(ref)(jnp.asarray(xs[i]))), **TOL)
    # one exchange pair per axis per step for the whole batch
    assert eng.transport.calls == 4


def test_exchanges_and_bytes_per_step():
    _, spec = _pair("box", 2, 1)
    eng = ShardedStencilEngine(spec, _mesh((4, 2)), temporal_steps=2)
    u = torch.zeros(40, 30)
    eng.iterate(u, 6)                     # 3 fused steps
    assert eng.transport.calls == 3 * 4
    h, b0, b1 = 2, 10, 15                 # halo, blocks of 40/4 and 30/2
    # axis 0: h rows of the block's width, 3 of 4 shards send per
    # direction, 2 columns of shards; axis 1: h columns of the extended
    # height, 1 of 2 shards sends, 4 rows of shards
    per_step = 2 * (3 * 2 * h * b1) + 2 * (4 * 1 * h * (b0 + 2 * h))
    assert eng.transport.sent_bytes == 3 * per_step * 4


def test_block_too_small_and_steps_not_a_multiple_raise():
    _, spec = _pair("box", 2, 2)
    eng = ShardedStencilEngine(spec, _mesh((2,)), temporal_steps=2)
    with pytest.raises(ValueError, match="blocks > 2·k·r"):
        eng.step(torch.zeros(14, 20))     # blocks of 7 <= 8
    with pytest.raises(ValueError, match="multiple of temporal_steps"):
        eng.iterate(torch.zeros(40, 20), 3)
    with pytest.raises(ValueError, match="float32 on cpu"):
        eng.step(torch.zeros(40, 20, dtype=torch.float64))


def test_mesh_validation():
    _, spec2 = _pair("box", 2, 1)
    _, spec1 = _pair("star", 1, 1)
    with pytest.raises(ValueError, match="needs"):
        grid_mesh(10_000, devices=[CPU])
    with pytest.raises(ValueError, match="needs 2 devices but only 0"):
        grid_mesh(2, devices=[])
    with pytest.raises(ValueError, match="positive"):
        grid_mesh((0, 2), devices=[CPU])
    with pytest.raises(ValueError, match="only 1-D"):
        ShardedStencilEngine(spec1, _mesh((1, 1)))
    with pytest.raises(ValueError, match="distinct axes"):
        ShardedStencilEngine(spec2, _mesh(1), grid_axes=(5,))
    mesh = grid_mesh((2,), devices=[CPU, torch.device("meta")])
    with pytest.raises(ValueError, match="one device"):
        LocalTransport().bind(mesh)
    with pytest.raises(ValueError, match="process group"):
        default_transport(mesh)
    assert isinstance(default_transport(_mesh((2,))), LocalTransport)
    m = _mesh((4, 2))
    assert m.axis_names == ("sp0", "sp1") and m.parts == (4, 2)
    assert dict(m.shape) == {"sp0": 4, "sp1": 2}


def test_grid_axes_partition_the_named_axis(rng):
    ref, spec = _pair("box", 2, 1)
    eng = ShardedStencilEngine(spec, _mesh((4,)), grid_axes=(1,))
    assert eng.partition() == {1: 4}
    x = rng.normal(size=(20, 45)).astype(np.float32)
    np.testing.assert_allclose(eng(_t(x)).numpy(), np.asarray(
        RefEngine(ref)(jnp.asarray(x))), **TOL)


# ---------------------------------------------------------------------------
# the tuner and the driver with a mesh
# ---------------------------------------------------------------------------

def _fields(encoded: str) -> dict:
    d = dict(f.split("=", 1) for f in encoded.split(";")[1:])
    d.pop("dev"), d.pop("univ")
    return d


def test_plan_key_with_a_mesh_equals_the_reference():
    ref, spec = _pair("box", 2, 1, seed=4)
    for mesh, desc in (((4, 2), "4x2"), (8, "8"), (_mesh((4, 2)), "4x2"),
                       ((1, 1), "1"), (None, "1")):
        got = plan_key(spec, (42, 34), torch.float32, CPU, mesh=mesh)
        want = rplan.plan_key(ref, (42, 34), jnp.float32, mesh=(
            mesh.parts if hasattr(mesh, "parts") else mesh))
        assert got.mesh == desc
        assert _fields(got.encode()) == _fields(want.encode())
    assert batch_group_key(spec, (34, 34), torch.float32, CPU) != \
        batch_group_key(spec, (34, 34), torch.float32, CPU, mesh="4x2")


def test_tuned_apply_with_a_mesh_equals_the_reference(data, reference):
    _, spec = _pair("box", 2, 1, seed=4)
    cache = PlanCache()
    x = _t(data["tuned_x"])
    y = tuned_apply(spec, x, cache=cache, mode="cost", mesh=_mesh((4, 2)))
    np.testing.assert_allclose(y.numpy(), reference["tuned"], **TOL_MATRIX)
    (key, plan), = cache._plans.items()
    assert _fields(key) == _fields(str(reference["tuned_key"]))
    assert repr(plan.to_dict()) == str(reference["tuned_plan"])
    # the sharded and the single-device plans land in distinct entries
    tuned_apply(spec, x, cache=cache, mode="cost")
    assert sorted(k.split("mesh=")[-1] for k in cache._plans) == ["1", "4x2"]


def test_tuned_apply_with_a_mesh_times_the_sharded_engine(data):
    ref, spec = _pair("box", 2, 1, seed=4)
    cache = PlanCache()
    mesh = _mesh((4, 2))
    x = _t(data["tuned_x"])
    y = tuned_apply(spec, x, cache=cache, mode="time", mesh=mesh,
                    warmup=1, iters=1)
    np.testing.assert_allclose(y.numpy(), np.asarray(RefEngine(ref)(
        jnp.asarray(data["tuned_x"]))), **TOL_MATRIX)
    assert cache.stats.tunes == 1 and not cache._engines
    (eng,) = cache._sharded.values()      # the winner; losers pruned
    assert isinstance(eng, ShardedStencilEngine) and eng.transport.calls > 0
    with pytest.raises(NotImplementedError, match="variable-coefficient"):
        tuned_apply(spec, x, cache=cache, mode="cost", mesh=mesh,
                    coefficients=np.ones((40, 32, 9)))


def test_tuned_apply_batched_with_a_mesh(data):
    ref, spec = _pair("star", 2, 1, seed=4)
    xs = _t(data["jobs"])
    got = tuned_apply_batched(spec, xs, cache=PlanCache(), mode="cost",
                              mesh=_mesh((4, 2))).numpy()
    for i in range(len(xs)):
        np.testing.assert_allclose(got[i], np.asarray(RefEngine(ref)(
            jnp.asarray(data["jobs"][i]))), **TOL_MATRIX)


def test_stencil_driver_with_a_mesh_equals_the_reference(data, reference):
    _, spec = _pair("star", 2, 1, seed=4)
    jobs = [_t(j) for j in data["jobs"]]
    with StencilDriver(cache=PlanCache(), mode="cost", mesh=_mesh((4, 2)),
                       device=CPU) as driver:
        key = driver.group_key(spec, jobs[0])
        assert "mesh=4x2" in key
        assert _fields(key) == _fields(str(reference["driver_key"]))
        results = driver.map([(spec, x) for x in jobs])
    for y, want in zip(results, reference["driver"]):
        np.testing.assert_allclose(y.numpy(), want, **TOL_MATRIX)


# ---------------------------------------------------------------------------
# vet: the exchange budget on the sharded step path
# ---------------------------------------------------------------------------

def test_analyze_sharded_certifies_the_reference_probes(reference):
    findings, probes = lowering.analyze_sharded(VetConfig(), CPU)
    assert findings == [], [f.format() for f in findings]
    assert probes == eval(str(reference["probes"]))     # the same counts
    for symbol, counts in probes.items():
        assert counts["gather-like"] == 0, symbol
        assert counts["collective-permute"] == (
            4 if "mesh2x2" in symbol else 2), symbol


@pytest.mark.parametrize("parts", [(2,), (2, 2)])
def test_planted_over_exchange_is_flagged(parts):
    _, spec = _pair("box", 2, 1, seed=7)
    eng = lowering.planted_over_exchange(spec, parts, CPU, backend="sptc")
    u = lowering.probe_input((24, 24), CPU)
    fs, counts = lowering.audit_sharded(VetConfig(), eng, u, 2, "over")
    assert [f.rule for f in fs] == ["sharded-collective-budget"], counts
    assert counts["collective-permute"] == 3 * len(parts)


@pytest.mark.parametrize("parts", [(2,), (2, 2)])
def test_planted_global_gather_is_flagged(parts):
    _, spec = _pair("box", 2, 1, seed=7)
    eng = lowering.planted_global_gather(spec, parts, CPU, backend="sptc")
    u = lowering.probe_input((24, 24), CPU)
    fs, counts = lowering.audit_sharded(VetConfig(), eng, u, 2, "gather")
    assert [f.rule for f in fs] == ["sharded-all-gather"], counts
    assert counts["gather-like"] >= 2          # one global grid per step


def test_wrong_sharded_output_is_flagged():
    _, spec = _pair("box", 2, 1, seed=7)
    eng = ShardedStencilEngine(spec, _mesh((2,)), backend="sptc")
    program = eng._shard_step
    eng._shard_step = lambda x: program(x) * 0.5
    fs, _ = lowering.audit_sharded(VetConfig(), eng,
                                   lowering.probe_input((24, 24), CPU), 1,
                                   "half")
    assert [f.rule for f in fs] == ["launch-output-mismatch"]


def test_sharded_engine_uses_the_engines_emission():
    # nothing of the halo path rebuilds a plan per call: the per-shard
    # program is built once, from the shared lowering
    _, spec = _pair("star", 2, 1)
    eng = ShardedStencilEngine(spec, _mesh((2, 2)), backend="cuda_sptc")
    one = StencilEngine(spec, "cuda_sptc", device=CPU)
    assert eng.plan_ir.decompose.mode == one.plan_ir.decompose.mode
    assert eng.L == one.L and eng.halo == 1
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(30, 30)),
                        dtype=torch.float32)
    torch.testing.assert_close(eng(x), one(x), rtol=1e-5, atol=1e-5)
    u = x[1:-1, 1:-1]
    torch.testing.assert_close(
        eng.iterate(u, 3), one.iterate(F.pad(u, (1,) * 4), 3)[1:-1, 1:-1],
        rtol=1e-5, atol=1e-5)
