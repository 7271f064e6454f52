"""The port's StencilDriver against the reference's, on the CPU.

Both drivers serve the same seeded mix of 30 jobs (edges <= 64) in cost
mode; per-job outputs agree within float32 ``rtol = atol = 3e-5`` for every
padding policy, group keys agree except in their ``dev`` and ``univ``
fields, and validation, backpressure and metrics behave as the reference's
own tests assert for it.
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stencil as ref_stencil
from repro.serving import StencilDriver as RefDriver
from repro.tuner import PlanCache as RefCache
from repro_torch.core.convert import spec_from_arrays
from repro_torch.core.engine import StencilEngine
from repro_torch.distributed import grid_mesh
from repro_torch.serving import BatchPolicy, QueueFullError, StencilDriver
from repro_torch.tuner import PlanCache, batch_group_key, tuned_apply

MODE = "cost"
F32 = dict(rtol=3e-5, atol=3e-5)
CPU = "cpu"
MIX = [("star", 2, 1, 1), ("box", 2, 2, 2), ("box", 1, 1, 3)]


def _pair(shape, ndim, r, seed):
    ref = ref_stencil.make_stencil(shape, ndim, r, seed=seed)
    return ref, spec_from_arrays(ref.shape, ref.ndim, ref.radius, ref.weights)


def _mix(n, seed=0, lo=12):
    """``n`` jobs over the three specs, halo-inclusive edges in (lo, 64]."""
    rng = np.random.default_rng(seed)
    pairs = [_pair(*m) for m in MIX]
    jobs = []
    for i in range(n):
        ref, spec = pairs[i % len(pairs)]
        hi = 64 - 2 * spec.radius + 1
        dims = tuple(int(d) for d in rng.integers(lo, hi, size=spec.ndim))
        x = rng.normal(size=tuple(s + 2 * spec.radius for s in dims)
                       ).astype(np.float32)
        jobs.append((ref, spec, x))
    return jobs


def _fields(key):
    d = dict(f.split("=", 1) for f in key.split(";")[1:])
    return d, d.pop("dev"), d.pop("univ")


def _cpu_driver(**kw):
    kw.setdefault("cache", PlanCache())
    return StencilDriver(mode=MODE, device=CPU, **kw)


@pytest.mark.parametrize("padding", ["bucket", "max", "exact"])
def test_outputs_match_reference_driver(padding):
    jobs = _mix(30)
    policy = dict(max_batch=6, max_wait_ms=1.0)
    with RefDriver(cache=RefCache(), mode=MODE, padding=padding,
                   policy=BatchPolicy(**policy)) as rdrv:
        want = rdrv.map([(ref, jnp.asarray(x)) for ref, _, x in jobs],
                        timeout=300)
    with _cpu_driver(padding=padding, policy=BatchPolicy(**policy)) as drv:
        got = drv.map([(spec, torch.as_tensor(x)) for _, spec, x in jobs],
                      timeout=300)
        metrics = drv.metrics()
    for (_, spec, x), y, w in zip(jobs, got, want):
        assert tuple(y.shape) == tuple(s - 2 * spec.radius for s in x.shape)
        assert y.is_contiguous() and y.device.type == "cpu"
        np.testing.assert_allclose(y.numpy(), np.asarray(w), **F32)
    assert metrics["overall"]["completed"] == 30
    assert metrics["overall"]["failed"] == 0


def test_group_keys_match_reference_except_dev_and_univ():
    rdrv = RefDriver(cache=RefCache(), mode=MODE, autostart=False)
    drv = _cpu_driver(autostart=False)
    for ref, spec, x in _mix(12, seed=4):
        for k in (1, 2):
            xk = np.pad(x, spec.radius) if k == 2 else x
            rk = rdrv.group_key(ref, jnp.asarray(xk), temporal_steps=k)
            pk = drv.group_key(spec, torch.as_tensor(xk), temporal_steps=k)
            (rf, rdev, runiv), (pf, pdev, puniv) = _fields(rk), _fields(pk)
            assert rf == pf and rdev == pdev == "cpu"
            assert (runiv, puniv) == ("jnp", "torch")
            assert pk == batch_group_key(spec, xk.shape, torch.float32, CPU,
                                         temporal_steps=k)
    rdrv.close()
    drv.close()


def test_group_key_splits_on_dtype_spec_and_exact_shape():
    _, spec = _pair("star", 2, 1, 0)
    drv = _cpu_driver(autostart=False)
    a, b = torch.zeros(22, 26), torch.zeros(30, 32)      # both bucket to 32
    assert drv.group_key(spec, a) == drv.group_key(spec, b)
    assert drv.group_key(spec, a.bfloat16()) != drv.group_key(spec, a)
    _, other = _pair("star", 2, 1, 9)
    assert drv.group_key(other, a) != drv.group_key(spec, a)
    drv.close()
    exact = _cpu_driver(padding="exact", autostart=False)
    assert exact.group_key(spec, a) != exact.group_key(spec, b)
    exact.close()


def test_submit_validates_ndim_halo_and_steps():
    _, spec = _pair("star", 2, 1, 0)
    with _cpu_driver() as drv:
        with pytest.raises(ValueError, match="2-D"):
            drv.submit(spec, torch.zeros(8))
        with pytest.raises(ValueError, match="halo"):
            drv.submit(spec, torch.zeros(2, 8))
        with pytest.raises(ValueError, match="2kr=4"):
            drv.submit(spec, torch.zeros(4, 8), temporal_steps=2)
        with pytest.raises(ValueError, match="temporal_steps"):
            drv.submit(spec, torch.zeros(8, 8), temporal_steps=0)
    with pytest.raises(ValueError, match="padding"):
        StencilDriver(padding="ragged", device=CPU)
    # a partitioned mesh runs sharded: it needs its shards' devices, and
    # the driver's device among them
    with pytest.raises(ValueError, match="needs 8 devices"):
        StencilDriver(mesh=(4, 2), device=CPU)
    with pytest.raises(ValueError, match="driver's device"):
        StencilDriver(mesh=grid_mesh((4, 2), devices=["meta"] * 8),
                      device=CPU)
    StencilDriver(mesh=grid_mesh((4, 2), devices=[CPU] * 8), device=CPU,
                  autostart=False).close()


def test_temporal_jobs_bucket_and_run_separately():
    _, spec = _pair("star", 2, 1, 0)
    rng = np.random.default_rng(1)
    x1 = torch.as_tensor(rng.normal(size=(22, 26)).astype(np.float32))
    xk = torch.as_tensor(rng.normal(size=(24, 28)).astype(np.float32))
    cache = PlanCache()
    with _cpu_driver(cache=cache,
                     policy=BatchPolicy(max_batch=4, max_wait_ms=1.0)) as drv:
        assert drv.group_key(spec, xk, temporal_steps=2) != \
            drv.group_key(spec, xk)
        f1 = drv.submit(spec, x1)
        fk = drv.submit(spec, xk, temporal_steps=2)
        y1, yk = f1.result(timeout=120), fk.result(timeout=120)
    np.testing.assert_allclose(
        y1.numpy(), tuned_apply(spec, x1, cache=cache, mode=MODE).numpy(),
        **F32)
    direct = StencilEngine(spec, "direct", device=CPU)
    assert tuple(yk.shape) == (20, 24)
    np.testing.assert_allclose(yk.numpy(), direct(direct(xk)).numpy(), **F32)


def test_many_jobs_from_client_threads_batch_and_match_direct():
    """Eight client threads submit concurrently; every job matches the
    ``direct`` oracle, the batches hold more than one job, and each of the
    three groups (every job buckets to 64) tunes once."""
    jobs = _mix(48, seed=9, lo=33)
    cache = PlanCache()
    drv = _cpu_driver(cache=cache,
                      policy=BatchPolicy(max_batch=8, max_wait_ms=20.0),
                      autostart=False)
    futures = [None] * len(jobs)

    def client(c):
        for i in range(c, len(jobs), 8):
            futures[i] = drv.submit(jobs[i][1], torch.as_tensor(jobs[i][2]))
    threads = [threading.Thread(target=client, args=(c,)) for c in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    drv.start()
    got = [f.result(timeout=300) for f in futures]
    metrics = drv.metrics()
    drv.close()
    for (_, spec, x), y in zip(jobs, got):
        want = StencilEngine(spec, "direct", device=CPU)(torch.as_tensor(x))
        np.testing.assert_allclose(y.numpy(), want.numpy(), **F32)
    overall = metrics["overall"]
    assert overall["completed"] == len(jobs)
    assert overall["batch_occupancy"] > 1.0
    assert overall["batches"] < len(jobs)
    assert len(metrics["plans"]) == metrics["tuner"]["tunes"] == 3
    assert metrics["tuner"]["plan_hit_rate"] > 0


def test_backpressure_reject_and_metrics():
    _, spec = _pair("box", 1, 1, 5)
    drv = _cpu_driver(policy=BatchPolicy(max_batch=8, max_queue=3,
                                         overflow="reject"),
                      autostart=False)
    xs = [torch.randn(42) for _ in range(4)]
    futures = [drv.submit(spec, x) for x in xs[:3]]
    with pytest.raises(QueueFullError):
        drv.submit(spec, xs[3])
    key = drv.group_key(spec, xs[0])
    assert drv.queue_depth() == 3 and drv.queue_depth(key) == 3
    m = drv.metrics()["plans"][key]
    assert m["rejected"] == 1 and m["submitted"] == 3
    drv.start()
    for f in futures:
        f.result(timeout=60)
    drv.close()


def test_backpressure_block_completes():
    _, spec = _pair("box", 1, 1, 5)
    xs = [torch.randn(42) for _ in range(10)]
    with _cpu_driver(policy=BatchPolicy(max_batch=4, max_wait_ms=0.0,
                                        max_queue=2,
                                        overflow="block")) as drv:
        got = drv.map([(spec, x) for x in xs], timeout=120)
    assert len(got) == 10
    want = StencilEngine(spec, "direct", device=CPU)(xs[0])
    np.testing.assert_allclose(got[0].numpy(), want.numpy(), **F32)


def test_metrics_counters_and_latency():
    _, spec = _pair("star", 2, 1, 0)
    cache = PlanCache()
    drv = _cpu_driver(cache=cache,
                      policy=BatchPolicy(max_batch=4, max_wait_ms=1.0),
                      autostart=False)
    xs = [torch.randn(18, 20) for _ in range(6)]
    futures = [drv.submit(spec, x) for x in xs]
    drv.start()
    [f.result(timeout=120) for f in futures]
    metrics = drv.metrics()
    drv.close()
    key = drv.group_key(spec, xs[0])
    m = metrics["plans"][key]
    assert m["submitted"] == 6 and m["completed"] == 6 and m["failed"] == 0
    assert m["batches"] == 2 and m["batch_occupancy"] == 3.0
    assert 0 < m["padding_efficiency"] <= 1.0
    assert m["padding_efficiency"] == pytest.approx((18 * 20) / (32 * 32),
                                                   abs=1e-4)
    assert m["latency"]["count"] == 6
    assert m["latency"]["p99_ms"] >= m["latency"]["p50_ms"] > 0
    assert m["queue_depth"] == 0
    assert metrics["tuner"]["tunes"] == 1
    assert metrics["tuner"]["plan_hits"] >= 1
    assert metrics["padding"] == "bucket"
    assert metrics["policy"]["max_batch"] == 4


def test_failed_batch_counts_and_reaches_every_future(monkeypatch):
    _, spec = _pair("box", 1, 1, 5)
    drv = _cpu_driver(policy=BatchPolicy(max_batch=2, max_wait_ms=1.0),
                      autostart=False)
    futures = [drv.submit(spec, torch.randn(42)) for _ in range(2)]

    def boom(*a, **k):
        raise RuntimeError("kernel fault")
    from repro_torch.serving import stencil_driver
    monkeypatch.setattr(stencil_driver, "tuned_apply_batched", boom)
    drv.start()
    for f in futures:
        with pytest.raises(RuntimeError, match="kernel fault"):
            f.result(timeout=60)
    assert drv.metrics()["overall"]["failed"] == 2
    drv.close()


def test_driver_runs_on_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StencilDriver(autostart=False)
