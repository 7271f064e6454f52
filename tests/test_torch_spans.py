"""The port's spans and set-up counters.

Spans (``kernels/common.py::region``) are profiler ranges, on exactly while
a ``torch.profiler`` is active: ``StencilEngine`` opens ``engine.iterate``,
``engine.apply`` and ``engine.pad`` (around each of ``iterate``'s halo
fills: one a buffer where it writes in place, one a re-pad otherwise); the
kernel wrappers' regions and the
per-RowOp loop's ``engine.layout_copy`` and ``engine.accumulate`` nest
inside ``engine.apply``.  The launch audit walks through the engine's
spans, so an engine call audits as its emitted function does.  Set-up
counters: ``lower_spec.calls`` / ``lower_spec.seconds``,
``CacheStats.tune_s`` and ``library.seconds``.  The last test needs a
Hopper card (``python -m pytest -q -m cuda tests/test_torch_spans.py``).

Imports nothing of JAX.
"""
from __future__ import annotations

import weakref

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import tuner
from repro_torch.core import engine as engine_mod
from repro_torch.core.engine import StencilEngine
from repro_torch.core.stencil import make_stencil
from repro_torch.core.transform import lower_spec
from repro_torch.kernels import build, dispatch
from repro_torch.kernels.common import ENGINE_SPANS, KERNEL_REGIONS
from repro_torch.kernels.sptc_spmm import ops as sptc_ops
from repro_torch.kernels.stencil_direct import ops as direct_ops
from repro_torch.vet import lowering

CPU = torch.device("cpu")
#: backend -> the kernel region each engine call of a 2-D box enters (on
#: cuda_sptc its row ops run as one rows-kernel launch)
REGION = {"cuda_sptc": "sptc_spmm_rows2d", "cuda_direct": "stencil2d"}


def _box(device, shape=(18, 18)):
    spec = make_stencil("box", 2, 1, seed=7)
    return spec, lowering.probe_input(shape, device)


def _ancestors(e):
    out = []
    while e.cpu_parent is not None:
        e = e.cpu_parent
        out.append(e.name)
    return out


def test_engine_span_names():
    assert ENGINE_SPANS == ("engine.iterate", "engine.apply", "engine.pad",
                            "engine.layout_copy", "engine.accumulate")
    assert not set(ENGINE_SPANS) & set(KERNEL_REGIONS)


@pytest.mark.parametrize("backend,k,pads", [
    pytest.param(b, 1, 2, id=b) for b in sorted(REGION)] + [
    pytest.param(b, 2, 3, id=f"{b}-repad") for b in sorted(REGION)])
def test_iterate_records_its_spans_with_the_regions_inside(backend, k, pads):
    """Three engine calls: in place (k = 1) the halos of the call's two
    buffers are zeroed in one ``engine.pad`` each; re-padding (the
    temporal-blocked fallback, k = 2) one ``engine.pad`` a call.  The
    kernel regions nest under ``engine.apply`` and ``engine.iterate``."""
    spec, x = _box(CPU)
    eng = StencilEngine(spec, backend=backend, temporal_steps=k,
                        device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y = eng.iterate(x, 3 * k)
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    count = {n: sum(e.name == n for e in events) for n in ENGINE_SPANS}
    assert count == {"engine.iterate": 1, "engine.apply": 3,
                     "engine.pad": pads, "engine.layout_copy": 0,
                     "engine.accumulate": 0}
    regions = [e for e in events if e.name == REGION[backend]]
    assert len(regions) == 3 * k
    for e in regions:
        assert _ancestors(e)[:2] == ["engine.apply", "engine.iterate"]
    for e in events:
        if e.name in ("engine.apply", "engine.pad"):
            assert _ancestors(e) == ["engine.iterate"]
    torch.testing.assert_close(y, eng.iterate(x, 3 * k), rtol=0, atol=0)


def _glue(eng, x, steps):
    """``eng.iterate(x, steps)`` under the profiler: its output and the
    per-RowOp glue's spans, each with its ancestors."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y = eng.iterate(x, steps)
    spans = [(e.name, _ancestors(e)) for e in prof.events()
             if e.device_type == DeviceType.CPU
             and e.name in ("engine.layout_copy", "engine.accumulate")]
    return y, spans


@pytest.mark.parametrize("ndim,r,shape,copies,adds", [
    (2, 3, (30, 34), 4, 12), (3, 2, (10, 12, 14), 0, 16)])
def test_star_iterate_records_the_row_op_glue_inside_apply(ndim, r, shape,
                                                           copies, adds):
    """A star on cuda_sptc run by the per-RowOp loop (``star-axis``; a 2-D
    one on the CPU): per step a copy of the last-axis op's transposed input
    on a 2-D grid (none on a 3-D one: each axis's slice is copied by the
    reshape that folds the other axes into its columns, which leaves it
    contiguous) and 1 + d accumulator spans (the zero fill and the adds),
    each under ``engine.apply``; the spans change no bit of the output."""
    spec = make_stencil("star", ndim, r, seed=11)
    eng = StencilEngine(spec, backend="cuda_sptc", device="cpu")
    assert eng.plan_ir.decompose.mode == "star-axis"
    x = lowering.probe_input(shape, CPU)
    plain = eng.iterate(x, 4)
    y, spans = _glue(eng, x, 4)
    names = [n for n, _ in spans]
    assert names.count("engine.layout_copy") == copies
    assert names.count("engine.accumulate") == adds
    for _, up in spans:
        assert up[:2] == ["engine.apply", "engine.iterate"]
    torch.testing.assert_close(y, plain, rtol=0, atol=0)


def test_2d_star_call_is_one_star_kernel_region_and_no_glue():
    """A 2-D star on cuda_sptc, emitted as on the card (the star kernel's
    plain version here), enters ``sptc_spmm_star2d`` once a call,
    ``sptc_spmm_fused`` never, and opens no glue span; its steps equal the
    per-RowOp loop's, which the CPU runs, bit for bit."""
    from repro_torch.core.engine import emit_grid
    spec = make_stencil("star", 2, 3, seed=11)
    eng = StencilEngine(spec, backend="cuda_sptc", device="cpu")
    x = lowering.probe_input((30, 34), CPU)
    loop = eng.iterate(x, 4)
    eng._fn = emit_grid(eng.plan_ir, CPU, torch.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y = eng.iterate(x, 4)
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CPU]
    assert names.count("sptc_spmm_star2d") == names.count("engine.apply") == 4
    assert "sptc_spmm_fused" not in names
    assert "engine.layout_copy" not in names
    assert "engine.accumulate" not in names
    torch.testing.assert_close(y, loop, rtol=0, atol=0)


@pytest.mark.parametrize("spec,shape", [(("box", 2, 1), (18, 18)),
                                        (("box", 1, 2), (68,))])
def test_contiguous_box_and_line_record_no_row_op_glue(spec, shape):
    # the rows kernel reads a contiguous grid in place; a 1-D line is the
    # ``single`` emission: neither copies, fills or adds
    eng = StencilEngine(make_stencil(*spec, seed=5), backend="cuda_sptc",
                        device="cpu")
    _, spans = _glue(eng, lowering.probe_input(shape, CPU), 3)
    assert spans == []


def test_rows_kernel_copy_of_a_transposed_grid_is_a_layout_copy():
    spec, x = _box(CPU, (18, 22))
    eng = StencilEngine(spec, backend="cuda_sptc", device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y = eng(x.t())
    spans = [(e.name, _ancestors(e)) for e in prof.events()
             if e.name in ("engine.layout_copy", "engine.accumulate")]
    assert spans == [("engine.layout_copy", ["engine.apply"])]
    torch.testing.assert_close(y, eng(x.t().contiguous()), rtol=0, atol=0)


@pytest.mark.parametrize("path", ["in_place", "repad"])
def test_iterate_frees_each_step_before_the_next(path, monkeypatch):
    """``iterate`` keeps no grid beyond what its steps need.  Re-padding (an
    engine whose ``__call__`` is replaced is iterated through it): the
    re-pad's span holds no step alive, a step's output is freed before the
    next step runs.  In place: the call makes two haloed grids and no
    other, each as the step that first writes it runs, the steps write into
    them in turn, and the one not returned is freed with the call."""
    spec, x = _box(CPU)
    x0 = x.clone()
    if path == "repad":
        outs = []

        class Watched(StencilEngine):
            def __call__(self, x):
                assert all(r() is None for r in outs)
                y = super().__call__(x)
                outs.append(weakref.ref(y))
                return y

        Watched(spec, backend="cuda_sptc", device="cpu").iterate(x, 3)
        assert len(outs) == 3
        assert torch.equal(x, x0)
        return
    made, wrote = [], []
    haloed = engine_mod._haloed

    def watched(like, h):
        grid = haloed(like, h)
        made.append(weakref.ref(grid))
        return grid

    monkeypatch.setattr(engine_mod, "_haloed", watched)
    eng = StencilEngine(spec, backend="cuda_sptc", device="cpu")
    fn = eng._fn

    def step(xs, out=None):
        wrote.append([g() is not None and out.untyped_storage().data_ptr()
                      == g().untyped_storage().data_ptr() for g in made])
        return fn(xs, out=out)

    step.takes_out = True
    eng._fn = step
    y = eng.iterate(x, 3)
    assert wrote == [[True], [False, True], [True, False]]
    assert y is made[0]() and made[1]() is None
    assert torch.equal(x, x0)


def test_apply_batched_opens_one_apply_span():
    spec, x = _box(CPU)
    eng = StencilEngine(spec, backend="cuda_sptc", device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.apply_batched(torch.stack([x, x]))
        eng(x)
    names = [e.name for e in prof.events()]
    assert names.count("engine.apply") == 2
    assert "engine.iterate" not in names and "engine.pad" not in names


def test_no_span_is_entered_without_a_profiler(monkeypatch):
    def entered(name):
        raise AssertionError(f"record_function({name!r}) entered")
    monkeypatch.setattr(torch.profiler, "record_function", entered)
    spec, x = _box(CPU)
    eng = StencilEngine(spec, backend="cuda_sptc", device="cpu")
    eng.iterate(x, 2)
    eng.apply_batched(x[None])


@pytest.mark.parametrize("backend",
                         ["direct", "gemm", "sptc", "cuda_sptc",
                          "cuda_direct"])
def test_audit_of_an_engine_call_is_that_of_its_function(backend):
    # the engine's spans hold no work: the audit walks through them
    spec, x = _box(CPU, (22, 22))
    eng = StencilEngine(spec, backend=backend, device="cpu")
    via_engine = lowering.audit_call(eng, x)
    direct = lowering.audit_call(lambda t: eng._fn(t[None])[0], x)
    assert via_engine.sequence == direct.sequence
    assert via_engine.counts == direct.counts
    assert via_engine.regions == direct.regions
    assert any(n.startswith("aten::") for n in via_engine.sequence)
    assert not set(via_engine.sequence) & set(ENGINE_SPANS)


def test_lower_spec_counts_one_call_per_engine_built():
    spec, _ = _box(CPU)
    calls, seconds = lower_spec.calls, lower_spec.seconds
    StencilEngine(spec, backend="cuda_sptc", device="cpu")
    assert lower_spec.calls == calls + 1
    StencilEngine(spec, backend="direct", device="cpu")
    assert lower_spec.calls == calls + 2
    assert lower_spec.seconds > seconds


def test_tune_seconds_grow_on_a_tune_and_not_on_a_plan_hit():
    spec = make_stencil("box", 1, 1, seed=1)
    cache = tuner.PlanCache()
    assert cache.stats.tune_s == 0.0
    tuner.plan_for(spec, (40,), device=CPU, cache=cache, mode="time",
                   iters=1)
    tuned = cache.stats.tune_s
    assert tuned > 0 and cache.stats.tunes == 1
    tuner.plan_for(spec, (40,), device=CPU, cache=cache, mode="time",
                   iters=1)
    assert cache.stats.plan_hits == 1 and cache.stats.tune_s == tuned
    assert tuner.cache_stats(cache)["tune_s"] == tuned


def test_library_seconds_is_none_until_the_library_is_loaded():
    if build.library.cache_info().currsize:
        assert build.library.seconds > 0
    else:
        assert build.library.seconds is None


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) < dispatch.MIN_CAPABILITY:
        pytest.skip("needs compute capability 9.0 (kernels built for sm_90a)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("backend,counter",
                         [("cuda_sptc", sptc_ops.sptc_spmm_rows2d),
                          ("cuda_direct", direct_ops.stencil2d)])
def test_kernels_start_after_the_apply_span_that_launched_them(
        cuda_device, backend, counter):
    """One clock: each port kernel on the device timeline starts after the
    host opened the ``engine.apply`` span that launched it."""
    spec, x = _box(cuda_device, (130, 258))
    eng = StencilEngine(spec, backend=backend, device=cuda_device)
    eng.iterate(x, 2)
    assert build.library.seconds > 0
    launched = []

    def run():
        before = counter.launches
        eng.iterate(x, 3)
        launched.append(counter.launches - before)
    events, _, _ = lowering.trace_device(run, cuda_device)
    kernel = KERNEL_REGIONS[counter.__name__]
    applies = sorted(e.time_range.start for e in events
                     if e.device_type == DeviceType.CPU
                     and e.name == "engine.apply")
    kernels = sorted(e.time_range.start for e in events
                     if e.device_type == DeviceType.CUDA
                     and not e.is_user_annotation and kernel in e.name)
    per_apply = launched[-1] // 3
    assert len(applies) == 3 and per_apply >= 1
    assert len(kernels) == launched[-1]
    for i, start in enumerate(kernels):
        assert start >= applies[i // per_apply], (i, start, applies)
    assert np.all(np.diff(applies) > 0)
