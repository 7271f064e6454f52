"""The star cell, ``solve.star-2d3r.sptc``, on the CPU at a tiny size: sound
runs are correct, the lower-precision controls and the faults a cell can
have are not.  Then the reference by hand on a radius-3 star, the reader of
the per-RowOp glue's spans (on traces built by hand, and on a profile of
the program itself) and the cell's entries in ``BENCHMARK.json``."""
import importlib.util
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SEED = 2 ** 31 + 4099
CELL = "solve.star-2d3r.sptc"
SMALL = {"config": {"grid": [70, 70]}}
GLUE = "engine.row_op_glue_per_step.solve"
JOINED = ("gstencil_per_s", "engine.outside_kernel_pct.solve",
          "engine.launches_per_step", "stencil_kernels_roofline.solve",
          "device.idle_pct.solve")


def _sbench():
    """The harness package, loaded from this folder by its path."""
    if "sbench" not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            "sbench", BENCH / "sbench" / "__init__.py",
            submodule_search_locations=[str(BENCH / "sbench")])
        mod = importlib.util.module_from_spec(spec)
        sys.modules["sbench"] = mod
        spec.loader.exec_module(mod)
    return sys.modules["sbench"]


def _run(control=None):
    _sbench()
    from sbench.harness import run_cell
    return run_cell(ROOT, CELL, SEED, 0.3, False, device="cpu",
                    overrides=SMALL, control=control)


def _reader(name):
    _sbench()
    from sbench.layout import Layout
    return Layout(ROOT).reader(name)


def _traced(host_ops, steps):
    _sbench()
    from sbench.trace import Trace
    tr = Trace(window=(0, 100_000), device_ops=[("k", 0, 100_000)],
               host_ops=list(host_ops))
    return SimpleNamespace(trace=tr, counters={"kind": "solve",
                                               "steps": steps})


def test_cell_runs_correct():
    r = _run()
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert {"setup_s", "gstencil_per_s"} <= set(r["metrics"])
    assert all(v["value"] > 0 for v in r["metrics"].values())


@pytest.mark.parametrize("control", ["tf32", "bfloat16"])
def test_control_fails(control):
    r = _run(control=control)
    assert not r["correct"]
    (name, c), = r["checks"].items()
    assert c["value"] > c["limit"]


def test_step_that_leaves_its_state_unchanged_fails(monkeypatch):
    from repro_torch.core.engine import StencilEngine

    def unchanged(self, x):
        r = self.spec.radius
        return x[(slice(r, -r),) * x.dim()].clone()
    monkeypatch.setattr(StencilEngine, "__call__", unchanged)
    assert not _run()["correct"]


def test_answer_altered_where_produced_fails(monkeypatch):
    from repro_torch.core.engine import StencilEngine
    call = StencilEngine.__call__

    def altered(self, x):
        y = call(self, x).clone(memory_format=torch.contiguous_format)
        y.view(-1)[y.numel() // 2] += 1e-3 * float(y.abs().max())
        return y
    monkeypatch.setattr(StencilEngine, "__call__", altered)
    assert not _run()["correct"]


def test_reference_2d_radius_3_star_by_hand():
    _sbench()
    from sbench.layout import _load
    ref = _load(BENCH / "reference" / "stencil.py", "spider_bench_reference_")
    raw = np.arange(1.0, 50.0).reshape(7, 7)
    w = ref.normalised_weights(raw, "star")
    # the centre row (22..28) and column (4, 11, ..., 46); off-axis ignored
    row, col = raw[3].sum(), raw[:, 3].sum() - raw[3, 3]
    assert ref.taps(w) == 13
    np.testing.assert_allclose(w.sum(), 1.0)
    x = torch.arange(81.0).reshape(9, 9) ** 1.5
    y = ref.apply_valid(w, x)
    assert y.shape == (3, 3)
    for i in range(3):
        for j in range(3):
            want = sum(raw[3, k] * float(x[i + 3, j + k]) for k in range(7))
            want += sum(raw[k, 3] * float(x[i + k, j + 3]) for k in range(7)
                        if k != 3)
            assert float(y[i, j]) == pytest.approx(want / (row + col),
                                                   rel=1e-12)


def test_glue_reader_on_traces_built_by_hand():
    read = _reader(GLUE)
    ops = [("engine.iterate", 0, 9_000), ("engine.apply", 100, 8_000),
           ("engine.accumulate", 100, 200), ("aten::zeros", 110, 190),
           ("engine.layout_copy", 300, 900), ("sptc_spmm_fused", 950, 990),
           ("engine.accumulate", 1_000, 1_100),
           ("engine.accumulate", 2_000, 2_100), ("engine.pad", 8_000, 9_000)]
    assert read(_traced(ops, steps=1)) == 4.0
    assert read(_traced(ops * 2, steps=4)) == 2.0
    # the program declares both spans, and the window holds none
    assert read(_traced([("engine.apply", 0, 10)], steps=3)) == 0.0
    assert read(SimpleNamespace(trace=None,
                                counters={"kind": "solve", "steps": 3})) \
        is None


def test_glue_reader_reads_none_where_the_program_lacks_the_spans(
        monkeypatch):
    from repro_torch.kernels import common
    monkeypatch.setattr(common, "ENGINE_SPANS",
                        ("engine.iterate", "engine.apply", "engine.pad"))
    read = _reader(GLUE)
    ops = [("engine.accumulate", 0, 10), ("engine.layout_copy", 10, 20)]
    assert read(_traced(ops, steps=1)) is None


def test_glue_reader_on_a_profile_of_the_star_engine():
    """The spans the program opens, reduced as the harness reduces a traced
    window: one copy and three adds-or-fills a step of a 2-D star."""
    _sbench()
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.core.engine import StencilEngine
    from repro_torch.core.stencil import make_stencil
    from sbench.trace import WINDOW_SPAN, reduce_events
    eng = StencilEngine(make_stencil("star", 2, 3, seed=3),
                        backend="cuda_sptc", device="cpu")
    x = torch.nn.functional.pad(torch.rand(20, 24), (3,) * 4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(WINDOW_SPAN):
            eng.iterate(x, 5)
    tr = reduce_events(prof.profiler.kineto_results.events())
    read = _reader(GLUE)
    assert read(SimpleNamespace(trace=tr, counters={"kind": "solve",
                                                    "steps": 5})) == 4.0


def test_entries_of_the_cell():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg, = [c for c in bench["configs"] if c["name"] == "star-2d3r"]
    assert cfg["reduced"] == []
    assert cfg["file"] == "spider_bench/configs/star-2d3r.json"
    assert "Star-2D13P, 10240^2 points" in cfg["source"]
    body = json.loads((ROOT / cfg["file"]).read_text())
    assert (body["stencil"], body["ndim"], body["radius"], body["grid"],
            body["dtype"], body["reference"]) == \
        ("star", 2, 3, [10246, 10246], "float32", "stencil")
    cell, = [w for w in bench["workloads"] if w["name"] == CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("star-2d3r", "solve.sptc", 1)
    metrics = {m["name"]: m for m in bench["end_to_end"] + bench["per_layer"]}
    for name in JOINED:
        assert metrics[name]["workloads"][-1] == CELL
    m = metrics[GLUE]
    assert {k: m[k] for k in ("unit", "better", "source", "layer", "moves",
                              "workloads")} == {
        "unit": "ops", "better": "lower", "source": "device_trace",
        "layer": "engine: core/engine.py", "moves": "gstencil_per_s",
        "workloads": [CELL]}
    assert (BENCH / "metrics" / f"{GLUE}.py").is_file()
    assert (BENCH / "limits" / f"{CELL}.json").is_file()
