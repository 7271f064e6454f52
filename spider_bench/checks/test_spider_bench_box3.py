"""The 7 x 7 box cell, ``solve.box-2d3r.sptc``, on the CPU at a tiny size:
sound runs are correct, the lower-precision controls and faults planted in
the rows wrapper the in-place step calls are not.  Then the reference by
hand on a radius-3 box, the reader of the rows kernel's time per row op
(on traces and counters built by hand) and the cell's entries in
``BENCHMARK.json``."""
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
SEED = 2 ** 31 + 8209
CELL = "solve.box-2d3r.sptc"
SMALL = {"config": {"grid": [70, 70]}}
PER_ROW_OP = "kernels.rows2d_us_per_row_op.solve"
JOINED = ("gstencil_per_s", "engine.outside_kernel_pct.solve",
          "engine.launches_per_step", "stencil_kernels_roofline.solve",
          "device.idle_pct.solve", "engine.in_place_pct.solve")
KERNEL = "void spider::rows2d::sptc_rows2d_kernel<float, 0, 2>(Params)"


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


def _traced(device_ops, kind="solve"):
    _sbench()
    from sbench.trace import Trace
    tr = Trace(window=(0, 100_000), device_ops=list(device_ops), host_ops=[])
    return SimpleNamespace(trace=tr, counters={"kind": kind, "steps": 10})


def test_cell_runs_correct():
    from repro_torch.core.engine import StencilEngine
    done = StencilEngine.iterate.steps_in_place
    r = _run()
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert StencilEngine.iterate.steps_in_place > done
    assert {"setup_s", "gstencil_per_s"} <= set(r["metrics"])
    assert all(v["value"] > 0 for v in r["metrics"].values())


@pytest.mark.parametrize("control", ["tf32", "bfloat16"])
def test_control_fails(control):
    r = _run(control=control)
    assert not r["correct"]
    (name, c), = r["checks"].items()
    assert c["value"] > c["limit"]


def _plant(monkeypatch, fault):
    """Put ``fault(real, gop, xs, out)`` in the place of the rows wrapper
    the engine's step calls (looked up as the engine is built), and return
    a function that says how many steps ``iterate`` wrote in place since."""
    from repro_torch.core import engine
    real = engine.GRID_WRAPPERS["sptc_spmm_rows2d"]

    def planted(gop, xs, *, out=None):
        return fault(real, gop, xs, out)
    monkeypatch.setitem(engine.GRID_WRAPPERS, "sptc_spmm_rows2d", planted)
    done = engine.StencilEngine.iterate.steps_in_place
    return lambda: engine.StencilEngine.iterate.steps_in_place - done


def test_step_that_leaves_its_state_unchanged_fails(monkeypatch):
    def unchanged(real, gop, xs, out):
        h = gop.halo // 2
        return out.copy_(xs[:, h:-h, h:-h])
    in_place = _plant(monkeypatch, unchanged)
    assert not _run()["correct"]
    assert in_place() > 0


def test_answer_altered_where_produced_fails(monkeypatch):
    def altered(real, gop, xs, out):
        y = real(gop, xs, out=out)
        y[0, y.shape[1] // 2, y.shape[2] // 2] += 1e-3 * float(y.abs().max())
        return y
    in_place = _plant(monkeypatch, altered)
    assert not _run()["correct"]
    assert in_place() > 0


def test_reference_2d_radius_3_box_by_hand():
    _sbench()
    from sbench.layout import _load
    ref = _load(BENCH / "reference" / "stencil.py", "spider_bench_reference_")
    raw = np.arange(1.0, 50.0).reshape(7, 7)
    w = ref.normalised_weights(raw, "box")
    assert ref.taps(w) == 49
    np.testing.assert_allclose(w.sum(), 1.0)
    x = torch.arange(81.0).reshape(9, 9) ** 1.5
    y = ref.apply_valid(w, x)
    assert y.shape == (3, 3)
    for i in range(3):
        for j in range(3):
            want = sum(raw[a, b] * float(x[i + a, j + b])
                       for a in range(7) for b in range(7))
            assert float(y[i, j]) == pytest.approx(want / raw.sum(),
                                                   rel=1e-12)


def test_per_row_op_reader_on_traces_and_counters_built_by_hand(
        monkeypatch):
    from repro_torch.kernels.sptc_spmm import ops
    read = _reader(PER_ROW_OP)
    monkeypatch.setattr(ops.sptc_spmm_rows2d, "launches", 12)
    monkeypatch.setattr(ops.sptc_spmm_rows2d, "row_ops", 84)   # 7 a launch
    dev = [(KERNEL, 0, 7_000), ("elementwise_kernel", 7_000, 9_000),
           (KERNEL, 9_000, 23_000), (KERNEL, 23_000, 44_000)]
    # 42,000 ns of three launches, 21 row ops
    assert read(_traced(dev)) == pytest.approx(2.0)
    monkeypatch.setattr(ops.sptc_spmm_rows2d, "row_ops", 36)   # 3 a launch
    assert read(_traced(dev)) == pytest.approx(42.0 / 9)
    # no rows kernel in the window, no trace, no solve run
    assert read(_traced([("stencil2d_kernel", 0, 5_000)])) is None
    assert read(SimpleNamespace(trace=None,
                                counters={"kind": "solve", "steps": 3})) \
        is None
    assert read(_traced(dev, kind="serve")) is None


def test_per_row_op_reader_reads_none_without_the_counter(monkeypatch):
    from repro_torch.kernels.sptc_spmm import ops
    read = _reader(PER_ROW_OP)
    monkeypatch.setattr(ops.sptc_spmm_rows2d, "launches", 12)
    monkeypatch.delattr(ops.sptc_spmm_rows2d, "row_ops")
    assert read(_traced([(KERNEL, 0, 7_000)])) is None


def test_entries_of_the_cell():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg, = [c for c in bench["configs"] if c["name"] == "box-2d3r"]
    assert cfg["reduced"] == []
    assert cfg["file"] == "spider_bench/configs/box-2d3r.json"
    assert "Box-2D49P, 10240^2 points" in cfg["source"]
    body = json.loads((ROOT / cfg["file"]).read_text())
    assert (body["stencil"], body["ndim"], body["radius"], body["grid"],
            body["dtype"], body["reference"]) == \
        ("box", 2, 3, [10246, 10246], "float32", "stencil")
    cell, = [w for w in bench["workloads"] if w["name"] == CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("box-2d3r", "solve.sptc", 1)
    metrics = {m["name"]: m for m in bench["end_to_end"] + bench["per_layer"]}
    # membership alone: a later cell is appended after this one
    for name in JOINED:
        assert CELL in metrics[name]["workloads"]
    m = metrics[PER_ROW_OP]
    assert {k: m[k] for k in ("unit", "better", "source", "layer",
                              "moves")} == {
        "unit": "us", "better": "lower", "source": "device_trace",
        "layer": "kernels: kernels/csrc/*.cu", "moves": "gstencil_per_s"}
    assert {"solve.box-2d1r.sptc", CELL} <= set(m["workloads"])
    assert (BENCH / "metrics" / f"{PER_ROW_OP}.py").is_file()
    limits = json.loads((BENCH / "limits" / f"{CELL}.json").read_text())
    c = limits["chunk_rel_err"]
    assert 16 * c["lower"] <= c["limit"] <= c["upper"] / 16
