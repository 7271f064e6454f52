"""Every cell driven on the CPU at a tiny size, past the harness's look for a
card: sound runs are correct, and the lower-precision control and each
fault that a cell can have (a step that leaves its state unchanged, an
answer altered where it is produced) are not.  Then
discovery by name, and what a process running the benchmark imports."""
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SEED = 2 ** 31 + 977

SMALL = {
    "solve.box-2d1r.sptc": {"config": {"grid": [98, 98]}},
    "solve.box-2d1r.tuned": {"config": {"grid": [98, 98]}},
    "solve.box-1d2r.sptc": {"config": {"grid": [2052]}},
}


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


def _run(workload, root=ROOT, control=None, seconds=0.3, overrides=None):
    _sbench()
    from sbench.harness import run_cell
    return run_cell(root, workload, SEED, seconds, False, device="cpu",
                    overrides=SMALL[workload] if overrides is None
                    else overrides, control=control)


@pytest.mark.parametrize("workload", list(SMALL))
def test_cell_runs_correct(workload):
    r = _run(workload)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    names = set(r["metrics"])
    assert "setup_s" in names
    assert "gstencil_per_s" in names
    assert all(v["value"] > 0 for v in r["metrics"].values())


@pytest.mark.parametrize("control", ["tf32", "bfloat16"])
@pytest.mark.parametrize("workload", list(SMALL))
def test_control_fails(workload, control):
    r = _run(workload, control=control)
    assert not r["correct"]
    (name, c), = r["checks"].items()
    assert c["value"] > c["limit"]


@pytest.mark.parametrize("workload", list(SMALL))
def test_step_that_leaves_its_state_unchanged_fails(workload, monkeypatch):
    from repro_torch.core.engine import StencilEngine

    def unchanged(self, x):
        r = self.spec.radius
        return x[(slice(r, -r),) * x.dim()].clone()
    monkeypatch.setattr(StencilEngine, "__call__", unchanged)
    assert not _run(workload)["correct"]


@pytest.mark.parametrize("workload", list(SMALL))
def test_answer_altered_where_produced_fails(workload, monkeypatch):
    from repro_torch.core.engine import StencilEngine
    call = StencilEngine.__call__

    def altered(self, x):
        y = call(self, x).clone(memory_format=torch.contiguous_format)
        y.view(-1)[y.numel() // 2] += 1e-3 * float(y.abs().max())
        return y
    monkeypatch.setattr(StencilEngine, "__call__", altered)
    assert not _run(workload)["correct"]


def test_a_new_configuration_traffic_and_metric_are_found_by_name(tmp_path):
    """Files and entries alone: no line of the harness changes."""
    root = tmp_path / "checkout"
    (root / "spider_bench").mkdir(parents=True)
    shutil.copy(ROOT / "BENCHMARK.json", root)
    for sub in ("configs", "traffic", "limits", "metrics", "reference"):
        shutil.copytree(BENCH / sub, root / "spider_bench" / sub)
    d = root / "spider_bench"
    (d / "configs" / "star-2d1r.json").write_text(json.dumps({
        "stencil": "star", "ndim": 2, "radius": 1, "grid": [66, 66],
        "dtype": "float32", "reference": "stencil"}))
    (d / "traffic" / "solve.direct.json").write_text(json.dumps({
        "kind": "solve", "entry": "engine", "backend": "cuda_direct",
        "steps_per_chunk": 4, "warmup_chunks": 1, "sampled_chunks": 2}))
    (d / "limits" / "solve.star-2d1r.direct.json").write_text(json.dumps({
        "chunk_rel_err": {"limit": 3e-5}}))
    (d / "metrics" / "steps_done.py").write_text(
        "def read(run):\n    return run.counters['steps']\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "star-2d1r", "source": "test",
                             "file": "spider_bench/configs/star-2d1r.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "solve.star-2d1r.direct",
                               "config": "star-2d1r",
                               "traffic": "solve.direct", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "steps_done", "unit": "steps",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["solve.star-2d1r.direct"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = _run("solve.star-2d1r.direct", root=root, overrides={})
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"steps_done", "setup_s"}
    assert r["metrics"]["steps_done"]["value"] % 4 == 0


def _python(code, **env):
    return subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"), **env})


def test_no_module_of_jax_or_its_package_is_loaded():
    """Every cell's kind, every reader and the reference, in a fresh process
    as the benchmark runs them; top-level names compared whole."""
    code = f"""
import json, sys
sys.path.insert(0, {str(BENCH)!r})
from pathlib import Path
from sbench.harness import run_cell
from sbench.layout import forbidden_modules
small = json.loads({json.dumps(json.dumps(SMALL))})
for w, ov in small.items():
    for traced in (False, True):
        from sbench.layout import Layout, readers
        readers(Layout(Path({str(ROOT)!r})), w, traced)
    run_cell(Path({str(ROOT)!r}), w, 5, 0.1, False, device="cpu", overrides=ov)
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps({{"forbidden": forbidden_modules(sys.modules), "tops": tops}}))
"""
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["forbidden"] == []
    assert "repro_torch" in got["tops"] and "sbench" in got["tops"]


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "spider_bench/run.py", "--workload",
         "solve.box-2d1r.sptc", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
    assert "CUDA device" in out.stderr
