"""The readers of the program's spans and set-up counters, on traces built
by hand: the host's time per step in ``engine.iterate``, the device idle
time under an ``engine.*`` span, and the set-up counters, which read None
where the program lacks them."""
import importlib.util
import json
import random
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
ALL = ["solve.box-2d1r.sptc", "solve.box-1d2r.sptc", "solve.box-2d1r.tuned"]
NEW = {
    "engine.host_us_per_step.solve": ("us", "device_trace", "gstencil_per_s",
                                      ALL),
    "engine.device_wait_pct.solve": ("%", "device_trace", "gstencil_per_s",
                                     ALL),
    "frontend.lower_s": ("s", "host_clock", "setup_s", ALL),
    "tuner.tune_s": ("s", "host_clock", "setup_s", ["solve.box-2d1r.tuned"]),
    "kernels.load_s": ("s", "host_clock", "setup_s", ALL),
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


def _reader(name):
    _sbench()
    from sbench.layout import Layout
    return Layout(ROOT).reader(name)


def _run(window, device_ops, host_ops, steps=10):
    _sbench()
    from sbench.trace import Trace
    tr = Trace(window=window, device_ops=[("k", s, e) for s, e in device_ops],
               host_ops=list(host_ops))
    return SimpleNamespace(trace=tr, counters={"kind": "solve",
                                               "steps": steps})


@pytest.mark.parametrize("name", sorted(NEW))
def test_entries_of_the_new_metrics(name):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    m = {e["name"]: e for e in bench["per_layer"]}[name]
    unit, source, moves, cells = NEW[name]
    assert (m["unit"], m["source"], m["moves"], m["workloads"]) == \
        (unit, source, moves, cells)
    assert m["better"] == "lower"
    assert (BENCH / "metrics" / f"{name}.py").is_file()


def test_host_us_per_step():
    read = _reader("engine.host_us_per_step.solve")
    run = _run((0, 100_000), [(0, 100_000)], [
        ("solve.chunk", 0, 50_000),
        ("engine.iterate", 1_000, 4_000),
        ("engine.apply", 1_000, 2_000),         # inside it: not counted again
        ("engine.pad", 2_000, 3_000),
        ("engine.iterate", 10_000, 15_000),
        ("aten::constant_pad_nd", 2_000, 3_000),
    ], steps=4)
    # (3000 + 5000) ns over 4 steps
    assert read(run) == pytest.approx(2.0)
    assert read(_run((0, 10), [], [("solve.chunk", 0, 10)])) is None
    assert read(SimpleNamespace(trace=None,
                                counters={"kind": "solve", "steps": 4})) \
        is None


def test_device_wait_counts_idle_time_under_engine_spans_only():
    read = _reader("engine.device_wait_pct.solve")
    run = _run((0, 1000), [(100, 200), (400, 500), (900, 1000)], [
        ("solve.chunk", 0, 1000),                 # the benchmark's span
        ("cudaDeviceSynchronize", 0, 100),        # idle, outside the port
        ("engine.iterate", 150, 450),
        ("engine.pad", 300, 350),                 # nested: counted once
        ("engine.apply", 600, 700),
        ("engine.apply", 650, 800),               # overlapping: counted once
    ])
    # idle (0,100), (200,400), (500,900); under a span 200-400 and 600-800
    assert read(run) == pytest.approx(40.0)


def test_device_wait_adds_up_every_gap():
    read = _reader("engine.device_wait_pct.solve")
    # 25 gaps of 10 ns, each under an engine span: more than the
    # breakdown's ten
    dev = [(20 * i, 20 * i + 10) for i in range(26)]
    run = _run((0, 510), dev, [("engine.iterate", 0, 510)])
    assert read(run) == pytest.approx(100.0 * 250 / 510)


def test_device_wait_reads_0_when_the_host_never_waited_in_a_span():
    read = _reader("engine.device_wait_pct.solve")
    run = _run((0, 1000), [(0, 500)], [("engine.iterate", 100, 400),
                                       ("solve.chunk", 0, 1000)])
    assert read(run) == 0.0
    # no engine span at all: the program opens none
    assert read(_run((0, 1000), [(0, 500)], [("solve.chunk", 0, 1000)])) \
        is None


@pytest.mark.parametrize("seed", range(5))
def test_device_wait_is_part_of_the_idle_share(seed):
    rnd = random.Random(seed)
    dev, host = [], []
    for _ in range(200):                     # device ops inside the window
        s = rnd.randrange(0, 99_000)
        dev.append((s, s + rnd.randrange(1, 800)))
        s = rnd.randrange(0, 100_000)
        host.append((rnd.choice(["engine.iterate", "engine.apply",
                                 "engine.pad", "aten::add"]),
                     s, s + rnd.randrange(1, 3000)))
    run = _run((0, 100_000), dev, host)
    wait = _reader("engine.device_wait_pct.solve")(run)
    idle = _reader("device.idle_pct.solve")(run)
    assert 0.0 <= wait <= idle + 1e-9
    # all the host's time in a span: the wait is the whole idle share
    everywhere = _run((0, 100_000), dev, [("engine.iterate", 0, 100_000)])
    assert wait <= _reader("engine.device_wait_pct.solve")(everywhere) \
        == pytest.approx(idle)


def test_setup_readers_read_the_program_counters(monkeypatch):
    from repro_torch.core import transform
    from repro_torch.kernels import build
    from repro_torch.tuner import cache
    monkeypatch.setattr(transform.lower_spec, "seconds", 0.25)
    monkeypatch.setattr(build.library, "seconds", 1.5)
    stats = SimpleNamespace(tune_s=0.75)
    monkeypatch.setattr(cache, "default_cache",
                        lambda: SimpleNamespace(stats=stats))
    run = SimpleNamespace(trace=None, counters={"kind": "solve"})
    assert _reader("frontend.lower_s")(run) == 0.25
    assert _reader("kernels.load_s")(run) == 1.5
    assert _reader("tuner.tune_s")(run) == 0.75


def test_setup_readers_read_none_where_a_counter_is_absent(monkeypatch):
    from repro_torch.core import transform
    from repro_torch.kernels import build
    from repro_torch.tuner import cache
    run = SimpleNamespace(trace=None, counters={"kind": "solve"})
    # the library was never loaded (a run on the CPU)
    monkeypatch.setattr(build.library, "seconds", None)
    assert _reader("kernels.load_s")(run) is None
    # a program that keeps no such counters
    monkeypatch.delattr(build.library, "seconds")
    monkeypatch.delattr(transform.lower_spec, "seconds")
    monkeypatch.setattr(cache, "default_cache",
                        lambda: SimpleNamespace(stats=SimpleNamespace()))
    assert _reader("kernels.load_s")(run) is None
    assert _reader("frontend.lower_s")(run) is None
    assert _reader("tuner.tune_s")(run) is None
