"""Where the benchmark finds each part by the name ``BENCHMARK.json`` gives.

    configs/<file named by the configuration's entry>   sizes, as run
    traffic/<traffic>.json                               a mix's parameters
    limits/<workload>.json                               the limits of a cell
    metrics/<metric>.py                                  a metric's reader
    reference/<name>.py                                  a plain reference

Nothing here lists a configuration, a mix or a metric: adding one is adding
its files and its entries.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Tuple

FOLDER = "spider_bench"
# whole top-level module names the process may never hold: JAX and the JAX
# package this port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names) -> List[str]:
    """The FORBIDDEN top-level names among module ``names`` (whole names:
    ``repro_torch`` is not ``repro``)."""
    tops = {n.split(".", 1)[0] for n in names}
    return sorted(tops.intersection(FORBIDDEN))


def _load(path: Path, prefix: str) -> ModuleType:
    name = prefix + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Layout:
    """The benchmark of the checkout at ``root``."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.dir = self.root / FOLDER
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"BENCHMARK.json has no config {name!r}")

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def limits(self, workload: str) -> Dict[str, dict]:
        return json.loads((self.dir / "limits" / f"{workload}.json")
                          .read_text())

    def metrics(self, workload: str, trace: bool) -> List[dict]:
        """The metrics a run of ``workload`` reports: its end-to-end ones,
        or with ``trace`` its per-layer ones."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if workload in m.get("workloads", [workload])]

    def reader(self, metric: str) -> Callable:
        return _load(self.dir / "metrics" / f"{metric}.py",
                     "spider_bench_metric_").read

    def reference(self, name: str) -> ModuleType:
        return _load(self.dir / "reference" / f"{name}.py",
                     "spider_bench_reference_")


def readers(layout: Layout, workload: str, trace: bool
            ) -> List[Tuple[dict, Callable]]:
    return [(m, layout.reader(m["name"]))
            for m in layout.metrics(workload, trace)]
