"""The port's verifier (``repro_torch.vet``) against the reference's
(``repro.vet``), on the CPU.

Invariants: both sweeps are clean, and each injected fault of the
reference's tests, pushed through both ``verify_kernel``s, gives the same
rule ids.  Rules: the copied rules give the reference's findings on its
fixture corpus; the retargeted ones flag torch idioms.  Launch audit (the
kernels' plain versions inside their profiler regions): products equal the
reference's dots and fused regions its ``pallas_call``s probe by probe,
neither reports a finding, and a tightened budget, a planted gather, the v1
path and a planted per-call upload each produce theirs.  CLI: exit codes,
JSON shape, baseline mechanics, and a run that imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from repro.vet import code as ref_code
from repro.vet import invariants as ref_invariants
from repro.vet import lowering as ref_lowering
from repro.vet.config import VetConfig as RefVetConfig
from repro.vet.config import load_config as ref_load_config
from repro.vet.rules import (LockDisciplineRule as RefLockDisciplineRule,
                             LockedSuffixRule as RefLockedSuffixRule,
                             NondetKeyRule as RefNondetKeyRule)
from repro_torch.core import StencilEngine, make_stencil, paper_suite
from repro_torch.core.engine import kernel_launches
from repro_torch.kernels.common import region
from repro_torch.vet import code as vet_code
from repro_torch.vet import invariants, lowering
from repro_torch.vet.baseline import Baseline
from repro_torch.vet.cli import main as vet_main
from repro_torch.vet.config import DEFAULT_BASELINE, VetConfig
from repro_torch.vet.rules import (LockDisciplineRule, LockedSuffixRule,
                                   NondetKeyRule)

REPO = Path(__file__).resolve().parent.parent
FIXTURES = Path(__file__).resolve().parent / "vet_fixtures"
CPU = torch.device("cpu")


def cfg_for(root: Path) -> VetConfig:
    cfg = VetConfig()
    cfg.root = root
    return cfg


# ---------------------------------------------------------------------------
# invariants
# ---------------------------------------------------------------------------

def test_both_invariant_sweeps_are_clean():
    ref_cfg, cfg = RefVetConfig(), VetConfig()
    ref_cfg.invariant_radii = cfg.invariant_radii = [1, 2]
    assert ref_invariants.run(ref_cfg) == []
    assert invariants.run(cfg) == []


def test_sweep_points_match_the_reference():
    ref_pts = list(ref_invariants.sweep_points(RefVetConfig()))
    pts = list(invariants.sweep_points(VetConfig()))
    assert [(L, s) for _, L, s in pts] == [(L, s) for _, L, s in ref_pts]
    for (w, _, _), (rw, _, _) in zip(pts, ref_pts):
        np.testing.assert_array_equal(w, rw)


def test_plan_probes_cover_the_kernel_backends():
    symbols = [s for _, s in invariants.plan_probes(VetConfig())]
    for b in ("cuda_direct", "cuda_gemm", "cuda_sptc"):
        assert f"star-2d1r/{b}" in symbols and f"box-2d3r/{b}" in symbols
    ref_symbols = {s for _, s in ref_invariants.plan_probes(RefVetConfig())}
    assert ref_symbols <= set(symbols)


def _swap_meta(sp):
    meta = np.asarray(sp.meta).copy()
    meta[0, 0], meta[0, 1] = meta[0, 1], meta[0, 0]
    return dataclasses.replace(sp, meta=meta)


def _bump_value(sp):
    vals = np.asarray(sp.values).copy()
    vals[0, 0] += 1.0
    return dataclasses.replace(sp, values=vals)


def _off_band(K):
    K = np.array(K)
    K[0, -1] = 7.0
    return K


def _swap_first_pair(perm):
    perm = np.array(perm)
    perm[0], perm[1] = perm[1], perm[0]
    return perm


def _dense_segment(Kp):
    Kp = np.array(Kp)
    Kp[0, :3] = 1.0
    return Kp


#: (fault, the stage it corrupts, corruption) — the injections of the
#: reference's tests/test_vet.py, pushed through verify_kernel
FAULTS = [
    ("band", "kernel_matrix", _off_band),
    ("permutation", "strided_swap_perm", _swap_first_pair),
    ("dense-segment", "apply_col_perm", _dense_segment),
    ("metadata", "encode_24", _swap_meta),
    ("values", "encode_24", _bump_value),
]


@pytest.mark.parametrize("fault,stage,corrupt", FAULTS,
                         ids=[f[0] for f in FAULTS])
def test_injected_fault_gives_the_reference_rules(monkeypatch, fault, stage,
                                                  corrupt):
    w = np.random.default_rng(3).normal(size=3)
    rules = []
    for mod, cfg in ((ref_invariants, RefVetConfig()),
                     (invariants, VetConfig())):
        kept = getattr(mod, stage)
        monkeypatch.setattr(mod, stage,
                            lambda *a, _k=kept, **kw: corrupt(_k(*a, **kw)))
        rules.append(sorted({f.rule for f in
                             mod.verify_kernel(cfg, w, 4, "inj")}))
    assert rules[0] == rules[1] and rules[1], (fault, rules)


def test_plan_stage_check_knows_the_kernel_backends():
    from repro_torch.core.transform import lower_spec
    spec = make_stencil("box", 2, 1, seed=0)
    for backend in ("cuda_direct", "cuda_gemm", "cuda_sptc"):
        plan = lower_spec(spec, backend=backend)
        assert invariants.check_lowered_plan(VetConfig(), plan, backend) == []
    # a dense kernel's emit on the sparse family's stages
    bad = dataclasses.replace(
        lower_spec(spec, backend="cuda_sptc"),
        stages=lower_spec(spec, backend="cuda_sptc").stages[:-1]
        + (lower_spec(spec, backend="cuda_gemm").emit,))
    fs = invariants.check_lowered_plan(VetConfig(), bad, "bad")
    assert [f.rule for f in fs] == ["invariant-plan-stages"]


# ---------------------------------------------------------------------------
# code rules
# ---------------------------------------------------------------------------

FIXTURE_FILES = sorted(p.relative_to(FIXTURES).as_posix()
                       for p in FIXTURES.rglob("*.py"))
COPIED_RULES = [(RefLockDisciplineRule, LockDisciplineRule),
                (RefLockedSuffixRule, LockedSuffixRule),
                (RefNondetKeyRule, NondetKeyRule)]


@pytest.mark.parametrize("rel", FIXTURE_FILES)
@pytest.mark.parametrize("ref_rule,rule", COPIED_RULES,
                         ids=[r.rule_id for _, r in COPIED_RULES])
def test_copied_rule_matches_the_reference_on_fixtures(rel, ref_rule, rule):
    ref_cfg = RefVetConfig()
    ref_cfg.root = FIXTURES
    want = ref_code.check_file(ref_cfg, FIXTURES / rel, rules=[ref_rule()])
    got = vet_code.check_file(cfg_for(FIXTURES), FIXTURES / rel,
                              rules=[rule()])
    assert [f.to_dict() for f in got] == [f.to_dict() for f in want]


HOST_SYNC_BAD = '''
import numpy as np
import torch


class Driver:
    def submit(self, spec, x):
        return x.cpu()                       # device->host copy

    def _run_batch(self, key, jobs):
        ys = [j * 2 for j in jobs]
        n = ys[0].sum().item()               # scalar pull
        rows = ys[0].tolist()
        torch.cuda.synchronize()
        torch.cuda.current_stream().synchronize()
        host = np.asarray(ys[1])
        arr = ys[1].numpy()
        return ys, n, rows, host, arr, float(ys[0].max())
'''
HOST_SYNC_CLEAN = '''
import torch


class Driver:
    def submit(self, spec, x):
        return torch.as_tensor(x, device="cuda")   # host -> device, no wait

    def _run_batch(self, key, jobs):
        return [j * 2 for j in jobs], float(3)

    def report(self):
        # cold path: syncing here is fine (not a hot-path function)
        torch.cuda.synchronize()
        return self._last.cpu().tolist()
'''
JIT_BAD = '''
import torch
from repro_torch.kernels import build


class Driver:
    def _run_batch(self, key, jobs):
        fn = torch.compile(lambda x: x * 2)     # recompiles per batch
        build.build()                           # nvcc per batch
        return [fn(j) for j in jobs]

    def drain(self):
        for j in self.jobs:
            torch.jit.trace(self.f, j)          # per iteration
'''
JIT_CLEAN = '''
import torch

_CACHE = {}


class Driver:
    def __init__(self, f):
        self._fn = torch.compile(f)             # once per driver

    def _run_batch(self, key, jobs):
        fn = _CACHE.get(key)
        if fn is None:
            fn = torch.jit.script(self.f)
            _CACHE[key] = fn                    # memoized
        return [fn(j) for j in jobs]
'''

RETARGETED = [("code-host-sync", HOST_SYNC_BAD, HOST_SYNC_CLEAN, 8),
              ("code-jit-per-call", JIT_BAD, JIT_CLEAN, 3)]


@pytest.mark.parametrize("rule,bad,clean,n", RETARGETED,
                         ids=[r[0] for r in RETARGETED])
def test_retargeted_rule_flags_torch_idioms(tmp_path, rule, bad, clean, n):
    hot = tmp_path / "serving"
    hot.mkdir()
    (hot / "bad.py").write_text(bad)
    (hot / "clean.py").write_text(clean)
    cfg = cfg_for(tmp_path)
    hits = [f for f in vet_code.check_file(cfg, hot / "bad.py")
            if f.rule == rule]
    assert len(hits) == n, [f.format() for f in hits]
    assert all(f.line > 0 and f.symbol and f.path == "serving/bad.py"
               for f in hits)
    assert vet_code.check_file(cfg, hot / "clean.py") == []
    cold = tmp_path / "models" / "bad.py"         # outside the hot modules
    cold.parent.mkdir()
    cold.write_text(bad)
    assert vet_code.check_file(cfg, cold) == []


def test_code_walk_skips_build_dirs_below_the_tree_only(tmp_path):
    tree = tmp_path / "build" / "checkout"      # a checkout under build/
    (tree / "serving").mkdir(parents=True)
    (tree / "serving" / "bad.py").write_text(JIT_BAD)
    (tree / "build").mkdir()
    (tree / "build" / "generated.py").write_text(JIT_BAD)
    assert list(vet_code.iter_py_files([tree])) == [
        tree / "serving" / "bad.py"]
    rules = {f.rule for f in vet_code.run(cfg_for(tree), [tree])}
    assert rules == {"code-jit-per-call"}


def test_shipped_tree_passes_code_analyzer_modulo_baseline():
    cfg = cfg_for(REPO)
    findings = vet_code.run(cfg, [REPO / "src" / "repro_torch"])
    new, suppressed, unused = Baseline.load(cfg.baseline_path()).split(
        findings)
    assert new == [] and unused == [], [f.format() for f in new]
    assert {f.symbol for f in suppressed} == {
        "GenerateDriver._run_batch", "StencilDriver._run_batch"}
    assert all(e.reason and not e.reason.startswith("TODO")
               for e in Baseline.load(DEFAULT_BASELINE).entries)


def test_config_defaults_equal_the_reference_block():
    ref = ref_load_config(pyproject=REPO / "pyproject.toml")
    cfg = VetConfig()
    assert cfg.baseline_path() == DEFAULT_BASELINE
    assert cfg.hot_path_modules == ref.hot_path_modules
    assert cfg.invariant_radii == ref.invariant_radii
    assert cfg.lowering_backends == ref.lowering_backends
    for rule in ("code-host-sync", "invariant-24", "pallas-fused-gather"):
        assert cfg.severity_of(rule) == ref.severity_of(rule)
    for b in ("gemm", "sptc"):
        assert cfg.lowering_budgets[b]["gather"] == \
            ref.lowering_budgets[b]["gather"]
    assert cfg.lowering_budgets["cuda_sptc"]["gather"] == \
        ref.lowering_budgets["pallas_sptc"]["gather"]


def test_relative_baseline_is_anchored_at_the_root(tmp_path):
    cfg = cfg_for(tmp_path)
    cfg.baseline = "ours.json"
    assert cfg.baseline_path() == tmp_path / "ours.json"
    cfg.baseline = str(DEFAULT_BASELINE)
    assert cfg.baseline_path() == DEFAULT_BASELINE


# ---------------------------------------------------------------------------
# launch audit
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_run():
    return lowering.run(VetConfig(), device="cpu")


@pytest.mark.parametrize("backend", ["gemm", "sptc"])
def test_products_equal_the_reference_dots(backend):
    ref_fs, ref_probes = ref_lowering.analyze_backend(RefVetConfig(), backend)
    fs, probes = lowering.analyze_backend(VetConfig(), backend, CPU)
    assert ref_fs == [] and fs == [], [f.format() for f in fs]
    assert sorted(probes) == sorted(ref_probes)
    for sym in probes:
        assert probes[sym]["products"] == ref_probes[sym]["dot"], sym
        assert probes[sym]["scatters"] == 0 and probes[sym]["uploads"] == 0


def test_fused_regions_equal_the_reference_pallas_calls():
    # one program per reference pallas_call, except on a 2-D grid: a box's
    # R pallas_calls (one per row op) are the one sptc_spmm_rows2d launch;
    # on the card a star's two (one per axis) are the one sptc_spmm_star2d
    # launch, on the CPU they stay its two
    ref_fs, ref_probes = ref_lowering.analyze_pallas_fused(RefVetConfig())
    fs, probes = lowering.analyze_fused(VetConfig(), CPU)
    assert ref_fs == [] and fs == [], [f.format() for f in fs]
    assert sorted(probes) == sorted(ref_probes)
    for (shape_kind, ndim, radius), _ in lowering.PALLAS_PROBES:
        spec = make_stencil(shape_kind, ndim, radius, seed=7)
        sym = f"{lowering.FUSED_KERNEL}/{spec.name}"
        napps = lowering.n_applications(spec, fused=False)
        assert ref_probes[sym]["pallas_call"] == napps, sym
        want = ({"sptc_spmm_rows2d": 1} if shape_kind == "box"
                else {lowering.FUSED_KERNEL: napps})
        card = ({"sptc_spmm_rows2d": 1} if shape_kind == "box"
                else {"sptc_spmm_star2d": 1})
        assert lowering.fused_programs(spec, CPU) == want, sym
        assert lowering.fused_programs(spec) == card, sym
        assert probes[sym]["programs"] == sum(want.values()), sym
        assert probes[sym]["gathers"] == ref_probes[sym]["gather"] == 0


def test_shipped_engines_certify_zero_overhead(port_run):
    ref_fs, _ = ref_lowering.run(RefVetConfig())
    findings, verdict = port_run
    assert ref_fs == [] and findings == [], [f.format() for f in findings]
    assert set(verdict) == {"stencil_gemm", "sptc_spmm", "sptc_spmm_fused",
                            "sharded_halo"}
    for kernel, v in verdict.items():
        assert v["certified"], (kernel, v)
        if kernel != "sharded_halo":
            assert v["rebuild"] == {"same_sequence": True, "uploads": 0}
    for sym, c in verdict["sptc_spmm"]["probes"].items():
        assert c["gathers"] <= c["products"], (sym, c)  # the window read
    gemm = {k.split("/", 1)[1]: v
            for k, v in verdict["stencil_gemm"]["probes"].items()}
    sptc = {k.split("/", 1)[1]: v
            for k, v in verdict["sptc_spmm"]["probes"].items()}
    for probe in gemm:     # sparse parity: <=, not ==
        assert sptc[probe]["gathers"] + sptc[probe]["copies"] <= \
            gemm[probe]["gathers"] + gemm[probe]["copies"]


@pytest.mark.parametrize("spec_args", [("star", 2, 1), ("box", 2, 1),
                                       ("star", 1, 2), ("box", 2, 3),
                                       ("box", 3, 1)])
def test_n_applications_matches_the_reference(spec_args):
    from repro.core.stencil import make_stencil as ref_make_stencil
    ref_spec = ref_make_stencil(*spec_args, seed=0)
    spec = make_stencil(*spec_args, seed=0)
    for fused in (False, True):
        assert lowering.n_applications(spec, fused) == \
            ref_lowering.n_applications(ref_spec, fused)


def test_tightened_budget_produces_findings():
    cfg = VetConfig()
    cfg.lowering_backends = ["sptc"]
    cfg.lowering_budgets["sptc"]["gather"] = 0      # forbid the window read
    findings, verdict = lowering.run(cfg, device="cpu")
    assert any(f.rule == "lowering-hot-gather" for f in findings)
    assert not verdict["sptc_spmm"]["certified"]


def test_fused_budget_violation_produces_finding():
    cfg = VetConfig()
    cfg.lowering_budgets["cuda_sptc"]["gather"] = -1
    findings, _ = lowering.analyze_fused(cfg, CPU)
    assert any(f.rule == "pallas-fused-gather" for f in findings)


def test_sparse_parity_pairs_probes_by_name():
    base = dict.fromkeys(("gathers", "copies", "scatters"), 0)
    dense = {"stencil_gemm/a": dict(base), "stencil_gemm/b": dict(base)}
    sparse = {"sptc_spmm/b": dict(base, gathers=1),
              "sptc_spmm/a": dict(base)}
    fs = lowering.sparse_parity(VetConfig(), dense, sparse)
    assert [(f.rule, f.symbol) for f in fs] == [
        ("lowering-sparse-parity", "sptc_spmm/b")]
    del sparse["sptc_spmm/a"]
    with pytest.raises(ValueError, match="same probes"):
        lowering.sparse_parity(VetConfig(), dense, sparse)


def test_wrong_output_is_flagged():
    spec = make_stencil("box", 2, 1, seed=7)
    engine = StencilEngine(spec, "cuda_sptc", device="cpu")
    x = lowering.probe_input((22, 22), CPU)
    fs, _, _ = lowering.audit_fused(VetConfig(), lambda x: engine(x) * 0.5,
                                    spec, x, "half")
    assert [f.rule for f in fs] == ["launch-output-mismatch"]
    nan = lambda x: engine(x) * float("nan")                    # noqa: E731
    assert lowering.check_output(VetConfig(), "nan", nan(x), spec, x)[1] \
        == float("inf")


def test_card_audit_walks_into_regions():
    # on the card a region holds only its launch, so a torch op inside it is
    # outside work; on the CPU the region holds the plain version
    def hidden(x):
        with region("sptc_spmm_fused"):
            with region("sptc_spmm_fused"):
                pass
            return x[torch.arange(x.shape[0])]

    x = lowering.probe_input((8, 8), CPU)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        hidden(x)
    cpu = lowering._summarize(prof.events(), on_card=False)
    card = lowering._summarize(prof.events(), on_card=True)
    assert cpu.counts["gathers"] == 0 and card.counts["gathers"] == 1
    assert cpu.regions == card.regions == {"sptc_spmm_fused": 1}
    assert card.counts["programs"] == 1 and card.counts["kernels"] == 0


def test_card_audit_skips_the_trace_markers():
    # a card trace opens with spin kernels that mark it complete; they are
    # no work of the call
    def dev(name, t):
        return SimpleNamespace(name=name, device_type=DeviceType.CUDA,
                               is_user_annotation=False,
                               time_range=SimpleNamespace(start=t, end=t + 5))
    events = [dev("at::cuda::(anonymous namespace)::spin_kernel(long)", 0),
              dev("at::cuda::(anonymous namespace)::spin_kernel(long)", 10),
              dev("void spider::sptc_mma_kernel<float, 0, false, 2>", 20),
              dev("Memset (Device)", 30)]
    a = lowering._summarize(events, on_card=True)
    assert a.counts["kernels"] == 1 and a.counts["device_ops"] == 1
    assert a.device_ms == {"kernel": 0.005, "outside": 0.005}
    assert not any(lowering.is_marker(SimpleNamespace(name=n))
                   for n in a.sequence)


class _StubTraces:
    """Stands in for ``torch.profiler.profile`` on the card: every trace
    holds ``per_call`` region kernels between two lead marker spins and the
    long tail spin, but the traces numbered in ``lose`` have lost their
    head, lead markers included, those in ``lose_tail`` their tail spin,
    and those in ``lose_middle`` one region kernel between the ends."""

    def __init__(self, per_call: int, lose=(), lose_tail=(), lose_middle=()):
        self.per_call, self.lose, self.taken = per_call, set(lose), 0
        self.lose_tail, self.lose_middle = set(lose_tail), set(lose_middle)

    def __call__(self, activities):
        return self

    def __enter__(self):
        self.taken += 1
        return self

    def __exit__(self, *exc):
        return False

    def events(self):
        def dev(name, t, us=5):
            return SimpleNamespace(
                name=name, device_type=DeviceType.CUDA,
                is_user_annotation=False,
                time_range=SimpleNamespace(start=t, end=t + us))
        kernels = [dev("void spider::sptc_mma_kernel<float, 0, false, 2>",
                       10 * (i + 2)) for i in range(self.per_call)]
        if self.taken in self.lose_middle:
            del kernels[len(kernels) // 2]
        tail = [] if self.taken in self.lose_tail else [
            dev("spin_kernel", 10 * (self.per_call + 2), us=60)]
        if self.taken in self.lose:
            return kernels[1:] + tail             # the head of the trace
        return [dev("spin_kernel", 0), dev("spin_kernel", 10)] + kernels \
            + tail


def _stub_card(monkeypatch, traces: _StubTraces):
    """``lowering``'s card traces on the CPU: the profiler and the CUDA
    calls around it stubbed; returns an input whose device is "cuda"."""
    import contextlib
    monkeypatch.setattr(lowering, "profile", traces)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    return SimpleNamespace(device=SimpleNamespace(type="cuda"))


@pytest.mark.parametrize("lose,planted,attempts", [
    ((), False, 1), ((1,), False, 2), ((1, 2), False, 3), ((), True, 2),
    ((2,), True, 3)])
def test_retaken_trace_counts_every_launch(monkeypatch, lose, planted,
                                           attempts):
    """A card trace that lost its markers is taken again, which runs the
    call again: an audited call (a warm-up, then the traced runs) makes
    ``(1 + attempts) * per_call`` launches, and the trace kept counts
    ``per_call`` kernels.  ``planted_lost_head`` hides the markers of the
    first trace, so it is retaken as a lost one is."""
    import contextlib
    per_call, launches = 3, []
    traces = _StubTraces(per_call, lose)
    x = _stub_card(monkeypatch, traces)
    before = dict(lowering.TRACE_STATS)

    def call(_x):                  # a wrapper's launch counter, per call
        launches.append(per_call)
        return len(launches)
    with lowering.planted_lost_head() if planted else \
            contextlib.nullcontext():
        a = lowering.audit_call(call, x)
    assert a.attempts == attempts == traces.taken
    assert sum(launches) == (1 + a.attempts) * per_call
    assert a.out == 1 + a.attempts                # the kept trace's call
    assert a.counts["kernels"] == per_call and a.counts["device_ops"] == 0
    assert lowering.TRACE_STATS["traces"] - before["traces"] == attempts
    assert lowering.TRACE_STATS["retaken"] - before["retaken"] == attempts - 1
    assert lowering.is_marker(SimpleNamespace(name="spin_kernel"))


def test_retake_doubles_the_lead_spins(monkeypatch):
    """Every card trace opens with ``LEAD_SPINS`` short spins and closes
    with one long tail spin after the call; each retake doubles the lead
    spins, so a head loss that grows with the card's load is outrun."""
    traces = _StubTraces(2, lose=(1, 2))
    x = _stub_card(monkeypatch, traces)
    spins = [[]]
    monkeypatch.setattr(torch.cuda, "_sleep", lambda c: spins[-1].append(c))
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: spins.append([]))
    a = lowering.profile_call(lambda _x: None, x)
    assert a.attempts == 3
    bursts = [b for b in spins if b]
    n, c = lowering.LEAD_SPINS, lowering.LEAD_CYCLES
    t = [lowering.TAIL_CYCLES]
    assert bursts == [[c] * n, t, [c] * 2 * n, t, [c] * 4 * n, t]


def test_trace_that_keeps_losing_its_head_raises(monkeypatch):
    traces = _StubTraces(2, lose=range(1, lowering.TRACE_ATTEMPTS + 1))
    x = _stub_card(monkeypatch, traces)
    calls = []
    with pytest.raises(RuntimeError, match="lost the head"):
        lowering.profile_call(lambda _x: calls.append(1), x)
    assert len(calls) == traces.taken == lowering.TRACE_ATTEMPTS


def _counted_call(monkeypatch, per_call: int):
    """A call that counts ``per_call`` launches on the fused wrapper's
    counter, as the wrapper does when it launches its kernel; returns the
    call and the list of its runs."""
    from repro_torch.kernels.sptc_spmm import ops as sptc_ops
    monkeypatch.setattr(sptc_ops.sptc_spmm_fused, "launches", 0)
    runs = []

    def call(_x):
        sptc_ops.sptc_spmm_fused.launches += per_call
        runs.append(per_call)
        return len(runs)
    return call, runs


@pytest.mark.parametrize("lost", ["lose_tail", "lose_middle"])
@pytest.mark.parametrize("traces_lost", [(1,), (1, 2)])
def test_trace_short_of_an_end_or_a_launch_is_retaken(monkeypatch, lost,
                                                      traces_lost):
    """A trace that lost its tail spin, or holds fewer region kernels than
    the wrapper counted launches in the call (one lost between two ends
    it kept), is taken again; ``attempts`` counts every run, so an audited
    call makes ``(1 + attempts) * per_call`` launches, and the kept trace
    holds all of them and both ends."""
    per_call = 3
    traces = _StubTraces(per_call, **{lost: traces_lost})
    x = _stub_card(monkeypatch, traces)
    call, runs = _counted_call(monkeypatch, per_call)
    before = dict(lowering.TRACE_STATS)
    a = lowering.audit_call(call, x)
    attempts = len(traces_lost) + 1
    assert a.attempts == attempts == traces.taken
    assert sum(runs) == (1 + a.attempts) * per_call
    assert a.out == 1 + a.attempts                # the kept trace's call
    assert a.counts["kernels"] == per_call and a.counts["device_ops"] == 0
    assert a.trace["tail_kept"] == 1 and a.trace["lead_kept"] == 2
    assert a.trace["launched"]["sptc_spmm_fused"] == per_call
    assert a.trace["kept"]["sptc_spmm_fused"] == per_call
    stat = {"lose_tail": "lost_tail", "lose_middle": "short_kernels"}[lost]
    assert lowering.TRACE_STATS[stat] - before[stat] == attempts - 1
    assert lowering.TRACE_STATS["retaken"] - before["retaken"] == attempts - 1


@pytest.mark.parametrize("lost", ["lose_tail", "lose_middle"])
def test_trace_that_keeps_losing_an_end_or_a_launch_raises(monkeypatch,
                                                           lost):
    """``TRACE_ATTEMPTS`` traces in a row without their tail spin, or short
    of the launched kernels, raise, after running the call that often."""
    traces = _StubTraces(2, **{lost: range(1, lowering.TRACE_ATTEMPTS + 1)})
    x = _stub_card(monkeypatch, traces)
    call, runs = _counted_call(monkeypatch, 2)
    with pytest.raises(RuntimeError, match="the tail or a counted kernel"):
        lowering.profile_call(call, x)
    assert len(runs) == traces.taken == lowering.TRACE_ATTEMPTS


def _card_counts(**kw):
    counts = dict.fromkeys(lowering.COUNT_KEYS, 0)
    counts.update(kernels=0, device_ops=0)
    counts.update(kw)
    return counts


def test_outside_device_ops_rule_on_synthetic_audits():
    cfg = VetConfig()
    rules = lambda c: [f.rule for f in lowering.check_device_ops(  # noqa: E731
        cfg, "s", c)]
    # the card's counts of the per-RowOp loop on cuda_sptc (a 2-D star
    # through it 4 = 1 + 2 + 1, a box 7 = 3 + 3 + 1), cuda_gemm star-2d1r
    # 9 = 4 copies + 2 adds + 3 fills, and one launch with nothing around it
    for copies, adds, fills, ops, kernels in ((1, 2, 1, 4, 2), (3, 3, 1, 7, 3),
                                              (4, 2, 3, 9, 2), (0, 0, 0, 0, 1)):
        ok = _card_counts(copies=copies, adds=adds, fills=fills,
                          device_ops=ops, programs=kernels, kernels=kernels)
        assert rules(ok) == []
        audit = lowering.CallAudit(counts=ok, regions={}, sequence=())
        assert rules(audit.counts) == []
        # a memset no torch op shows; a kernel launched outside any region
        assert rules(dict(ok, device_ops=ops + 1)) == ["outside-device-ops"]
        assert rules(dict(ok, kernels=kernels + 1)) == ["outside-device-ops"]
    # a CPU audit has no device ops to hold
    assert rules(dict.fromkeys(lowering.COUNT_KEYS, 3)) == []
    assert cfg.severity_of("outside-device-ops") == "error"


@pytest.mark.parametrize("shape_kind", ["star", "box"])
def test_planted_gather_and_v1_path_are_flagged(shape_kind):
    spec = make_stencil(shape_kind, 2, 1, seed=7)
    x = lowering.probe_input((22, 22), CPU)
    engine = lowering.planted_gather(spec, CPU)
    torch.testing.assert_close(
        engine(x), StencilEngine(spec, "cuda_sptc", device="cpu")(x))
    fs, got, dense = lowering.audit_fused(VetConfig(), engine, spec, x, "p")
    napps = lowering.n_applications(spec, fused=False)
    # one gather in front of each program: the box's one rows kernel, each
    # of the star's axis ops' fused kernels (on the card its one star
    # kernel)
    programs = lowering.fused_programs(spec, CPU)
    assert got.counts["gathers"] == sum(programs.values())
    assert dense.counts["gathers"] == 0
    assert {f.rule for f in fs} == {"pallas-fused-overhead"}
    # inside the region the CPU audit cannot see it (the card's can)
    hidden = lowering.planted_gather(spec, CPU, in_region=True)
    fs, got, _ = lowering.audit_fused(VetConfig(), hidden, spec, x, "p")
    assert fs == [] and got.regions == programs
    fs, got, _ = lowering.audit_fused(VetConfig(), lowering.v1_path(spec),
                                      spec, x, "v1")
    assert got.regions == {"sptc_spmm_windows": napps}
    assert {"pallas-fused-program", "pallas-fused-overhead"} <= \
        {f.rule for f in fs}
    # the shipped engine passes the same rules on the same input
    fs, _, _ = lowering.audit_fused(
        VetConfig(), StencilEngine(spec, "cuda_sptc", device="cpu"), spec, x,
        "shipped")
    assert fs == []


def test_planted_per_call_upload_is_flagged():
    spec = make_stencil("star", 2, 1, seed=7)
    engine = StencilEngine(spec, "cuda_sptc", device="cpu")
    table = np.random.default_rng(0).normal(size=4)
    x = lowering.probe_input((34, 34), CPU)
    fs, info = lowering.check_rebuild(
        VetConfig(), lambda x: engine(x) + torch.tensor(table).sum(), x, "u")
    assert [f.rule for f in fs] == ["launch-per-call-rebuild"]
    assert info == {"same_sequence": True, "uploads": 2}
    fs, info = lowering.check_rebuild(VetConfig(), engine, x, "shipped")
    assert fs == [] and info["uploads"] == 0


def test_changing_op_sequence_is_flagged():
    spec = make_stencil("star", 2, 1, seed=7)
    engine = StencilEngine(spec, "gemm", device="cpu")
    calls = [0]

    def drifting(x):
        calls[0] += 1
        return engine(x) if calls[0] % 2 else engine(x).clone()

    fs, info = lowering.check_rebuild(VetConfig(), drifting,
                                      lowering.probe_input((34, 34), CPU), "d")
    assert [f.rule for f in fs] == ["launch-per-call-rebuild"]
    assert not info["same_sequence"]


@pytest.mark.parametrize("backend", ["cuda_sptc", "cuda_gemm"])
def test_outside_counts_do_not_depend_on_size(backend):
    for spec in paper_suite():
        r = spec.radius
        eng = StencilEngine(spec, backend, device="cpu")
        shapes = ([(200,), (4099,)] if spec.ndim == 1
                  else [(16, 16), (61, 130)])
        counts = [lowering.audit_call(eng, lowering.probe_input(
            tuple(s + 2 * r for s in dims), CPU)).counts for dims in shapes]
        assert counts[0] == counts[1], (spec.name, counts)
        # a cuda_sptc 2-D box runs its row ops as one rows-kernel program
        want = sum(kernel_launches(eng.plan_ir, eng.device).values())
        assert counts[0]["programs"] == want


def test_region_is_free_without_a_profiler():
    import contextlib
    assert not torch.autograd._profiler_enabled()
    assert isinstance(region("windows_gemm"), contextlib.nullcontext)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with region("windows_gemm"):
            torch.ones(2).add_(1)
    names = [e.name for e in prof.events()]
    assert "windows_gemm" in names


def test_audit_needs_a_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lowering.run(VetConfig())


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def test_cli_flags_fixture_corpus_nonzero(capsys):
    rc = vet_main(["--analyzers", "code", "--no-baseline",
                   "--root", str(FIXTURES), str(FIXTURES)])
    out = capsys.readouterr().out
    assert rc == 1
    assert "code-lock-discipline" in out and "code-nondet-key" in out


def test_cli_json_report_shape(capsys):
    rc = vet_main(["--analyzers", "code", "--no-baseline", "--json",
                   "--root", str(FIXTURES), str(FIXTURES)])
    report = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert {"findings", "suppressed", "unused_baseline", "counts"} \
        <= set(report)
    assert report["counts"]["error"] >= 1
    assert "code-nondet-key" in {f["rule"] for f in report["findings"]}


def test_cli_json_carries_the_verdict(capsys):
    rc = vet_main(["--analyzers", "lowering", "--device", "cpu", "--json"])
    report = json.loads(capsys.readouterr().out)
    assert rc == 0 and report["findings"] == []
    assert set(report["verdict"]) == {"stencil_gemm", "sptc_spmm",
                                      "sptc_spmm_fused", "sharded_halo"}
    assert report["verdict"]["sharded_halo"]["certified"]


def test_cli_write_baseline_then_pass(tmp_path, capsys):
    hot = tmp_path / "serving"
    hot.mkdir()
    (hot / "bad.py").write_text(JIT_BAD)
    bl = tmp_path / "bl.json"
    rc = vet_main(["--analyzers", "code", "--root", str(tmp_path),
                   "--baseline", str(bl), "--write-baseline", str(tmp_path)])
    assert rc == 0 and bl.exists()
    capsys.readouterr()
    rc = vet_main(["--analyzers", "code", "--root", str(tmp_path),
                   "--baseline", str(bl), str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "suppressed by baseline" in out


@pytest.mark.parametrize("argv,err", [
    (["--analyzers", "nope"], "unknown analyzer"),
    (["--analyzers", "code", "/definitely/not/here"], "no such path"),
])
def test_cli_usage_errors(capsys, argv, err):
    assert vet_main(argv) == 2
    assert err in capsys.readouterr().err


def test_cli_run_imports_no_jax():
    probe = (
        "import json, runpy, sys\n"
        "sys.argv = ['repro_torch.vet', '--device', 'cpu', "
        "'src/repro_torch']\n"
        "try:\n"
        "    runpy.run_module('repro_torch.vet', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(json.dumps({'rc': rc, 'bad': bad}))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out == {"rc": 0, "bad": []}
    assert "2 finding(s) suppressed by baseline" in res.stdout
