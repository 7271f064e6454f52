"""The port's verifier configuration (``repro_torch.vet.config.load_config``
on ``[tool.repro-torch-vet]``) against the reference's (``repro.vet.config``
on ``[tool.repro-vet]``).

Each case writes one TOML body twice, once under each block name, loads
each with its own package's loader and compares the two configs field by
field.  Two defaults differ by design: the baseline (the port ships its
own ``baseline.json``) and the launch audit's budget tables (the port's
``cuda_sptc``/``scatter`` against the reference's
``pallas_sptc``/``dynamic-slice``); those fields are compared as each
config's change from its own ``VetConfig()``.  Then the CLI: a severity
re-ranked in the block moves ``main()``'s exit code, and a gather budget
of 0 flags every plain sptc probe at the configured severity.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tomllib
from pathlib import Path

import pytest
from _hypothesis_compat import given, settings, st

from repro.vet import config as ref_config
from repro.vet.cli import main as ref_main
from repro_torch.vet import config as port_config
from repro_torch.vet.cli import main as vet_main

REPO = Path(__file__).resolve().parents[1]
FIXTURES = Path(__file__).resolve().parent / "vet_fixtures"
BLOCKS = {"ref": "repro-vet", "port": "repro-torch-vet"}


def write_pair(tmp_path: Path, body: str) -> dict:
    """``body`` with ``BLOCK`` as each package's block name, one
    pyproject.toml per package under ``tmp_path/<ref|port>/``."""
    out = {}
    for side, block in BLOCKS.items():
        d = tmp_path / side
        d.mkdir(parents=True, exist_ok=True)
        (d / "pyproject.toml").write_text(body.replace("BLOCK", block))
        out[side] = d / "pyproject.toml"
    return out


def view(cfg, default) -> dict:
    """``cfg``'s fields but the root (each side's file lies in its own
    directory), with the baseline, the severities and the budget tables as
    their change from ``default`` (each package's defaults differ there by
    design)."""
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
         if f.name != "root"}
    d["baseline"] = None if cfg.baseline == default.baseline else cfg.baseline
    d["severity"] = {r: s for r, s in cfg.severity.items()
                     if default.severity.get(r) != s}
    d["lowering_budgets"] = {}
    for b in set(cfg.lowering_budgets) | set(default.lowering_budgets):
        ops, was = (c.lowering_budgets.get(b) for c in (cfg, default))
        if ops != was:      # a table added, dropped, or ops changed in it
            d["lowering_budgets"][b] = None if ops is None else {
                op: ops.get(op) for op in set(ops) | set(was or {})
                if ops.get(op) != (was or {}).get(op, -1)}
    return d


def load_both(paths: dict, **kw) -> tuple:
    ref = ref_config.load_config(pyproject=paths["ref"], **kw)
    port = port_config.load_config(pyproject=paths["port"], **kw)
    return ref, port


def assert_same(ref, port) -> None:
    assert type(port) is port_config.VetConfig
    assert view(port, port_config.VetConfig(root=port.root)) == \
        view(ref, ref_config.VetConfig(root=ref.root))


# ---------------------------------------------------------------------------
# one body, two loaders
# ---------------------------------------------------------------------------

CASES = {
    "no block": '[tool.other]\nx = 1\n',
    "empty file": '',
    "empty block": '[tool.BLOCK]\n',
    "block not a table": '[tool]\nBLOCK = 3\n',
    "block a list": '[tool]\nBLOCK = ["baseline"]\n',
    "baseline relative": '[tool.BLOCK]\nbaseline = "vet-baseline.json"\n',
    "baseline nested": '[tool.BLOCK]\nbaseline = "ci/vet/bl.json"\n',
    "baseline absolute": '[tool.BLOCK]\nbaseline = "/abs/where/bl.json"\n',
    "hot_path_modules": '[tool.BLOCK]\nhot_path_modules = ["api", "worker"]\n',
    "hot_path_functions": '[tool.BLOCK]\nhot_path_functions = ["step", 7]\n',
    "invariant_radii": '[tool.BLOCK]\ninvariant_radii = [1, 3]\n',
    "invariant_radii empty": '[tool.BLOCK]\ninvariant_radii = []\n',
    "severity re-rank": ('[tool.BLOCK.severity]\n"invariant-24" = "warning"\n'
                         '"code-host-sync" = "error"\n'),
    "severity off": ('[tool.BLOCK.severity]\n"code-nondet-key" = "off"\n'
                     '"lowering-hot-gather" = "off"\n'),
    "severity unknown rule": '[tool.BLOCK.severity]\n"my-rule" = "info"\n',
    "severity non-string": '[tool.BLOCK.severity]\n"invariant-24" = 3\n',
    "backends": '[tool.BLOCK.lowering]\nbackends = ["sptc"]\n',
    "backends empty": '[tool.BLOCK.lowering]\nbackends = []\n',
    "budget into an existing backend": (
        '[tool.BLOCK.lowering.budgets.sptc]\ngather = 0\n'),
    "budget new op on an existing backend": (
        '[tool.BLOCK.lowering.budgets.gemm]\ncopy = 2\n'),
    "budget new backend": (
        '[tool.BLOCK.lowering.budgets.mybackend]\ngather = 2\ncopy = 0\n'),
    "budget counts cast to int": (
        '[tool.BLOCK.lowering.budgets.gemm]\ngather = 2.9\n'),
    "budget two backends": (
        '[tool.BLOCK.lowering.budgets.gemm]\ngather = 3\n'
        '[tool.BLOCK.lowering.budgets.sptc]\ngather = 0\n'),
    "every field": (
        '[tool.BLOCK]\nbaseline = "b.json"\nhot_path_modules = ["m"]\n'
        'hot_path_functions = ["f"]\ninvariant_radii = [2]\n'
        '[tool.BLOCK.severity]\n"invariant-meta" = "info"\n'
        '[tool.BLOCK.lowering]\nbackends = ["gemm"]\n'
        '[tool.BLOCK.lowering.budgets.gemm]\ngather = 4\n'),
    "wrong type baseline": '[tool.BLOCK]\nbaseline = 3\n',
    "wrong type hot_path_modules": '[tool.BLOCK]\nhot_path_modules = "serving"\n',
    "wrong type hot_path_functions": '[tool.BLOCK]\nhot_path_functions = {a = 1}\n',
    "wrong type invariant_radii": '[tool.BLOCK]\ninvariant_radii = 2\n',
    "wrong type severity": '[tool.BLOCK]\nseverity = "off"\n',
    "wrong type lowering": '[tool.BLOCK]\nlowering = ["gemm"]\n',
    "wrong type backends": '[tool.BLOCK.lowering]\nbackends = "gemm"\n',
    "wrong type budgets": '[tool.BLOCK.lowering]\nbudgets = [1, 2]\n',
    "wrong type budget table": '[tool.BLOCK.lowering.budgets]\ngemm = 3\n',
}


@pytest.mark.parametrize("body", list(CASES.values()), ids=list(CASES))
@pytest.mark.parametrize("root", [False, True], ids=["pyproject-dir", "root"])
def test_load_config_equals_the_reference(tmp_path, body, root):
    paths = write_pair(tmp_path, body)
    kw = {"root": tmp_path / "elsewhere"} if root else {}
    ref, port = load_both(paths, **kw)
    assert_same(ref, port)
    for side, cfg in (("ref", ref), ("port", port)):
        assert cfg.root == (kw["root"] if root else paths[side].parent)
    block = tomllib.loads(body.replace("BLOCK", "b")).get("tool", {}).get("b")
    if isinstance(block, dict) and isinstance(block.get("baseline"), str):
        # a relative baseline resolves against the root, an absolute one
        # stays
        for cfg in (ref, port):
            assert cfg.baseline_path() == cfg.root / block["baseline"]
    else:
        assert port.baseline_path() == port_config.DEFAULT_BASELINE


@pytest.mark.parametrize("body,error", [
    ('[tool.BLOCK\nbaseline = "x"\n', tomllib.TOMLDecodeError),
    ('[tool.BLOCK]\nbaseline = \n', tomllib.TOMLDecodeError),
    ('[tool.BLOCK]\ninvariant_radii = ["one"]\n', ValueError),
    ('[tool.BLOCK.lowering.budgets.gemm]\ngather = "many"\n', ValueError),
], ids=["unclosed header", "missing value", "radius not a number",
        "budget not a number"])
def test_malformed_block_raises_in_both(tmp_path, body, error):
    paths = write_pair(tmp_path, body)
    with pytest.raises(error):
        ref_config.load_config(pyproject=paths["ref"])
    with pytest.raises(error):
        port_config.load_config(pyproject=paths["port"])


@pytest.mark.parametrize("root", [None, "given"])
def test_missing_file_gives_the_defaults(tmp_path, root):
    kw = {"root": tmp_path / "r"} if root else {}
    ref = ref_config.load_config(pyproject=tmp_path / "nope.toml", **kw)
    port = port_config.load_config(pyproject=tmp_path / "nope.toml", **kw)
    assert_same(ref, port)
    assert port.root == (tmp_path / "r" if root else Path.cwd())
    assert port.baseline == str(port_config.DEFAULT_BASELINE)
    assert port.lowering_budgets == port_config.DEFAULT_HOT_BUDGET


def test_root_finds_the_pyproject_in_it(tmp_path):
    paths = write_pair(tmp_path, '[tool.BLOCK]\ninvariant_radii = [4]\n'
                                 'baseline = "bl.json"\n')
    ref = ref_config.load_config(root=paths["ref"].parent)
    port = port_config.load_config(root=paths["port"].parent)
    assert_same(ref, port)
    assert port.invariant_radii == [4]
    assert port.baseline_path() == tmp_path / "port" / "bl.json"


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_find_pyproject_walks_up_from_a_nested_directory(tmp_path, depth):
    (tmp_path / "pyproject.toml").write_text("")
    start = tmp_path.joinpath(*["d"] * depth)
    start.mkdir(parents=True, exist_ok=True)
    assert port_config._find_pyproject(start) == \
        ref_config._find_pyproject(start) == tmp_path / "pyproject.toml"


def test_find_pyproject_without_one_under_tmp(tmp_path):
    start = tmp_path / "a" / "b"
    start.mkdir(parents=True)
    found = port_config._find_pyproject(start)
    assert found == ref_config._find_pyproject(start)
    # whatever lies above the temporary directory, nothing inside it
    assert found is None or tmp_path not in found.parents


def test_block_of_the_other_package_is_not_read(tmp_path):
    """The port reads ``[tool.repro-torch-vet]`` only: the reference's block
    (the repo's own, with its ``src/repro`` baseline) leaves the port at
    its defaults, and the port's block leaves the reference at its own."""
    p = tmp_path / "pyproject.toml"
    p.write_text((REPO / "pyproject.toml").read_text()
                 + '\n[tool.repro-torch-vet]\ninvariant_radii = [2]\n')
    port = port_config.load_config(pyproject=p)
    ref = ref_config.load_config(pyproject=p)
    assert port.invariant_radii == [2] and ref.invariant_radii == [1, 2, 3, 4]
    assert ref.baseline == ".vet-baseline.json"
    assert port.baseline == str(port_config.DEFAULT_BASELINE)
    assert port.lowering_budgets == port_config.DEFAULT_HOT_BUDGET
    repo = port_config.load_config(pyproject=REPO / "pyproject.toml")
    assert repo == port_config.VetConfig(root=REPO)


# ---------------------------------------------------------------------------
# random blocks of the reference's accepted types
# ---------------------------------------------------------------------------

_NAMES = st.text(alphabet="abcdefghijklmnopqrstuvwxyz_-.", min_size=1,
                 max_size=8)
#: rule ids whose default is the same in both packages, and unknown ones
_RULES = st.sampled_from(sorted(
    {r for r, s in ref_config.DEFAULT_SEVERITY.items()
     if port_config.DEFAULT_SEVERITY.get(r) == s} | {"my-rule", "x-y"}))
#: backends with one budget table in both packages, and new ones (the
#: fused backend is keyed differently by design: pallas_sptc, cuda_sptc)
_BACKENDS = st.sampled_from(["gemm", "sptc", "direct", "custom"])
_OPS = st.sampled_from(["gather", "copy", "fusion", "while"])


def _toml(v) -> str:
    if isinstance(v, dict):
        return "{" + ", ".join(f"{json.dumps(k)} = {_toml(x)}"
                               for k, x in v.items()) + "}"
    if isinstance(v, list):
        return "[" + ", ".join(_toml(x) for x in v) + "]"
    return json.dumps(v)


_BLOCK = st.fixed_dictionaries({}, optional={
    "baseline": st.one_of(_NAMES, _NAMES.map(lambda s: "/abs/" + s)),
    "hot_path_modules": st.lists(_NAMES, max_size=3),
    "hot_path_functions": st.lists(st.one_of(_NAMES, st.integers(0, 9)),
                                   max_size=3),
    "invariant_radii": st.lists(st.integers(1, 6), max_size=4),
    "severity": st.dictionaries(_RULES, st.sampled_from(
        ["error", "warning", "info", "off"]), max_size=4),
    "lowering": st.fixed_dictionaries({}, optional={
        "backends": st.lists(_BACKENDS, max_size=3),
        "budgets": st.dictionaries(_BACKENDS, st.dictionaries(
            _OPS, st.integers(0, 5), max_size=3), max_size=3)}),
})


@settings(max_examples=60, deadline=None)
@given(block=_BLOCK, root=st.booleans())
def test_random_blocks_equal_the_reference(tmp_path_factory, block, root):
    tmp = tmp_path_factory.mktemp("cfg")
    body = "[tool]\nBLOCK = " + _toml(block) + "\n"
    paths = write_pair(tmp, body)
    kw = {"root": tmp / "r"} if root else {}
    ref, port = load_both(paths, **kw)
    assert_same(ref, port)
    assert port.root == (tmp / "r" if root else tmp / "port")
    if "baseline" in block:
        assert port.baseline == block["baseline"]


# ---------------------------------------------------------------------------
# the CLI reads the block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("severity,rc", [
    (None, 1), ("error", 1), ("warning", 0), ("info", 0), ("off", 0)])
def test_severity_in_the_block_moves_the_exit_code(tmp_path, capsys,
                                                   severity, rc):
    """The fixture breaks ``code-nondet-key`` in a tuner module: an error by
    default; the block re-ranks it, and ``off`` silences it.  The
    reference's CLI on the same body under its block agrees."""
    body = "" if severity is None else (
        f'[tool.BLOCK.severity]\n"code-nondet-key" = "{severity}"\n')
    paths = write_pair(tmp_path, body)
    rcs, outs = {}, {}
    for side, main in (("ref", ref_main), ("port", vet_main)):
        root = paths[side].parent
        (root / "tuner").mkdir()
        shutil.copy(FIXTURES / "tuner" / "bad_nondet_key.py", root / "tuner")
        argv = ["--analyzers", "code", "--json", "--no-baseline",
                "--root", str(root), str(root)]
        rcs[side] = main(argv + (["--device", "cpu"] if side == "port"
                                 else []))
        outs[side] = json.loads(capsys.readouterr().out)
    assert rcs == {"ref": rc, "port": rc}
    want = "error" if severity is None else severity
    got = [(f["rule"], f["severity"]) for f in outs["port"]["findings"]]
    assert got == ([] if want == "off" else
                   [("code-nondet-key", want)] * len(got)) and (
        want == "off" or got)
    assert got == [(f["rule"], f["severity"])
                   for f in outs["ref"]["findings"]]


@pytest.mark.parametrize("severity,rc", [
    ("warning", 0), ("error", 1), ("off", 0)])
def test_gather_budget_in_the_block_flags_every_sptc_probe(
        tmp_path, capsys, monkeypatch, severity, rc):
    """``lowering.budgets.sptc.gather = 0``: every plain sptc probe runs one
    window gather (the ``comb`` index), so each is flagged at the block's
    severity, and none is when the rule is off; no gemm probe is audited
    with ``backends = ["sptc"]``."""
    (tmp_path / "pyproject.toml").write_text(
        '[tool.repro-torch-vet]\nbaseline = "vet-baseline.json"\n'
        f'[tool.repro-torch-vet.severity]\n"lowering-hot-gather" = '
        f'"{severity}"\n[tool.repro-torch-vet.lowering]\n'
        'backends = ["sptc"]\n'
        '[tool.repro-torch-vet.lowering.budgets.sptc]\ngather = 0\n')
    monkeypatch.chdir(tmp_path)
    assert vet_main(["--analyzers", "lowering", "--device", "cpu",
                     "--json"]) == rc
    report = json.loads(capsys.readouterr().out)
    verdict = report["verdict"]
    sptc = sorted(verdict["sptc_spmm"]["probes"])
    assert sptc and set(verdict) == {"sptc_spmm", "sptc_spmm_fused",
                                     "sharded_halo"}
    assert not [p for v in verdict.values() for p in v["probes"]
                if "gemm" in p]
    flagged = sorted(f["symbol"] for f in report["findings"]
                     if f["rule"] == "lowering-hot-gather"
                     and f["severity"] == severity)
    assert flagged == ([] if severity == "off" else sptc)
    assert len(report["findings"]) == len(flagged)
    assert verdict["sptc_spmm"]["certified"] == (severity == "off")
    assert verdict["sptc_spmm_fused"]["certified"]


@pytest.mark.parametrize("severity", ["error", "warning", "off"])
def test_severity_in_the_block_ranks_an_invariant_rule(tmp_path, monkeypatch,
                                                       severity):
    """A kernel matrix with a tap off its band breaks ``invariant-banded``:
    its findings come at the block's severity, and none when it is off."""
    from repro_torch.vet import invariants
    (tmp_path / "pyproject.toml").write_text(
        '[tool.repro-torch-vet]\ninvariant_radii = [1]\n'
        f'[tool.repro-torch-vet.severity]\n"invariant-banded" = '
        f'"{severity}"\n')
    cfg = port_config.load_config(root=tmp_path)
    kept = invariants.kernel_matrix

    def off_band(*a, **kw):
        K = kept(*a, **kw).copy()
        K[0, -1] = 7.0
        return K
    monkeypatch.setattr(invariants, "kernel_matrix", off_band)
    banded = [f.severity for f in invariants.run(cfg)
              if f.rule == "invariant-banded"]
    assert banded == ([] if severity == "off" else
                      [severity] * len(banded)) and (severity == "off"
                                                     or banded)


def test_config_imports_neither_repro_nor_jax():
    probe = ("import json, sys\n"
             "import repro_torch.vet.config as c\n"
             "c.load_config(root=c.Path.cwd())\n"
             "print(json.dumps(sorted(m for m in sys.modules if "
             "m.split('.')[0] in ('jax', 'jaxlib', 'repro'))))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []
