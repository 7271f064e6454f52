"""Code analyzer: walk Python sources, apply every AST rule.

Paths are reported repo-relative (relative to the config root) with
forward slashes, so findings and baseline entries are stable across
checkouts.  Unparseable files produce a ``code-parse`` error finding
rather than crashing the run — a vet tool that dies on the tree it vets
is useless in CI.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterable, Iterator, List, Optional

from repro_torch.vet.config import VetConfig
from repro_torch.vet.findings import Finding
from repro_torch.vet.rules import ALL_RULES, Rule, RuleContext

SKIP_DIRS = {"__pycache__", ".git", ".venv", "build", "dist"}


def iter_py_files(paths: Iterable[Path]) -> Iterator[Path]:
    for p in paths:
        p = Path(p)
        if p.is_file() and p.suffix == ".py":
            yield p
        elif p.is_dir():
            for f in sorted(p.rglob("*.py")):
                # below the walked directory only: a checkout may itself
                # lie under a directory named build/
                if not any(part in SKIP_DIRS
                           for part in f.relative_to(p).parts):
                    yield f


def rel_path(path: Path, root: Path) -> str:
    try:
        return Path(path).resolve().relative_to(
            Path(root).resolve()).as_posix()
    except ValueError:
        return Path(path).as_posix()


def check_file(cfg: VetConfig, path: Path,
               rules: Optional[List[Rule]] = None) -> List[Finding]:
    rp = rel_path(path, cfg.root)
    try:
        tree = ast.parse(Path(path).read_text(), filename=str(path))
    except SyntaxError as e:
        return [Finding(rule="code-parse", severity="error", path=rp,
                        line=e.lineno or 0, symbol="<module>",
                        message=f"syntax error: {e.msg}")]
    ctx = RuleContext(cfg=cfg, path=rp, tree=tree)
    out: List[Finding] = []
    for rule in (rules if rules is not None else ALL_RULES):
        out += rule.check(ctx)
    return out


def run(cfg: VetConfig, paths: Iterable[Path],
        rules: Optional[List[Rule]] = None) -> List[Finding]:
    findings: List[Finding] = []
    for f in iter_py_files(paths):
        findings += check_file(cfg, f, rules=rules)
    return findings
