"""Structured findings shared by every ``repro_torch.vet`` analyzer.

A :class:`Finding` is one verifiable claim about the tree: a rule id
(``invariant-24``, ``pallas-fused-gather``, ``code-host-sync``, ...), a
severity, a location, and a message.  Findings are what the CLI prints
(text or JSON), what the baseline suppresses, and what decides the exit
code — ``error`` findings outside the baseline fail the run.

The ``symbol`` field is the *stable* part of the location (a qualified
function name, a backend name, a sweep point) so baseline entries keep
matching across line-number drift.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

SEVERITIES = ("error", "warning", "info")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer result."""

    rule: str                       # stable rule id, e.g. "code-host-sync"
    severity: str                   # "error" | "warning" | "info"
    path: str                       # file the finding is about ("-" if n/a)
    line: int                       # 1-based; 0 when not line-anchored
    symbol: str                     # enclosing symbol / backend / sweep point
    message: str

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"severity must be one of {SEVERITIES}, got {self.severity!r}")

    def key(self) -> str:
        """Line-independent identity used for baseline matching."""
        return f"{self.rule}::{self.path}::{self.symbol}"

    def format(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: {self.severity}: [{self.rule}] {self.symbol}: {self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Finding":
        return cls(rule=str(d["rule"]), severity=str(d["severity"]),
                   path=str(d["path"]), line=int(d.get("line", 0)),
                   symbol=str(d.get("symbol", "")), message=str(d["message"]))


def with_severity(finding: Finding, severity: str) -> Finding:
    """The same finding at a (config-overridden) severity."""
    if severity == finding.severity:
        return finding
    return dataclasses.replace(finding, severity=severity)


def switched_on(findings: List[Finding],
                severity_of: Callable[[str], str]) -> List[Finding]:
    """``findings`` less those of rules whose configured severity is
    ``"off"``: a rule set off reports nothing."""
    return [f for f in findings if severity_of(f.rule) != "off"]


def worst_severity(findings: List[Finding]) -> Optional[str]:
    for sev in SEVERITIES:          # ordered worst-first
        if any(f.severity == sev for f in findings):
            return sev
    return None


def counts_by_severity(findings: List[Finding]) -> dict:
    out = {sev: 0 for sev in SEVERITIES}
    for f in findings:
        out[f.severity] += 1
    return out
