"""Baseline: the checked-in set of findings a tree is *allowed* to have.

Each entry is a documented, reviewed exception — a rule match that was
inspected and judged intentional (e.g. the serving driver's deliberate
stream synchronisation that anchors its latency metric).  Matching is by
:meth:`Finding.key` (rule + path + symbol), deliberately line-free so
unrelated edits don't invalidate entries.

Format (JSON, sorted, diff-friendly)::

    {"version": 1,
     "entries": [{"rule": "...", "path": "...", "symbol": "...",
                  "reason": "why this is accepted"}]}

``python -m repro_torch.vet --write-baseline`` regenerates entries from the
current findings (preserving reasons of kept entries); unused entries
are reported so the baseline can only shrink silently, never grow.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Tuple

from repro_torch.vet.findings import Finding

_FORMAT_VERSION = 1


@dataclasses.dataclass(frozen=True)
class BaselineEntry:
    rule: str
    path: str
    symbol: str
    reason: str = ""

    def key(self) -> str:
        return f"{self.rule}::{self.path}::{self.symbol}"


class Baseline:
    def __init__(self, entries: List[BaselineEntry] | None = None):
        self.entries = list(entries or [])

    def __len__(self) -> int:
        return len(self.entries)

    def split(self, findings: List[Finding]
              ) -> Tuple[List[Finding], List[Finding], List[BaselineEntry]]:
        """(new findings, suppressed findings, unused baseline entries)."""
        by_key: Dict[str, BaselineEntry] = {e.key(): e for e in self.entries}
        new: List[Finding] = []
        suppressed: List[Finding] = []
        used = set()
        for f in findings:
            if f.key() in by_key:
                suppressed.append(f)
                used.add(f.key())
            else:
                new.append(f)
        unused = [e for e in self.entries if e.key() not in used]
        return new, suppressed, unused

    @classmethod
    def load(cls, path: Path, missing_ok: bool = True) -> "Baseline":
        if not Path(path).exists():
            if missing_ok:
                return cls()
            raise FileNotFoundError(path)
        payload = json.loads(Path(path).read_text())
        if payload.get("version") != _FORMAT_VERSION:
            return cls()
        entries = [BaselineEntry(rule=str(e["rule"]), path=str(e["path"]),
                                 symbol=str(e.get("symbol", "")),
                                 reason=str(e.get("reason", "")))
                   for e in payload.get("entries", [])]
        return cls(entries)

    def save(self, path: Path) -> None:
        payload = {
            "version": _FORMAT_VERSION,
            "entries": [dataclasses.asdict(e) for e in sorted(
                self.entries, key=lambda e: e.key())],
        }
        Path(path).write_text(json.dumps(payload, indent=1, sort_keys=True)
                              + "\n")

    @classmethod
    def from_findings(cls, findings: List[Finding],
                      previous: "Baseline | None" = None) -> "Baseline":
        """Entries for every finding, keeping reasons from ``previous``."""
        reasons = {e.key(): e.reason for e in (previous.entries
                                               if previous else [])}
        seen = set()
        entries = []
        for f in findings:
            if f.key() in seen:
                continue
            seen.add(f.key())
            entries.append(BaselineEntry(
                rule=f.rule, path=f.path, symbol=f.symbol,
                reason=reasons.get(f.key(), "TODO: document why accepted")))
        return cls(entries)
