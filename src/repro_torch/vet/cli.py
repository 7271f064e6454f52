"""``python -m repro_torch.vet`` — run the analyzers, print findings, gate CI.

    python -m repro_torch.vet src/repro_torch            # all three, on the card
    python -m repro_torch.vet --device cpu src/repro_torch
    python -m repro_torch.vet --analyzers invariants,code src/repro_torch
    python -m repro_torch.vet src/repro_torch --json     # machine-readable
    python -m repro_torch.vet src/repro_torch --write-baseline

The launch audit (``lowering``) runs on the card unless ``--device cpu``
is given, and raises without a card; ``invariants`` and ``code`` need no
device.  Settings come from the ``[tool.repro-torch-vet]`` block of the
nearest ``pyproject.toml`` at or above the root (``vet/config.py``);
``--baseline`` overrides the block's baseline.

Exit status: 0 when no *error* finding survives the baseline, 1 when at
least one does, 2 on usage errors.  Warnings and infos never fail the
run; suppressed findings and unused baseline entries are reported so the
baseline stays honest.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional

from repro_torch.vet.baseline import Baseline
from repro_torch.vet.config import VetConfig, load_config
from repro_torch.vet.findings import Finding, counts_by_severity

ANALYZERS = ("invariants", "lowering", "code")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="repro_torch.vet",
        description="Verifier of the PyTorch/CUDA port: SPIDER transform "
                    "invariants, a launch audit of the engines' zero-overhead "
                    "profile, and hot-path/concurrency lint.")
    p.add_argument("paths", nargs="*", default=[],
                   help="files/directories for the code analyzer "
                        "(default: src/repro_torch under the config root)")
    p.add_argument("--analyzers", default=",".join(ANALYZERS),
                   help="comma-separated subset of: " + ", ".join(ANALYZERS))
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit a JSON report instead of text")
    p.add_argument("--baseline", default=None,
                   help="baseline file (default: the config block's "
                        "baseline, else the package's baseline.json)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore the baseline entirely")
    p.add_argument("--write-baseline", action="store_true",
                   help="rewrite the baseline from current findings "
                        "(preserves reasons of kept entries) and exit 0")
    p.add_argument("--root", default=None,
                   help="repo root for relative paths (default: the "
                        "current directory)")
    p.add_argument("--device", default=None,
                   help="device of the launch audit (default: the card; "
                        "'cpu' runs the kernels' plain versions)")
    return p


def run_analyzers(cfg: VetConfig, which: List[str], paths: List[Path],
                  device: Optional[str] = None
                  ) -> tuple[List[Finding], Optional[Dict[str, dict]]]:
    findings: List[Finding] = []
    verdict: Optional[Dict[str, dict]] = None
    if "invariants" in which:
        from repro_torch.vet import invariants
        findings += invariants.run(cfg)
    if "lowering" in which:
        from repro_torch.vet import lowering
        fs, verdict = lowering.run(cfg, device=device)
        findings += fs
    if "code" in which:
        from repro_torch.vet import code
        findings += code.run(cfg, paths)
    return findings, verdict


def _print_text(new: List[Finding], suppressed: List[Finding],
                unused, verdict: Optional[Dict[str, dict]],
                out=None) -> None:
    out = out if out is not None else sys.stdout
    for f in new:
        print(f.format(), file=out)
    if verdict:
        print("zero-overhead verdict:", file=out)
        for kernel in sorted(verdict):
            v = verdict[kernel]
            status = "certified" if v.get("certified") else "NOT certified"
            rebuild = v.get("rebuild")
            extra = f", rebuild={rebuild}" if rebuild is not None else ""
            print(f"  {kernel}: {status}{extra}", file=out)
            for probe in sorted(v.get("probes", {})):
                counts = v["probes"][probe]
                ops = " ".join(f"{k}={counts[k]}" for k in sorted(counts))
                print(f"    {probe}: {ops}", file=out)
    if suppressed:
        print(f"{len(suppressed)} finding(s) suppressed by baseline",
              file=out)
    for e in unused:
        print(f"warning: unused baseline entry {e.key()!r} — remove it",
              file=out)
    counts = counts_by_severity(new)
    print(f"vet: {counts['error']} error(s), {counts['warning']} "
          f"warning(s), {counts['info']} info(s)", file=out)


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    which = [a.strip() for a in args.analyzers.split(",") if a.strip()]
    bad = [a for a in which if a not in ANALYZERS]
    if bad:
        print(f"repro_torch.vet: unknown analyzer(s): {', '.join(bad)} "
              f"(choose from {', '.join(ANALYZERS)})", file=sys.stderr)
        return 2

    root = Path(args.root) if args.root else None
    cfg = load_config(root=root or Path.cwd())
    if root is not None:
        cfg.root = root
    if args.baseline:
        cfg.baseline = args.baseline

    paths = [Path(p) for p in args.paths]
    if not paths and "code" in which:
        default = cfg.root / "src" / "repro_torch"
        if default.exists():
            paths = [default]
    missing = [p for p in paths if not p.exists()]
    if missing:
        print("repro_torch.vet: no such path(s): "
              + ", ".join(str(p) for p in missing), file=sys.stderr)
        return 2

    findings, verdict = run_analyzers(cfg, which, paths, args.device)

    bl_path = cfg.baseline_path()
    if args.write_baseline:
        previous = Baseline.load(bl_path)
        Baseline.from_findings(findings, previous).save(bl_path)
        print(f"repro_torch.vet: wrote {len(findings)} finding(s) to {bl_path}")
        return 0

    baseline = Baseline() if args.no_baseline else Baseline.load(bl_path)
    new, suppressed, unused = baseline.split(findings)

    if args.as_json:
        report = {
            "findings": [f.to_dict() for f in new],
            "suppressed": [f.to_dict() for f in suppressed],
            "unused_baseline": [e.key() for e in unused],
            "counts": counts_by_severity(new),
        }
        if verdict is not None:
            report["verdict"] = verdict
        print(json.dumps(report, indent=1, sort_keys=True))
    else:
        _print_text(new, suppressed, unused, verdict)

    return 1 if any(f.severity == "error" for f in new) else 0


if __name__ == "__main__":          # pragma: no cover
    sys.exit(main())
