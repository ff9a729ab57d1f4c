#!/usr/bin/env python
"""Graftlint entry of the port: lint dotaclient_tpu_torch/ for
THR/LIF/WIRE/OBS/SVC violations.

    python -m dotaclient_tpu_torch.scripts.lint_graft           # default gate (errors fail)
    python -m dotaclient_tpu_torch.scripts.lint_graft --strict  # warnings fail too
    python -m dotaclient_tpu_torch.scripts.lint_graft --json    # one JSON report line
    python -m dotaclient_tpu_torch.scripts.lint_graft --write-baseline "reason"
                                              # pin current findings; edit the
                                              # per-entry reasons before commit

Exit status: 0 when clean, 1 when anything fails the selected gate.
Baseline hygiene (stale entries, reason-less suppressions/entries) fails
at EVERY strictness — the ratchet only ratchets if the escape hatches
stay audited. Pure AST: runs with no torch, no numpy, no JAX and no
import of the package beyond its stdlib analysis modules. The same
flags and exit codes as the reference's scripts/lint_graft.py.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="graftlint: repo-native static analysis")
    p.add_argument("paths", nargs="*", help="files/dirs to lint (default: the package)")
    p.add_argument("--strict", action="store_true", help="warnings fail too (nightly)")
    p.add_argument("--json", action="store_true", help="print one JSON report line")
    p.add_argument("--baseline", default=None, help="baseline path override")
    p.add_argument(
        "--write-baseline",
        metavar="REASON",
        default=None,
        help="regenerate the baseline from current findings with this "
        "placeholder reason (edit per-entry reasons before committing)",
    )
    p.add_argument("--root", default=REPO_ROOT, help="repo root override (tests)")
    args = p.parse_args(argv)

    from dotaclient_tpu_torch.analysis import lint_repo, load_baseline, write_baseline
    from dotaclient_tpu_torch.analysis.core import BASELINE_REL

    paths = [os.path.abspath(x) for x in args.paths] or None
    report = lint_repo(args.root, paths=paths, baseline_path=args.baseline)

    if args.write_baseline is not None:
        baseline_path = args.baseline or os.path.join(args.root, *BASELINE_REL)
        # ALL new findings — warnings included, or the nightly --strict
        # gate stays red after a regeneration — PLUS everything already
        # baselined: regenerating must extend the pin set, never drop
        # still-valid entries NOR erase their hand-audited reasons (the
        # placeholder applies only to the new entries). The baseline is
        # a REPO-WIDE artifact: pin from a full lint, never from a paths
        # subset (whose report omits out-of-subset entries — writing
        # that would silently unpin them).
        existing, _ = (
            load_baseline(baseline_path) if os.path.exists(baseline_path) else ({}, [])
        )
        full = (
            report
            if paths is None
            else lint_repo(args.root, baseline_path=args.baseline)
        )
        pin = list(full.findings) + full.baselined
        write_baseline(baseline_path, pin, args.write_baseline, keep_reasons=existing)
        print(f"baseline written: {len(pin)} entries → {baseline_path}")
        return 0

    failures = report.failures(strict=args.strict)
    if args.json:
        print(json.dumps(report.to_json(strict=args.strict)))
    else:
        for f in report.findings:
            print(f.render())
        for f in report.invalid:
            print(f.render())
        for fp in report.stale_baseline:
            print(f"STALE baseline entry (finding no longer exists): {fp}")
        print(
            f"graftlint: {report.files_scanned} files, "
            f"{len(report.findings)} new finding(s) "
            f"({len(failures)} fail{'' if len(failures) == 1 else 's'} this gate), "
            f"{len(report.suppressed)} suppressed inline, "
            f"{len(report.baselined)} baselined, "
            f"{len(report.stale_baseline)} stale baseline entr"
            f"{'y' if len(report.stale_baseline) == 1 else 'ies'}"
        )
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
