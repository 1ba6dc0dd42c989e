"""odlint CLI (the port's): run the port's rule set over source trees.

Usage:
  python -m repro_torch.analysis [paths...] [--format text|json] [--output FILE]
         [--baseline FILE] [--write-baseline] [--rules ODL001,ODL004]
         [--list-rules]

Exit status: 0 when no (unbaselined) findings, 1 otherwise, 2 on usage
errors.  Stdlib-only — runs without torch.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

from . import core
from .rules import ALL_RULES


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repo-native static analysis for the port of the ODL runtime",
    )
    p.add_argument(
        "paths",
        nargs="*",
        default=["src/repro_torch"],
        help="files or directories to lint (default: src/repro_torch)",
    )
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--output", help="write the report here instead of stdout")
    p.add_argument(
        "--baseline",
        help="JSON baseline of accepted fingerprints; matching findings "
        "are reported but do not fail the run",
    )
    p.add_argument(
        "--write-baseline",
        action="store_true",
        help="write the current findings to --baseline and exit 0",
    )
    p.add_argument(
        "--rules",
        help="comma-separated rule IDs to run (default: all)",
    )
    p.add_argument("--list-rules", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.list_rules:
        for rule in ALL_RULES:
            print(f"{rule.rule_id}  {rule.title}")
            print(f"        rationale: {rule.rationale}")
        return 0

    rules = list(ALL_RULES)
    if args.rules:
        want = {r.strip() for r in args.rules.split(",") if r.strip()}
        unknown = want - {r.rule_id for r in rules}
        if unknown:
            print(f"odlint: unknown rule id(s): {sorted(unknown)}", file=sys.stderr)
            return 2
        rules = [r for r in rules if r.rule_id in want]

    files = core.collect_files(args.paths)
    if not files:
        print(f"odlint: no .py files under {args.paths}", file=sys.stderr)
        return 2

    t0 = time.perf_counter()
    project = core.Project.load(files, root=Path.cwd())
    findings = core.run_rules(project, rules)
    elapsed = time.perf_counter() - t0

    if args.write_baseline:
        if not args.baseline:
            print("odlint: --write-baseline requires --baseline", file=sys.stderr)
            return 2
        core.write_baseline(Path(args.baseline), findings)
        print(
            f"odlint: wrote {len(findings)} fingerprint(s) to {args.baseline}"
        )
        return 0

    baseline = core.load_baseline(Path(args.baseline)) if args.baseline else set()
    blocking = core.apply_baseline(findings, baseline)

    if args.format == "json":
        report = core.report_json(findings, rules)
    else:
        report = core.report_text(findings)
        report += (
            f"\nodlint: scanned {len(project.modules)} file(s) in "
            f"{elapsed:.2f}s, {len(blocking)} blocking"
        )
    if args.output:
        Path(args.output).write_text(report + "\n")
    else:
        print(report)
    return 1 if blocking else 0


if __name__ == "__main__":
    sys.exit(main())
