"""CLI for the invariant lint suite.

    PYTHONPATH=src python -m repro_torch.analysis src/repro_torch \\
        --baseline analysis-baseline-torch.txt --report ra-findings.txt

Exit status: 0 when every finding is baselined (or there are none),
1 when new findings exist, 2 on usage errors.
"""

from __future__ import annotations

import argparse
import os
import sys

from .engine import (all_checkers, format_baseline, load_baseline,
                     run_analysis, selftest)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Run the RA invariant checkers over a source tree.")
    parser.add_argument("paths", nargs="*", default=[],
                        help="files or directories to scan "
                             "(default: src/repro_torch)")
    parser.add_argument("--root", default=None,
                        help="root findings are reported relative to and "
                             "docs/ resolved against (default: cwd)")
    parser.add_argument("--baseline", default=None, metavar="FILE",
                        help="suppress findings listed in FILE")
    parser.add_argument("--write-baseline", default=None, metavar="FILE",
                        help="write current findings to FILE and exit 0")
    parser.add_argument("--report", default=None, metavar="FILE",
                        help="also write the findings report to FILE "
                             "(always written, for CI artifacts)")
    parser.add_argument("--selftest", default=None, metavar="DIR",
                        help="run the fixture self-test over DIR and exit")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule table and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        for checker in all_checkers():
            print(f"{checker.RULE}  {checker.DESCRIPTION}")
        return 0

    if args.selftest:
        ok, report = selftest(args.selftest)
        print(report)
        return 0 if ok else 1

    paths = args.paths or ["src/repro_torch"]
    for p in paths:
        if not os.path.exists(p):
            print(f"error: no such path: {p}", file=sys.stderr)
            return 2
    result = run_analysis(paths, root=args.root)

    if args.write_baseline:
        with open(args.write_baseline, "w", encoding="utf-8") as fh:
            fh.write(format_baseline(result.findings))
        print(f"wrote {len(result.findings)} finding(s) to "
              f"{args.write_baseline}")
        return 0

    baseline = set()
    if args.baseline and os.path.exists(args.baseline):
        with open(args.baseline, "r", encoding="utf-8") as fh:
            baseline = load_baseline(fh.read())
    fresh = result.non_baselined(baseline)
    baselined = len(result.findings) - len(fresh)

    lines = [f.render() for f in fresh]
    summary = (f"{len(fresh)} finding(s) "
               f"({baselined} baselined, {result.waived} waived) "
               f"across {result.files} file(s)")
    out = "\n".join(lines + [summary]) + "\n"
    sys.stdout.write(out)
    if args.report:
        with open(args.report, "w", encoding="utf-8") as fh:
            fh.write(out)
    return 1 if fresh else 0


if __name__ == "__main__":
    sys.exit(main())
