"""``python -m repro_torch.analysis`` — run the port's static-analysis
passes.

Exit codes: 0 = clean (or report-only mode), 1 = live findings under
``--strict``, 2 = a pass crashed or the device asked for is absent.
``--device`` (default ``cuda``) is where the launch audit runs; without a
CUDA device, ``--device cuda`` exits 2 — it never audits the CPU path
instead. ``--update-baseline`` rewrites the frozen lint-debt file from the
current tree (contract and launch findings are never baselined — those
either hold or the build is wrong).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List

from . import PASSES
from .findings import format_findings


def main(argv: List[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's static contract checker + torch lint + launch audit",
    )
    ap.add_argument(
        "--passes", nargs="+", default=list(PASSES), choices=list(PASSES),
        help="which passes to run (default: all)",
    )
    ap.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="where the launch audit runs (default: cuda; exits 2 without one)",
    )
    ap.add_argument(
        "--strict", action="store_true",
        help="exit 1 if any live (unsuppressed, unbaselined) finding",
    )
    ap.add_argument(
        "--update-baseline", action="store_true",
        help="rewrite src/repro_torch/analysis/baseline.json from current "
        "lint findings (runs the lint pass only)",
    )
    ap.add_argument(
        "--json", action="store_true", dest="as_json",
        help="emit findings as a JSON array instead of text",
    )
    ap.add_argument(
        "--all", action="store_true",
        help="show suppressed/baselined findings too (default: live only)",
    )
    args = ap.parse_args(argv)

    if args.update_baseline:
        from .lint import run_lint, write_baseline

        findings = run_lint()
        path = write_baseline(findings)
        n = sum(1 for f in findings if not f.suppressed)
        print(f"baseline: froze {n} finding(s) -> {path}")
        return 0

    from . import DeviceUnavailable, run_all

    try:
        findings = run_all(passes=tuple(args.passes), device=args.device)
    except DeviceUnavailable as e:
        print(f"repro_torch.analysis: {e}", file=sys.stderr)
        return 2
    except Exception as e:  # a crashed pass must not look like "clean"
        print(f"analysis pass crashed: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 2

    shown = findings if args.all else [f for f in findings if f.live]
    if args.as_json:
        print(json.dumps([f.__dict__ for f in shown], indent=1,
                         default=list))
    elif shown:
        print(format_findings(shown))

    live = [f for f in findings if f.live]
    n_sup = sum(1 for f in findings if f.suppressed)
    n_base = sum(1 for f in findings if f.baselined)
    print(
        f"repro_torch.analysis: {len(live)} live finding(s) "
        f"({n_sup} suppressed, {n_base} baselined) "
        f"across passes: {', '.join(args.passes)} on {args.device}",
        file=sys.stderr,
    )
    return 1 if (args.strict and live) else 0


if __name__ == "__main__":
    sys.exit(main())
