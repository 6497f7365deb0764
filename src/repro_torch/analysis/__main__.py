"""``python -m repro_torch.analysis`` — run mergelint from the command line.

Exit codes: 0 clean, 1 findings, 2 usage error.

Examples::

    python -m repro_torch.analysis               # lint the repo (text)
    python -m repro_torch.analysis --format json  # machine-readable
    python -m repro_torch.analysis --show-waived  # include waived findings
    python -m repro_torch.analysis --passes guarded-by,durability
    python -m repro_torch.analysis src/repro_torch/store/tiered.py
    python -m repro_torch.analysis --update-baseline  # bootstrap only
"""
from __future__ import annotations

import argparse
import os
import sys

from repro_torch.analysis import baseline as baseline_mod
from repro_torch.analysis import runner
from repro_torch.analysis.findings import render_json, render_text


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="mergelint: repo-specific static analysis for MergePipe",
    )
    ap.add_argument("paths", nargs="*",
                    help="files to lint (default: all of src/repro_torch)")
    ap.add_argument("--root", default=None,
                    help="repo root (default: auto-detect from cwd)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--passes", default=None,
                    help="comma-separated subset of: %s"
                         % ",".join(runner.ALL_PASSES))
    ap.add_argument("--show-waived", action="store_true",
                    help="also print waived findings (text format)")
    ap.add_argument("--list-passes", action="store_true")
    ap.add_argument("--baseline", default=None,
                    help="baseline file (default: <root>/%s)"
                         % baseline_mod.BASELINE_NAME)
    ap.add_argument("--update-baseline", action="store_true",
                    help="write current findings to the baseline file "
                         "(bootstrap; entries still need reasons)")
    args = ap.parse_args(argv)

    if args.list_passes:
        for pid in runner.ALL_PASSES:
            print(pid)
        return 0

    passes = None
    if args.passes:
        passes = [p.strip() for p in args.passes.split(",") if p.strip()]
        unknown = [p for p in passes if p not in runner.ALL_PASSES]
        if unknown:
            print("mergelint: unknown pass(es): %s" % ", ".join(unknown),
                  file=sys.stderr)
            return 2

    root = args.root or runner.find_repo_root(os.getcwd())
    baseline_path = args.baseline or os.path.join(
        root, baseline_mod.BASELINE_NAME)

    if args.paths:
        paths = [os.path.abspath(p) for p in args.paths]
        findings = runner.run_paths(paths, root=root, passes=passes)
        findings.extend(baseline_mod.lint_baseline(baseline_path))
        baseline_mod.apply(findings, baseline_mod.load(baseline_path))
    else:
        findings = runner.run_repo(
            root, passes=passes, baseline_path=baseline_path)

    if args.update_baseline:
        n = baseline_mod.write(baseline_path, findings)
        print("mergelint: wrote %d entr%s to %s (add reasons before "
              "committing)" % (n, "y" if n == 1 else "ies", baseline_path))
        return 0

    if args.format == "json":
        print(render_json(findings))
    else:
        print(render_text(findings, show_waived=args.show_waived))
    return 1 if any(not f.waived for f in findings) else 0


if __name__ == "__main__":
    sys.exit(main())
