"""CLI: ``python -m repro_torch.lint [paths...] [--gate] [--format json]``
(port of ``repro.lint.__main__``: the same flags and exit codes).

``--gate`` exits 1 on any unsuppressed finding — and on a vacuous run (no
files linted), so a mistyped path cannot silently pass; a usage error (an
unknown check id) exits 2. With no paths it lints ``src/repro_torch`` and
the port's tests (``tests/test_torch_*.py``) under the working directory,
where the reference lints ``src`` and ``tests``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Sequence

from repro_torch.lint import core, report

DEFAULT_PATHS = ("src/repro_torch", "tests/test_torch_*.py")


def default_paths() -> list[str]:
    """:data:`DEFAULT_PATHS` with the test pattern expanded (sorted)."""
    return [p for pattern in DEFAULT_PATHS
            for p in (sorted(glob.glob(pattern)) if glob.has_magic(pattern)
                      else [pattern]) if os.path.exists(p)]


def _parse_ids(raw: str | None) -> set[str] | None:
    if not raw:
        return None
    return {s.strip() for s in raw.split(",") if s.strip()}


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.lint",
        description="AST-based invariant checks of the port (DESIGN.md §14)",
    )
    ap.add_argument(
        "paths",
        nargs="*",
        default=None,
        help=f"files/directories to lint (default: {' '.join(DEFAULT_PATHS)})",
    )
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--out", default=None, help="write the report to a file")
    ap.add_argument(
        "--gate",
        action="store_true",
        help="exit 1 on any unsuppressed finding (or a vacuous run)",
    )
    ap.add_argument("--select", default=None, help="comma-separated check ids")
    ap.add_argument("--ignore", default=None, help="comma-separated check ids")
    ap.add_argument(
        "--show-suppressed",
        action="store_true",
        help="include suppressed findings in the text report",
    )
    ap.add_argument(
        "--list-checks", action="store_true", help="print the check catalogue"
    )
    args = ap.parse_args(argv)

    if args.list_checks:
        for check_id in sorted(core.CHECKS):
            check = core.CHECKS[check_id]
            print(f"{check_id}  {check.title}")
            print(f"        {check.rationale}")
        return 0

    paths = args.paths or default_paths()
    select = _parse_ids(args.select)
    ignore = _parse_ids(args.ignore)
    unknown = (select or set()) | (ignore or set())
    unknown -= set(core.CHECKS) | {core.PARSE_ERROR_ID}
    if unknown:
        print(f"unknown check id(s): {sorted(unknown)}", file=sys.stderr)
        return 2

    findings, n_files = core.lint_paths(paths, select=select, ignore=ignore)
    active = [f for f in findings if not f.suppressed]

    if args.format == "json":
        text = json.dumps(report.make_doc(findings, n_files, paths), indent=1)
    else:
        text = report.render_text(
            findings, n_files, show_suppressed=args.show_suppressed
        )
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(text + "\n")
    else:
        print(text)

    if args.gate:
        if n_files == 0:
            print("gate FAILED: no files linted (vacuous gate)", file=sys.stderr)
            return 1
        if active:
            print(f"gate FAILED: {len(active)} finding(s)", file=sys.stderr)
            return 1
        print(f"gate OK: {n_files} file(s) clean", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
