"""Reporters and the ``repro.lint/v1`` JSON document (port of
``repro.lint.report``, the same schema: either package validates the
other's document, as the two bench schemas do).

``make_doc`` emits a machine-readable run summary; ``validate_doc`` returns
a list of schema violations (empty == valid) so tests and CI can round-trip
the document exactly like the BENCH_torch_*.json suites do.
"""

from __future__ import annotations

import re
from typing import Iterable, Sequence

from repro_torch.lint.core import CHECKS, Finding

SCHEMA_VERSION = "repro.lint/v1"

_CHECK_ID_RE = re.compile(r"^RPL\d{3}$")
_FINDING_FIELDS = {
    "check": str,
    "path": str,
    "line": int,
    "col": int,
    "message": str,
}


def _finding_dict(f: Finding) -> dict:
    return {
        "check": f.check,
        "path": f.path,
        "line": f.line,
        "col": f.col,
        "message": f.message,
    }


def make_doc(findings: Sequence[Finding], n_files: int, paths: Sequence[str]) -> dict:
    """Build one schema'd document from a lint run."""
    active = [f for f in findings if not f.suppressed]
    suppressed = [f for f in findings if f.suppressed]
    counts: dict[str, int] = {}
    for f in active:
        counts[f.check] = counts.get(f.check, 0) + 1
    return {
        "schema": SCHEMA_VERSION,
        "paths": [str(p) for p in paths],
        "files": int(n_files),
        "checks": sorted(CHECKS),
        "findings": [_finding_dict(f) for f in active],
        "suppressed": [_finding_dict(f) for f in suppressed],
        "counts": counts,
    }


def validate_doc(doc: object) -> list[str]:
    """Schema errors for ``doc`` (empty list == valid)."""
    errors: list[str] = []
    if not isinstance(doc, dict):
        return ["document is not an object"]
    if doc.get("schema") != SCHEMA_VERSION:
        errors.append(f"schema must be {SCHEMA_VERSION!r}, got {doc.get('schema')!r}")
    if not isinstance(doc.get("files"), int) or doc.get("files", -1) < 0:
        errors.append("files must be a non-negative int")
    if not isinstance(doc.get("paths"), list):
        errors.append("paths must be a list")
    for section in ("findings", "suppressed"):
        items = doc.get(section)
        if not isinstance(items, list):
            errors.append(f"{section} must be a list")
            continue
        for i, item in enumerate(items):
            errors.extend(_validate_finding(f"{section}[{i}]", item))
    counts = doc.get("counts")
    if not isinstance(counts, dict):
        errors.append("counts must be an object")
    elif isinstance(doc.get("findings"), list):
        derived: dict[str, int] = {}
        for item in doc["findings"]:
            if isinstance(item, dict) and isinstance(item.get("check"), str):
                derived[item["check"]] = derived.get(item["check"], 0) + 1
        if counts != derived:
            errors.append(f"counts {counts} do not match findings {derived}")
    return errors


def _validate_finding(where: str, item: object) -> list[str]:
    if not isinstance(item, dict):
        return [f"{where} is not an object"]
    errors = []
    for field, typ in _FINDING_FIELDS.items():
        if not isinstance(item.get(field), typ):
            errors.append(f"{where}.{field} must be {typ.__name__}")
    check = item.get("check")
    if isinstance(check, str) and not _CHECK_ID_RE.match(check):
        errors.append(f"{where}.check {check!r} is not an RPLxxx id")
    return errors


def render_text(
    findings: Iterable[Finding], n_files: int, *, show_suppressed: bool = False
) -> str:
    """Human-readable report: one ``path:line:col: ID message`` per finding."""
    lines = []
    n_active = 0
    n_suppressed = 0
    for f in findings:
        if f.suppressed:
            n_suppressed += 1
            if show_suppressed:
                lines.append(f"{f.location()}: {f.check} [suppressed] {f.message}")
        else:
            n_active += 1
            lines.append(f"{f.location()}: {f.check} {f.message}")
    summary = (
        f"{n_files} file(s) checked: {n_active} finding(s), "
        f"{n_suppressed} suppressed"
    )
    lines.append(summary)
    return "\n".join(lines)
