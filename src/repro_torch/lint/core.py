"""Visitor core for ``repro_torch.lint`` — files, suppressions, registry,
runner (port of ``repro.lint.core``).

Pure standard library, like the reference's gate: no torch, jax or
``repro`` import, so the CLI and the gate run without touching a backend.
A small registry of named checks, and the reference's machine-readable
document (``repro.lint/v1``, :mod:`repro_torch.lint.report`).

Every check is AST-based: string literals, comments and docstrings are never
flagged, so tests can embed bad snippets as fixtures and modules can document
forbidden patterns freely.  Findings are suppressed per line with a trailing
``# repro-lint: disable=RPL001`` comment (or ``disable-next=`` on the line
above, or ``disable-file=`` anywhere in the file); suppressed findings stay
in the report but do not fail the ``--gate``. The comment syntax is the
reference's, so one comment serves both gates; ``# repro-lint: twin=<name>``
on a ``def`` line names a kernel wrapper's twin (RPL005).
"""

from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import tokenize
from typing import Iterable, Iterator

_SUPPRESS_RE = re.compile(
    r"#\s*repro-lint:\s*(disable|disable-next|disable-file)=([A-Za-z0-9_,\s]+)"
)
_TWIN_RE = re.compile(r"#\s*repro-lint:\s*twin=([A-Za-z0-9_]+)")

PARSE_ERROR_ID = "RPL000"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint finding; ``suppressed`` findings never fail the gate."""

    check: str
    path: str
    line: int
    col: int
    message: str
    suppressed: bool = False

    def location(self) -> str:
        return f"{self.path}:{self.line}:{self.col}"


class SourceFile:
    """A parsed source file plus its suppression table."""

    def __init__(self, path: str, text: str):
        self.path = path.replace(os.sep, "/")
        self.text = text
        self.tree = ast.parse(text)  # raises SyntaxError -> RPL000 upstream
        self.line_suppress: dict[int, set[str]] = {}
        self.file_suppress: set[str] = set()
        self.twin_overrides: dict[int, str] = {}
        self._scan_comments()

    def _scan_comments(self) -> None:
        try:
            tokens = tokenize.generate_tokens(io.StringIO(self.text).readline)
            comments = [t for t in tokens if t.type == tokenize.COMMENT]
        except (tokenize.TokenError, IndentationError):  # pragma: no cover
            return
        for tok in comments:
            line = tok.start[0]
            twin = _TWIN_RE.search(tok.string)
            if twin:
                self.twin_overrides[line] = twin.group(1)
            m = _SUPPRESS_RE.search(tok.string)
            if not m:
                continue
            directive, raw = m.group(1), m.group(2)
            ids = {s.strip() for s in raw.split(",") if s.strip()}
            if directive == "disable-file":
                self.file_suppress |= ids
            elif directive == "disable-next":
                self.line_suppress.setdefault(line + 1, set()).update(ids)
            else:
                self.line_suppress.setdefault(line, set()).update(ids)

    def is_suppressed(self, check_id: str, line: int) -> bool:
        if check_id in self.file_suppress:
            return True
        return check_id in self.line_suppress.get(line, ())


class LintContext:
    """Shared cross-file state for one run (e.g. RPL005's twin names)."""

    def __init__(self) -> None:
        self.cache: dict = {}


class Check:
    """Base class: subclass, set ``id``/``title``/``rationale``, register."""

    id = ""
    title = ""
    rationale = ""

    def applies(self, src: SourceFile) -> bool:
        return True

    def run(self, src: SourceFile, ctx: LintContext) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, src: SourceFile, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0) + 1
        return Finding(self.id, src.path, line, col, message)


CHECKS: dict[str, Check] = {}


def register(cls: type[Check]) -> type[Check]:
    """Class decorator adding one check instance to the registry."""
    inst = cls()
    if not inst.id or inst.id in CHECKS:
        raise ValueError(f"bad or duplicate check id {inst.id!r}")
    CHECKS[inst.id] = inst
    return cls


def _selected(select: set[str] | None, ignore: set[str] | None) -> list[Check]:
    checks = [CHECKS[k] for k in sorted(CHECKS)]
    if select:
        checks = [c for c in checks if c.id in select]
    if ignore:
        checks = [c for c in checks if c.id not in ignore]
    return checks


def lint_source(
    text: str,
    path: str,
    *,
    select: set[str] | None = None,
    ignore: set[str] | None = None,
    ctx: LintContext | None = None,
) -> list[Finding]:
    """Lint one source string as if it lived at ``path``.

    Path-scoped checks (RPL002 bench suites, RPL004 and RPL006 decode
    modules, RPL005 kernel modules) key off ``path``, so fixtures can
    exercise them without touching the real tree.
    """
    ctx = ctx if ctx is not None else LintContext()
    try:
        src = SourceFile(path, text)
    except SyntaxError as e:
        line = e.lineno or 1
        col = e.offset or 1
        msg = f"file does not parse: {e.msg}"
        return [Finding(PARSE_ERROR_ID, path.replace(os.sep, "/"), line, col, msg)]
    findings: list[Finding] = []
    for check in _selected(select, ignore):
        if not check.applies(src):
            continue
        for f in check.run(src, ctx):
            if src.is_suppressed(f.check, f.line):
                f = dataclasses.replace(f, suppressed=True)
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.check))
    return findings


def lint_file(
    path: str,
    *,
    select: set[str] | None = None,
    ignore: set[str] | None = None,
    ctx: LintContext | None = None,
) -> list[Finding]:
    """Lint one file on disk."""
    with open(path, encoding="utf-8") as f:
        text = f.read()
    return lint_source(text, path, select=select, ignore=ignore, ctx=ctx)


_SKIP_DIRS = {"__pycache__", ".git", ".ruff_cache", ".pytest_cache", "node_modules"}


def iter_python_files(paths: Iterable[str]) -> Iterator[str]:
    """Yield ``.py`` files under each path (files pass through verbatim)."""
    for p in paths:
        if os.path.isfile(p):
            yield p
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = sorted(
                d for d in dirnames if d not in _SKIP_DIRS and not d.startswith(".")
            )
            for name in sorted(filenames):
                if name.endswith(".py"):
                    yield os.path.join(dirpath, name)


def lint_paths(
    paths: Iterable[str],
    *,
    select: set[str] | None = None,
    ignore: set[str] | None = None,
) -> tuple[list[Finding], int]:
    """Lint every python file under ``paths``; returns ``(findings, n_files)``."""
    ctx = LintContext()
    findings: list[Finding] = []
    n_files = 0
    for path in iter_python_files(paths):
        n_files += 1
        findings.extend(lint_file(path, select=select, ignore=ignore, ctx=ctx))
    return findings, n_files
