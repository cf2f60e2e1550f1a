"""RPL007 — non-atomic JSON writes to checkpoint/sidecar/ledger paths (port
of ``repro.lint.io_checks``, unchanged: on the same source it gives the
reference's findings).

A crash (or a kill -9) between ``open(path, "w")`` and the final flush
leaves a *truncated but present* JSON file.  For checkpoint manifests and
sim sidecars that is worse than no file at all: resume logic that picks the
newest pair by existence then dies inside ``json.load`` instead of falling
back to the previous good checkpoint — exactly the bug fixed in
``checkpoint/store.py`` and ``sim/engine.py``.  The repo-wide discipline is
therefore *tmp + os.replace*: dump into ``path + ".tmp"`` and atomically
rename over the target.

RPL007 flags any ``json.dump(obj, f)`` where ``f`` comes from a
``with open(path, "w")`` whose path expression is not tmp-like (no
``".tmp"`` component in the literal, f-string, concatenation, or the simple
assignment the name resolves to).  Test files are exempt — tests write
throwaway JSON (and deliberately truncated fixtures) all the time.
"""

from __future__ import annotations

import ast
import posixpath
from typing import Iterator, Optional

from repro_torch.lint.core import (Check, Finding, LintContext, SourceFile,
                                   register)
from repro_torch.lint.determinism import _call_name


def _expr_is_tmp_like(node: ast.AST, assigns: dict[str, ast.AST],
                      depth: int = 0) -> bool:
    """Does the path expression visibly carry a ``.tmp`` component?"""
    if depth > 8:
        return False
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str) and ".tmp" in node.value
    if isinstance(node, ast.JoinedStr):
        return any(
            isinstance(v, ast.Constant) and isinstance(v.value, str)
            and ".tmp" in v.value
            for v in node.values
        )
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        return (_expr_is_tmp_like(node.left, assigns, depth + 1)
                or _expr_is_tmp_like(node.right, assigns, depth + 1))
    if isinstance(node, ast.Name) and node.id in assigns:
        return _expr_is_tmp_like(assigns[node.id], assigns, depth + 1)
    return False


def _open_write_target(item: ast.withitem) -> Optional[tuple[ast.AST, str]]:
    """``(path_expr, as_name)`` when the withitem is ``open(path, "w"...)``."""
    call = item.context_expr
    if not isinstance(call, ast.Call) or _call_name(call.func) != "open":
        return None
    if not call.args:
        return None
    mode = None
    if len(call.args) >= 2:
        mode = call.args[1]
    for kw in call.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if not (isinstance(mode, ast.Constant) and isinstance(mode.value, str)
            and "w" in mode.value):
        return None
    if item.optional_vars is None or not isinstance(item.optional_vars,
                                                    ast.Name):
        return None
    return call.args[0], item.optional_vars.id


@register
class NonAtomicJsonDump(Check):
    id = "RPL007"
    title = "json.dump to a non-tmp path without the tmp + os.replace idiom"
    rationale = (
        "a crash mid-dump leaves a truncated-but-present JSON file that "
        "shadows the last good checkpoint/sidecar/ledger; dumping to "
        "path + '.tmp' then os.replace() makes the write atomic"
    )

    def applies(self, src: SourceFile) -> bool:
        name = posixpath.basename(src.path)
        return not (name.startswith("test_") or "/tests/" in src.path
                    or src.path.startswith("tests/"))

    def run(self, src: SourceFile, ctx: LintContext) -> Iterator[Finding]:
        # simple `name = expr` assignments anywhere in the file, for
        # resolving `tmp = path + ".tmp"` through the open() argument
        assigns: dict[str, ast.AST] = {}
        for sub in ast.walk(src.tree):
            if (isinstance(sub, ast.Assign) and len(sub.targets) == 1
                    and isinstance(sub.targets[0], ast.Name)):
                assigns[sub.targets[0].id] = sub.value
        for w in ast.walk(src.tree):
            if isinstance(w, ast.With):
                yield from self._check_with(src, w, assigns)

    def _check_with(self, src: SourceFile, w: ast.With,
                    assigns: dict[str, ast.AST]) -> Iterator[Finding]:
        for item in w.items:
            target = _open_write_target(item)
            if target is None:
                continue
            path_expr, as_name = target
            if _expr_is_tmp_like(path_expr, assigns):
                continue
            for sub in ast.walk(w):
                if not isinstance(sub, ast.Call):
                    continue
                if _call_name(sub.func) != "dump":
                    continue
                fileobj = None
                if len(sub.args) >= 2:
                    fileobj = sub.args[1]
                for kw in sub.keywords:
                    if kw.arg == "fp":
                        fileobj = kw.value
                if (isinstance(fileobj, ast.Name)
                        and fileobj.id == as_name):
                    yield self.finding(
                        src,
                        sub,
                        "json.dump into open(..., 'w') on a non-tmp path — "
                        "a crash mid-write leaves a truncated JSON shadowing "
                        "the last good file; dump to path + '.tmp' and "
                        "os.replace() it over the target (DESIGN.md §14)",
                    )
