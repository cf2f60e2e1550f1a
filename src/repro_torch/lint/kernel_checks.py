"""RPL005 — the kernel-twin contract of the CUDA wrappers (port of
``repro.lint.kernel_checks``).

The reference's rule looks for ``pallas_call`` and so finds nothing in the
port. Here every kernel module in ``kernels/`` (all but ``ref.py``,
``ops.py``, ``build.py`` and ``__init__.py``) holds to two things:

(a) every public ``*_cuda`` wrapper has its plain PyTorch twin in the
    sibling ``kernels/ref.py`` — the version that the CPU takes and that
    ``chip_smoke.py`` holds each kernel against on the card. Twin names are
    resolved as in the reference, with ``_cuda`` in place of the bare name:
    ``name_ref``, the ``_apply``-stripped form (``mask_prng_apply_cuda`` ->
    ``mask_prng_ref``) and the de-pluralized form
    (``pair_mask_streams_cuda`` -> ``pair_mask_stream_ref``); a
    ``# repro-lint: twin=<ref_name>`` comment on the ``def`` line overrides
    the search;
(b) every launch runs inside a ``with build.on_device(...)`` block, so the
    kernel runs on the device whose stream it is handed (the multi-device
    launch contract). A launch is a call of what ``build.kernel(name)``
    returns with a stream argument (a name ``stream``, or an expression
    reading ``cuda_stream`` / ``current_stream``); a call without one, such
    as the scatter's scratch-size helper, is not a launch.
"""

from __future__ import annotations

import ast
import posixpath
from typing import Iterator

from repro_torch.lint.core import (Check, Finding, LintContext, SourceFile,
                                   register)
from repro_torch.lint.determinism import _call_name

_EXEMPT = {"ref.py", "ops.py", "build.py", "__init__.py"}
_SUFFIX = "_cuda"


def _twin_candidates(name: str) -> set[str]:
    cands = {f"{name}_ref"}
    if name.endswith("_apply"):
        cands.add(f"{name[: -len('_apply')]}_ref")
    if name.endswith("s"):
        cands.add(f"{name[:-1]}_ref")
    return cands


def _ref_names(src: SourceFile, ctx: LintContext) -> set[str] | None:
    """Top-level def names in the sibling ``ref.py``; None when absent."""
    ref_path = posixpath.join(posixpath.dirname(src.path), "ref.py")
    key = ("rpl005-ref-names", ref_path)
    if key not in ctx.cache:
        try:
            with open(ref_path, encoding="utf-8") as f:
                tree = ast.parse(f.read())
        except (OSError, SyntaxError):
            ctx.cache[key] = None
        else:
            ctx.cache[key] = {
                node.name
                for node in tree.body
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            }
    return ctx.cache[key]


def _is_kernel_lookup(node: ast.AST) -> bool:
    """``build.kernel(...)`` (or a bare ``kernel(...)``)."""
    return isinstance(node, ast.Call) and _call_name(node.func) == "kernel"


def _is_on_device(item: ast.withitem) -> bool:
    call = item.context_expr
    return isinstance(call, ast.Call) and _call_name(call.func) == "on_device"


def _has_stream_argument(node: ast.Call) -> bool:
    for arg in [*node.args, *(kw.value for kw in node.keywords)]:
        for sub in ast.walk(arg):
            if isinstance(sub, ast.Name) and sub.id == "stream":
                return True
            if isinstance(sub, ast.Attribute) and sub.attr == "cuda_stream":
                return True
            if (isinstance(sub, ast.Call)
                    and _call_name(sub.func) == "current_stream"):
                return True
    return False


def _launches(fn: ast.FunctionDef) -> list[tuple[ast.Call, bool]]:
    """Every launch in ``fn``'s own body, with whether it runs under
    ``build.on_device``."""
    launchers = {
        target.id
        for node in ast.walk(fn)
        if isinstance(node, ast.Assign) and _is_kernel_lookup(node.value)
        for target in node.targets
        if isinstance(target, ast.Name)
    }
    found: list[tuple[ast.Call, bool]] = []

    def visit(node: ast.AST, guarded: bool) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)) and node is not fn:
            return  # a nested def is checked on its own
        if isinstance(node, (ast.With, ast.AsyncWith)):
            guarded = guarded or any(_is_on_device(i) for i in node.items)
        if isinstance(node, ast.Call):
            func = node.func
            is_launcher = (isinstance(func, ast.Name) and func.id in launchers
                           ) or _is_kernel_lookup(func)
            if is_launcher and _has_stream_argument(node):
                found.append((node, guarded))
        for child in ast.iter_child_nodes(node):
            visit(child, guarded)

    visit(fn, False)
    return found


@register
class KernelTwinContract(Check):
    id = "RPL005"
    title = "CUDA wrapper missing its ref twin, or launching off on_device"
    rationale = (
        "kernel == plain-version parity is what keeps each kernel testable "
        "on the CPU and checked on the card; a launch outside "
        "build.on_device may run on another device than its stream's"
    )

    def applies(self, src: SourceFile) -> bool:
        in_kernels = posixpath.basename(posixpath.dirname(src.path)) == "kernels"
        return in_kernels and posixpath.basename(src.path) not in _EXEMPT

    def run(self, src: SourceFile, ctx: LintContext) -> Iterator[Finding]:
        for node in ast.walk(src.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for call, guarded in _launches(node):
                if not guarded:
                    yield self.finding(
                        src,
                        call,
                        f"{node.name}() launches a kernel outside "
                        "'with build.on_device(...)'; the launch may run on "
                        "another device than the stream it is handed",
                    )
        wrappers = [
            node for node in src.tree.body
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            and node.name.endswith(_SUFFIX) and not node.name.startswith("_")
        ]
        if not wrappers:
            return
        ref_names = _ref_names(src, ctx)
        for fn in wrappers:
            yield from self._check_twin(src, fn, ref_names)

    def _check_twin(
        self,
        src: SourceFile,
        fn: ast.FunctionDef,
        ref_names: set[str] | None,
    ) -> Iterator[Finding]:
        override = src.twin_overrides.get(fn.lineno)
        bare = fn.name[: -len(_SUFFIX)]
        cands = {override} if override else _twin_candidates(bare)
        if ref_names is None:
            yield self.finding(
                src,
                fn,
                f"CUDA wrapper {fn.name}() has no kernels/ref.py sibling "
                "to host its plain twin",
            )
        elif not (cands & ref_names):
            yield self.finding(
                src,
                fn,
                f"CUDA wrapper {fn.name}() has no plain twin in "
                f"kernels/ref.py (looked for {sorted(cands)}); add the twin "
                "or a '# repro-lint: twin=<name>' marker on the def line",
            )
