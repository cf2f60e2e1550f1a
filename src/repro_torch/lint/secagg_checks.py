"""RPL003/RPL004 — secagg x codec guard and decode-combine invariants
(port of ``repro.lint.secagg_checks``).

RPL003 carries over unchanged: sparse pair masks cancel bit-exactly only on
the f32 2^-24 grid (Beguier et al., arXiv 2007.14861; DESIGN.md §12), so
every public entry point that accepts both a ``codec`` and a
secure-aggregation parameter must route the combination through the one
shared guard, the port's ``repro_torch.core.codecs.reject_codec_with_masks``.

RPL004: DESIGN.md §13 mandates the *concatenation* combine for the tree
decode — f32 addition is non-associative, and any partial-sum combine of
per-group dense buffers silently breaks the tree==flat bit-parity that every
hierarchical-aggregation test relies on.  Scope: the decode modules
(``core/streams.py``, ``core/blocked.py``, ``kernels/*decode*``), matched by
suffix as the reference's. Besides the reference's names (``psum``,
``psum_scatter``, ``all_reduce``, ``pmean``, ``reduce(add, ...)``) the port
flags ``torch.distributed``'s reductions (``reduce_scatter``,
``reduce_scatter_tensor``) and PyTorch's accumulating scatters, which fold
duplicates in no fixed order: CPU ``index_put_(accumulate=True)`` uses
multi-threaded atomics above its grain size, and CUDA sorts duplicates and
warp-reduces them (``index_add``/``index_add_``, ``index_put``/
``index_put_`` with ``accumulate=True``, ``scatter_add``/``scatter_add_``,
``scatter_reduce``/``scatter_reduce_``). The sanctioned fold is
``kernels/ops.stream_scatter_add``, which folds each position in slot order.
A scatter whose indices are distinct within each row folds one value a
position and carries a suppression comment that says so.
"""

from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.lint.core import (Check, Finding, LintContext, SourceFile,
                                   register)
from repro_torch.lint.determinism import _call_name, in_decode_scope

GUARD_NAMES = {"reject_codec_with_masks", "_reject_codec_with_masks"}

#: parameters whose presence marks a secure-aggregation surface
MASK_PARAMS = {"sa", "k_mask", "k_masks", "pair_seeds", "pair_keys", "use_masks"}

_FORBIDDEN_COMBINES = {"psum", "psum_scatter", "all_reduce", "pmean",
                       "reduce_scatter", "reduce_scatter_tensor"}

_UNORDERED_SCATTERS = {"index_add", "index_add_", "scatter_add",
                       "scatter_add_", "scatter_reduce", "scatter_reduce_"}
_ACCUMULATING_PUTS = {"index_put", "index_put_"}


def _param_names(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> set[str]:
    args = fn.args
    return {a.arg for a in args.posonlyargs + args.args + args.kwonlyargs}


def _accumulates(node: ast.Call) -> bool:
    """``index_put(..., accumulate=True)``, by keyword or as the third
    positional argument (``torch.index_put(x, idx, v, True)``: the fourth)."""
    for kw in node.keywords:
        if kw.arg == "accumulate":
            return not (isinstance(kw.value, ast.Constant)
                        and kw.value.value is False)
    is_function = (isinstance(node.func, ast.Attribute)
                   and isinstance(node.func.value, ast.Name)
                   and node.func.value.id == "torch")
    pos = 3 if is_function else 2
    if len(node.args) > pos:
        arg = node.args[pos]
        return not (isinstance(arg, ast.Constant) and arg.value is False)
    return False


@register
class CodecMaskGuard(Check):
    id = "RPL003"
    title = "codec x secagg entry point misses the shared rejection guard"
    rationale = (
        "quantized codecs off the f32 2^-24 grid break pair-mask "
        "cancellation; one shared guard keeps every layer's rejection "
        "identical"
    )

    def run(self, src: SourceFile, ctx: LintContext) -> Iterator[Finding]:
        for node in ast.walk(src.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if node.name.startswith("_") or node.name in GUARD_NAMES:
                continue
            params = _param_names(node)
            if "codec" not in params or not (params & MASK_PARAMS):
                continue
            calls_guard = any(
                isinstance(sub, ast.Call) and _call_name(sub.func) in GUARD_NAMES
                for sub in ast.walk(node)
            )
            if not calls_guard:
                yield self.finding(
                    src,
                    node,
                    f"public entry point {node.name}() accepts 'codec' and a "
                    f"secagg parameter ({sorted(params & MASK_PARAMS)}) but "
                    "never calls codecs.reject_codec_with_masks — non-f32 "
                    "codecs must be rejected under masks (DESIGN.md §12)",
                )


@register
class DecodeCombine(Check):
    id = "RPL004"
    title = "non-associative or unordered reduction in a decode module"
    rationale = (
        "f32 addition is non-associative; DESIGN.md §13 mandates the "
        "concatenation combine and the slot-order fold so tree==flat stays "
        "bit-exact"
    )

    def applies(self, src: SourceFile) -> bool:
        return in_decode_scope(src)

    def run(self, src: SourceFile, ctx: LintContext) -> Iterator[Finding]:
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node.func)
            if name in _FORBIDDEN_COMBINES:
                yield self.finding(
                    src,
                    node,
                    f"{name}() combines partial sums in a decode module — "
                    "f32 addition is non-associative and breaks tree==flat "
                    "bit-parity; use the range-sharded concatenation combine "
                    "(DESIGN.md §13)",
                )
            elif name in _UNORDERED_SCATTERS or (
                    name in _ACCUMULATING_PUTS and _accumulates(node)):
                yield self.finding(
                    src,
                    node,
                    f"{name}() folds duplicate indices in no fixed order "
                    "(atomics on the CPU, a sort and warp reduction on the "
                    "card); fold through ops.stream_scatter_add, which adds "
                    "each position in slot order",
                )
            elif name == "reduce" and node.args:
                first = node.args[0]
                if _call_name(first) == "add" or (
                    isinstance(first, ast.Attribute) and first.attr == "add"
                ):
                    yield self.finding(
                        src,
                        node,
                        "reduce(add, ...) over decode partials is order-"
                        "dependent in f32; use the concatenation combine "
                        "(DESIGN.md §13)",
                    )
