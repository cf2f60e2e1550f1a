"""RPL001/RPL006 — nondeterminism sources and host syncs in the decode
(port of ``repro.lint.determinism``).

RPL001 carries over unchanged: on the same source it gives the reference's
findings. It codifies the bug class of ``data/datasets.py`` seeding its
class prototypes from builtin ``hash()``, which is salted per process
(``PYTHONHASHSEED``), so identical runs produced different accuracies across
invocations.  The check flags every statically recognizable source of
cross-process nondeterminism: builtin ``hash()``, wall-clock ``time.time()``
(use ``time.perf_counter()`` for durations; suppress for intentional epoch
stamps), argless ``datetime.now()``/``today()``/``utcnow()``, the
process-global stdlib ``random`` module (counter-based RNG is the
sanctioned source), and iteration-order dependence on sets (``for x in
set(...)``, ``list(set(...))`` — wrap in ``sorted()``).

RPL006 has the port's own meaning. The reference's rule (Python branching
on a traced value inside ``@jit``) has no ``jit`` to look at here: PyTorch
runs eagerly, and a Python branch on a tensor does not fail; it *syncs*.
Reading a tensor's value on the host (``.item()``, ``.tolist()``,
``.cpu()``, ``.numpy()``, or ``bool()``/``int()``/``float()`` of a tensor)
waits for the card to drain its queue. In the server's decode that stalls
every round, and the FL round is already host-bound, so the port's RPL006
flags a host sync inside the functions of the decode modules (RPL004's
scope: ``core/streams.py``, ``core/blocked.py``, ``kernels/*decode*``).
The AST shows no types: ``bool()``/``int()``/``float()`` count as a sync
when their argument is visibly computed on a value (a method call such as
``x.sum()``, a ``torch.*`` call, or a subscript ``x[0]``), never a bare
name, and not a shape query (``.shape``, ``.numel()``, ``.size()``, ...).
A sync on a tensor that lives on the host by design (the keyed path's pair
keys) carries a suppression comment that says so.
"""

from __future__ import annotations

import ast
import posixpath
from typing import Iterator

from repro_torch.lint.core import (Check, Finding, LintContext, SourceFile,
                                   register)

_DATETIME_NOW = {"now", "today", "utcnow"}
_ORDERED_CONSUMERS = {"list", "tuple", "enumerate", "iter"}

_HASH_MSG = (
    "builtin hash() is salted per process (PYTHONHASHSEED) — the "
    "prototype-seeding bug of data/datasets.py; use zlib.crc32 or hashlib "
    "for a stable digest"
)
_TIME_MSG = (
    "wall-clock time.time() is nondeterministic; use time.perf_counter() "
    "for durations, or suppress for an intentional epoch stamp"
)
_RANDOM_MSG = (
    "stdlib random draws from process-global state; use counter-based RNG "
    "(core/threefry, a seeded torch.Generator or np.random.RandomState)"
)
_DATETIME_MSG = (
    "argless datetime.{attr}() reads the wall clock; pass an explicit "
    "timestamp in"
)
_SET_ORDER_MSG = "set iteration order is unstable across processes; wrap in sorted(...)"


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        return node.func.id in ("set", "frozenset")
    return False


def _call_name(func: ast.AST) -> str:
    """Rightmost name of a call target: ``a.b.c(...)`` -> ``'c'``."""
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return ""


@register
class NondeterminismSources(Check):
    id = "RPL001"
    title = "nondeterminism source in seed/sim path"
    rationale = (
        "bit-exact cross-process replay is a stated contract (DESIGN.md §9); "
        "salted hash()/wall clocks/global random/set order silently break it"
    )

    def run(self, src: SourceFile, ctx: LintContext) -> Iterator[Finding]:
        random_names = self._stdlib_random_imports(src.tree)
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Call):
                yield from self._check_call(src, node, random_names)
            elif isinstance(node, (ast.For, ast.comprehension)):
                if _is_set_expr(node.iter):
                    yield self.finding(src, node.iter, _SET_ORDER_MSG)

    @staticmethod
    def _stdlib_random_imports(tree: ast.Module) -> set[str]:
        """Names bound to the stdlib ``random`` module or its members."""
        names: set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name == "random":
                        names.add(alias.asname or "random")
            elif isinstance(node, ast.ImportFrom):
                if node.module == "random" and node.level == 0:
                    for alias in node.names:
                        names.add(alias.asname or alias.name)
        return names

    def _check_call(
        self, src: SourceFile, node: ast.Call, random_names: set[str]
    ) -> Iterator[Finding]:
        func = node.func
        if isinstance(func, ast.Name):
            if func.id == "hash":
                yield self.finding(src, node, _HASH_MSG)
            elif func.id in random_names and func.id != "random":
                yield self.finding(src, node, _RANDOM_MSG)
            elif func.id in _ORDERED_CONSUMERS:
                if node.args and _is_set_expr(node.args[0]):
                    yield self.finding(src, node, _SET_ORDER_MSG)
        elif isinstance(func, ast.Attribute):
            base = func.value
            argless = not node.args and not node.keywords
            if isinstance(base, ast.Name):
                if base.id == "time" and func.attr == "time":
                    yield self.finding(src, node, _TIME_MSG)
                elif base.id in random_names:
                    yield self.finding(src, node, _RANDOM_MSG)
                elif base.id == "datetime" and func.attr in _DATETIME_NOW:
                    if argless:
                        msg = _DATETIME_MSG.format(attr=func.attr)
                        yield self.finding(src, node, msg)
            elif func.attr == "join" and node.args and _is_set_expr(node.args[0]):
                yield self.finding(src, node, _SET_ORDER_MSG)
            elif func.attr in _DATETIME_NOW and isinstance(base, ast.Attribute):
                if base.attr == "datetime" and argless:
                    msg = _DATETIME_MSG.format(attr=func.attr)
                    yield self.finding(src, node, msg)


_DECODE_FILES = ("core/streams.py", "core/blocked.py")

_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_SYNC_CASTS = {"bool", "int", "float"}
_SHAPE_QUERIES = {"shape", "ndim", "numel", "size", "dim", "stride",
                  "element_size", "data_ptr", "nelement", "device", "dtype"}


def in_decode_scope(src: SourceFile) -> bool:
    """The decode modules: ``core/streams.py``, ``core/blocked.py`` and
    ``kernels/*decode*.py`` (matched by suffix, as the reference's)."""
    if any(src.path.endswith(f) for f in _DECODE_FILES):
        return True
    name = posixpath.basename(src.path)
    return "decode" in name and name.endswith(".py")


def _is_shape_query(node: ast.AST) -> bool:
    return any(isinstance(sub, ast.Attribute) and sub.attr in _SHAPE_QUERIES
               for sub in ast.walk(node))


def _computes_a_value(node: ast.AST) -> bool:
    """Is ``node`` visibly a computed value (possibly a tensor)?"""
    if _is_shape_query(node):
        return False
    if isinstance(node, ast.Subscript):
        return True
    return isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)


@register
class HostSyncInDecode(Check):
    id = "RPL006"
    title = "host sync on a tensor inside a decode module"
    rationale = (
        "the port has no @jit to trace; .item()/.tolist()/.cpu()/.numpy() "
        "or bool()/int()/float() of a tensor waits for the card, stalling "
        "every round of a decode that is already host-bound"
    )

    def applies(self, src: SourceFile) -> bool:
        return in_decode_scope(src)

    def run(self, src: SourceFile, ctx: LintContext) -> Iterator[Finding]:
        for fn in ast.walk(src.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    yield from self._check_call(src, fn, node)

    def _check_call(self, src: SourceFile, fn: ast.AST,
                    node: ast.Call) -> Iterator[Finding]:
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr in _SYNC_METHODS:
            if func.attr == "cpu" or not node.args:
                yield self.finding(
                    src, node,
                    f".{func.attr}() in {fn.name}() reads a tensor on the "
                    "host: the decode waits for the card; keep the value "
                    "on the device, or suppress where it lives on the host "
                    "by design",
                )
        elif (isinstance(func, ast.Name) and func.id in _SYNC_CASTS
              and len(node.args) == 1 and _computes_a_value(node.args[0])):
            yield self.finding(
                src, node,
                f"{func.id}() of a computed value in {fn.name}() syncs with "
                "the card when the value is a tensor; keep it on the device "
                "(torch.where, masks), or suppress where it is a host value",
            )
