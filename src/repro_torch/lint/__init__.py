"""repro_torch.lint — AST-based invariant checks for the port (port of
``repro.lint``).

The type system sees none of the invariants the port rests on: bit-exact
cross-process replay, pair-mask cancellation that only holds on the f32
2^-24 grid, min-of-reps bench timing, the concatenation combine and the
slot-order fold of the decode, and the contract that every CUDA kernel has
its plain twin and launches on its own device. ``repro_torch.lint`` codifies
each as a named, testable static check, with the reference's ids:

========  ==============================================================
RPL001    nondeterminism sources (hash(), time.time(), stdlib random,
          argless datetime.now(), set iteration order); the reference's
RPL002    bench suites under ``repro_torch/bench/`` timing outside
          ``timing.measure`` (min-of-reps)
RPL003    codec x secagg entry points missing the shared non-f32 guard;
          the reference's
RPL004    non-associative combines (psum-style, torch.distributed
          reductions) and accumulating scatters (index_add, scatter_add,
          scatter_reduce, index_put(accumulate=True)) in decode modules
RPL005    CUDA wrappers (``kernels/*_cuda``) without a kernels/ref.py
          twin, or launching outside ``build.on_device``
RPL006    host syncs (.item(), .tolist(), .cpu(), .numpy(), bool()/int()/
          float() of a tensor) inside decode modules: the port has no
          ``@jit`` for the reference's traced-branch rule to look at
RPL007    json.dump to a non-tmp path (crash leaves a truncated file;
          the discipline is dump to path + '.tmp' then os.replace);
          the reference's
========  ==============================================================

``python -m repro_torch.lint --gate`` runs the suite over ``src/repro_torch``
and the port's tests and exits non-zero on any unsuppressed finding;
findings are suppressed per line with ``# repro-lint: disable=RPLxxx``, the
reference's comment, so one comment serves both gates.

Import discipline: standard library only — this package imports neither
torch, jax nor ``repro``.
"""

from __future__ import annotations

from repro_torch.lint import bench_checks as _bench_checks
from repro_torch.lint import determinism as _determinism
from repro_torch.lint import io_checks as _io_checks
from repro_torch.lint import kernel_checks as _kernel_checks
from repro_torch.lint import secagg_checks as _secagg_checks
from repro_torch.lint.core import (
    CHECKS,
    PARSE_ERROR_ID,
    Check,
    Finding,
    LintContext,
    SourceFile,
    iter_python_files,
    lint_file,
    lint_paths,
    lint_source,
    register,
)
from repro_torch.lint.report import (SCHEMA_VERSION, make_doc, render_text,
                                     validate_doc)

del _bench_checks, _determinism, _io_checks, _kernel_checks, _secagg_checks

__all__ = [
    "CHECKS",
    "Check",
    "Finding",
    "LintContext",
    "PARSE_ERROR_ID",
    "SCHEMA_VERSION",
    "SourceFile",
    "iter_python_files",
    "lint_file",
    "lint_paths",
    "lint_source",
    "make_doc",
    "register",
    "render_text",
    "validate_doc",
]
