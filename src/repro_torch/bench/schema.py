"""BENCH_torch_*.json schema + the regression gate (port of
``repro.bench.schema``). No torch import at module level: the gate runs
without touching a device.

The document shape is the reference's ``repro.bench/v1``, so either
package's ``validate_doc`` accepts the other's documents; only the ``env``
block differs (torch, CUDA and the card instead of jax)::

    {
      "schema": "repro.bench/v1",
      "suite": "round",              # single-suite form
      "quick": true,
      "created_unix": 1753776000.0,
      "env": {"python": "3.12.3", "platform": "linux",
              "torch": "2.6.0", "cuda": "12.4",
              "backend": "cuda", "device_count": 1,
              "device_name": "NVIDIA H100 80GB HBM3",
              "power_limit": "700.00 W"},
      "entries": [
        {"name": "round/serial_c8",
         "us_per_call": 12345.6,      # 0.0 marks an info-only row
         "reps": 3,
         "derived": "648_clients_per_s"}
      ]
    }

    {"schema": "...", "quick": true, "env": {...},
     "suites": {"round": [...entries], "agg": [...entries]}}

Entry names are stable identifiers: they encode the workload (suite, client
count, size, device count) and equal the reference's for the same workload,
so quick and full runs never collide and the gate only ever compares like
against like. The machines differ: the port gates against its own
baselines, never the reference's.
"""
from __future__ import annotations

import json
import platform
import subprocess
import sys
import time
from typing import Iterable, Sequence

SCHEMA_VERSION = "repro.bench/v1"

# gate defaults: generous — host timings move between runs
DEFAULT_MAX_SLOWDOWN = 3.0
# entries faster than this are timer noise; never gate on them
DEFAULT_MIN_US = 20.0


def card_info(index: int = 0) -> tuple[str | None, str | None]:
    """``(name, power limit)`` of CUDA card ``index`` as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them, or
    ``(None, None)`` where no card is present. Without ``nvidia-smi`` the
    name comes from torch and the power limit stays None."""
    import torch

    if not torch.cuda.is_available():
        return None, None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    if len(out) > index and "," in out[index]:
        name, limit = out[index].rsplit(",", 1)
        return name.strip(), limit.strip()
    return torch.cuda.get_device_name(index), None


def env_info(device="cuda") -> dict:
    """Runtime fingerprint stamped into every document: the Python, torch
    and CUDA versions, the backend the suites ran on (``cuda`` or ``cpu``)
    with its device count, and the card's name and power limit."""
    import torch

    dev = torch.device(device)
    name, limit = card_info(dev.index or 0)
    return {
        "python": platform.python_version(),
        "platform": sys.platform,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "backend": dev.type,
        "device_count": (torch.cuda.device_count() if dev.type == "cuda"
                         else 1),
        "device_name": name,
        "power_limit": limit,
    }


def make_doc(entries: list[dict], *, suite: str | None = None,
             suites: dict[str, list[dict]] | None = None,
             quick: bool = False, device="cuda") -> dict:
    """A schema'd document for one suite (``suite=``) or several
    (``suites=``, the ``--out`` combined form), run on ``device``."""
    assert (suite is None) != (suites is None), "exactly one of suite/suites"
    doc = {
        "schema": SCHEMA_VERSION,
        "quick": bool(quick),
        # intentional epoch stamp (doc metadata, not a timed duration)
        "created_unix": time.time(),  # repro-lint: disable=RPL001
        "env": env_info(device),
    }
    if suite is not None:
        doc["suite"] = suite
        doc["entries"] = entries
    else:
        doc["suites"] = suites
    return doc


def validate_doc(doc: dict) -> list[str]:
    """Schema errors ([] = valid). Checked by tests and before every gate."""
    errs: list[str] = []
    if not isinstance(doc, dict):
        return ["document is not an object"]
    if doc.get("schema") != SCHEMA_VERSION:
        errs.append(f"schema must be {SCHEMA_VERSION!r}, "
                    f"got {doc.get('schema')!r}")
    if not isinstance(doc.get("env"), dict):
        errs.append("missing env object")
    single = "entries" in doc
    multi = "suites" in doc
    if single == multi:
        errs.append("need exactly one of 'entries' (with 'suite') "
                    "or 'suites'")
        return errs
    if single and not isinstance(doc.get("suite"), str):
        errs.append("'entries' form needs a string 'suite'")
    groups = ({doc.get("suite", "?"): doc["entries"]} if single
              else doc["suites"])
    if not isinstance(groups, dict):
        return errs + ["'suites' must be an object"]
    for sname, entries in groups.items():
        if not isinstance(entries, list) or not entries:
            errs.append(f"suite {sname!r}: entries must be a non-empty list")
            continue
        seen = set()
        for e in entries:
            name = e.get("name") if isinstance(e, dict) else None
            if not isinstance(name, str) or not name:
                errs.append(f"suite {sname!r}: entry without a name: {e!r}")
                continue
            if name in seen:
                errs.append(f"suite {sname!r}: duplicate entry {name!r}")
            seen.add(name)
            us = e.get("us_per_call")
            if not isinstance(us, (int, float)) or us < 0:
                errs.append(f"{name}: us_per_call must be a number >= 0")
            if "derived" in e and not isinstance(e["derived"], str):
                errs.append(f"{name}: derived must be a string")
    return errs


def iter_entries(doc: dict) -> Iterable[dict]:
    """Entries of either document form, flattened."""
    if "entries" in doc:
        yield from doc["entries"]
    for entries in doc.get("suites", {}).values():
        yield from entries


def load_doc(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    errs = validate_doc(doc)
    if errs:
        raise ValueError(f"{path}: invalid bench document: " + "; ".join(errs))
    return doc


def gate_compare(current: dict, baselines: Sequence[dict], *,
                 max_slowdown: float = DEFAULT_MAX_SLOWDOWN,
                 min_us: float = DEFAULT_MIN_US) -> tuple[list[str], int]:
    """Compare a fresh run against the committed baselines.

    Matches entries by name; an entry regresses when
    ``current > max_slowdown * baseline`` and the baseline is above the
    ``min_us`` noise floor. Info rows (``us_per_call == 0``) never gate.
    Returns ``(failure_lines, n_compared)`` — the caller must also fail when
    ``n_compared == 0`` (a vacuous gate means the baseline is stale, e.g.
    quick entries compared against a full-mode baseline).
    """
    base_by_name: dict[str, float] = {}
    for doc in baselines:
        for e in iter_entries(doc):
            base_by_name[e["name"]] = float(e["us_per_call"])
    failures: list[str] = []
    compared = 0
    for e in iter_entries(current):
        name = e["name"]
        cur = float(e["us_per_call"])
        base = base_by_name.get(name)
        if base is None or cur == 0.0 or base == 0.0:
            continue
        compared += 1
        if base < min_us:
            continue
        if cur > max_slowdown * base:
            failures.append(
                f"{name}: {cur:.1f}us vs baseline {base:.1f}us "
                f"({cur / base:.2f}x > {max_slowdown:.1f}x)")
    return failures, compared
