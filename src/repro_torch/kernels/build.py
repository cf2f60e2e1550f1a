"""Build and load the port's CUDA kernels.

Each source under ``kernels/csrc/`` is compiled by ``nvcc`` for ``sm_90a``
into its own shared library with a plain C interface, and loaded with
``ctypes``. The sources include no PyTorch header, so a build takes seconds;
all sources compile in parallel (one ``nvcc`` each, started together).

The build runs at first CUDA use, never at import: importing ``repro_torch``
on a machine without ``nvcc`` builds nothing. A failed build raises. Outputs
go to ``build/repro_torch_ext/`` at the root of the checkout (ignored by git),
or to ``$REPRO_TORCH_BUILD_DIR``; each library's file name carries a digest
of its source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source or header is rebuilt.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# each source's C entry points (one per kernel -- the pair masks' is the
# segmented round launch, which the flat per-pair call uses as one segment
# -- the packs' segmented twins, and the scatter's scratch-size helper) and
# their ctypes signatures; the result is a C int (a cudaError code) unless a
# third element names another type
_P, _LL, _U, _F, _I = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint,
                       ctypes.c_float, ctypes.c_int)
SOURCES = {
    "stream_scatter_add.cu": {
        "stream_scatter_add": ("stream_scatter_add_launch",
                               [_P, _P, _LL, _P, _LL, _P, _LL, _P]),
        "stream_scatter_add_workspace_bytes": (
            "stream_scatter_add_workspace_bytes", [_LL, _LL], _LL)},
    "pair_mask_streams.cu": {
        "pair_mask_streams": ("pair_mask_round_launch",
                              [_P, _P, _P, _I, _I, _I, _I, _F, _F, _P, _I,
                               _P]),
        "mask_prng_apply": ("mask_prng_apply_launch",
                            [_P, _LL, _U, _F, _F, _F, _F, _I, _P, _P, _P])},
    "thgs_sparsify.cu": {
        "thgs_sparsify": ("thgs_sparsify_launch",
                          [_P, _P, _P, _F, _LL, _I, _I, _P, _P, _P])},
    "bitpack.cu": {
        "bitpack_rows": ("bitpack_rows_launch",
                         [_P, _LL, _LL, _I, _P, _LL, _P]),
        "bitunpack_rows": ("bitunpack_rows_launch",
                           [_P, _LL, _LL, _LL, _I, _P, _P]),
        "bitpack_segments": ("bitpack_segments_launch", [_P, _I, _P]),
        "bitunpack_segments": ("bitunpack_segments_launch", [_P, _I, _P])},
    "flash_attention.cu": {
        "flash_attention": ("flash_attention_launch",
                            [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                             _I, _P])},
}
N_ENTRIES = sum(len(entries) for entries in SOURCES.values())
# the floating-point dtype code the launchers take
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_LOCK = threading.Lock()
_FUNCS: dict = {}
build_seconds: float | None = None


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_ext"


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    nvcc = shutil.which("nvcc") or shutil.which("nvcc", path=f"{home}/bin")
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are built from "
            "src/repro_torch/kernels/csrc at first CUDA use and need the CUDA "
            "toolkit (nvcc on PATH or under $CUDA_HOME/bin)")
    return nvcc


def _lib_path(fname: str) -> Path:
    src = CSRC / fname
    # the shared headers are part of every source's digest
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def build_all(verbose: bool = False) -> dict:
    """Compile every missing library (in parallel) and load all of them.

    Returns ``{kernel name: ctypes function}``; idempotent and thread-safe.
    """
    global build_seconds
    with _LOCK:
        if len(_FUNCS) == N_ENTRIES:
            return _FUNCS
        t0 = time.perf_counter()
        build_dir().mkdir(parents=True, exist_ok=True)
        procs = []
        for fname in SOURCES:
            out = _lib_path(fname)
            if out.exists():
                continue
            tmp = out.with_name(out.name + f".tmp{os.getpid()}")
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / fname)]
            if verbose:
                cmd[1:1] = ["-Xptxas", "-v"]
            procs.append((fname, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        errors = []
        for name, out, tmp, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
                continue
            if verbose and log.strip():
                print(f"[nvcc {name}]\n{log.rstrip()}", flush=True)
            os.replace(tmp, out)
        if errors:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
        for fname, entries in SOURCES.items():
            lib = ctypes.CDLL(str(_lib_path(fname)))
            for name, (sym, argtypes, *restype) in entries.items():
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = restype[0] if restype else ctypes.c_int
                _FUNCS[name] = fn
        build_seconds = time.perf_counter() - t0
        return _FUNCS


def kernel(name: str):
    """The loaded C launcher of one kernel, building on first use."""
    fn = _FUNCS.get(name)
    return fn if fn is not None else build_all()[name]


def on_device(device):
    """The guard every launch runs under: ``device`` made the current CUDA
    device for the launch, so the kernel runs on the device whose stream it
    is handed (a launch into another device's stream is refused) and the
    launcher's per-device set-up reads the right device."""
    return torch.cuda.device(device)


def check(rc: int, name: str) -> None:
    """Raise on a refused launch (the C launcher returns cudaGetLastError)."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")
