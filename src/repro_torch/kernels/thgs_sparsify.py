"""Fused THGS threshold split: the CUDA kernel's wrapper (port of
``repro.kernels.thgs_sparsify.thgs_sparsify``).

The kernel is ``csrc/thgs_sparsify.cu``, one grid-stride elementwise pass;
its plain version is ``kernels/ref.py::thgs_sparsify_ref``. A CPU tensor
takes the plain version, a CUDA tensor launches the kernel or raises.
``launches`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

launches = 0


def thgs_sparsify_cuda(g: torch.Tensor, residual: torch.Tensor, threshold):
    """Launch the kernel: ``g`` and ``residual`` of one shape, each f32 or
    bf16, on one CUDA device; ``threshold`` a float or a one-element tensor
    on that device (read by the kernel: no host sync). Returns ``(sparse``
    in g's dtype, ``new residual`` in residual's dtype)."""
    global launches
    if g.device.type != "cuda" or residual.device != g.device:
        raise ValueError("thgs_sparsify_cuda needs g and residual on one "
                         f"CUDA device, got {g.device} and {residual.device}")
    if g.shape != residual.shape:
        raise ValueError(f"g {tuple(g.shape)} and residual "
                         f"{tuple(residual.shape)} differ in shape")
    if (g.dtype not in build.DTYPE_CODES
            or residual.dtype not in build.DTYPE_CODES):
        raise ValueError("thgs_sparsify_cuda takes float32 or bfloat16, got "
                         f"{g.dtype} and {residual.dtype}")
    thr_ptr, thr = None, 0.0
    if torch.is_tensor(threshold):
        if threshold.device != g.device or threshold.numel() != 1:
            raise ValueError("a tensor threshold must be one element on "
                             f"{g.device}, got {threshold.numel()} on "
                             f"{threshold.device}")
        thr_t = threshold.to(torch.float32).reshape(1).contiguous()
        thr_ptr = thr_t.data_ptr()
    else:
        thr = float(threshold)
    g_in, r_in = g.contiguous(), residual.contiguous()
    sparse = torch.empty_like(g_in)
    resid = torch.empty_like(r_in)
    if g.numel() == 0:
        return sparse, resid
    fn = build.kernel("thgs_sparsify")
    with build.on_device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        rc = fn(g_in.data_ptr(), r_in.data_ptr(), thr_ptr, thr, g.numel(),
                build.DTYPE_CODES[g.dtype], build.DTYPE_CODES[residual.dtype],
                sparse.data_ptr(), resid.data_ptr(), stream)
    build.check(rc, "thgs_sparsify")
    launches += 1
    return sparse, resid
