"""repro_torch — the PyTorch/CUDA port of the THGS + sparse secure
aggregation system, beside the JAX reference package ``repro``.

It mirrors the reference's layout (``repro_torch.core.streams`` ports
``repro.core.streams``, and so on), imports PyTorch and numpy and nothing of
JAX or of ``repro``. The data plane's two kernels are hand-written CUDA for
Hopper (``kernels/csrc``), built at first CUDA use; on a CPU tensor every
kernel entry point takes its plain PyTorch version.
"""
__version__ = "0.1.0"
