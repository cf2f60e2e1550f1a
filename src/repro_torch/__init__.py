"""repro_torch — the PyTorch/CUDA port of the THGS + sparse secure
aggregation system, beside the JAX reference package ``repro``.

It mirrors the reference's layout (``repro_torch.core.streams`` ports
``repro.core.streams``, and so on), imports PyTorch and numpy and nothing of
JAX or of ``repro``. Each of the reference's seven Pallas kernels (the
stream scatter-add, the pair masks, the two bit packs, flash attention, the
THGS split and the dense mask apply) is hand-written CUDA for Hopper
(``kernels/csrc``), built at first CUDA use; on a CPU tensor every kernel
entry point takes its plain PyTorch version. This package itself imports
nothing, so ``repro_torch.lint`` loads neither PyTorch nor JAX.
"""
__version__ = "0.1.0"
