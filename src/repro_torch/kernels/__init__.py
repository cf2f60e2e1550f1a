"""The port's kernels: CUDA C++ sources (``csrc/``), their wrappers and
plain PyTorch versions, and the device dispatch (``ops``)."""
