"""The program's own CUDA kernels, device ms a step (mesh cells)."""

from benchmark.readers import hand_kernel_ms as read  # noqa: F401
