"""The program's own CUDA kernels, device ms a step (loop cells)."""

from benchmark.readers import hand_kernel_ms as read  # noqa: F401
