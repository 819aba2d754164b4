"""The program's own CUDA kernels, device ms a step (fused cells)."""

from benchmark.readers import hand_kernel_ms as read  # noqa: F401
