"""PyTorch's own kernels (tree build, collectors, integrator), device
ms a step (loop cells)."""

from benchmark.readers import torch_kernel_ms as read  # noqa: F401
