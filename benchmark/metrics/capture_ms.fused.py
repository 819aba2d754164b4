"""Capture of the fused run's CUDA graph, ms a run (fused cells)."""

from benchmark.readers import capture_ms as read  # noqa: F401
