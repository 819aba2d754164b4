"""The program's NCCL collectives (the all-gather of positions), device
ms a step: each collective timed on the rank that reached it last, so
that the wait for the slowest peer is left out."""

from benchmark.readers import nccl_ms as merge  # noqa: F401
from benchmark.readers import nccl_parts as read  # noqa: F401
