"""Two-tier timing with the reference's machine-readable stdout contract.

The reference measures (a) total wall time of the whole run in ms
(project.cu:1083-1088, printed 1097) and (b) accumulated "parallel" /
important time bracketing only force+update work in us (project.cu:76-77,
985-1007, printed 1102), made valid by cudaDeviceSynchronize before reading
the clock.  Here ``torch.cuda.synchronize`` plays the role of the sync
(the contract loop calls it before every ``Stopwatch.stop``).

The printed lines keep the exact reference wording ("GPU ...") because the
analysis layer regex-matches those tokens (plot_first_scale.py:58-59,
plot_second_scale.py:20); truth-in-labeling lines can be added alongside.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional


@dataclasses.dataclass
class RunTiming:
    total_ms: float = 0.0
    parallel_us: float = 0.0  # accumulated force+update time

    def total_line(self) -> str:
        # project.cu:1097
        return (
            f"GPU total computation took {int(self.total_ms)} milliseconds."
        )

    def parallel_line(self) -> str:
        # project.cu:1102
        return (
            "GPU parallel computation took "
            f"{int(self.parallel_us)} microseconds."
        )

    def report(self) -> str:
        return self.total_line() + "\n" + self.parallel_line()


class Stopwatch:
    """Monotonic stopwatch accumulating microseconds across brackets."""

    def __init__(self):
        self.accum_us = 0.0
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        assert self._t0 is not None, "stop() without start()"
        self.accum_us += (time.perf_counter() - self._t0) * 1e6
        self._t0 = None
