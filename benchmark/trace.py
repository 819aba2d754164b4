"""Reading a ``torch.profiler`` trace of the device.

The profiler records the device's kernels, copies and sets (CUPTI; the
kernels of a replayed CUDA graph one by one) and the host's operators.
:class:`Trace` keeps what the per-layer metrics read: the kernels inside
the traced window, the window's length, the time some device operation
ran (their union), and the longest idle gaps, each named by the
innermost host span or operator that was running when it began.  The
trace file goes under ``TMPDIR`` and is deleted once read.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

WINDOW_SPAN = "benchmark.traced_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
CSRC = Path(__file__).resolve().parents[1] / "nbody_tpu_torch" / "csrc"


def hand_kernel_names(csrc: Path = CSRC) -> frozenset:
    """The program's own CUDA kernels: every ``__global__`` function of
    its sources (a kernel a later change adds is found the same way)."""
    pat = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*"
                     r"\([^)]*\)\s*)?(?:void\s+)?(\w+)\s*\(")
    names = set()
    for src in sorted(csrc.glob("*.cu")):
        names.update(pat.findall(src.read_text()))
    return frozenset(names)


def kernel_base(name: str) -> str:
    """A demangled kernel name without its return type, namespaces,
    template arguments and parameters: ``void (anonymous
    namespace)::runs_kernel<3, 1>(float const*, ...)`` -> ``runs_kernel``."""
    if name.startswith(("Memcpy", "Memset")):
        return name.split(" (")[0]
    s = name.replace("(anonymous namespace)::", "")
    cut = min((i for i in (s.find("<"), s.find("(")) if i >= 0),
              default=len(s))
    head = s[:cut].strip()
    return head.split()[-1].split("::")[-1] if head else name


class Trace:
    """The device side of one traced window on one device."""

    def __init__(self, events: List[dict]):
        win = [e for e in events if e.get("name") == WINDOW_SPAN
               and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
        if not win:
            raise RuntimeError(f"the trace has no {WINDOW_SPAN} span")
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
        self.window_s = (w1 - w0) * 1e-6
        dev = [e for e in events if e.get("ph") == "X"
               and e.get("cat") in DEVICE_CATS
               and w0 <= float(e["ts"]) < w1]
        # (name, start us, end us), clipped to the window
        self.device_ops: List[Tuple[str, float, float]] = [
            (e["name"], float(e["ts"]),
             min(float(e["ts"]) + float(e["dur"]), w1)) for e in dev]
        self.kernels = [op for op, e in zip(self.device_ops, dev)
                        if e["cat"] == "kernel"]
        starts = np.array([op[1] for op in self.device_ops])
        ends = np.array([op[2] for op in self.device_ops])
        order = np.argsort(starts, kind="stable")
        starts, ends = starts[order], ends[order]
        # union of the device intervals, and the gaps between them
        busy = 0.0
        gaps = []
        cur_s = cur_e = None
        for s, e in zip(starts.tolist(), ends.tolist()):
            if cur_e is None:
                cur_s, cur_e = s, e
                if s > w0:
                    gaps.append((w0, s))
            elif s > cur_e:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
            if cur_e < w1:
                gaps.append((cur_e, w1))
        else:
            gaps.append((w0, w1))
        self.busy_s = busy * 1e-6
        self._gaps = gaps
        self._host = [e for e in events if e.get("ph") == "X"
                      and e.get("cat") in HOST_CATS
                      and e.get("tid") == win[0].get("tid")]

    def kernel_seconds(self, pick) -> float:
        """Seconds of the kernels whose base name ``pick`` accepts."""
        return sum(e - s for n, s, e in self.kernels
                   if pick(kernel_base(n), n)) * 1e-6

    def kernel_durations(self, pick) -> List[float]:
        """Seconds of each kernel whose base name ``pick`` accepts, in
        the order they started."""
        return [(e - s) * 1e-6 for n, s, e in sorted(
            self.kernels, key=lambda k: k[1]) if pick(kernel_base(n), n)]

    def top_device_ops(self, k: int = 10) -> List[list]:
        tot: Dict[str, float] = {}
        for n, s, e in self.device_ops:
            key = kernel_base(n)
            tot[key] = tot.get(key, 0.0) + (e - s) * 1e-6
        return [[n, v] for n, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:k]]

    def top_idle_gaps(self, k: int = 10, longest: int = 2000) -> List[list]:
        """The idle time of the ``longest`` gaps, summed by the innermost
        host span or operator running when each began; the ``k`` largest
        sums."""
        if not self._gaps:
            return []
        gaps = sorted(self._gaps, key=lambda g: g[0] - g[1])[:longest]
        hs = np.array([float(e["ts"]) for e in self._host])
        he = hs + np.array([float(e["dur"]) for e in self._host])
        tot: Dict[str, float] = {}
        for g0, g1 in gaps:
            t = g0 + 1e-3
            inside = np.nonzero((hs <= t) & (he > t))[0] if len(hs) else []
            if len(inside):
                j = inside[np.argmin(he[inside] - hs[inside])]
                label = self._host[j]["name"]
            else:
                label = "host: outside any operator"
            tot[label] = tot.get(label, 0.0) + (g1 - g0) * 1e-6
        return [[n, v] for n, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:k]]


class Profiler:
    """``torch.profiler`` over host and device around the traced runs;
    :meth:`stop` returns the :class:`Trace`."""

    def __init__(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._span = None

    def start(self) -> None:
        import torch

        self._prof.start()
        self._span = torch.profiler.record_function(WINDOW_SPAN)
        self._span.__enter__()

    def stop(self) -> Trace:
        self._span.__exit__(None, None, None)
        self._prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        return Trace(events)
