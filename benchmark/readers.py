"""What the per-layer metrics' readers share: sums over the traced
runs' device trace, per step.  Each reader (``metrics/<name>.py``) is a
``read(readings)`` returning a number, or None where its trace or
counter holds nothing to read; one read on every rank of a mesh also
has ``merge(values)``, which makes the number of the ranks' values."""

from __future__ import annotations


def is_nccl(base: str, name: str) -> bool:
    return name.startswith("nccl") or base.startswith("nccl")


def kernel_ms_per_step(r, pick):
    """Device milliseconds a step of the kernels ``pick(base, name)``
    accepts, over the traced runs; None without a trace or with no such
    kernel."""
    if r.trace is None or not r.traced_steps:
        return None
    s = r.trace.kernel_seconds(pick)
    return s * 1e3 / r.traced_steps if s > 0 else None


def hand_kernel_ms(r):
    return kernel_ms_per_step(r, lambda base, name: base in r.hand_kernels)


def torch_kernel_ms(r):
    return kernel_ms_per_step(
        r, lambda base, name: base not in r.hand_kernels
        and not is_nccl(base, name))


def nccl_parts(r):
    """{"steps", "seconds"}: the traced steps and the device seconds of
    each NCCL kernel in the traced window, in the order they started;
    None without a trace or with no such kernel."""
    if r.trace is None or not r.traced_steps:
        return None
    seconds = r.trace.kernel_durations(is_nccl)
    return {"steps": r.traced_steps, "seconds": seconds} if seconds else None


def nccl_ms(ranks):
    """Device ms a step of the collectives, each timed on the rank that
    reached it last: a collective's kernel runs on every rank until the
    last one has joined, so the least of its ranks' times is the
    exchange without the wait for peers.  None where the ranks ran a
    different number of collectives."""
    counts = {len(p["seconds"]) for p in ranks}
    if len(counts) != 1:
        return None
    least = sum(min(t) for t in zip(*(p["seconds"] for p in ranks)))
    return least * 1e3 / ranks[0]["steps"]


def idle_share(r):
    if r.trace is None or r.trace.window_s <= 0 or not r.trace.device_ops:
        return None
    return 1.0 - r.trace.busy_s / r.trace.window_s


def capture_ms(r):
    """Mean capture time of a run's CUDA graph (the program's own
    ``Simulation.last_capture_ms``), over the window's runs."""
    taken = [c for c in r.capture_ms if c > 0]
    return sum(taken) / len(taken) if taken else None
