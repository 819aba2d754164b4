"""Debug-mode validation (counterpart of ``nbody_tpu.utils.debug``).

The reference guards its hot paths with in-kernel printf checks (stack
overflow/underflow, project.cu:712-721) and host-side bounds checks
(project.cu:385-388, 411-414).  Here:

* :func:`validate_state` — argument validation of a state (shapes,
  finiteness, non-negative masses), the loader-exception analogue;
* :func:`checked_accel` — wraps an acceleration function so NaN/Inf in
  the force pass raises instead of silently corrupting the trajectory
  (the JAX package's checkify check, written as an explicit test);
* the traversal overflow flags (``return_diagnostics=True``) are the
  stack-guard analogue.

Both checks read the device from the host (one reduction each), so they
are off the hot path: call them around a run, not inside a fused one.
"""

from __future__ import annotations

import torch

from ..state import SimState


def validate_state(state: SimState) -> None:
    """Raise ``ValueError`` on a malformed state: no bodies, shapes that
    disagree, non-finite or negative masses, non-finite positions or
    velocities.  Reads the device once per check (host syncs)."""
    n = state.n_bodies
    if n < 1:
        raise ValueError("need at least one body")
    dims = state.positions.shape[-1]
    if (dims not in (2, 3) or state.positions.shape != (n, dims)
            or state.velocities.shape != (n, dims)):
        raise ValueError(
            f"shape mismatch: masses {tuple(state.masses.shape)}, positions "
            f"{tuple(state.positions.shape)}, velocities "
            f"{tuple(state.velocities.shape)}"
        )
    if not bool(torch.isfinite(state.masses).all()):
        raise ValueError("non-finite masses")
    if bool((state.masses < 0).any()):
        raise ValueError("negative masses")
    if not bool(torch.isfinite(state.positions).all()):
        raise ValueError("non-finite positions")
    if not bool(torch.isfinite(state.velocities).all()):
        raise ValueError("non-finite velocities")


def checked_accel(accel_fn):
    """Wrap an acceleration function ``(positions, masses) -> acc`` so
    that a non-finite acceleration raises ``FloatingPointError``; the
    accelerations are returned unchanged otherwise.  The check reads one
    flag from the device per call (a host sync)."""

    def checked(positions, masses):
        acc = accel_fn(positions, masses)
        if not bool(torch.isfinite(acc).all()):
            raise FloatingPointError("non-finite acceleration in force pass")
        return acc

    return checked
