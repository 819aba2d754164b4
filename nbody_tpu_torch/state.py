"""Simulation state: structure-of-arrays body data as a dataclass of tensors.

Same layout as :mod:`nbody_tpu.state` — masses [N], positions [N, D],
velocities [N, D] (reference project.cu:38-43) — so the text-file
contracts map 1:1 and a state carries across the two packages through
numpy (:func:`from_numpy` / :func:`to_numpy`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class SimState:
    """Bodies + simulation clock; ``time`` / ``step`` / ``overflow`` are
    0-dim tensors on the bodies' device (``overflow`` counts bodies whose
    traversal caps overflowed in the step that produced this state)."""

    masses: torch.Tensor  # [N]
    positions: torch.Tensor  # [N, D]
    velocities: torch.Tensor  # [N, D]
    time: torch.Tensor  # scalar, positions' dtype
    step: torch.Tensor  # scalar int32
    overflow: torch.Tensor  # scalar int32

    @property
    def n_bodies(self) -> int:
        return self.masses.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.positions.dtype

    @property
    def device(self) -> torch.device:
        return self.positions.device


def make_state(
    masses,
    positions,
    velocities,
    time: float = 0.0,
    step: int = 0,
    dtype: torch.dtype = torch.float32,
    device="cuda",
) -> SimState:
    """A state of ``dtype`` tensors on ``device`` (the card unless the
    caller asks for the CPU, where the kernels' plain twins run)."""

    def _as(a):
        if not isinstance(a, torch.Tensor):
            a = np.array(a)  # a writable copy (JAX hands out read-only)
        return torch.as_tensor(a, dtype=dtype, device=device)

    masses, positions, velocities = map(_as, (masses, positions, velocities))
    if (
        masses.ndim != 1
        or positions.ndim != 2
        or positions.shape[0] != masses.shape[0]
        or positions.shape[1] not in (2, 3)
    ):
        raise ValueError(
            f"bad shapes: masses {tuple(masses.shape)}, positions "
            f"{tuple(positions.shape)} (expected [N] and [N, 2|3])"
        )
    if velocities.shape != positions.shape:
        raise ValueError(
            f"velocities shape {tuple(velocities.shape)} != positions "
            f"{tuple(positions.shape)}"
        )
    return SimState(
        masses=masses.contiguous(),
        positions=positions.contiguous(),
        velocities=velocities.contiguous(),
        time=torch.tensor(time, dtype=dtype, device=device),
        step=torch.tensor(step, dtype=torch.int32, device=device),
        overflow=torch.tensor(0, dtype=torch.int32, device=device),
    )


def from_numpy(
    masses: np.ndarray,
    positions: np.ndarray,
    velocities: np.ndarray,
    time: float = 0.0,
    step: int = 0,
    dtype: torch.dtype = torch.float32,
    device="cuda",
) -> SimState:
    """A state from host arrays — the carrier between the two packages
    (``nbody_tpu.state.to_numpy`` output feeds straight in)."""
    return make_state(
        np.asarray(masses), np.asarray(positions), np.asarray(velocities),
        time=time, step=step, dtype=dtype, device=device,
    )


def to_numpy(state: SimState):
    """Host copies ``(masses, positions, velocities, time, step)``, the
    same tuple as ``nbody_tpu.state.to_numpy``."""
    return (
        state.masses.detach().cpu().numpy(),
        state.positions.detach().cpu().numpy(),
        state.velocities.detach().cpu().numpy(),
        float(state.time),
        int(state.step),
    )
