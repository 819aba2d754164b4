"""Checkpoint / resume (counterpart of ``nbody_tpu.utils.checkpoint``).

Any mid-run (step, time, masses, positions, velocities) snapshot
round-trips through ``.npz`` with the JAX package's keys and scalar
types (``time`` a 0-d array of the state's float type, ``step`` a 0-d
int32), so a file written by either package loads in the other with
bit-equal arrays.  The write goes to a temporary file renamed into
place, so a run cut mid-write leaves the previous checkpoint whole.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..state import SimState, make_state


def save_checkpoint(path: str, state: SimState) -> None:
    tmp = path + ".tmp"
    host = {
        k: getattr(state, k).detach().cpu().numpy()
        for k in ("masses", "positions", "velocities", "time", "step")
    }
    np.savez(tmp, **host)
    # np.savez appends .npz to the temporary name
    os.replace(tmp + ".npz", path)


def load_checkpoint(path: str, dtype: torch.dtype | None = None,
                    device="cuda") -> SimState:
    """The state in ``path`` on ``device``; ``dtype`` defaults to the
    stored masses' type."""
    with np.load(path) as z:
        masses = z["masses"]
        if dtype is None:
            dtype = torch.from_numpy(masses[:0]).dtype
        return make_state(
            masses, z["positions"], z["velocities"], time=float(z["time"]),
            step=int(z["step"]), dtype=dtype, device=device,
        )
