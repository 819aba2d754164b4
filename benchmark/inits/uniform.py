"""The reference's distribution (project.cu:30-35, generateLogRandom and
generateRandom at 80-101): masses log-uniform, positions and velocities
uniform, in the ranges the configuration's ``init`` states (``mass``,
``position``, ``velocity``: [low, high] each, every axis alike).  The
distribution a configuration gets when its ``init`` names none."""

from __future__ import annotations

import math

import torch


def make(config: dict, gen: torch.Generator, device):
    """(masses [N], positions [N, D], velocities [N, D]) float32, drawn
    by ``gen`` in one call."""
    n, dims = int(config["n_bodies"]), int(config["n_dim"])
    init = config["init"]
    u = torch.rand((n, 1 + 2 * dims), generator=gen, device=device,
                   dtype=torch.float32)
    lo, hi = (math.log10(v) for v in init["mass"])
    masses = torch.pow(10.0, lo + u[:, 0] * (hi - lo))
    p0, p1 = init["position"]
    v0, v1 = init["velocity"]
    positions = p0 + u[:, 1:1 + dims] * (p1 - p0)
    velocities = v0 + u[:, 1 + dims:] * (v1 - v0)
    return masses, positions.contiguous(), velocities.contiguous()
