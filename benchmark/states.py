"""Initial states made from the seed, on the device.

The reference's distribution (project.cu:30-35, generateLogRandom and
generateRandom at 80-101): masses log-uniform, positions and velocities
uniform, in the ranges the configuration states.  Run ``index`` of seed
``seed`` always gets the same bodies on one device; every run of a
window gets new bodies from the same distribution, so two checks do the
same work however many runs each completes.
"""

from __future__ import annotations

import math

import torch

MASK64 = (1 << 64) - 1


def run_seed(seed: int, index: int) -> int:
    """A 63-bit generator seed for run ``index`` of ``seed``
    (splitmix64 of the pair; any whole seed, of any size)."""
    z = (seed * 0x9E3779B97F4A7C15 + index * 0xBF58476D1CE4E5B9
         + 0x94D049BB133111EB) & MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
    return (z ^ (z >> 31)) >> 1


def make_bodies(config: dict, seed: int, index: int, device):
    """(masses [N], positions [N, D], velocities [N, D]) float32 on
    ``device``, drawn by one generator on that device in one call."""
    n, dims = int(config["n_bodies"]), int(config["n_dim"])
    init = config["init"]
    gen = torch.Generator(device=device)
    gen.manual_seed(run_seed(seed, index))
    u = torch.rand((n, 1 + 2 * dims), generator=gen, device=device,
                   dtype=torch.float32)
    lo, hi = (math.log10(v) for v in init["mass"])
    masses = torch.pow(10.0, lo + u[:, 0] * (hi - lo))
    p0, p1 = init["position"]
    v0, v1 = init["velocity"]
    positions = p0 + u[:, 1:1 + dims] * (p1 - p0)
    velocities = v0 + u[:, 1 + dims:] * (v1 - v0)
    return masses, positions.contiguous(), velocities.contiguous()
