"""Random initial conditions with explicit ``torch.Generator``s.

The same distributions as :mod:`nbody_tpu.rng` (reference
project.cu:80-101): log-uniform masses, uniform positions and
velocities, or the two-blob collapsed state.  The bits differ from the
JAX package's threefry draws, so parity tests build their states with
numpy or with ``nbody_tpu.rng`` and carry them across with
``state.from_numpy``.  Draws are made on a CPU generator and then moved,
so a (seed, N) gives the same bodies on every device.
"""

from __future__ import annotations

import math

import torch

from .config import InitRanges, SimConfig
from .state import SimState, make_state


def log_uniform(gen: torch.Generator, shape, lower: float, higher: float,
                dtype=torch.float32) -> torch.Tensor:
    """10 ** U(log10(lower), log10(higher)) — generateLogRandom
    (project.cu:99-101)."""
    lo, hi = math.log10(lower), math.log10(higher)
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return torch.pow(10.0, lo + u * (hi - lo)).to(dtype)


def uniform(gen: torch.Generator, shape, lower: float, higher: float,
            dtype=torch.float32) -> torch.Tensor:
    """U(lower, higher) — generateRandom (project.cu:80-82)."""
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return (lower + u * (higher - lower)).to(dtype)


def random_state(config: SimConfig, device="cuda") -> SimState:
    """Fresh random bodies per the configured ranges; ``init_mode`` is
    ``"uniform"`` (the reference's distribution) or ``"blobs"`` (two
    Gaussian clusters, sigma 2% of the position span)."""
    dtype = config.torch_dtype()
    n = config.n_bodies
    dims = config.n_dim
    r: InitRanges = config.init
    gen = torch.Generator().manual_seed(config.seed)
    masses = log_uniform(gen, (n,), r.lower_m, r.higher_m, dtype)
    if config.init_mode == "blobs":
        span = r.higher_p - r.lower_p
        centers = uniform(gen, (2, dims), r.lower_p + 0.25 * span,
                          r.higher_p - 0.25 * span, dtype)
        which = (torch.arange(n) % 2)[:, None]
        noise = 0.02 * span * torch.randn(
            (n, dims), generator=gen, dtype=torch.float32).to(dtype)
        positions = torch.where(which == 0, centers[0], centers[1]) + noise
        positions = positions.clamp(r.lower_p, r.higher_p)
    elif config.init_mode == "uniform":
        positions = uniform(gen, (n, dims), r.lower_p, r.higher_p, dtype)
    else:
        raise ValueError(f"unknown init_mode {config.init_mode!r}")
    velocities = uniform(gen, (n, dims), r.lower_v, r.higher_v, dtype)
    return make_state(masses, positions, velocities, dtype=dtype,
                      device=device)
