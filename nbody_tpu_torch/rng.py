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


# the Plummer sphere's mass cut-off (Aarseth, Henon & Wielen 1974): the
# radii of the outermost 0.1% of the mass are not drawn
PLUMMER_MASS_CUT = 0.999


def _isotropic(gen: torch.Generator, n: int) -> torch.Tensor:
    """[n, 3] f64 unit vectors, uniform on the sphere (normalised normal
    triples)."""
    v = torch.randn((n, 3), generator=gen, dtype=torch.float64)
    return v / v.norm(dim=1, keepdim=True).clamp(min=1e-300)


def plummer(gen: torch.Generator, n: int):
    """(masses, positions, velocities) [n], [n, 3], [n, 3] f64 of a
    Plummer sphere in Henon units (G = M = 1, E = -1/4), drawn as
    Aarseth, Henon & Wielen (1974, A&A 37, 183) prescribe:

    * equal masses 1/n;
    * r = (X^(-2/3) - 1)^(-1/2) Plummer radii, X the enclosed mass
      fraction, uniform below ``PLUMMER_MASS_CUT``;
    * speed q v_esc(r), v_esc = sqrt(2) (1 + r^2)^(-1/4), q drawn by
      rejection from g(q) = q^2 (1 - q^2)^(7/2) (maximum 0.0921 at
      q^2 = 2/9, under the box height 0.1);
    * positions times 3 pi / 16, velocities over its square root (the
      Plummer radius a = 3 pi / 16 in Henon units), both on isotropic
      directions, then moved to the centre-of-mass frame."""
    x = PLUMMER_MASS_CUT * torch.rand(n, generator=gen, dtype=torch.float64)
    x = x.clamp(min=1e-12)
    r = 1.0 / torch.sqrt(x.pow(-2.0 / 3.0) - 1.0)
    q = torch.empty(0, dtype=torch.float64)
    while q.numel() < n:
        trial = torch.rand((2 * n, 2), generator=gen, dtype=torch.float64)
        ok = 0.1 * trial[:, 1] < (trial[:, 0] ** 2
                                  * (1.0 - trial[:, 0] ** 2) ** 3.5)
        q = torch.cat([q, trial[ok, 0]])
    speed = q[:n] * math.sqrt(2.0) * (1.0 + r * r) ** -0.25
    a = 3.0 * math.pi / 16.0
    pos = (a * r)[:, None] * _isotropic(gen, n)
    vel = (speed / math.sqrt(a))[:, None] * _isotropic(gen, n)
    masses = torch.full((n,), 1.0 / n, dtype=torch.float64)
    return masses, pos - pos.mean(0), vel - vel.mean(0)


def random_state(config: SimConfig, device="cuda") -> SimState:
    """Fresh random bodies per the configured ranges; ``init_mode`` is
    ``"uniform"`` (the reference's distribution), ``"blobs"`` (two
    Gaussian clusters, sigma 2% of the position span) or ``"plummer"``
    (3D: :func:`plummer`, in Henon units, whatever the ranges)."""
    dtype = config.torch_dtype()
    n = config.n_bodies
    dims = config.n_dim
    r: InitRanges = config.init
    gen = torch.Generator().manual_seed(config.seed)
    if config.init_mode == "plummer":
        if dims != 3:
            raise ValueError("init_mode='plummer' is 3D: the Plummer "
                             f"sphere has no {dims}D form here")
        return make_state(*plummer(gen, n), dtype=dtype, device=device)
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
