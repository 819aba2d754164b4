"""The Plummer sphere: the standard clustered initial state of tree codes,
drawn as Aarseth, Henon & Wielen (1974, A&A 37, 183) draw it, and as
NEMO's ``mkplummer`` and AMUSE's ``new_plummer_model`` do, in Henon units
(G = M = 1, total energy -1/4).

* Masses equal, 1/N each.
* Radius: X uniform in [0, 0.999) (the mass cut-off), r = (X^(-2/3) -
  1)^(-1/2) in Plummer's units, on an isotropic direction.
* Speed: q sqrt(2) (1 + r^2)^(-1/4), q drawn by von Neumann rejection
  from g(q) = q^2 (1 - q^2)^(7/2) under the bound 0.1 (~43% accepted;
  drawn until every body has one), on an isotropic direction.
* Positions times 3 pi / 16 and velocities times sqrt(16 / (3 pi)) (to
  Henon units), then shifted to the centre-of-mass frame (equal
  masses: the mean).

3D only; of the configuration it reads ``n_bodies`` and ``n_dim``.
Drawn in float64 on the device, returned in float32.
"""

from __future__ import annotations

import math

import torch

MASS_CUT = 0.999
Q_BOUND = 0.1  # above g's maximum, 0.0921 at q^2 = 2/9
SCALE = 3.0 * math.pi / 16.0  # Plummer's scale length in Henon units


def direction(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unit vectors [N, 3], isotropic for a, b uniform in [0, 1)."""
    z = 2.0 * a - 1.0
    phi = 2.0 * math.pi * b
    s = (1.0 - z * z).clamp(min=0.0).sqrt()
    return torch.stack([s * phi.cos(), s * phi.sin(), z], dim=1)


def speed_fractions(n: int, gen: torch.Generator, device) -> torch.Tensor:
    """[n] q in [0, 1) with density proportional to g(q), by rejection."""
    f64 = torch.float64
    q = torch.empty(0, dtype=f64, device=device)
    while q.numel() < n:
        m = n - q.numel()
        c = torch.rand((3 * m + 1024, 2), generator=gen, device=device,
                       dtype=f64)
        x = c[:, 0]
        keep = Q_BOUND * c[:, 1] < x * x * (1.0 - x * x).pow(3.5)
        q = torch.cat([q, x[keep][:m]])
    return q


def make(config: dict, gen: torch.Generator, device):
    """(masses [N], positions [N, 3], velocities [N, 3]) float32."""
    n, dims = int(config["n_bodies"]), int(config["n_dim"])
    if dims != 3:
        raise ValueError(f"the Plummer sphere is 3D; n_dim is {dims}")
    u = torch.rand((n, 5), generator=gen, device=device,
                   dtype=torch.float64)
    r = ((MASS_CUT * u[:, 0]).pow(-2.0 / 3.0) - 1.0).rsqrt()
    positions = r[:, None] * direction(u[:, 1], u[:, 2])
    speed = (speed_fractions(n, gen, device) * math.sqrt(2.0)
             * (1.0 + r * r).pow(-0.25))
    velocities = speed[:, None] * direction(u[:, 3], u[:, 4])
    positions = positions * SCALE
    velocities = velocities / math.sqrt(SCALE)
    positions = positions - positions.mean(0)
    velocities = velocities - velocities.mean(0)
    masses = torch.full((n,), 1.0 / n, dtype=torch.float32, device=device)
    return (masses, positions.float().contiguous(),
            velocities.float().contiguous())
