"""The initial distributions of ``benchmark/inits/`` (on the CPU)."""

import math

import pytest
import torch

from benchmark import cells, states

PLUMMER = {"n_bodies": 65536, "n_dim": 3, "init": {"distribution": "plummer"}}
SEEDS = [0, 2**31 + 5, 2**40 + 17]
A = cells.init_module("plummer").SCALE  # the scale length, 3 pi / 16


def plummer(n: int = 65536, seed: int = 2**31 + 5, index: int = 0):
    return states.make_bodies(dict(PLUMMER, n_bodies=n), seed, index, "cpu")


def test_plummer_mass_and_centre_of_mass():
    m, p, v = plummer()
    assert bool((m == 1.0 / 65536).all())
    assert float(m.double().sum()) == pytest.approx(1.0, abs=1e-9)
    assert float(p.double().mean(0).abs().max()) < 1e-6
    assert float(v.double().mean(0).abs().max()) < 1e-6


@pytest.mark.parametrize("seed", SEEDS)
def test_plummer_radii_follow_the_mass_profile(seed):
    """Kolmogorov-Smirnov distance of the radii from M(<r) = r^3 /
    (r^2 + a^2)^(3/2); the cut-off at 0.999 of the mass, r <= ~22.8."""
    r = plummer(seed=seed)[1].double().norm(dim=1).sort().values
    cdf = r ** 3 / (r * r + A * A) ** 1.5
    n = r.numel()
    i = torch.arange(1, n + 1, dtype=torch.float64)
    ks = max(float((i / n - cdf).abs().max()),
             float((cdf - (i - 1) / n).abs().max()))
    assert ks < 0.01
    r_cut = A * (0.999 ** (-2 / 3) - 1) ** -0.5
    assert float(r[-1]) < r_cut + 1e-3


@pytest.mark.parametrize("seed", SEEDS)
def test_plummer_is_bound_and_in_virial_equilibrium(seed):
    """2T / |W| within 3% of 1 (W by a float64 direct sum) and every
    body below its escape speed, sqrt(2 / sqrt(r^2 + a^2))."""
    m, p, v = (t.double() for t in plummer(n=8192, seed=seed))
    kinetic = 0.5 * float((m * (v * v).sum(1)).sum())
    d = torch.cdist(p, p)
    d.fill_diagonal_(math.inf)
    potential = -0.5 * float((m[:, None] * m[None, :] / d).sum())
    assert abs(2 * kinetic / -potential - 1) < 0.03
    r2 = (p * p).sum(1)
    assert bool(((v * v).sum(1) < 2 / (r2 + A * A).sqrt() + 1e-6).all())


def test_plummer_is_deterministic():
    first = plummer(seed=2**40 + 17, index=3)
    again = plummer(seed=2**40 + 17, index=3)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert not torch.equal(first[1], plummer(seed=2**40 + 17, index=4)[1])
    assert not torch.equal(first[1], plummer(seed=2**40 + 18, index=3)[1])


def test_plummer_is_3d_only():
    with pytest.raises(ValueError, match="3D"):
        states.make_bodies(dict(PLUMMER, n_bodies=64, n_dim=2), 1, 0, "cpu")
