"""Initial states made from the seed, on the device.

A configuration's ``init.distribution`` names the module
``benchmark/inits/<distribution>.py`` that draws its bodies (default
``uniform``, the reference's distribution), found by name as the
metrics' readers are: a new distribution is a new file.  Each module has
``make(config, gen, device)`` -> (masses [N], positions [N, D],
velocities [N, D]) float32 on ``device``, drawn by ``gen``.  Run
``index`` of seed ``seed`` always gets the same bodies on one device;
every run of a window gets new bodies from the same distribution, so two
checks do the same work however many runs each completes.
"""

from __future__ import annotations

import torch

from . import cells

MASK64 = (1 << 64) - 1


def run_seed(seed: int, index: int) -> int:
    """A 63-bit generator seed for run ``index`` of ``seed``
    (splitmix64 of the pair; any whole seed, of any size)."""
    z = (seed * 0x9E3779B97F4A7C15 + index * 0xBF58476D1CE4E5B9
         + 0x94D049BB133111EB) & MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
    return (z ^ (z >> 31)) >> 1


def distribution(config: dict) -> str:
    return config.get("init", {}).get("distribution", "uniform")


def make_bodies(config: dict, seed: int, index: int, device,
                root=cells.ROOT):
    """(masses [N], positions [N, D], velocities [N, D]) float32 on
    ``device``, drawn by the configuration's distribution with one
    generator on that device (the files of the checkout ``root``)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(run_seed(seed, index))
    name = distribution(config)
    bodies = cells.init_module(name, root).make(config, gen, device)
    n, dims = int(config["n_bodies"]), int(config["n_dim"])
    shapes = [tuple(t.shape) for t in bodies]
    if shapes != [(n,), (n, dims), (n, dims)] or any(
            t.dtype != torch.float32 for t in bodies):
        raise ValueError(f"initial distribution {name!r} made "
                         f"{shapes} {[t.dtype for t in bodies]}, not "
                         f"float32 [{n}], [{n}, {dims}], [{n}, {dims}]")
    return bodies
