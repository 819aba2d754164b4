"""Kernel K1's plain twin (nbody_tpu_torch.ops.allpairs) against the JAX
Pallas kernel in interpret mode, on the same numpy bodies (CPU).  The
CUDA kernel itself is held against this twin on the card by
chip_smoke.py and tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.models import oracle
from nbody_tpu.ops.allpairs import allpairs_accelerations as jax_allpairs
from nbody_tpu_torch import SimConfig
from nbody_tpu_torch.models.engines import make_accel_fn
from nbody_tpu_torch.ops import allpairs
from nbody_tpu_torch.utils.occupancy import resolve_tiles

G = 6.67e-11
# f32 on both sides, sums in another order: the JAX kernel test's own
# tolerance (tests/test_allpairs.py:46)
RTOL, ATOL = 5e-4, 1e-11


def _cloud(n, seed=0):
    rng = np.random.default_rng(seed)
    masses = (10 ** rng.uniform(-1, np.log10(0.5), size=n)).astype(np.float32)
    positions = rng.uniform(-0.1, 0.1, size=(n, 2)).astype(np.float32)
    return masses, positions


def _both(masses, positions, **kw):
    want = np.asarray(jax_allpairs(
        jnp.asarray(positions), jnp.asarray(masses), g=G, target_block=256,
        source_block=512, interpret=True, **kw))
    got = allpairs.allpairs_accelerations(
        torch.tensor(positions), torch.tensor(masses), g=G,
        source_block=512, **kw).numpy()
    return got, want


@pytest.mark.parametrize("n", [700, 1024])
def test_twin_matches_jax_kernel(n):
    got, want = _both(*_cloud(n))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_twin_softened_matches_jax_kernel():
    got, want = _both(*_cloud(1024, seed=5), softening=1e-3)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_twin_compensated_matches_jax_kernel():
    got, want = _both(*_cloud(1024, seed=6), compensated=True)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_coincident_bodies_finite():
    masses, positions = _cloud(700, seed=2)
    positions[10] = positions[20]
    positions[30] = positions[20]
    got, want = _both(masses, positions)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_twin_matches_f64_oracle():
    masses, positions = _cloud(1024, seed=3)
    want = oracle.naive_accelerations(positions, masses, g=G)
    got = allpairs.allpairs_accelerations(
        torch.tensor(positions), torch.tensor(masses), g=G).numpy()
    # the f32-vs-f64 budget of tests/test_allpairs.py:62
    np.testing.assert_allclose(got, want, atol=2e-4 * np.abs(want).max())


def test_targets_differ_from_sources():
    masses, positions = _cloud(900, seed=4)
    tgt = positions[::3].copy()
    got = allpairs.allpairs_accelerations_vs(
        torch.tensor(tgt), torch.tensor(positions), torch.tensor(masses),
        g=G).numpy()
    full = allpairs.allpairs_accelerations(
        torch.tensor(positions), torch.tensor(masses), g=G).numpy()
    np.testing.assert_allclose(got, full[::3], rtol=1e-6, atol=ATOL)


@pytest.mark.parametrize("n", [256, 1024])
def test_engine_routes(n):
    """n < 512 takes the dense path, larger n the K1 wrapper; both match
    the JAX engine."""
    from nbody_tpu import SimConfig as JaxConfig
    from nbody_tpu.models.engines import make_accel_fn as jax_make

    masses, positions = _cloud(n, seed=n)
    want = np.asarray(jax_make(JaxConfig(engine="allpairs"))(
        jnp.asarray(positions), jnp.asarray(masses)))
    acc, ovf = make_accel_fn(SimConfig(engine="allpairs"),
                             return_diagnostics=True)(
        torch.tensor(positions), torch.tensor(masses))
    np.testing.assert_allclose(acc.numpy(), want, rtol=RTOL, atol=ATOL)
    assert not ovf.any()


def test_resolve_tiles_h100_shape():
    """K1's default shape on targets = sources: 256-thread blocks of 2
    targets a thread, the slices (512 / 256 / 128 / 64 targets a block)
    from N, the fastest measured on an H100; an explicit target_block picks
    the slices, source_block stays the caller's."""
    assert resolve_tiles(700) == (512, 768)  # one unit: one slice
    assert resolve_tiles(16384) == (64, 1024)  # 8 slices, 256 blocks
    assert resolve_tiles(65536) == (256, 1024)  # 2 slices, 256 blocks
    assert resolve_tiles(65536, compensated=True) == (128, 1024)  # 4
    assert resolve_tiles(1 << 20) == (512, 1024)  # 2,048 blocks of 1 slice
    assert resolve_tiles(4096, target_block=64, source_block=256) == (64, 256)
    assert allpairs.allpairs_launch_shape(700, 700, 768, False) == (2, 1, 2)
    assert allpairs.allpairs_launch_shape(65536, 65536, 1024, False) == (
        2, 2, 256)
    assert allpairs.allpairs_launch_shape(65536, 65536, 1024, True) == (
        2, 4, 512)
    assert allpairs.allpairs_launch_shape(1 << 20, 1 << 20, 1024, False) == (
        2, 1, 2048)


def test_launch_shape_few_targets_many_sources():
    """nt << ns: the most slices the units allow, so a few blocks still
    spread each target's sums over 8 threads."""
    assert allpairs.allpairs_launch_shape(700, 65536, 1024, False) == (
        2, 8, 11)
    assert allpairs.allpairs_launch_shape(33, 10000, 128, True) == (2, 8, 1)
    assert allpairs.allpairs_launch_shape(4096, 1 << 20, 1024, False) == (
        2, 8, 64)
    assert allpairs.allpairs_launch_shape(65536, 1 << 20, 1024, False) == (
        2, 2, 256)
    # never more slices than units: 2 tiles of 768 sources
    assert allpairs.allpairs_launch_shape(33, 1400, 768, False) == (2, 2, 1)


@pytest.mark.parametrize("nt,ns", [(1, 1), (33, 10000), (700, 700),
                                   (4099, 4099), (65536, 65536),
                                   (700, 1 << 20), (300000, 300000),
                                   (1 << 20, 1 << 20)])
@pytest.mark.parametrize("source_block,compensated", [
    (1, False), (128, False), (500, True), (768, False), (1024, False),
    (1024, True)])
def test_launch_shape_invariants(nt, ns, source_block, compensated):
    tpt, r, blocks = allpairs.allpairs_launch_shape(nt, ns, source_block,
                                                    compensated)
    units = allpairs.allpairs_units(ns, source_block, compensated)
    assert tpt == allpairs.ALLPAIRS_TARGETS_PER_THREAD
    assert r in (1, 2, 4, 8) and r <= max(units, 1)
    per_block = allpairs.ALLPAIRS_THREADS // r * tpt
    assert (blocks - 1) * per_block < nt <= blocks * per_block
    assert allpairs.allpairs_slices(per_block) == r


@pytest.mark.parametrize("ns,source_block,compensated", [
    (700, 768, False), (700, 768, True), (4099, 500, True),
    (4099, 512, True), (10000, 128, True), (10000, 100, True),
    (65536, 1024, False), (65536, 1024, True), (5, 1, True)])
def test_units_are_the_twins_partials(ns, source_block, compensated):
    """allpairs_units counts the partials the twin sums whole: one per
    tile, or one per 128-source chunk of each tile when compensated."""
    want = 0
    for s0 in range(0, ns, source_block):
        width = min(source_block, ns - s0)
        want += -(-width // 128) if compensated else 1
    assert allpairs.allpairs_units(ns, source_block, compensated) == want


@pytest.mark.parametrize("target_block,slices", [
    (512, 1), (256, 2), (128, 4), (64, 8), (100, None), (32, None),
    (1024, None), (-128, None)])
def test_explicit_target_block_maps_to_its_slices_or_raises(target_block,
                                                             slices):
    p, m = torch.zeros((4, 2)), torch.ones(4)
    if slices is None:
        with pytest.raises(ValueError, match="512, 256, 128|64, 128, 256"):
            allpairs.allpairs_slices(target_block)
        with pytest.raises(ValueError, match="target_block"):
            allpairs.allpairs_accelerations(p, m, g=G,
                                            target_block=target_block)
        with pytest.raises(ValueError, match="target_block"):
            resolve_tiles(4096, target_block=target_block)
    else:
        assert allpairs.allpairs_slices(target_block) == slices
        assert resolve_tiles(4096, target_block=target_block)[0] == (
            target_block)
