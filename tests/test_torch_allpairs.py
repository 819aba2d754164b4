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
    assert resolve_tiles(65536) == (128, 1024)  # 512 blocks of 128
    assert resolve_tiles(1 << 20) == (256, 1024)  # >= 4 blocks per SM
    assert resolve_tiles(700) == (128, 768)
    assert resolve_tiles(4096, target_block=64, source_block=256) == (64, 256)
