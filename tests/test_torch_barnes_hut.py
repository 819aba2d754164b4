"""The port's exact per-body Barnes-Hut (nbody_tpu_torch.ops.barnes_hut)
against nbody_tpu.ops.barnes_hut and the f64 oracles (CPU).

Bounds: accelerations within 1e-5 x max|a| of the JAX package's (both
f32; the per-level sums over a frontier differ only in summation order),
overflow flags exactly equal (integer frontier compaction on the same
trees); within 2e-4 x max|a| of the f64 oracle, the JAX package's own
oracle budget (tests/test_barnes_hut.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ops import barnes_hut as jbh
from nbody_tpu.ops.tree import build_quadtree as jbuild
from nbody_tpu_torch.models import oracle as toracle
from nbody_tpu_torch.ops import barnes_hut as tbh
from nbody_tpu_torch.ops.tree import build_quadtree as tbuild
from nbody_tpu_torch.physics import pair_accelerations_dense

G = 6.67e-11
TOL = 1e-5


def _cloud(n, seed=11):
    rng = np.random.default_rng(seed)
    masses = (10 ** rng.uniform(-1, np.log10(0.5), n)).astype(np.float32)
    positions = rng.uniform(-0.1, 0.1, (n, 2)).astype(np.float32)
    return masses, positions


def _port(positions, masses, **kw):
    acc, ovf = tbh.bh_accelerations(
        torch.tensor(positions), torch.tensor(masses), g=G,
        return_diagnostics=True, **kw)
    return acc.numpy(), ovf.numpy()


def _jax(positions, masses, **kw):
    acc, ovf = jbh.bh_accelerations(
        jnp.asarray(positions), jnp.asarray(masses), g=G,
        return_diagnostics=True, **kw)
    return np.asarray(acc), np.asarray(ovf)


def test_matches_jax():
    masses, positions = _cloud(600)
    got, got_ovf = _port(positions, masses, theta=0.5, body_chunk=1024)
    want, want_ovf = _jax(positions, masses, theta=0.5, body_chunk=1024)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= TOL * scale
    np.testing.assert_array_equal(got_ovf, want_ovf)
    assert not got_ovf.any()


def test_overflow_flags_match_jax():
    """theta -> 0 opens every cell: a small frontier cap overflows for
    most bodies, and the flags say which, as in the JAX package."""
    masses, positions = _cloud(200, seed=4)
    kw = dict(theta=1e-6, frontier_cap=16, body_chunk=1024)
    got, got_ovf = _port(positions, masses, **kw)
    want, want_ovf = _jax(positions, masses, **kw)
    assert got_ovf.sum() > 0
    np.testing.assert_array_equal(got_ovf, want_ovf)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_max_depth_aggregation_self_interaction():
    """Bodies co-located in one max-depth cell feel their own aggregate
    (PARTICLE_INDEX=-1 defeats the self-skip, project.cu:378), while a
    single body at max depth skips itself (project.cu:376/646)."""
    masses = np.array([1.0, 1.0, 1.0], dtype=np.float32)
    positions = np.array(
        [[0.01, 0.01], [0.0101, 0.0101], [0.9, 0.9]], dtype=np.float32)
    want = toracle.bh_accelerations(positions, masses, g=G, theta=0.5,
                                    max_depth=2)
    got, _ = _port(positions, masses, theta=0.5, max_depth=2, body_chunk=4)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-5 * scale)
    jgot, _ = _jax(positions, masses, theta=0.5, max_depth=2, body_chunk=4)
    assert np.abs(got - jgot).max() <= TOL * scale
    # the aggregate self-pull is real: bodies 0 and 1 attract their own
    # cell's COM, which lies between them
    assert np.sign(got[0, 0]) != np.sign(got[1, 0])


def test_traverse_prebuilt_tree_matches_jax():
    """traverse_accelerations on a prebuilt tree, in several body chunks
    (the last one padded): the entry point the multi-device step calls."""
    masses, positions = _cloud(600, seed=7)
    ttree = tbuild(torch.tensor(positions), torch.tensor(masses))
    jtree = jbuild(jnp.asarray(positions), jnp.asarray(masses))
    np.testing.assert_array_equal(ttree.codes.numpy(), np.asarray(jtree.codes))
    got, got_ovf = tbh.traverse_accelerations(
        torch.tensor(positions), ttree.codes, ttree, g=G, theta=0.5,
        frontier_cap=64, body_chunk=256)
    want, want_ovf = jbh.traverse_accelerations(
        jnp.asarray(positions), jtree.codes, jtree, g=G, theta=0.5,
        frontier_cap=64, body_chunk=256)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= TOL * np.abs(want).max()
    np.testing.assert_array_equal(got_ovf.numpy(), np.asarray(want_ovf))


@pytest.mark.parametrize("theta", [0.5, 0.8])
def test_matches_port_oracle(theta):
    masses, positions = _cloud(600)
    want = toracle.bh_accelerations(positions, masses, g=G, theta=theta)
    got, ovf = _port(positions, masses, theta=theta, body_chunk=1024)
    assert not ovf.any()
    np.testing.assert_allclose(got, want, atol=2e-4 * np.abs(want).max())


def test_theta_zero_converges_to_allpairs():
    """theta -> 0 opens everything: softened all-pairs when the frontier
    fits (N < frontier_cap)."""
    masses, positions = _cloud(150, seed=3)
    p, m = torch.tensor(positions), torch.tensor(masses)
    ap = pair_accelerations_dense(p, m, g=G, softening=1e-15).numpy()
    got, ovf = tbh.bh_accelerations(p, m, g=G, theta=1e-9, body_chunk=256,
                                    return_diagnostics=True)
    assert int(ovf.sum()) == 0
    np.testing.assert_allclose(got.numpy(), ap, atol=1e-5 * np.abs(ap).max())
