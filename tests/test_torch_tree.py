"""The port's quadtree pyramid (nbody_tpu_torch.ops.tree) against
nbody_tpu.ops.tree on the same numpy bodies (CPU): integer fields and the
sort order exactly, mass/COM fields within rtol 1e-6, singleton COMs
bit-equal to their body."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ops import tree as jt
from nbody_tpu_torch.ops import tree as tt


def _cloud(mode, n=2048, seed=0):
    rng = np.random.default_rng(seed)
    m = (10 ** rng.uniform(-1, np.log10(0.5), n)).astype(np.float32)
    if mode == "uniform":
        p = rng.uniform(-0.1, 0.1, (n, 2))
    else:  # two tight clusters: deep cells, many multi-body leaves
        c = rng.uniform(-0.05, 0.05, (2, 2))
        p = c[np.arange(n) % 2] + 0.004 * rng.normal(size=(n, 2))
    return m, p.astype(np.float32)


@pytest.fixture(params=["uniform", "blobs"])
def trees(request):
    m, p = _cloud(request.param)
    jtree = jt.build_quadtree(jnp.asarray(p), jnp.asarray(m), max_depth=9)
    ttree = tt.build_quadtree(torch.tensor(p), torch.tensor(m), max_depth=9)
    return m, p, jtree, ttree


def test_bounds_and_morton_codes_exact(trees):
    _, _, jtree, ttree = trees
    np.testing.assert_array_equal(np.asarray(jtree.bounds),
                                  ttree.bounds.numpy())
    np.testing.assert_array_equal(np.asarray(jtree.codes),
                                  ttree.codes.numpy())


def test_sort_order_exact(trees):
    _, _, jtree, ttree = trees
    np.testing.assert_array_equal(
        np.asarray(jnp.argsort(jtree.codes)),
        torch.argsort(ttree.codes, stable=True).numpy())


def test_counts_and_occupancy_exact(trees):
    _, _, jtree, ttree = trees
    for lvl in range(10):
        for col in (tt.RAW_CNT, tt.RAW_OCC):
            np.testing.assert_array_equal(
                np.asarray(jtree.raw[lvl])[:, col],
                ttree.raw[lvl][:, col].numpy())


def test_pyramid_mass_and_com(trees):
    _, _, jtree, ttree = trees
    for jl, tl in zip(jtree.levels, ttree.levels):
        np.testing.assert_array_equal(np.asarray(jl.count), tl.count.numpy())
        for f in ("mass", "comx", "comy"):
            np.testing.assert_allclose(
                getattr(tl, f).numpy(), np.asarray(getattr(jl, f)),
                rtol=1e-6, atol=1e-12)


def test_singleton_com_bit_equal_to_body(trees):
    m, p, _, ttree = trees
    codes = ttree.codes.numpy()
    leaf = ttree.levels[9]
    cnt = leaf.count.numpy()
    single = np.nonzero(cnt[codes] == 1)[0]
    assert single.size > 0
    np.testing.assert_array_equal(leaf.comx.numpy()[codes[single]],
                                  p[single, 0])
    np.testing.assert_array_equal(leaf.comy.numpy()[codes[single]],
                                  p[single, 1])
    # the same body stays bit-exact up every singleton ancestor
    for lvl in range(9):
        lv = ttree.levels[lvl]
        cell = codes[single] >> (2 * (9 - lvl))
        one = lv.count.numpy()[cell] == 1
        np.testing.assert_array_equal(lv.comx.numpy()[cell[one]],
                                      p[single[one], 0])


def test_degenerate_cloud_and_cell_size():
    p = np.full((5, 2), 0.25, np.float32)
    b = tt.root_bounds(torch.tensor(p)).numpy()
    np.testing.assert_array_equal(b, np.asarray(jt.root_bounds(
        jnp.asarray(p))))
    bounds = torch.tensor([-1.0, 3.0, -2.0, 0.0])
    for lvl in (0, 3, 9):
        assert float(tt.level_cell_size(bounds, lvl)) == float(
            jt.level_cell_size(jnp.asarray(bounds.numpy()), lvl))
