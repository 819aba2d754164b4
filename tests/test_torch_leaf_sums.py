"""The tree builds' leaf sums (nbody_tpu_torch.ops.tree.leaf_sums) on the
CPU, where the wrapper takes its plain twin (two ``torch.segment_reduce``
calls in the two-level order of ``tree.LEAF_CHUNK``-row chunks); the
kernels (csrc/tree_sums.cu) are held to the twin on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 9).

Bounds, each with its reason:

* against an explicit numpy loop in the two-level order (serial sums from
  0 of each chunk, then of the chunk partials): bit for bit, the order is
  the twin's definition;
* against ``torch.segment_reduce`` on leaves of at most ``LEAF_CHUNK``
  rows: bit for bit (one chunk a leaf is one serial sum);

* against the JAX package's ``jax.ops.segment_sum`` (the unsorted
  bodies scattered by leaf code, nbody_tpu/ops/tree.py:154 and
  tree3d.py:141) on inputs whose leaves hold thousands of rows: rtol
  1e-6, atol 1e-12, the tree tests' bound on the pyramid's fields
  (tests/test_torch_tree.py, tests/test_torch_3d.py: f32 sums of the
  same terms);
* a singleton leaf: its row's bits exactly; an empty leaf: exactly 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu_torch.ops import _cuda
from nbody_tpu_torch.ops import tree as tt
from nbody_tpu_torch.ops import tree3d as tt3
from nbody_tpu_torch.utils.profiling import counter


def _rows(n, w, seed):
    """Rows like the tree builds' [m, m*x, ...]: positive masses in
    [0.1, 0.5], positions in [-0.1, 0.1], and their products."""
    rng = np.random.default_rng(seed)
    m = rng.uniform(0.1, 0.5, (n, 1))
    x = rng.uniform(-0.1, 0.1, (n, w - 1))
    return np.concatenate([m, m * x], axis=1).astype(np.float32)


def _ours(rows, codes, n_leaf):
    """The port's path: stable Morton sort, per-leaf lengths, leaf_sums."""
    c = torch.tensor(codes)
    order = torch.argsort(c, stable=True)
    return tt.leaf_sums(torch.tensor(rows)[order],
                        tt.leaf_counts(c, n_leaf)).numpy()


# (width, leaves, bodies, share of the bodies in four heavy leaves): the
# quadtree's 8 columns and the octree's 16
HEAVY = [(8, 4 ** 6, 40960, 0.7), (16, 8 ** 5, 65536, 0.8),
         (16, 8 ** 4, 20000, 1.0)]


@pytest.mark.parametrize("w,n_leaf,n,share", HEAVY,
                         ids=["2d", "3d", "3d-four-leaves"])
def test_twin_matches_jax_segment_sum_on_heavy_leaves(w, n_leaf, n, share):
    rng = np.random.default_rng(w + n)
    heavy = rng.integers(0, 4, n) * (n_leaf // 4) + 1
    codes = np.where(rng.random(n) < share, heavy,
                     rng.integers(0, n_leaf, n)).astype(np.int32)
    rows = _rows(n, w, seed=n)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(rows),
                                          jnp.asarray(codes),
                                          num_segments=n_leaf))
    got = _ours(rows, codes, n_leaf)
    assert got.shape == (n_leaf, w)
    assert np.bincount(codes, minlength=n_leaf).max() > 1000
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("w", [8, 16])
def test_singleton_leaves_keep_the_row_bits(w):
    n_leaf, n = 4096, 1000
    rng = np.random.default_rng(w)
    codes = rng.permutation(n_leaf)[:n].astype(np.int32)
    rows = _rows(n, w, seed=w)
    got = _ours(rows, codes, n_leaf)
    np.testing.assert_array_equal(got[codes], rows)
    empty = np.ones(n_leaf, bool)
    empty[codes] = False
    assert (got[empty] == 0).all()


def test_cpu_tensors_never_reach_the_kernel(monkeypatch):
    def no_library():
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(_cuda, "library", no_library)
    before = counter("ops.tree.LEAF_SUM_LAUNCHES")
    rows = torch.tensor(_rows(500, 16, seed=1))
    lengths = torch.tensor([100, 0, 400], dtype=torch.int64)
    got = tt.leaf_sums(rows, lengths)
    assert torch.equal(got, tt.leaf_sums_plain(rows, lengths))
    p = torch.tensor(np.random.default_rng(2).uniform(-0.1, 0.1, (2048, 3)),
                     dtype=torch.float32)
    tree = tt3.build_octree(p, torch.ones(2048), max_depth=4)
    assert int(tree.raw[0][0, tt3.R3_CNT]) == 2048
    assert counter("ops.tree.LEAF_SUM_LAUNCHES") == before


C = tt.LEAF_CHUNK


def _two_level(rows, lengths):
    """The order written out: each chunk of C rows a serial sum from 0
    (``np.add.accumulate`` adds in sequence), then the partials of a leaf
    serially from 0 in chunk order."""
    out = np.zeros((len(lengths), rows.shape[1]), rows.dtype)
    start = 0
    for leaf, n in enumerate(lengths):
        zero = np.zeros((1, rows.shape[1]), rows.dtype)
        end = start + n
        parts = [np.add.accumulate(np.concatenate(
            [zero, rows[c:min(c + C, end)]]))[-1] for c in range(start, end, C)]
        out[leaf] = np.add.accumulate(np.concatenate([zero] + [
            p[None] for p in parts]))[-1]
        start = end
    return out


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("w", [8, 16])
def test_twin_is_the_two_level_order(w, dtype):
    lengths = np.array([1, C - 1, 0, C, C + 1, 2 * C, 3 * C + 5, 0, 7],
                       np.int64)
    rows = np.random.default_rng(w).uniform(
        -0.1, 0.5, (int(lengths.sum()), w)).astype(dtype)
    got = tt.leaf_sums_plain(torch.tensor(rows), torch.tensor(lengths))
    want = _two_level(rows, lengths)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.tensor(rows).dtype
    # the order is not segment_reduce's past C rows (else nothing changed)
    serial = torch.segment_reduce(torch.tensor(rows), "sum",
                                  lengths=torch.tensor(lengths), axis=0)
    assert not torch.equal(got[lengths > C], serial[lengths > C])


@pytest.mark.parametrize("w", [8, 16])
def test_twin_is_segment_reduce_on_leaves_of_at_most_c_rows(w):
    rng = np.random.default_rng(3 + w)
    lengths = np.concatenate([[C, C - 1, 0, 1], rng.integers(0, 300, 400),
                              [C]]).astype(np.int64)
    rows = torch.tensor(_rows(int(lengths.sum()), w, seed=w))
    lengths = torch.tensor(lengths)
    assert torch.equal(
        tt.leaf_sums_plain(rows, lengths),
        torch.segment_reduce(rows, "sum", lengths=lengths, axis=0))
