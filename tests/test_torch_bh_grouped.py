"""The port's grouped Barnes-Hut (nbody_tpu_torch.ops.bh_grouped,
experiments, list_eval) against nbody_tpu on the same numpy bodies (CPU).

Integer tables (direct ranges, merged runs, k-tile tables, overflow
flags) must be exactly equal; approx lists equal entry for entry with
values within rtol 1e-6; kernel K2's plain twin and the whole force pass
within 1e-5 of the largest |a| — the bound the JAX package holds its runs
evaluator to (tests/test_list_eval.py:131)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ops import bh_grouped as jb
from nbody_tpu.ops import experiments as jx
from nbody_tpu.ops import list_eval as jle
from nbody_tpu.ops import tree as jt
from nbody_tpu_torch.ops import bh_grouped as tb
from nbody_tpu_torch.ops import experiments as tx
from nbody_tpu_torch.ops import list_eval as tle
from nbody_tpu_torch.ops import tree as tt

G = 6.67e-11
N, GS = 2048, 512
FORCE_TOL = 1e-5


def _cloud(mode, seed, n=N):
    rng = np.random.default_rng(seed)
    m = (10 ** rng.uniform(-1, np.log10(0.5), n)).astype(np.float32)
    if mode == "uniform":
        p = rng.uniform(-0.1, 0.1, (n, 2))
    else:
        c = rng.uniform(-0.05, 0.05, (2, 2))
        p = c[np.arange(n) % 2] + 0.004 * rng.normal(size=(n, 2))
    return m, p.astype(np.float32)


def _collect_both(m, p, **cap_kw):
    """Both packages' _collect_lists on the same trees and group bboxes."""
    jtree = jt.build_quadtree(jnp.asarray(p), jnp.asarray(m), max_depth=9)
    ttree = tt.build_quadtree(torch.tensor(p), torch.tensor(m), max_depth=9)
    ps = p[np.argsort(np.asarray(jtree.codes), kind="stable")]
    sub = ps.reshape(N // GS, 4, GS // 4, 2)
    bbox = (sub[..., 0].min(2), sub[..., 0].max(2), sub[..., 1].min(2),
            sub[..., 1].max(2))
    caps = jb.cap_defaults(GS, N)
    kw = dict(theta=0.5, softening=1e-15,
              frontier_caps=jb.frontier_schedule(
                  cap_kw.get("frontier_cap", caps["frontier_cap"]), 9, N),
              list_cap=cap_kw.get("list_cap", caps["list_cap"]),
              direct_cap=cap_kw.get("direct_cap", caps["direct_cap"]),
              direct_cell_max=32)
    # jit: one compile instead of hundreds of eager op compiles
    jres = jax.jit(functools.partial(jb._collect_lists, **kw))(
        tuple(jnp.asarray(b) for b in bbox), jtree)
    tres = tb._collect_lists(tuple(torch.tensor(b) for b in bbox), ttree,
                             **kw)
    return jres, tres


@pytest.fixture(scope="module", params=[("uniform", 3), ("blobs", 4)],
                ids=["uniform", "blobs"])
def lists(request):
    m, p = _cloud(*request.param)
    return m, p, _collect_both(m, p)


def test_direct_ranges_exact(lists):
    _, _, ((_, jr, _), (_, tr, _)) = lists
    jr = np.asarray(jr)
    assert (jr[:, :, 1] > 0).any()
    np.testing.assert_array_equal(jr, tr.numpy())


def test_approx_lists_equal(lists):
    _, _, ((jl, _, _), (tl, _, _)) = lists
    jx_, jy, jm = (np.asarray(a) for a in jl)
    tx_, ty, tm = (a.numpy() for a in tl)
    for g in range(jm.shape[0]):
        jv, tv = jm[g] > 0, tm[g] > 0
        assert jv.sum() == tv.sum() > 0
        for ja, ta in ((jx_, tx_), (jy, ty), (jm, tm)):
            np.testing.assert_allclose(ta[g][tv], ja[g][jv], rtol=1e-6,
                                       atol=1e-12)


def test_overflow_flags_equal(lists):
    _, _, ((_, _, jo), (_, _, to)) = lists
    np.testing.assert_array_equal(np.asarray(jo), to.numpy())


def test_overflow_flags_equal_at_tight_caps():
    m, p = _cloud("blobs", 4)
    (_, jr, jo), (_, tr, to) = _collect_both(
        m, p, frontier_cap=64, list_cap=96, direct_cap=40)
    assert np.asarray(jo).any()
    np.testing.assert_array_equal(np.asarray(jo), to.numpy())
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())


def test_merge_ranges_and_tiles_exact(lists):
    _, _, ((_, jr, _), (_, tr, _)) = lists
    jm, jov = jx.merge_ranges(jr, cap=256)
    tm, tov = tx.merge_ranges(tr, cap=256)
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
    np.testing.assert_array_equal(np.asarray(jov), tov.numpy())
    for t_cap in (24576 // 256 + 512, 3):  # default and overflowing
        j_t = jb._expand_runs_tiles(jm, 256, t_cap)
        t_t = tb._expand_runs_tiles(tm, 256, t_cap)
        for a, b in zip(j_t, t_t):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_merge_ranges_small_cap_overflows():
    ranges = np.zeros((2, 6, 2), np.int32)
    ranges[0, :4] = [(40, 5), (0, 10), (10, 5), (30, 2)]  # 3 runs
    ranges[1, :2] = [(7, 3), (3, 4)]  # 1 run
    for cap in (2, 8):
        jm, jo = jx.merge_ranges(jnp.asarray(ranges), cap=cap)
        tm, to = tx.merge_ranges(torch.tensor(ranges), cap=cap)
        np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
        np.testing.assert_array_equal(np.asarray(jo), to.numpy())
    assert tm[0, :3].tolist() == [[0, 15], [30, 2], [40, 5]]


def test_expand_runs_tiles_hand_table():
    """The JAX package's hand-checked table (tests/test_list_eval.py)."""
    runs = np.zeros((2, 3, 2), np.int32)
    runs[0, 0] = (5, 300)
    runs[0, 1] = (1000, 10)
    runs[1, 0] = (0, 2000)
    tiles, n_t, ovf = tb._expand_runs_tiles(torch.tensor(runs), 256, 4)
    assert n_t.tolist() == [3, 4] and ovf.tolist() == [False, True]
    assert tiles[0, 0, :3].tolist() == [0, 256, 896]
    assert tiles[0, 1, :3].tolist() == [5, 0, 104]
    assert tiles[0, 2, :3].tolist() == [256, 49, 114]
    assert tiles[1, 0, :4].tolist() == [0, 256, 512, 768]


def test_k2_twin_matches_jax_kernel():
    """Plain twin of K2 vs the Pallas runs kernel (interpret mode) on one
    table whose direct tiles leave real bodies outside [lo, hi)."""
    rng = np.random.default_rng(0)
    g, s, k, a_w, ns = 2, 256, 256, 512, 1024
    targets = rng.uniform(-0.1, 0.1, (g, s, 2)).astype(np.float32)
    approx = np.zeros((g, 8, a_w), np.float32)
    approx[0, :2, :300] = rng.uniform(-0.1, 0.1, (2, 300))
    approx[0, 2, :300] = G * rng.uniform(0.1, 0.5, 300)
    srct = np.zeros((8, ns + k), np.float32)
    srct[:2, :ns] = rng.uniform(-0.1, 0.1, (2, ns))
    srct[2, :ns] = G * rng.uniform(0.1, 0.5, ns)  # every lane a real body
    srct[:2, 100] = targets[1, 7]  # a target meeting itself: excluded
    tiles = np.zeros((g, 3, 4), np.int32)
    tiles[0, :, :3] = [[0, 256, 640], [5, 0, 17], [256, 100, 200]]
    tiles[1, :, :1] = [[0], [90], [250]]
    lens = np.array([[300, 0], [3, 1]], np.int32)
    want = np.asarray(jle.list_eval_runs(
        jnp.asarray(targets), jnp.asarray(approx), jnp.asarray(srct),
        jnp.asarray(tiles), jnp.asarray(lens), softening=1e-15, k_tile=k,
        interpret=True))
    got = tle.list_eval_runs(
        torch.tensor(targets), torch.tensor(approx), torch.tensor(srct),
        torch.tensor(tiles), torch.tensor(lens), softening=1e-15,
        k_tile=k).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=FORCE_TOL * np.abs(want).max())


@pytest.mark.parametrize("mode,seed", [("uniform", 3), ("blobs", 4)])
def test_whole_force_pass_matches_jax(mode, seed):
    m, p = _cloud(mode, seed)
    want, jovf = jb.bh_accelerations_grouped(
        jnp.asarray(p), jnp.asarray(m), g=G, group_size=GS,
        use_pallas=False, return_diagnostics=True)
    got, tovf = tb.bh_accelerations_grouped(
        torch.tensor(p), torch.tensor(m), g=G, group_size=GS,
        return_diagnostics=True)
    want = np.asarray(want)
    assert int(np.asarray(jovf).sum()) == int(tovf.sum()) == 0
    np.testing.assert_allclose(got.numpy(), want,
                               atol=FORCE_TOL * np.abs(want).max())


@pytest.mark.parametrize("n", [2048, 40960, 65536, 1 << 20])
def test_cap_calibration_matches_jax(n):
    assert tb.cap_defaults(2048, n) == jb.cap_defaults(2048, n)
    assert tb.frontier_peak(n) == jb.frontier_peak(n)
    peak = jb.frontier_peak(n)
    assert tb.frontier_schedule(peak, 9, n) == jb.frontier_schedule(
        peak, 9, n)
    assert tle.runs_k_max() == jle.runs_k_max()


def test_packed_segments_raise():
    """seg_pack > 1 is kernel K3: its segments are 128-lane multiples, so
    a k_tile that P segments cannot tile is refused, as in the JAX
    package (list_eval.py:571)."""
    z = torch.zeros
    with pytest.raises(ValueError, match="K3"):
        tle.list_eval_runs(z(1, 8, 2), z(1, 8, 256), z(8, 512),
                           z(1, 3, 1, dtype=torch.int32),
                           z(2, 1, dtype=torch.int32), softening=0.0,
                           k_tile=256, seg_pack=4)
