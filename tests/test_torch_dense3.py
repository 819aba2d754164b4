"""The port's dense window collector (nbody_tpu_torch.ops.collect_dense3)
against nbody_tpu's and against the port's own gather walk (CPU).

Bounds, each with its reason:

* integer fields (cell counts, Morton body prefixes, window origins,
  direct ranges, quarter bits, overflow flags): exactly equal;
* the spatial pyramid's mass and COM against the JAX package's: rtol 1e-6
  (f32 sums of the same terms in another order: the JAX grid scatters the
  bodies, the port permutes the octree's segment sums), with an absolute
  floor of 1e-6 of the box's width for COMs, which are differences of
  large sums near the origin;
* each group's approx masses against the JAX dense collector: sorted,
  rtol 1e-5, the JAX package's own criterion for its dense collector
  (tests/test_collect_dense.py:75-87);
* against the port's gather walk: exactly equal, entry set for entry set
  (the port's spatial pyramid is the octree permuted, so both walks see
  the same bits; only the order of a group's entries differs).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ops import bh3d as jb
from nbody_tpu.ops import collect_dense3 as jd
from nbody_tpu.ops import tree3d as jt
from nbody_tpu_torch.ops import bh3d as tb
from nbody_tpu_torch.ops import collect_dense3 as td
from nbody_tpu_torch.ops import tree3d as tt
from nbody_tpu_torch.utils.profiling import counter

G = 6.67e-11
TINY_WINDOWS = (1, 2, 4, 6, 6, 6, 6, 6)  # tests/test_collect_dense.py:148


def _cloud(n, seed, blobs):
    """tests/test_collect_dense.py's cloud: uniform in [-0.1, 0.1]^3, or
    two tight Gaussian blobs clipped to the box."""
    rng = np.random.default_rng(seed)
    m = 10 ** rng.uniform(-1, np.log10(0.5), n)
    if blobs:
        k = n // 2
        c = rng.uniform(-0.05, 0.05, (2, 3))
        p = np.clip(np.concatenate([rng.normal(c[0], 0.004, (k, 3)),
                                    rng.normal(c[1], 0.004, (n - k, 3))]),
                    -0.1, 0.1)
    else:
        p = rng.uniform(-0.1, 0.1, (n, 3))
    return m.astype(np.float32), p.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _setup(n, seed, blobs, gs=2048):
    """Both packages' octrees and spatial pyramids, and the group
    sub-bboxes (Q = gs / 128) of the Morton-sorted bodies."""
    m, p = _cloud(n, seed, blobs)
    md = jt.default_max_depth3(n)
    jtree = jt.build_octree(jnp.asarray(p), jnp.asarray(m), max_depth=md)
    ttree = tt.build_octree(torch.tensor(p), torch.tensor(m), max_depth=md)
    jspyr = jd.build_spatial_pyramid(jnp.asarray(p), jnp.asarray(m),
                                     jtree.bounds, md)
    tspyr = td.build_spatial_pyramid(ttree)
    ps = p[np.argsort(np.asarray(jtree.codes), kind="stable")]
    q = gs // 128
    sub = ps.reshape(n // gs, q, gs // q, 3)
    bbox = tuple(f(sub[..., a], axis=2) for a in range(3)
                 for f in (np.min, np.max))
    caps = jb.cap_defaults_3d(n)
    kw = dict(theta=0.5, softening=1e-15, list_cap=caps["list_cap"],
              direct_cap=caps["direct_cap"],
              direct_cell_max=jb.direct_cell_max_default(n),
              frontier_caps=jb.frontier_schedule_3d(caps["frontier_cap"], md,
                                                    n))
    return m, p, jtree, ttree, jspyr, tspyr, bbox, kw


def _jbox(bbox):
    return tuple(jnp.asarray(b) for b in bbox)


def _tbox(bbox):
    return tuple(torch.tensor(b) for b in bbox)


# -- the spatial pyramid ----------------------------------------------------


@pytest.mark.parametrize("blobs", [False, True], ids=["uniform", "blobs"])
def test_spatial_pyramid_matches_jax(blobs):
    _, _, jtree, _, jspyr, tspyr, _, _ = _setup(4096, 2, blobs)
    b = np.asarray(jtree.bounds)
    width = float(max(b[1] - b[0], b[3] - b[2], b[5] - b[4]))
    assert tspyr.max_depth == jspyr.max_depth
    for jg, tg, js, ts in zip(jspyr.grid, tspyr.grid, jspyr.start,
                              tspyr.start):
        jg, tg = np.asarray(jg), tg.numpy()
        assert jg.shape == tg.shape
        np.testing.assert_array_equal(tg[..., 4], jg[..., 4])  # counts
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_allclose(tg[..., 0], jg[..., 0], rtol=1e-6)
        np.testing.assert_allclose(tg[..., 1:4], jg[..., 1:4], rtol=1e-6,
                                   atol=1e-6 * width)


def test_spatial_pyramid_is_the_octree_permuted():
    """Cell for cell, the grid holds the COM the gather walk derives from
    the octree row (bit for bit) and the prefix its leaf_cum gives."""
    _, p, _, ttree, _, tspyr, _, _ = _setup(4096, 2, True)
    md = ttree.max_depth
    coords = td.spatial_cell_coords_3d(torch.tensor(p), ttree.bounds, md)
    leaf_cum = np.concatenate([[0], np.cumsum(ttree.leaf_counts().numpy())])
    codes = ttree.codes.numpy()
    for lv in range(md + 1):
        raw = ttree.raw[lv].numpy()
        cell = codes >> (3 * (md - lv))
        c = coords.numpy() >> (md - lv)
        grid = tspyr.grid[lv].numpy()[c[:, 0], c[:, 1], c[:, 2]]
        m = raw[cell, tt.R3_M]
        cnt = raw[cell, tt.R3_CNT]
        safe = np.where(m > 0, m, np.float32(1.0))
        for k, (s, w) in enumerate(((tt.R3_SX, tt.R3_MX),
                                    (tt.R3_SY, tt.R3_MY),
                                    (tt.R3_SZ, tt.R3_MZ))):
            com = np.where(cnt == 1, raw[cell, s], raw[cell, w] / safe)
            np.testing.assert_array_equal(grid[:, 1 + k], com)
        np.testing.assert_array_equal(grid[:, 0], m)
        start = tspyr.start[lv].numpy()[c[:, 0], c[:, 1], c[:, 2]]
        np.testing.assert_array_equal(start,
                                      leaf_cum[cell << (3 * (md - lv))])


@pytest.mark.parametrize("blobs", [False, True], ids=["uniform", "blobs"])
def test_spatial_cell_coords_match_jax_and_morton(blobs):
    m, p = _cloud(1000, 7, blobs)
    md = 6
    bounds = jt.root_bounds_3d(jnp.asarray(p))
    want = np.asarray(jd.spatial_cell_coords_3d(jnp.asarray(p), bounds, md))
    got = td.spatial_cell_coords_3d(torch.tensor(p),
                                    torch.tensor(np.asarray(bounds)), md)
    np.testing.assert_array_equal(got.numpy(), want)
    codes = np.asarray(jt.morton_codes_3d(jnp.asarray(p), bounds, md))
    for a in range(3):
        axis = sum(((codes >> (3 * k + a)) & 1) << k for k in range(md))
        np.testing.assert_array_equal(got.numpy()[:, a], axis)


# -- window origins and schedules -----------------------------------------


@pytest.mark.parametrize("blobs", [False, True], ids=["uniform", "blobs"])
def test_window_origins_match_jax_and_stay_in_range(blobs):
    _, _, jtree, ttree, _, _, bbox, _ = _setup(8192, 0, blobs, gs=512)
    md = ttree.max_depth
    for sched in (td.window_schedule_3d(md), TINY_WINDOWS[:md + 1]):
        want = jd._window_origins(_jbox(bbox), jtree.bounds, sched)
        got = td._window_origins(_tbox(bbox), ttree.bounds, sched)
        assert len(got) == md + 1
        for lv, (jo, to) in enumerate(zip(want, got)):
            to = to.numpy()
            np.testing.assert_array_equal(to, np.asarray(jo))
            # no clamp of JAX's dynamic_slice ever fires, and no torch
            # index can wrap: the window lies in the level, even-aligned,
            # and its parent span lies in the parent window
            w, d = sched[lv], 1 << lv
            assert ((to >= 0) & (to <= d - w)).all()
            if lv:
                assert (to % 2 == 0).all()
                r_off = to // 2 - got[lv - 1].numpy()
                assert ((r_off >= 0)
                        & (r_off + w // 2 <= sched[lv - 1])).all()


def test_window_schedule_default_and_validation():
    assert td.WINDOW_SCHEDULE_3D == jd.WINDOW_SCHEDULE_3D
    for md in range(1, 10):
        s = td.window_schedule_3d(md)
        assert s == jd.window_schedule_3d(md)
        assert td.check_window_schedule(s, md) == s
    assert td.check_window_schedule(TINY_WINDOWS[:6], 5)
    for bad, match in (((1, 2, 4), "6 levels"), ((1, 2, 4, 8, 8, 24), "= 24"),
                       ((1, 2, 4, 8, 16, 27), "27"), ((2, 2, 4, 8, 16, 28),
                                                      r"\[0\]"),
                       ((1, 2, 4, 8, 16, 34), "34")):
        with pytest.raises(ValueError, match=match):
            td.check_window_schedule(bad, 5)


# -- the dense collector ----------------------------------------------------


def _group_sets(lm, ranges, gi):
    a = np.sort(lm[gi][lm[gi] > 0])
    r = ranges[gi][ranges[gi][:, 1] > 0]
    return a, r[np.lexsort(r.T)]


@functools.lru_cache(maxsize=None)
def _dense(blobs, quarter_bits):
    m, p, jtree, ttree, jspyr, tspyr, bbox, kw = _setup(8192, 0, blobs)
    kw = dict(kw, quarter_bits=quarter_bits)
    jres = jax.jit(lambda b: jd.collect_lists_3d_dense(b, jtree, jspyr,
                                                       **kw))(_jbox(bbox))
    tres = td.collect_lists_3d_dense(_tbox(bbox), ttree, tspyr, **kw)
    gres = tb._collect_lists_3d(_tbox(bbox), ttree, **kw)
    return jres, tres, gres


DENSE = [(False, False), (False, True), (True, False), (True, True)]
DENSE_IDS = ["uniform", "uniform-quarters", "blobs", "blobs-quarters"]


@pytest.mark.parametrize("blobs,quarter_bits", DENSE, ids=DENSE_IDS)
def test_dense_collector_matches_jax(blobs, quarter_bits):
    jres, tres, _ = _dense(blobs, quarter_bits)
    jlm, tlm = np.asarray(jres[0][3]), tres[0][3].numpy()
    jr, tr = np.asarray(jres[1]), tres[1].numpy()
    assert jr.shape == tr.shape and (tr[:, :, 1] > 0).any()
    np.testing.assert_array_equal(np.asarray(jres[2]), tres[2].numpy())
    assert not tres[2].any()
    for gi in range(tlm.shape[0]):
        ja, jrs = _group_sets(jlm, jr, gi)
        ta, trs = _group_sets(tlm, tr, gi)
        assert len(ja) == len(ta) > 0
        np.testing.assert_allclose(ta, ja, rtol=1e-5)
        np.testing.assert_array_equal(trs, jrs)
    if quarter_bits:
        np.testing.assert_array_equal(tres[3]["bits"].numpy(),
                                      np.asarray(jres[3]["bits"]))
        np.testing.assert_allclose(tres[3]["mass"].numpy(),
                                   np.asarray(jres[3]["mass"]), rtol=1e-5)


@pytest.mark.parametrize("blobs,quarter_bits", DENSE, ids=DENSE_IDS)
def test_dense_collector_equals_gather_walk(blobs, quarter_bits):
    _, tres, gres = _dense(blobs, quarter_bits)
    assert torch.equal(tres[2], gres[2])
    dlm, glm = tres[0][3].numpy(), gres[0][3].numpy()
    dr, gr = tres[1].numpy(), gres[1].numpy()
    for gi in range(dlm.shape[0]):
        da, drs = _group_sets(dlm, dr, gi)
        ga, grs = _group_sets(glm, gr, gi)
        np.testing.assert_array_equal(da, ga)
        np.testing.assert_array_equal(drs, grs)
        # every approx entry, coordinates included, as one sorted set
        dset = sorted(zip(*(a[gi].numpy().tolist() for a in tres[0])))
        gset = sorted(zip(*(a[gi].numpy().tolist() for a in gres[0])))
        assert [e for e in dset if e[3] > 0] == [e for e in gset if e[3] > 0]
        if quarter_bits:
            key = [tres[1][gi, :, 0]] + [tres[3]["bits"][gi],
                                         tres[3]["mass"][gi],
                                         *(c[gi] for c in tres[3]["com"])]
            gkey = [gres[1][gi, :, 0]] + [gres[3]["bits"][gi],
                                          gres[3]["mass"][gi],
                                          *(c[gi] for c in gres[3]["com"])]
            live_d, live_g = dr[gi, :, 1] > 0, gr[gi, :, 1] > 0
            assert sorted(zip(*(k.numpy()[live_d].tolist() for k in key))) \
                == sorted(zip(*(k.numpy()[live_g].tolist() for k in gkey)))


def test_spill_ladder():
    """Forced-tiny windows escape groups: with spill_cap = G every group
    the gather walk completes comes back exact, as JAX's spill does
    (tests/test_collect_dense.py:141-169), and spill_cap = 0 leaves every
    escape as an overflow."""
    _, _, jtree, ttree, jspyr, tspyr, bbox, kw = _setup(8192, 0, False,
                                                         gs=512)
    g = bbox[0].shape[0]
    md = ttree.max_depth
    sched = TINY_WINDOWS[:md + 1]
    (_, _, _, glm), granges, _ = tb._collect_lists_3d(_tbox(bbox), ttree,
                                                      **kw)
    names = ("ops.collect_dense3.ESCAPED_GROUPS",
             "ops.collect_dense3.SPILL_PASSES")
    before = tuple(map(counter, names))
    (_, _, _, slm), sranges, sovf = td.collect_lists_3d_dense(
        _tbox(bbox), ttree, tspyr, window_schedule=sched, spill_cap=g, **kw)
    escaped = counter(names[0]) - before[0]
    assert escaped > 0 and counter(names[1]) == before[1] + 1
    jovf = jax.jit(lambda b: jd.collect_lists_3d_dense(
        b, jtree, jspyr, window_schedule=sched, spill_cap=g,
        **kw))(_jbox(bbox))[2]
    np.testing.assert_array_equal(sovf.numpy(), np.asarray(jovf))
    checked = 0
    for gi in range(g):
        if sovf[gi]:
            continue
        a, ra = _group_sets(slm.numpy(), sranges.numpy(), gi)
        b, rb = _group_sets(glm.numpy(), granges.numpy(), gi)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ra, rb)
        checked += 1
    assert checked >= g // 2

    _, _, oovf = td.collect_lists_3d_dense(
        _tbox(bbox), ttree, tspyr, window_schedule=sched, spill_cap=0, **kw)
    assert int(oovf.sum()) >= escaped


def test_spill_cap_auto_has_absolute_floor():
    """Auto spill budget max(48, G // 4), clamped to G: with G = 16 < 48
    the auto run equals an explicit spill_cap = G run; a budget of 4 can
    only leave more overflow."""
    _, _, _, ttree, _, tspyr, bbox, kw = _setup(8192, 0, False, gs=512)
    g = bbox[0].shape[0]
    sched = TINY_WINDOWS[:ttree.max_depth + 1]
    run = functools.partial(td.collect_lists_3d_dense, _tbox(bbox), ttree,
                            tspyr, window_schedule=sched, **kw)
    auto, full, four = run()[2], run(spill_cap=g)[2], run(spill_cap=4)[2]
    assert torch.equal(auto, full)
    assert int(four.sum()) >= int(auto.sum())
    assert int(four.sum()) > 0


@pytest.mark.parametrize("blobs", [False, True], ids=["uniform", "blobs"])
def test_dense_force_pass_matches_jax(blobs):
    """End to end through bh3_accelerations_grouped with collect='dense'
    against the JAX package's dense route (its XLA evaluator), 1e-5 of
    the largest |a| (tests/test_list_eval.py:131), and bit-equal lists:
    the same forces as the port's gather route within f32 reordering."""
    m, p = _cloud(4096, 1, blobs)
    kw = dict(g=G, group_size=512, return_diagnostics=True)
    want, jovf = jb.bh3_accelerations_grouped(
        jnp.asarray(p), jnp.asarray(m), use_pallas=False, collect="dense",
        **kw)
    got, tovf = tb.bh3_accelerations_grouped(
        torch.tensor(p), torch.tensor(m), collect="dense", **kw)
    gather, _ = tb.bh3_accelerations_grouped(
        torch.tensor(p), torch.tensor(m), collect="gather", **kw)
    want = np.asarray(want)
    assert int(np.asarray(jovf).sum()) == int(tovf.sum()) == 0
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * scale)
    np.testing.assert_allclose(got.numpy(), gather.numpy(),
                               atol=1e-5 * scale)


def test_dense_route_needs_the_pyramid():
    m, p = _cloud(512, 3, False)
    tree = tt.build_octree(torch.tensor(p), torch.tensor(m), max_depth=4)
    pt = torch.tensor(p)
    with pytest.raises(ValueError, match="spyr"):
        tb.grouped_eval_3d(pt, tree, target_order=torch.arange(512),
                           target_sorted=pt,
                           sorted_srcs=(pt[:, 0], pt[:, 1], pt[:, 2],
                                        torch.tensor(m)),
                           g=G, group_size=128, collect="dense")


def test_dense_counters_and_1m_defaults():
    """The N = 1,048,576 defaults: depth 7, group 2,048 (G = 512), dcm
    128 and the caps the slice runs at; both sizes route dense."""
    n = 1 << 20
    c = tb.cap_defaults_3d(n)
    assert tt.default_max_depth3(n) == 7
    assert tb.default_group_size3(n) == 2048
    assert tb.direct_cell_max_default(n) == 128
    assert (c["list_cap"], c["direct_cap"], c["direct_body_cap"],
            c["run_cap"]) == (14336, 8192, 655360, 640)
    assert tb.default_group_size3(262144) == 4096
    assert tb.direct_cell_max_default(262144) == 32
    for n_ in (262144, n):
        assert tb._resolve_collect(None, n_) == "dense"
    assert td.window_schedule_3d(7) == (1, 2, 4, 8, 16, 28, 24, 32)


def _refuse_walk(*a, **kw):
    raise AssertionError("the walk ran before its schedule was checked")


def test_dense_collector_rejects_windows_its_kernel_cannot_take(
        monkeypatch):
    """A window wider than the kernel's 32 cells raises before the walk
    is dispatched, on either device, so the twin runs no schedule that
    the card would refuse; the widest default schedule passes."""
    m, p = _cloud(512, 4, False)
    tree = tt.build_octree(torch.tensor(p), torch.tensor(m), max_depth=6)
    spyr = td.build_spatial_pyramid(tree)
    bbox = tuple(torch.tensor(np.full((2, 4), v, np.float32))
                 for v in (-0.01, 0.01) * 3)
    kw = dict(theta=0.5, softening=1e-15, frontier_caps=(64,) * 7,
              list_cap=256, direct_cap=64, direct_cell_max=32)
    monkeypatch.setattr(td, "_dense_lists", _refuse_walk)
    monkeypatch.setattr(td, "_dense_lists_kernel", _refuse_walk)
    wide = (1, 2, 4, 8, 16, 32, 64)
    assert td.check_window_schedule(wide, 6) == wide
    with pytest.raises(ValueError, match=r"widths \[64\] exceed"):
        td.collect_lists_3d_dense(bbox, tree, spyr, window_schedule=wide,
                                  **kw)
    with pytest.raises(AssertionError, match="schedule was checked"):
        td.collect_lists_3d_dense(bbox, tree, spyr, **kw)
    for md in range(1, 16):
        td.check_kernel_schedule(td.window_schedule_3d(md))


def test_dense_kernel_schedule_depth_limit():
    td.check_kernel_schedule(td.window_schedule_3d(td.KERNEL_MAX_LEVELS - 1))
    deep = td.window_schedule_3d(td.KERNEL_MAX_LEVELS)
    assert td.check_window_schedule(deep, td.KERNEL_MAX_LEVELS) == deep
    with pytest.raises(ValueError, match="at most 16"):
        td.check_kernel_schedule(deep)
