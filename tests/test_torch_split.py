"""The port's quarter-split evaluation (quarter bits in both gather walks,
``bh_grouped._evaluate_runs_split``, kernel K4's twin
``list_eval.list_eval_runs_split_plain``, the split routes of the 2D and
3D engines) against nbody_tpu on the same numpy bodies (CPU).

Bounds, each with its reason:

* quarter bits, direct-entry COMs and masses from the gather walks, and
  the split tables built from the same collected lists (ext, its lane
  counts, the per-quarter tile tables, lens, overflow): exactly equal
  (the same f32 operations on the same bits);
* K4's twin against the Pallas kernel in interpret mode, and the whole
  split force pass against the JAX package's Pallas route: 1e-5 of the
  largest |a| (the bound of tests/test_list_eval.py:131: f32 both sides,
  sums taken in another order);
* split against unsplit evaluation: 2e-3 of the largest |a|, the JAX
  package's own bound (tests/test_list_eval.py:224): extension COMs
  replace pairwise sums where a quarter's theta passes;
* the 3-step contract loop with the dense collector and split evaluation:
  1e-6 absolute on positions in the 0.2-wide box, as
  tests/test_torch_3d.py's loop test.
"""

import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbody_tpu
import nbody_tpu_torch
from nbody_tpu.models.simulation import Simulation as JaxSimulation
from nbody_tpu.ops import bh3d as jb3
from nbody_tpu.ops import bh_grouped as jb2
from nbody_tpu.ops import list_eval as jle
from nbody_tpu.ops import tree as jt2
from nbody_tpu.ops import tree3d as jt3
from nbody_tpu.state import to_numpy as jax_to_numpy
from nbody_tpu_torch.models.simulation import Simulation
from nbody_tpu_torch.ops import bh3d as tb3
from nbody_tpu_torch.ops import bh_grouped as tb2
from nbody_tpu_torch.ops import list_eval as tle
from nbody_tpu_torch.ops import tree as tt2
from nbody_tpu_torch.ops import tree3d as tt3
from nbody_tpu_torch.state import from_numpy

G = 6.67e-11
N, GS, K_TILE = 2048, 512, 256
FORCE_TOL = 1e-5
SPLIT_TOL = 2e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cloud(dims, mode, seed, n=N):
    rng = np.random.default_rng(seed)
    m = (10 ** rng.uniform(-1, np.log10(0.5), n)).astype(np.float32)
    if mode == "uniform":
        p = rng.uniform(-0.1, 0.1, (n, dims))
    else:
        c = rng.uniform(-0.05, 0.05, (2, dims))
        p = c[np.arange(n) % 2] + 0.004 * rng.normal(size=(n, dims))
    return m, p.astype(np.float32)


def _setup(dims, m, p):
    """Both packages' trees, the Morton-sorted bodies and the group
    sub-bboxes (Q = 4 per group of GS), as both engines cut them."""
    if dims == 2:
        md = 9
        jtree = jt2.build_quadtree(jnp.asarray(p), jnp.asarray(m),
                                   max_depth=md)
        ttree = tt2.build_quadtree(torch.tensor(p), torch.tensor(m),
                                   max_depth=md)
        caps = jb2.cap_defaults(GS, N)
        sched = jb2.frontier_schedule(caps["frontier_cap"], md, N)
    else:
        md = jt3.default_max_depth3(N)
        jtree = jt3.build_octree(jnp.asarray(p), jnp.asarray(m),
                                 max_depth=md)
        ttree = tt3.build_octree(torch.tensor(p), torch.tensor(m),
                                 max_depth=md)
        caps = jb3.cap_defaults_3d(N)
        sched = jb3.frontier_schedule_3d(caps["frontier_cap"], md, N)
    order = np.argsort(np.asarray(jtree.codes), kind="stable")
    ps = p[order]
    sub = ps.reshape(N // GS, 4, GS // 4, dims)
    bbox = tuple(f(sub[..., a], axis=2) for a in range(dims)
                 for f in (np.min, np.max))
    kw = dict(theta=0.5, softening=1e-15, frontier_caps=sched,
              list_cap=caps["list_cap"], direct_cap=caps["direct_cap"],
              direct_cell_max=32, quarter_bits=True)
    return jtree, ttree, order, ps, bbox, caps, kw


@functools.lru_cache(maxsize=None)
def _collected(dims, mode, seed):
    """Both gather walks with quarter bits on the same bodies."""
    m, p = _cloud(dims, mode, seed)
    jtree, ttree, order, ps, bbox, caps, kw = _setup(dims, m, p)
    jwalk = jb2._collect_lists if dims == 2 else jb3._collect_lists_3d
    twalk = tb2._collect_lists if dims == 2 else tb3._collect_lists_3d
    jres = jax.jit(functools.partial(jwalk, **kw))(
        tuple(jnp.asarray(b) for b in bbox), jtree)
    tres = twalk(tuple(torch.tensor(b) for b in bbox), ttree, **kw)
    return m, p, order, ps, caps, jres, tres


CASES = [(2, "uniform", 3), (2, "blobs", 4), (3, "uniform", 3),
         (3, "blobs", 4)]
CASE_IDS = ["2d-uniform", "2d-blobs", "3d-uniform", "3d-blobs"]


# -- quarter bits in the gather walks -------------------------------------


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_quarter_bits_match_jax(case):
    *_, jres, tres = _collected(*case)
    jq, tq = jres[3], tres[3]
    bits = tq["bits"].numpy()
    has = tres[1][:, :, 1].numpy() > 0
    np.testing.assert_array_equal(np.asarray(jres[1])[:, :, 1] > 0, has)
    # bits and masses are zero past the direct entries in both; the COM
    # payload there is whatever the JAX package's unstable compaction
    # sort left, so COMs are compared on the direct entries
    np.testing.assert_array_equal(np.asarray(jq["bits"]), bits)
    np.testing.assert_array_equal(np.asarray(jq["mass"]), tq["mass"].numpy())
    for jc, tc in zip(jq["com"], tq["com"]):
        np.testing.assert_array_equal(np.asarray(jc)[has], tc.numpy()[has])
    # every direct cell fails theta for at least one quarter, and some
    # cells pass for some quarters (the extension section is not empty)
    assert has.any() and (bits[has] > 0).all()
    assert (bits[has] < 15).any()
    assert (bits[~has] == 0).all()


@pytest.mark.parametrize("case", CASES[::2], ids=CASE_IDS[::2])
def test_quarter_bits_leave_the_lists_unchanged(case):
    """The quarter payload rides the direct compaction: lists, ranges and
    overflow are those of the walk without it."""
    dims, mode, seed = case
    m, p = _cloud(dims, mode, seed)
    _, ttree, _, _, bbox, _, kw = _setup(dims, m, p)
    walk = tb2._collect_lists if dims == 2 else tb3._collect_lists_3d
    tb = tuple(torch.tensor(b) for b in bbox)
    with_q = walk(tb, ttree, **kw)
    without = walk(tb, ttree, **{**kw, "quarter_bits": False})
    assert len(without) == 3 and len(with_q) == 4
    for a, b in zip(with_q[0], without[0]):
        assert torch.equal(a, b)
    assert torch.equal(with_q[1], without[1])
    assert torch.equal(with_q[2], without[2])


# -- the split tables ------------------------------------------------------


def _split_tables(dims, mode, seed):
    """The tables both packages' split evaluators hand their K4 wrapper,
    built from the same collected lists (the JAX walk's, as numpy)."""
    m, p, order, ps, caps, jres, _ = _collected(dims, mode, seed)
    pg = ps.reshape(N // GS, GS, dims)
    (lists, ranges, _, quarters) = jres
    lists = [np.asarray(a) for a in lists]
    ranges = np.asarray(ranges)
    quarters = dict(bits=np.asarray(quarters["bits"]),
                    com=tuple(np.asarray(c) for c in quarters["com"]),
                    mass=np.asarray(quarters["mass"]))
    sorted_c = tuple(np.ascontiguousarray(ps[:, a]) for a in range(dims))
    gm = (G * m[order]).astype(np.float32)
    rc = caps["run_cap"]
    t_cap = caps["direct_body_cap"] // K_TILE + 2 * rc
    kw = dict(g_const=G, softening=1e-15, k_tile=K_TILE, run_cap=rc,
              t_cap=t_cap)

    seen = {}

    def spy(key):
        def f(*a, **k):
            seen[key] = [np.asarray(x) for x in a]
            return jnp.zeros(a[0].shape, jnp.float32) if key == "jax" else (
                torch.zeros(a[0].shape))
        return f

    orig_j, orig_t = jle.list_eval_runs_split, tle.list_eval_runs_split
    try:
        jle.list_eval_runs_split = spy("jax")
        tle.list_eval_runs_split = spy("torch")
        _, jovf = jb2._evaluate_pallas_runs_split(
            jnp.asarray(pg), tuple(jnp.asarray(a) for a in lists[:dims]),
            jnp.asarray(lists[dims]), jnp.asarray(ranges),
            dict(bits=jnp.asarray(quarters["bits"]),
                 com=tuple(jnp.asarray(c) for c in quarters["com"]),
                 mass=jnp.asarray(quarters["mass"])),
            tuple(jnp.asarray(c) for c in sorted_c), jnp.asarray(gm), **kw)
        _, tovf = tb2._evaluate_runs_split(
            torch.tensor(pg), tuple(torch.tensor(a) for a in lists[:dims]),
            torch.tensor(lists[dims]), torch.tensor(ranges),
            dict(bits=torch.tensor(quarters["bits"]),
                 com=tuple(torch.tensor(c) for c in quarters["com"]),
                 mass=torch.tensor(quarters["mass"])),
            tuple(torch.tensor(c) for c in sorted_c), torch.tensor(gm), **kw)
    finally:
        jle.list_eval_runs_split, tle.list_eval_runs_split = orig_j, orig_t
    return seen["jax"], seen["torch"], np.asarray(jovf), tovf.numpy()


@pytest.mark.parametrize("case", CASES[::2], ids=CASE_IDS[::2])
def test_split_tables_match_jax(case):
    jargs, targs, jovf, tovf = _split_tables(*case)
    names = ("targets", "approx", "ext", "sources_t", "tiles", "lens")
    for name, ja, ta in zip(names, jargs, targs):
        assert ja.shape == ta.shape, (name, ja.shape, ta.shape)
        np.testing.assert_array_equal(ja, ta, err_msg=name)
    np.testing.assert_array_equal(jovf, tovf)
    ext, lens = targs[2], targs[5]
    g4 = lens.shape[1]
    assert ext.shape[0] == g4 == 4 * (N // GS)
    assert ext.shape[2] % K_TILE == 0
    # lens = (approx lanes repeated per quarter, ext lanes, tiles)
    np.testing.assert_array_equal(lens[0].reshape(-1, 4),
                                  lens[0][::4, None].repeat(4, 1))
    assert lens[1].sum() > 0 and lens[2].sum() > 0
    # ext rows past each quarter's lane count are gm = 0 padding
    dims = case[0]
    lane = np.arange(ext.shape[2])
    assert (ext[:, dims][lane[None] >= lens[1][:, None]] == 0).all()
    assert (ext[:, dims][lane[None] < lens[1][:, None]] > 0).all()


# -- the premise of K4's packed streaming ----------------------------------


def _assert_packing_premise(approx, ext, srct, tiles, lens, k_tile, dims):
    """What makes K4's packing exact: every approx and extension lane past
    lens inside an occupied tile is gm = 0 with finite coordinates (so
    skipping it drops +-0), and every direct entry's clipped [lo, hi) lies
    inside its k_tile window and the source table."""
    approx, ext, srct, tiles, lens = (torch.as_tensor(np.asarray(a)) for a in
                                      (approx, ext, srct, tiles, lens))
    for table, n_lanes, rows in ((approx, lens[0, ::4], approx.shape[0]),
                                 (ext, lens[1], ext.shape[0])):
        assert table.shape[0] == rows == n_lanes.shape[0]
        width = table.shape[2]
        lane = torch.arange(width)[None]
        occupied = (-(-n_lanes // k_tile)) * k_tile
        tail = (lane >= n_lanes[:, None]) & (lane < occupied[:, None])
        assert (table[:, dims][tail] == 0).all()
        assert torch.isfinite(table[:, :dims + 1]).all()
    npad, t_cap = srct.shape[1], tiles.shape[2]
    start, lo, hi = tiles.long().unbind(1)
    live = torch.arange(t_cap)[None] < lens[2, :, None].clamp(max=t_cap)
    assert (start[live] >= 0).all() and (start[live] % 128 == 0).all()
    assert (lo[live] >= 0).all() and (lo[live] <= hi[live]).all()
    assert (hi[live] <= k_tile).all()
    assert (start[live] + hi[live] <= npad).all()
    # the lanes K4 stages, counted two ways
    span = (hi - lo).clamp(min=0) * live
    want = (lens[0].long().clamp(max=approx.shape[2])
            + lens[1].long().clamp(max=ext.shape[2]) + span.sum(1))
    got = tle.split_quarter_lanes(approx, ext, srct, tiles, lens,
                                  k_tile=k_tile)
    assert torch.equal(got, want) and int(got.sum()) > 0


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_split_tables_hold_the_packing_premise(case):
    _, targs, _, _ = _split_tables(*case)
    _, approx, ext, srct, tiles, lens = targs
    _assert_packing_premise(approx, ext, srct, tiles, lens, K_TILE, case[0])


@pytest.mark.parametrize("dims,collect", [(2, None), (3, "gather"),
                                          (3, "dense")],
                         ids=["2d", "3d-gather", "3d-dense"])
def test_engine_split_pass_holds_the_packing_premise(dims, collect,
                                                     monkeypatch):
    """The tables a whole split force pass hands K4 at N = 8,192."""
    m, p = _cloud(dims, "blobs", 9, n=8192)
    seen = []
    orig = tle.list_eval_runs_split

    def spy(*a, **kw):
        seen.append((a, kw))
        return orig(*a, **kw)

    monkeypatch.setattr(tle, "list_eval_runs_split", spy)
    kw = dict(g=G, group_size=GS, split_eval=True)
    if dims == 3:
        tb3.bh3_accelerations_grouped(torch.tensor(p), torch.tensor(m),
                                      collect=collect, **kw)
    else:
        tb2.bh_accelerations_grouped(torch.tensor(p), torch.tensor(m), **kw)
    (a, k), = seen
    _assert_packing_premise(*a[1:], k["k_tile"], dims)


@pytest.mark.parametrize("s,want", [(2048, (1, 2)), (512, (1, 1)),
                                    (256, (1, 1)), (4400, (1, 5))])
def test_k4_launch_shape(s, want):
    """K4's launch: one target a thread, blocks of SPLIT_THREADS over each
    quarter, the same on every call; at the 1M default (2,048 quarters of
    512 targets) the grid is many waves long at the blocks an SM is
    counted to hold."""
    n_q = 2048
    tpt, per_q, blocks = tle.split_launch_shape(n_q, s)
    assert (tpt, per_q) == want and blocks == n_q * per_q
    assert per_q * tle.SPLIT_THREADS >= s // 4
    assert tle.split_launch_shape(n_q, s) == (tpt, per_q, blocks)
    if s == 2048:
        assert blocks / (tle.SMS * tle.SPLIT_WAVE_BLOCKS) >= 2


# -- K4's twin against the Pallas kernel ----------------------------------


def _split_table(dims, seed, sections):
    """Synthetic K4 tables: two groups of S = 256 (eight quarters), every
    source lane a real body, approx / ext / direct sections each empty,
    partial or full per quarter; direct entries whose windows leave lanes
    outside [lo, hi), and a target meeting itself in a direct window."""
    rng = np.random.default_rng(seed)
    g, s, a_w, e_w, ns, k = 2, 256, 300, 200, 2048, 128
    targets = rng.uniform(-0.1, 0.1, (g, s, dims)).astype(np.float32)
    approx = np.zeros((g, 8, a_w), np.float32)
    approx[:, :dims] = rng.uniform(-0.1, 0.1, (g, dims, a_w))
    approx[:, dims] = G * rng.uniform(0.1, 0.5, (g, a_w))
    ext = np.zeros((4 * g, 8, e_w), np.float32)
    ext[:, :dims] = rng.uniform(-0.1, 0.1, (4 * g, dims, e_w))
    srct = np.zeros((8, ns + k), np.float32)
    srct[:dims, :ns] = rng.uniform(-0.1, 0.1, (dims, ns))
    srct[dims, :ns] = G * rng.uniform(0.1, 0.5, ns)
    srct[:dims, 300] = targets[1, 7]  # excluded by d2 > 0
    pool = [(0, 5, k - 3), (256, 0, k), (1024, 17, 40), (128, 2, 2),
            (1792, 1, k), (256, 30, k), (384, 0, 90)]
    t_cap = 5
    tiles = np.zeros((4 * g, 3, t_cap), np.int32)
    lens = np.zeros((3, 4 * g), np.int32)
    fill = {"empty": 0.0, "partial": 0.5, "full": 1.0}
    for i in range(4 * g):
        a_sec, e_sec, d_sec = sections[i % len(sections)]
        lens[0, i] = int(fill[a_sec] * a_w)
        lens[1, i] = int(fill[e_sec] * e_w)
        ext[i, dims, :lens[1, i]] = G * rng.uniform(0.1, 0.5, lens[1, i])
        n_d = int(fill[d_sec] * t_cap)
        ents = [pool[(i + j) % len(pool)] for j in range(n_d)]
        if ents:
            tiles[i, :, :n_d] = np.array(ents).T
        lens[2, i] = n_d
    # group 0 shares one approx count over its quarters, as the engine's
    lens[0, 0:4] = lens[0, 0]
    lens[0, 4:8] = lens[0, 4]
    return (targets, approx, ext, srct, tiles, lens), k


SECTIONS = [("full", "partial", "full"), ("empty", "full", "partial"),
            ("partial", "empty", "empty"), ("full", "full", "empty"),
            ("empty", "empty", "full")]


@pytest.mark.parametrize("dims", [2, 3])
def test_k4_twin_matches_jax_kernel(dims):
    args, k = _split_table(dims, seed=dims, sections=SECTIONS)
    want = np.asarray(jle.list_eval_runs_split(
        *(jnp.asarray(a) for a in args), softening=1e-15, k_tile=k,
        interpret=True))
    got = tle.list_eval_runs_split(
        *(torch.tensor(a) for a in args), softening=1e-15,
        k_tile=k).numpy()
    assert got.shape == want.shape == (2, 256, dims)
    assert np.isfinite(got).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, atol=FORCE_TOL * np.abs(want).max())
    # a quarter whose three sections are all empty gets no force
    empty = np.asarray([all(x == 0 for x in args[5][:, i])
                        for i in range(8)])
    for i in np.nonzero(empty)[0]:
        g, q = divmod(i, 4)
        assert (got[g, q * 64:(q + 1) * 64] == 0).all()


def test_k4_wrapper_checks_the_quarter_layout():
    (targets, approx, ext, srct, tiles, lens), k = _split_table(
        3, seed=0, sections=SECTIONS)
    t = [torch.tensor(a) for a in (targets, approx, ext, srct, tiles, lens)]
    with pytest.raises(ValueError, match="S % 4"):
        tle.list_eval_runs_split(t[0][:, :255], *t[1:], softening=0.0,
                                 k_tile=k)
    with pytest.raises(ValueError, match="4G"):
        tle.list_eval_runs_split(t[0], t[1], t[2][:4], *t[3:],
                                 softening=0.0, k_tile=k)


# -- the whole split force pass -------------------------------------------


@pytest.fixture
def interpret_split(monkeypatch):
    """Run the JAX package's K4 in interpret mode (the CPU has no
    Mosaic), as tests/test_list_eval.py:197 does."""
    orig = jle.list_eval_runs_split

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(jle, "list_eval_runs_split", interp)


def _spy_split(monkeypatch):
    seen = []
    orig = tle.list_eval_runs_split

    def spy(*a, **kw):
        seen.append(a[0].shape)
        return orig(*a, **kw)

    monkeypatch.setattr(tle, "list_eval_runs_split", spy)
    return seen


@pytest.mark.parametrize("dims,collect", [(2, None), (3, "gather"),
                                          (3, "dense")],
                         ids=["2d", "3d-gather", "3d-dense"])
def test_whole_split_pass_matches_jax(dims, collect, interpret_split,
                                      monkeypatch):
    m, p = _cloud(dims, "uniform", 5)
    kw = dict(g=G, group_size=GS, eval_k_tile=K_TILE, split_eval=True,
              return_diagnostics=True)
    if dims == 3:
        kw["collect"] = collect
        jfn, tfn = jb3.bh3_accelerations_grouped, tb3.bh3_accelerations_grouped
    else:
        jfn, tfn = jb2.bh_accelerations_grouped, tb2.bh_accelerations_grouped
    want, jovf = jfn(jnp.asarray(p), jnp.asarray(m), use_pallas=True,
                     eval_mode="runs", **kw)
    want = np.asarray(want)
    seen = _spy_split(monkeypatch)
    got, tovf = tfn(torch.tensor(p), torch.tensor(m), **kw)
    assert seen == [(N // GS, GS, dims)]
    assert int(np.asarray(jovf).sum()) == int(tovf.sum()) == 0
    assert got.shape == (N, dims) and torch.isfinite(got).all()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, atol=FORCE_TOL * scale)
    # split against the unsplit runs evaluator of the port
    unsplit = tfn(torch.tensor(p), torch.tensor(m),
                  **{**kw, "split_eval": False, "return_diagnostics": False})
    d = float((got - unsplit).abs().max())
    assert 0 < d <= SPLIT_TOL * scale


@pytest.mark.parametrize("dims", [2, 3])
def test_split_needs_quarterable_groups(dims):
    m, p = _cloud(dims, "uniform", 1, n=300)
    fn = tb2.bh_accelerations_grouped if dims == 2 else (
        tb3.bh3_accelerations_grouped)
    with pytest.raises(ValueError, match="divisible by 4"):
        fn(torch.tensor(p), torch.tensor(m), g=G, group_size=150,
           split_eval=True)


@pytest.mark.parametrize("dims,n,want", [
    (3, 1 << 20, True), (3, 786432, True), (3, 786431, False),
    (3, 262144, False), (2, 1 << 20, False)])
def test_split_auto_gate(dims, n, want, monkeypatch):
    """The JAX package's gate: on at direct_cell_max >= 128 and
    N >= 786,432 (3D resolves dcm 128 there; 2D keeps 32 unless asked)."""
    seen = []

    class Stop(Exception):
        pass

    def stop(*a, quarter_bits, **kw):
        seen.append(quarter_bits)
        raise Stop

    walk = "_collect_lists" if dims == 2 else "_collect_lists_3d"
    mod = tb2 if dims == 2 else tb3
    monkeypatch.setattr(mod, walk, stop)
    if dims == 3:
        monkeypatch.setattr(tb3, "_resolve_collect", lambda c, n: "gather")
    # a tiny stand-in for an N-body source set: the gate reads the
    # sources' count, so the sources are n copies of a few bodies
    m, p = _cloud(dims, "uniform", 2, n=2048)
    reps = n // 2048 + 1
    ps = torch.tensor(p).repeat(reps, 1)[:n]
    ms = torch.tensor(m).repeat(reps)[:n]
    if dims == 3:
        tree = tt3.build_octree(torch.tensor(p), torch.tensor(m), max_depth=4)
        srcs = (ps[:, 0], ps[:, 1], ps[:, 2], G * ms)
        call = functools.partial(
            tb3.grouped_eval_3d, torch.tensor(p), tree,
            target_order=torch.arange(2048), target_sorted=torch.tensor(p),
            sorted_srcs=srcs)
    else:
        tree = tt2.build_quadtree(torch.tensor(p), torch.tensor(m),
                                  max_depth=6)
        call = functools.partial(
            tb2.grouped_eval, tree, target_order=torch.arange(2048),
            target_sorted=torch.tensor(p), sorted_x=ps[:, 0],
            sorted_y=ps[:, 1], sorted_gm=G * ms)
    with pytest.raises(Stop):
        call(g=G, group_size=2048)
    assert seen == [want]


# -- the contract loop and the CLI ------------------------------------------


def test_run_contract_3d_dense_split_matches_jax(tmp_path, interpret_split,
                                                 monkeypatch):
    """3 steps from one nbody_tpu.rng state with the dense collector and
    split evaluation forced, against the JAX package's Pallas route
    (K4 in interpret mode)."""
    orig = jb3.bh3_accelerations_grouped
    monkeypatch.setattr(jb3, "bh3_accelerations_grouped",
                        functools.partial(orig, use_pallas=True))
    jcfg = nbody_tpu.SimConfig(n_bodies=N, n_dim=3, n_steps=3,
                               engine="barnes_hut", seed=1, group_size=GS,
                               collect3="dense", split_eval=True,
                               eval_k_tile=K_TILE,
                               output_dir=str(tmp_path / "jax"))
    jsim = JaxSimulation(jcfg)
    m, p, v, _, _ = jax_to_numpy(jsim.state)
    tcfg = nbody_tpu_torch.SimConfig.from_dict(
        {**dataclasses.asdict(jcfg), "output_dir": str(tmp_path / "torch")})
    tsim = Simulation(tcfg, state=from_numpy(m, p, v, device="cpu"),
                      device="cpu")
    seen = _spy_split(monkeypatch)
    jstate, _ = jsim.run_contract()
    tstate, _ = tsim.run_contract()
    assert len(seen) == 3
    assert int(tstate.overflow) == int(jstate.overflow) == 0
    pos_t = tstate.positions.numpy()
    assert pos_t.shape == (N, 3) and np.isfinite(pos_t).all()
    np.testing.assert_allclose(pos_t, np.asarray(jstate.positions), rtol=0,
                               atol=1e-6)


def test_cli_runs_dense_and_split_on_the_cpu():
    """The acceptance command: --dims 3 --collect3 dense --split-eval on
    at N=8,192 runs and writes the reference's timing lines."""
    out = subprocess.run(
        [sys.executable, "-m", "nbody_tpu_torch", "run", "--device", "cpu",
         "--dims", "3", "--collect3", "dense", "--split-eval", "on",
         "--n-bodies", "8192", "--steps", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=600, check=True,
    ).stdout
    assert "GPU total computation took" in out
    assert "GPU parallel computation took" in out


def test_split_modules_import_without_jax():
    code = (
        "import sys, nbody_tpu_torch.ops.list_eval, "
        "nbody_tpu_torch.ops.bh_grouped, nbody_tpu_torch.ops.bh3d, "
        "nbody_tpu_torch.ops.collect_dense3; "
        "assert 'jax' not in sys.modules"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
