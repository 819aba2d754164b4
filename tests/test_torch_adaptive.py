"""The adaptive 3D engine (``engine="barnes_hut_adaptive"``) against its
plain reference (``benchmark/reference/adaptive_bh.py``), the reference
against the accepted grouped one at shallow depths, the direct sum, and
the Plummer initial state, on the CPU at small sizes."""

import json
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark.check import force_gap
from benchmark.reference import adaptive_bh, gravity
from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.models.engines import make_accel_fn
from nbody_tpu_torch.models.simulation import Simulation
from nbody_tpu_torch.ops import bh3d, tree3d
from nbody_tpu_torch.rng import plummer, random_state
from nbody_tpu_torch.utils import profiling
from nbody_tpu_torch.utils.profiling import counter

ROOT = Path(__file__).resolve().parents[1]
SOFT = 0.01
THETA = 0.5
DCM = 32
GS = 1024  # groups of 1,024 bodies: 8 sub-boxes each, quarters of 256
CELL = json.loads((ROOT / "benchmark" / "configs"
                   / "plummer_1m.json").read_text())


def _plummer(n, seed, dtype=torch.float64):
    m, p, _ = plummer(torch.Generator().manual_seed(seed), n)
    return p.to(dtype), m.to(dtype)


def _blobs(n, seed, dtype=torch.float64):
    cfg = SimConfig(n_bodies=n, n_dim=3, init_mode="blobs", seed=seed,
                    dtype="float64")
    st = random_state(cfg, device="cpu")
    return st.positions.to(dtype), st.masses.to(dtype)


STATES = {"plummer-16384": lambda: _plummer(16384, 5),
          "plummer-4096": lambda: _plummer(4096, 6),
          "plummer-2048": lambda: _plummer(2048, 7),
          "blobs-8192": lambda: _blobs(8192, 4)}


def _walk(p, m, quarter_bits=True):
    """The engine's lists for every group: (approx x, y, z, m [G, L],
    ranges [G, D, 2], overflow [G], quarters), with room to spare."""
    md = tree3d.default_max_depth3(p.shape[0])
    tree, refine, order = tree3d.build_octree_adaptive(p, m, md, DCM)
    bbox = bh3d.sub_boxes_3d(p[order].reshape(-1, GS, 3), GS // 128)
    caps = bh3d.frontier_schedule_adaptive(1 << 15, md, p.shape[0])
    out = bh3d._collect_lists_3d(
        bbox, tree, theta=THETA, softening=SOFT, frontier_caps=caps,
        list_cap=1 << 14, direct_cap=1 << 13, direct_cell_max=DCM,
        quarter_bits=quarter_bits, refine=refine)
    return out, refine


def _reference(p, m, **kw):
    return adaptive_bh.AdaptiveBH(
        p, m, g=1.0, theta=THETA, group_size=GS, sub_boxes=GS // 128,
        direct_cell_max=DCM, quarter_split=True, softening=SOFT, **kw)


@pytest.fixture(scope="module", params=sorted(STATES))
def walked(request):
    p, m = STATES[request.param]()
    out, refine = _walk(p, m)
    return request.param, p, m, out, refine, _reference(p, m)


def test_lists_equal_the_reference(walked):
    """Every group's approx cells (centre and mass) and direct cells (first
    body, count, quarter bits) are the reference's, and nothing
    overflows; the clustered states build a refinement."""
    name, p, m, out, refine, ref = walked
    (lx, ly, lz, lm), ranges, overflow, quarters = out
    assert not bool(overflow.any())
    assert refine.n_cells > 0 and refine.depth > refine.base
    for grp in range(ref.n_groups):
        (ac, am), (ds, dc, db, _, _) = ref.walk(grp)
        keep = lm[grp] > 0
        got = torch.stack([lx[grp][keep], ly[grp][keep], lz[grp][keep],
                           lm[grp][keep]], 1)
        want = torch.cat([ac, am[:, None]], 1)
        assert got.shape == want.shape, (name, grp)
        got = got[torch.argsort(got[:, 0])]
        want = want[torch.argsort(want[:, 0])]
        torch.testing.assert_close(got, want, rtol=1e-12, atol=0)
        has = ranges[grp, :, 1] > 0
        mine = torch.stack([ranges[grp, has, 0].long(),
                            ranges[grp, has, 1].long(),
                            quarters["bits"][grp, has].long()], 1)
        theirs = torch.stack([ds, dc, db], 1)
        assert torch.equal(mine[torch.argsort(mine[:, 0])],
                           theirs[torch.argsort(theirs[:, 0])]), (name, grp)


@pytest.mark.parametrize("state,split", [("plummer-2048", True),
                                         ("blobs-8192", False)])
def test_forces_match_the_reference_f64(state, split):
    """A float64 pass of the engine (quarter split as the cell runs it,
    and without) gives the reference's accelerations to 1e-10."""
    p, m = STATES[state]()
    acc = bh3d.bh3_accelerations_adaptive(
        p, m, g=1.0, theta=THETA, softening=SOFT, direct_cell_max=DCM,
        group_size=GS, split_eval=split)
    ref = adaptive_bh.AdaptiveBH(
        p, m, g=1.0, theta=THETA, group_size=GS, sub_boxes=GS // 128,
        direct_cell_max=DCM, quarter_split=split, softening=SOFT)
    groups = range(ref.n_groups) if split else (0, 3, ref.n_groups - 1)
    for grp in groups:
        idx, want = ref.accelerations(grp)
        want = want[torch.float64]
        err = (acc[idx] - want).norm(dim=1) / want.norm(dim=1)
        assert float(err.max()) < 1e-10, (state, grp)


@pytest.mark.parametrize("depth", [4, 6])
def test_reference_equals_grouped_bh_at_shallow_depth(depth):
    """``adaptive_bh.py`` at max_depth D is ``gravity.GroupedBH`` at D:
    the new reference is the accepted one where both apply."""
    for p, m in (_plummer(4096, 8), _blobs(4096, 9)):
        kw = dict(g=1.0, theta=THETA, group_size=GS, sub_boxes=8,
                  direct_cell_max=DCM, quarter_split=True, softening=SOFT,
                  max_depth=depth)
        new = adaptive_bh.AdaptiveBH(p, m, **kw)
        old = gravity.GroupedBH(p, m, **kw)
        for grp in (0, 2):
            i_new, a_new = new.accelerations(grp)
            i_old, a_old = old.accelerations(grp)
            assert torch.equal(i_new, i_old)
            torch.testing.assert_close(a_new[torch.float64],
                                       a_old[torch.float64], rtol=1e-12,
                                       atol=0)


def _config(n, engine, **kw):
    return SimConfig(n_bodies=n, n_dim=3, engine=engine, g=1.0,
                     theta=THETA, softening=SOFT, dt=1 / 64,
                     direct_cell_max=DCM, **kw)


@pytest.mark.parametrize("seed", [12, 13])
def test_force_gap_under_the_cells_limit_and_the_fault_above(seed):
    """Against the direct sum, the engine reads under the cell's
    ``force_gap`` limit; with the refinement left out (``barnes_hut`` on
    the same state: crowded leaves aggregated at depth 7) it reads far
    above."""
    p, m = _plummer(2048, seed, torch.float32)
    limit = float(CELL["check"]["force_gap_limit"])
    ref = gravity.pair_sum(p, p, m.double(), SOFT)
    good = make_accel_fn(_config(2048, "barnes_hut_adaptive"))(p, m)
    fault = make_accel_fn(_config(2048, "barnes_hut"))(p, m)
    assert force_gap(good.double(), ref) < limit
    assert force_gap(fault.double(), ref) > limit


def _lattice(k=16, seed=0):
    """A uniform state with one body a depth-5 leaf: a k^3 lattice, each
    point moved by up to a fifth of the spacing."""
    g = torch.Generator().manual_seed(seed)
    ax = torch.arange(k, dtype=torch.float32)
    grid = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1)
    p = (grid.reshape(-1, 3) + 0.2 * (2 * torch.rand(
        (k ** 3, 3), generator=g) - 1)) * (0.2 / k) - 0.1
    m = 0.1 + 0.4 * torch.rand(k ** 3, generator=g)
    return p, m


def test_uniform_builds_no_refinement_and_is_barnes_hut():
    """Where no leaf of the pyramid holds two bodies the refinement is
    empty, no group walks it, and the pass is ``barnes_hut``'s bit for
    bit; a uniform random state builds no refinement either."""
    p, m = _lattice()
    assert tree3d.default_max_depth3(p.shape[0]) == 5
    names = ("ops.tree3d.REFINED_CELLS", "ops.bh3d.REFINE_GROUPS")
    cells, groups = map(counter, names)
    got = make_accel_fn(_config(4096, "barnes_hut_adaptive"))(p, m)
    want = make_accel_fn(_config(4096, "barnes_hut"))(p, m)
    assert tuple(map(counter, names)) == (cells, groups)
    assert torch.equal(got, want)
    st = random_state(_config(8192, "barnes_hut_adaptive", seed=2),
                      device="cpu")
    md = tree3d.default_max_depth3(8192)
    _, refine, _ = tree3d.build_octree_adaptive(st.positions, st.masses, md,
                                                DCM)
    assert refine.n_cells == 0 and refine.depth == md


def test_refinement_cells_are_contiguous_body_runs():
    """Each refined cell is the run of sorted bodies that share its
    prefix, its row their sums, and each crowded cell's children tile
    its run."""
    p, m = _plummer(8192, 14)
    md = tree3d.default_max_depth3(8192)
    tree, refine, order = tree3d.build_octree_adaptive(p, m, md, DCM)
    wide = tree3d.morton_codes_3d(p, tree.bounds, tree3d.MAX_DEPTH3_WIDE,
                                  torch.int64)
    sc = wide[order]
    assert torch.equal(tree.codes, (wide >> 3 * (21 - md)).int())
    for i, (raw, start) in enumerate(zip(refine.raw, refine.start)):
        level = md + 1 + i
        shift = 3 * (21 - level)
        cnt = raw[:, tree3d.R3_CNT].long()
        first = start.long()
        pre = sc[first] >> shift
        assert torch.equal(sc[first + cnt - 1] >> shift, pre)
        before = first > 0
        assert bool((sc[first[before] - 1] >> shift != pre[before]).all())
        assert bool((cnt >= 1).all())
        # each parent crowded, every body of the level's runs counted
        kids = refine.child[i]
        parent_cnt = (tree.leaf_counts().long() if i == 0 else
                      refine.raw[i - 1][:, tree3d.R3_CNT].long())
        assert bool((kids[:, 1] > 0).eq(parent_cnt > DCM).all())
        mass = torch.zeros(raw.shape[0], dtype=m.dtype).index_add_(
            0, torch.repeat_interleave(torch.arange(raw.shape[0]), cnt),
            m[order][torch.cat([torch.arange(a, a + c) for a, c in zip(
                first.tolist(), cnt.tolist())])])
        torch.testing.assert_close(raw[:, tree3d.R3_M], mass, rtol=1e-12,
                                   atol=0)


def test_counters_and_the_refine_span():
    """A traced step: ``nbody.refine`` sits inside ``nbody.tree``; the
    counted ``nbody.run`` keeps the refinement's cells and groups and its
    two host reads (the level sizes, the groups that enter)."""
    cfg = _config(4096, "barnes_hut_adaptive", n_steps=1,
                  init_mode="plummer", seed=3)
    sim = Simulation(cfg, device="cpu")
    profiling.clear()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        sim.run_contract()
    recs = profiling.spans()
    profiling.clear()
    by_id = {r.id: r for r in recs}
    refine = [r for r in recs if r.name == "nbody.refine"]
    assert len(refine) == 1
    assert by_id[refine[0].parent].name == "nbody.tree"
    run = [r for r in recs if r.name == "nbody.run"][0]
    assert run.counters["ops.tree3d.REFINED_CELLS"] > 0
    assert 0 < run.counters["ops.bh3d.REFINE_GROUPS"] <= 4
    # the refinement's two reads and the loop's overflow count
    assert run.counters["ops._graph.HOST_READS"] == 3


def test_retry_at_four_times_the_caps():
    """An overflowed step is retried with every cap at 4x, through the
    same adaptive walk, and lands where a pass at those caps lands."""
    base = _config(2048, "barnes_hut_adaptive", n_steps=1,
                   init_mode="plummer", seed=4, direct_cap=64)
    sim = Simulation(base, device="cpu")
    start = sim.state
    sim.run_contract()
    assert sim.last_retried_steps == 1 and sim.last_overflowed_steps == 0
    from nbody_tpu_torch.models.engines import resolved_caps
    caps = {k: 4 * v for k, v in resolved_caps(base).items()}
    acc = make_accel_fn(base.replace(**caps))(start.positions, start.masses)
    v = start.velocities + acc * base.dt
    assert torch.equal(sim.state.velocities, v)


@pytest.mark.parametrize("argv,case", [
    (["--dims", "2"], "3D only"),
    (["--dims", "3", "--fused"], "--fused"),
    (["--dims", "3", "--devices", "2"], "--devices > 1")])
def test_unsupported_cases_stop_with_their_errors(argv, case):
    out = subprocess.run(
        [sys.executable, "-m", "nbody_tpu_torch", "run", "--device", "cpu",
         "--engine", "barnes_hut_adaptive", "--n-bodies", "256",
         "--steps", "1", *argv], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 2
    assert case in out.stderr and "barnes_hut_adaptive" in out.stderr


def test_unsupported_cases_raise_in_the_program():
    with pytest.raises(ValueError, match="3D only"):
        make_accel_fn(SimConfig(n_bodies=64, engine="barnes_hut_adaptive"))
    sim = Simulation(_config(512, "barnes_hut_adaptive", n_steps=1,
                             init_mode="plummer"), device="cpu")
    with pytest.raises(ValueError, match="--fused"):
        sim.run_scan(1)


def test_plummer_state_half_mass_radius_and_virial_ratio():
    """At N = 4,096 the half-mass radius is 0.769 (Henon units) and
    2T/|W| is 1, each within a few times its sampling error; equal masses
    of 1/N, the centre of mass at rest at the origin."""
    n = 4096
    cfg = SimConfig(n_bodies=n, n_dim=3, init_mode="plummer", seed=11,
                    dtype="float64")
    st = random_state(cfg, device="cpu")
    p, v, m = st.positions, st.velocities, st.masses
    assert torch.equal(m, torch.full((n,), 1.0 / n, dtype=torch.float64))
    assert float(p.mean(0).abs().max()) < 1e-12
    assert float(v.mean(0).abs().max()) < 1e-12
    r_half = float(p.norm(dim=1).median())
    # the median of N draws: sd ~ 1.25 sqrt(pi / 2N) r_half-ish, ~2%
    assert abs(r_half - 0.769) < 0.04
    d = (p[:, None] - p[None]).norm(dim=-1)
    iu = torch.triu_indices(n, n, 1)
    w = -float((m[iu[0]] * m[iu[1]] / d[iu[0], iu[1]]).sum())
    t = 0.5 * float((m * (v * v).sum(1)).sum())
    assert abs(2 * t / abs(w) - 1) < 0.06
    assert abs(t + w + 0.25) < 0.02  # E = -1/4
    with pytest.raises(ValueError, match="3D"):
        random_state(cfg.replace(n_dim=2), device="cpu")


def test_plummer_draws_depend_on_the_seed_alone():
    a = plummer(torch.Generator().manual_seed(5), 1000)
    b = plummer(torch.Generator().manual_seed(5), 1000)
    c = plummer(torch.Generator().manual_seed(6), 1000)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[1], c[1])
    r = a[1].norm(dim=1) / (3 * math.pi / 16)
    # radii stop at the mass cut-off (the centre-of-mass shift aside)
    assert float(r.max()) < (0.999 ** (-2 / 3) - 1) ** -0.5 + 1


def test_demand_script_measures_the_adaptive_walk(capsys):
    """``scripts/demand.py init=plummer,engine=barnes_hut_adaptive`` walks
    the refinement with room to spare and reports what the adaptive caps
    bound."""
    from nbody_tpu_torch.scripts import demand

    res = demand.run(4096, 3, init="plummer", engine="barnes_hut_adaptive",
                     seed=2, device="cpu")
    assert not res["truncated"] and res["cells"]
    assert 0 < res["bodies"] <= 4096 and res["runs"] > 0
    assert len(res["frontier"]) == tree3d.default_max_depth3(4096) + len(
        res["cells"])
    assert "barnes_hut_adaptive" in capsys.readouterr().out
