"""The port's multi-device steps (nbody_tpu_torch.parallel) on thread
ranks of one CPU process, against nbody_tpu's sharded steps on its
8-device fake CPU mesh and against the port's single-device steps.

Bounds, each with its reason:

* dp_allpairs, ring_allpairs, dp_barnes_hut at D=8 and dp2d_allpairs at
  4x2 against the JAX package's ``make_sharded_step``: 5e-6 x max|p|
  after 3 (dp2d: 2) steps, the bound of tests/test_parallel.py for
  these modes (f32 both sides; K1's twin and the JAX package's dense XLA
  route sum in other orders);
* the grouped and sharded modes, 2D and 3D, at D = 2 and 4 against the
  port's single-device grouped step: tests/test_torch_parallel_grouped.py
  (its own file: at 70-90 s a case they set this file's time);
* one rank's windowed grouped pass against the JAX function with the
  same window, offset and source hint: 1e-5 x max|a| (the runs twin
  against the JAX package's XLA route, tests/test_list_eval.py:131);
* at D=1 every mode gives the bits of the single-device step of its
  engine.  For the sharded modes that step is the single-device grouped
  pass with the whole cloud's window: the window gate keeps close cells
  whose leaf span reaches past the cloud's first or last occupied leaf
  from being direct, so even at D=1 (and in the JAX package alike) a
  sharded step is not the plain grouped step.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbody_tpu
from nbody_tpu.ops import bh3d as jb3
from nbody_tpu.ops import bh_grouped as jbg
from nbody_tpu.ops import tree as jtree
from nbody_tpu.ops import tree3d as jtree3
from nbody_tpu.parallel import make_mesh as jmake_mesh
from nbody_tpu.parallel import make_mesh_2d as jmake_mesh_2d
from nbody_tpu.parallel import make_sharded_step as jmake_step
from nbody_tpu.parallel import shard_state as jshard_state
from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.models.simulation import Simulation
from nbody_tpu_torch.ops import bh3d, bh_grouped
from nbody_tpu_torch.ops.tree import morton_codes, root_bounds
from nbody_tpu_torch.ops.tree3d import morton_codes_3d, root_bounds_3d
from nbody_tpu_torch.parallel import make_sharded_step, shard_state
from nbody_tpu_torch.parallel.mesh import (
    gather_state,
    run_ranks,
    thread_meshes,
    thread_meshes_2d,
)
from nbody_tpu_torch.physics import integrate
from nbody_tpu_torch.state import from_numpy

G = 6.67e-11
N = 512
MODES = ("dp_allpairs", "ring_allpairs", "dp_barnes_hut",
         "dp_barnes_hut_grouped", "dp_barnes_hut_sharded",
         "dp_barnes_hut_grouped3", "dp_barnes_hut_sharded3",
         "dp2d_allpairs")


@pytest.fixture(scope="module")
def cloud():
    """tests/test_parallel.py's cloud."""
    rng = np.random.default_rng(42)
    masses = (10 ** rng.uniform(-1, np.log10(0.5), N)).astype(np.float32)
    positions = rng.uniform(-0.1, 0.1, (N, 2)).astype(np.float32)
    velocities = rng.uniform(-1e-4, 1e-4, (N, 2)).astype(np.float32)
    return masses, positions, velocities


def _grid(side: int, dims: int, seed: int = 3):
    """tests/test_parallel.py's jittered grid (bounded separations) in
    ``dims`` dimensions, Morton-sorted so contiguous slabs are
    Morton-contiguous."""
    rng = np.random.default_rng(seed)
    axes = np.meshgrid(*[np.arange(side)] * dims)
    p = np.stack(axes, -1).reshape(-1, dims).astype(np.float64)
    p = ((p + rng.uniform(0.25, 0.75, p.shape)) / side * 0.2 - 0.1).astype(
        np.float32)
    n = p.shape[0]
    m = (10 ** rng.uniform(-1, np.log10(0.5), n)).astype(np.float32)
    v = rng.uniform(-1e-4, 1e-4, (n, dims)).astype(np.float32)
    pt = torch.from_numpy(p)
    if dims == 2:
        codes = morton_codes(pt, root_bounds(pt), 9)
    else:
        depth = SimConfig(n_bodies=n, n_dim=3).resolved_max_depth
        codes = morton_codes_3d(pt, root_bounds_3d(pt), depth)
    order = torch.argsort(codes, stable=True).numpy()
    return m[order], p[order], v[order]


def _meshes(mode: str, n_dev: int):
    if mode == "dp2d_allpairs":
        return thread_meshes_2d(max(n_dev // 2, 1), 2 if n_dev > 1 else 1,
                                "cpu")
    return thread_meshes(n_dev, "cpu")


def run_threads(mode, cfg, state, n_dev, steps):
    """``steps`` steps of ``mode`` on ``n_dev`` thread ranks from the
    global ``state``; returns (global positions, global overflow count of
    the last step)."""

    def rank(mesh):
        s = shard_state(state, mesh)
        step = make_sharded_step(cfg, mesh, mode)
        for _ in range(steps):
            s = step(s)
        return gather_state(s, mesh).positions, int(s.overflow)

    return run_ranks(rank, _meshes(mode, n_dev))[0]


def single_device(cfg, state, steps):
    sim = Simulation(cfg, state=state)
    for _ in range(steps):
        state = sim.step_fn(state)
    return state.positions


@pytest.mark.parametrize("mode", ["dp_allpairs", "ring_allpairs",
                                  "dp_barnes_hut", "dp2d_allpairs"])
def test_sharded_matches_jax(cloud, mode):
    """Eight ranks (dp2d: 4x2) against the JAX package's sharded step on
    its fake 8-device mesh, from the same bodies."""
    kw = dict(n_bodies=N, engine="allpairs", dt=1.0, group_size=256,
              group_chunk=8)
    steps = 2 if mode == "dp2d_allpairs" else 3
    jstate = nbody_tpu.make_state(*cloud)
    if mode == "dp2d_allpairs":
        jstep = jmake_step(nbody_tpu.SimConfig(**kw), jmake_mesh_2d(4, 2),
                           mode)
    else:
        mesh = jmake_mesh(8)
        jstep = jmake_step(nbody_tpu.SimConfig(**kw), mesh, mode)
        jstate = jshard_state(jstate, mesh)
    for _ in range(steps):
        jstate = jstep(jstate)
    want = np.asarray(jstate.positions)
    got, ovf = run_threads(mode, SimConfig(**kw),
                           from_numpy(*cloud, device="cpu"), 8, steps)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=5e-6 * np.abs(want).max())
    assert ovf == int(np.asarray(jstate.overflow)) == 0


@pytest.fixture(scope="module")
def grids():
    return {2: _grid(48, 2), 3: _grid(12, 3)}


class _Capture:
    """Wraps a grouped pass to keep each call's arguments and result."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []
        self.lock = threading.Lock()

    def __call__(self, *args, **kw):
        out = self.fn(*args, **kw)
        with self.lock:
            self.calls.append((args, kw, out))
        return out


@pytest.mark.parametrize("dims", [2, 3])
def test_windowed_pass_matches_jax(grids, monkeypatch, dims):
    """Rank 1 of four (both halos, a full count match): its windowed
    grouped pass, run again through the JAX function on the same pyramid,
    window, offset, sources and targets."""
    m, p, v = grids[dims]
    n = m.shape[0]
    mod = bh3d if dims == 3 else bh_grouped
    name = "grouped_eval_3d" if dims == 3 else "grouped_eval"
    cap = _Capture(getattr(mod, name))
    monkeypatch.setattr(mod, name, cap)
    cfg = SimConfig(n_bodies=n, n_dim=dims, engine="barnes_hut",
                    group_size=96)
    mode = "dp_barnes_hut_sharded3" if dims == 3 else "dp_barnes_hut_sharded"
    run_threads(mode, cfg, from_numpy(m, p, v, device="cpu"), 4, 1)
    slab = torch.from_numpy(p[n // 4:n // 2])
    (args, kw, (acc, _)), = [
        c for c in cap.calls
        if torch.equal(c[0][0] if dims == 3 else c[1]["target_positions"],
                       slab)]
    tree = args[1] if dims == 3 else args[0]
    c_lo, c_hi = (int(c) for c in kw["window_cells"])
    assert c_lo <= c_hi  # the count match held: a real window
    md = tree.max_depth
    j = dict(window_cells=(jnp.int32(c_lo), jnp.int32(c_hi)),
             range_offset=jnp.int32(int(kw["range_offset"])),
             n_sources_hint=kw["n_sources_hint"], g=G)
    bounds = jnp.asarray(tree.bounds.numpy())
    codes = jnp.asarray(tree.codes.numpy())
    raw = jnp.asarray(tree.raw[md].numpy())
    if dims == 3:
        jt = jtree3.pyramid_from_raw_3d(raw, bounds, codes, md)
        want = jb3.grouped_eval_3d(
            jnp.asarray(slab.numpy()), jt,
            sorted_srcs=tuple(jnp.asarray(a.numpy())
                              for a in kw["sorted_srcs"]),
            group_size=96, **j)
    else:
        jt = jtree.pyramid_from_raw(raw, bounds, codes, md)
        want = jbg.grouped_eval(
            jnp.asarray(slab.numpy()), jt,
            sorted_x=jnp.asarray(kw["sorted_x"].numpy()),
            sorted_y=jnp.asarray(kw["sorted_y"].numpy()),
            sorted_gm=jnp.asarray(kw["sorted_gm"].numpy()),
            target_codes=jnp.asarray(kw["target_codes"].numpy()),
            group_size=96, direct_cell_max=32, **j)
    want = np.asarray(want)
    np.testing.assert_allclose(acc.numpy(), want,
                               atol=1e-5 * np.abs(want).max())


def test_shard_state_requires_divisible(cloud):
    masses, positions, velocities = cloud
    state = from_numpy(masses[:500], positions[:500], velocities[:500],
                       device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        shard_state(state, thread_meshes(8, "cpu")[0])


def test_sharded_overflow_surfaces(cloud):
    """tests/test_parallel.py's overflow case: an under-capped sharded run
    (frontier_cap=128 on the unsorted cloud, whose windows degrade) gives
    a nonzero GLOBAL count in state.overflow; calibrated caps give 0, and
    the all-pairs mode an explicit 0."""
    state = from_numpy(*cloud, device="cpu")
    _, ovf = run_threads("dp_barnes_hut_sharded",
                         SimConfig(n_bodies=N, frontier_cap=128), state, 8, 1)
    assert ovf > 0
    _, ovf = run_threads("dp_barnes_hut_sharded", SimConfig(n_bodies=N),
                         state, 8, 1)
    assert ovf == 0
    _, ovf = run_threads("dp_allpairs", SimConfig(n_bodies=N), state, 8, 1)
    assert ovf == 0


def _windowed_single_device(cfg, state):
    """One step of the single-device grouped pass with the whole cloud's
    window (what a sharded mode computes at D=1)."""
    p, m = state.positions, state.masses
    md = cfg.resolved_max_depth
    if cfg.n_dim == 3:
        tree = bh3d.build_octree(p, m, max_depth=md)
    else:
        tree = bh_grouped.build_quadtree(p, m, max_depth=md)
    order = torch.argsort(tree.codes, stable=True)
    ps = p[order]
    srcs = [ps[:, d].contiguous() for d in range(cfg.n_dim)]
    kw = dict(window_cells=(tree.codes.min(), tree.codes.max()),
              range_offset=torch.zeros((), dtype=torch.int32),
              n_sources_hint=p.shape[0], g=cfg.g, group_size=cfg.group_size,
              return_diagnostics=True)
    if cfg.n_dim == 3:
        acc, ovf = bh3d.grouped_eval_3d(
            p, tree, sorted_srcs=(*srcs, cfg.g * m[order]), **kw)
    else:
        acc, ovf = bh_grouped.grouped_eval(
            tree, target_positions=p, sorted_x=srcs[0], sorted_y=srcs[1],
            sorted_gm=cfg.g * m[order], direct_cell_max=32, **kw)
    return integrate(state, acc, cfg.dt, overflow=ovf.sum())


@pytest.mark.parametrize("mode", MODES)
def test_one_rank_gives_the_single_device_bits(mode):
    dims = 3 if mode.endswith("3") else 2
    m, p, v = _grid(24 if dims == 2 else 10, dims, seed=5)
    n = m.shape[0]
    engine = "allpairs" if "allpairs" in mode else "barnes_hut"
    cfg = SimConfig(n_bodies=n, n_dim=dims, engine=engine, group_size=96,
                    bh_mode="exact" if mode == "dp_barnes_hut" else "grouped")
    state = from_numpy(m, p, v, device="cpu")
    got, _ = run_threads(mode, cfg, state, 1, 2)
    if "sharded" in mode:
        want = _windowed_single_device(cfg, _windowed_single_device(
            cfg, state)).positions
    else:
        want = single_device(cfg, state, 2)
    assert torch.equal(got, want)


def test_end_rank_windows_degrade_as_in_jax(capsys):
    """At D >= 4 the windows of ranks 0 and D-1 wrap around the ring
    ([D-1 | 0 | 1] and [D-2 | D-1 | 0]), so their count match always
    fails and every close cell of their bodies aggregates at max depth,
    in the JAX package alike: the sharded mode's distance from the
    grouped step there is the design's, not the port's.  The port's
    sharded step equals the JAX package's on the same bodies (rounding
    only) and degrades exactly those ranks."""
    from nbody_tpu.ops.bh3d import bh3_accelerations_grouped as jgrouped3
    from nbody_tpu.physics import integrate as jintegrate
    from nbody_tpu_torch.parallel import steps

    m, p, v = _grid(16, 3, seed=3)
    n = m.shape[0]
    jcfg = nbody_tpu.SimConfig(n_bodies=n, n_dim=3, engine="barnes_hut")
    mesh = jmake_mesh(4)
    jstep = jmake_step(jcfg, mesh, "dp_barnes_hut_sharded3")
    js = jshard_state(nbody_tpu.make_state(m, p, v), mesh)
    ref = nbody_tpu.make_state(m, p, v)
    for _ in range(3):
        js = jstep(js)
        ref = jintegrate(ref, jgrouped3(
            ref.positions, ref.masses, g=G,
            max_depth=jcfg.resolved_max_depth), dt=1.0)
    jgot, want = np.asarray(js.positions), np.asarray(ref.positions)

    windows = {}
    orig = steps._source_window

    def spy(ax, *a):
        out = orig(ax, *a)
        windows.setdefault(ax.axis_index(), int(out[1][0]) <= int(out[1][1]))
        return out

    steps._source_window = spy
    try:
        got, _ = run_threads("dp_barnes_hut_sharded3",
                             SimConfig(n_bodies=n, n_dim=3,
                                       engine="barnes_hut"),
                             from_numpy(m, p, v, device="cpu"), 4, 3)
    finally:
        steps._source_window = orig
    got = got.numpy()
    scale = np.abs(want).max()
    slab = n // 4
    by_rank = [np.abs(jgot - want)[r * slab:(r + 1) * slab].max() / scale
               for r in range(4)]
    with capsys.disabled():
        print(f"\nsharded3 D=4 N={n}: JAX vs its grouped step by owner rank "
              f"{['%.2e' % e for e in by_rank]}; port vs JAX "
              f"{np.abs(got - jgot).max() / scale:.2e} x max|p|")
    assert [r for r in range(4) if not windows[r]] == [0, 3]
    np.testing.assert_allclose(got, jgot, atol=1e-6 * scale)
    assert max(by_rank[1:3]) <= 5e-5 < by_rank[0]


def test_ring_bound_holds_for_small_clouds_only(capsys):
    """tests/test_parallel.py's 5e-6 x max|p| after 3 steps holds for its
    512-body cloud; from a few thousand uniform bodies on, close
    encounters amplify the last bits any reorder of the f32 sums moves,
    and the JAX package's own ring at D=4 leaves that bound against its
    own single-device step, as does the port's single-device step
    against itself under another K1 tile width."""
    from nbody_tpu.physics import integrate as jintegrate
    from nbody_tpu.physics import pair_accelerations_dense
    from nbody_tpu_torch.ops.allpairs import allpairs_accelerations_plain

    out = {}
    for n in (512, 4096):
        rng = np.random.default_rng(42)
        m = (10 ** rng.uniform(-1, np.log10(0.5), n)).astype(np.float32)
        p = rng.uniform(-0.1, 0.1, (n, 2)).astype(np.float32)
        v = rng.uniform(-1e-4, 1e-4, (n, 2)).astype(np.float32)
        ref = nbody_tpu.make_state(m, p, v)
        mesh = jmake_mesh(4)
        jstep = jmake_step(nbody_tpu.SimConfig(n_bodies=n), mesh,
                           "ring_allpairs")
        js = jshard_state(nbody_tpu.make_state(m, p, v), mesh)
        tiles = {sb: from_numpy(m, p, v, device="cpu") for sb in (1024, 256)}
        for _ in range(3):
            ref = jintegrate(ref, pair_accelerations_dense(
                ref.positions, ref.masses, g=G), dt=1.0)
            js = jstep(js)
            for sb, s in tiles.items():
                tiles[sb] = integrate(s, allpairs_accelerations_plain(
                    s.positions, s.positions, s.masses, g=G,
                    source_block=sb), 1.0)
        want = np.asarray(ref.positions)
        scale = np.abs(want).max()
        out[n] = (np.abs(np.asarray(js.positions) - want).max() / scale,
                  float((tiles[1024].positions - tiles[256].positions)
                        .abs().max()) / scale)
    with capsys.disabled():
        print("\nring D=4 vs single, JAX; port single-device under another "
              "tile width, x max|p| after 3 steps: "
              + "; ".join(f"N={n}: {a:.2e}, {b:.2e}"
                          for n, (a, b) in out.items()))
    assert out[512][0] <= 5e-6 and out[512][1] <= 5e-6
    assert out[4096][0] > 5e-6
