"""The port's 3D path (nbody_tpu_torch.ops.tree3d, ops.bh3d, the 3D
kernels' twins, the 3D engines, contract loop and CLI) against nbody_tpu
on the same numpy bodies (CPU).

Bounds, each with its reason:

* integer fields (Morton codes, counts, OCC bits, the sort order, direct
  ranges, overflow flags) and the caps and schedules: exactly equal;
* pyramid mass and COM fields and approx-list values: rtol 1e-6 (f32
  sums of the same terms); singleton COMs bit-equal to the body;
* the K2/K3 twins against the Pallas kernel in interpret mode and the
  whole force pass against the JAX package's XLA route: 1e-5 of the
  largest |a| (the bound of tests/test_list_eval.py:131: f32 both sides,
  sums taken in another order);
* the K1 twin in 3D: rtol 5e-4, atol 1e-11 (tests/test_allpairs.py:46);
* the 3-step contract loop: 1e-6 absolute on positions in the 0.2-wide
  box, as the 2D loop test (tests/test_torch_simulation.py).
"""

import dataclasses
import functools
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbody_tpu
import nbody_tpu_torch
from nbody_tpu import physics as jphys
from nbody_tpu.models.simulation import Simulation as JaxSimulation
from nbody_tpu.ops import allpairs as jap
from nbody_tpu.ops import bh3d as jb
from nbody_tpu.ops import list_eval as jle
from nbody_tpu.ops import tree3d as jt
from nbody_tpu.state import to_numpy as jax_to_numpy
from nbody_tpu.utils import textio as jtext
from nbody_tpu_torch import physics as tphys
from nbody_tpu_torch import rng as trng
from nbody_tpu_torch.models.engines import make_accel_fn, resolved_caps
from nbody_tpu_torch.models.simulation import Simulation
from nbody_tpu_torch.ops import allpairs as tap
from nbody_tpu_torch.ops import bh3d as tb
from nbody_tpu_torch.ops import bh_grouped as tbg
from nbody_tpu_torch.ops import list_eval as tle
from nbody_tpu_torch.ops import tree3d as tt
from nbody_tpu_torch.state import from_numpy
from nbody_tpu_torch.utils import textio as ttext

G = 6.67e-11
N, GS = 2048, 512
FORCE_TOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMING_RE = (
    re.compile(r"GPU total computation took\s+(\d+)\s+milliseconds"),
    re.compile(r"GPU parallel computation took\s+(\d+)\s+microseconds"),
)


def _cloud(mode, seed, n=N):
    """tests/test_3d.py's cloud: uniform in [-0.1, 0.1]^3, log-uniform
    masses; or two tight blobs (deep cells, many multi-body leaves)."""
    rng = np.random.default_rng(seed)
    m = (10 ** rng.uniform(-1, np.log10(0.5), n)).astype(np.float32)
    if mode == "uniform":
        p = rng.uniform(-0.1, 0.1, (n, 3))
    else:
        c = rng.uniform(-0.05, 0.05, (2, 3))
        p = c[np.arange(n) % 2] + 0.004 * rng.normal(size=(n, 3))
    return m, p.astype(np.float32)


# -- octree -------------------------------------------------------------


@pytest.fixture(scope="module", params=[
    ("uniform", 5), ("uniform", None), ("blobs", 5), ("blobs", None)],
    ids=["uniform-md5", "uniform-default", "blobs-md5", "blobs-default"])
def octrees(request):
    mode, md = request.param
    m, p = _cloud(mode, 0)
    md = md or jt.default_max_depth3(N)
    jtree = jt.build_octree(jnp.asarray(p), jnp.asarray(m), max_depth=md)
    ttree = tt.build_octree(torch.tensor(p), torch.tensor(m), max_depth=md)
    return m, p, jtree, ttree


def test_octree_codes_bounds_and_sort_order_exact(octrees):
    _, _, jtree, ttree = octrees
    np.testing.assert_array_equal(np.asarray(jtree.bounds),
                                  ttree.bounds.numpy())
    np.testing.assert_array_equal(np.asarray(jtree.codes),
                                  ttree.codes.numpy())
    np.testing.assert_array_equal(
        np.asarray(jnp.argsort(jtree.codes)),
        torch.argsort(ttree.codes, stable=True).numpy())


def test_octree_counts_and_occupancy_exact(octrees):
    _, _, jtree, ttree = octrees
    assert ttree.max_depth == jtree.max_depth
    for jr, tr in zip(jtree.raw, ttree.raw):
        for col in (tt.R3_CNT, tt.R3_OCC):
            np.testing.assert_array_equal(np.asarray(jr)[:, col],
                                          tr[:, col].numpy())


def test_octree_mass_and_com(octrees):
    _, _, jtree, ttree = octrees
    for jr, tr in zip(jtree.raw, ttree.raw):
        jr, tr = np.asarray(jr), tr.numpy()
        np.testing.assert_allclose(tr[:, :tt.R3_CNT], jr[:, :jt.R3_CNT],
                                   rtol=1e-6, atol=1e-12)
        m = np.where(jr[:, jt.R3_M] > 0, jr[:, jt.R3_M], 1.0)
        for w in (tt.R3_MX, tt.R3_MY, tt.R3_MZ):
            np.testing.assert_allclose(tr[:, w] / m, jr[:, w] / m,
                                       rtol=1e-6, atol=1e-12)


def test_octree_singleton_com_bit_equal_to_body(octrees):
    _, p, _, ttree = octrees
    md = ttree.max_depth
    codes = ttree.codes.numpy()
    for lvl in range(md + 1):
        raw = ttree.raw[lvl].numpy()
        cell = codes >> (3 * (md - lvl))
        one = raw[cell, tt.R3_CNT] == 1
        if lvl == md:
            assert one.any()
        np.testing.assert_array_equal(
            raw[cell[one]][:, tt.R3_SX:tt.R3_SZ + 1], p[one])


def test_octree_cell_size_and_degenerate_bounds():
    p = np.full((5, 3), 0.25, np.float32)
    np.testing.assert_array_equal(
        tt.root_bounds_3d(torch.tensor(p)).numpy(),
        np.asarray(jt.root_bounds_3d(jnp.asarray(p))))
    b = np.array([-1.0, 3.0, -2.0, 0.0, 0.5, 7.0], np.float32)
    for lvl in (0, 3, 7):
        assert float(tt.level_cell_size_3d(torch.tensor(b), lvl)) == float(
            jt.level_cell_size_3d(jnp.asarray(b), lvl))


# -- schedules and caps -------------------------------------------------


@pytest.mark.parametrize("n", [2048, 65536, 131072, 262144, 1 << 20])
def test_caps_and_schedules_match_jax(n):
    assert tb.frontier_peak_3d(n) == jb.frontier_peak_3d(n)
    assert tb.cap_defaults_3d(n) == jb.cap_defaults_3d(n)
    assert tb.run_cap_default_3d(n) == jb.run_cap_default_3d(n)
    assert tb.direct_cell_max_default(n) == jb.direct_cell_max_default(n)
    assert tb.default_group_size3(n) == jb.default_group_size3(n)
    assert tt.default_max_depth3(n) == jt.default_max_depth3(n)
    peak = jb.frontier_peak_3d(n)
    for md in (5, jt.default_max_depth3(n)):
        assert tb.frontier_schedule_3d(peak, md, n) == (
            jb.frontier_schedule_3d(peak, md, n))
    jcfg = nbody_tpu.SimConfig(n_bodies=n, n_dim=3, engine="barnes_hut")
    tcfg = nbody_tpu_torch.SimConfig.from_dict(dataclasses.asdict(jcfg))
    assert tcfg.resolved_max_depth == jcfg.resolved_max_depth
    from nbody_tpu.models.engines import resolved_caps as jax_caps
    assert resolved_caps(tcfg) == jax_caps(jcfg)


def test_defaults_at_131072():
    """The defaults the N=131,072 main path resolves to."""
    n = 131072
    c = tb.cap_defaults_3d(n)
    assert tt.default_max_depth3(n) == 7
    assert tb.default_group_size3(n) == 2048
    assert tb.direct_cell_max_default(n) == 32
    assert (c["frontier_cap"], c["list_cap"], c["direct_cap"],
            c["direct_body_cap"], c["run_cap"]) == (
        16384, 20480, 12288, 196608, 384)
    assert tb._resolve_collect(None, n) == "gather"
    assert tb._resolve_collect(None, 262144) == "dense"


# -- the gather walk ----------------------------------------------------


def _collect_both(m, p):
    md = jt.default_max_depth3(N)
    jtree = jt.build_octree(jnp.asarray(p), jnp.asarray(m), max_depth=md)
    ttree = tt.build_octree(torch.tensor(p), torch.tensor(m), max_depth=md)
    ps = p[np.argsort(np.asarray(jtree.codes), kind="stable")]
    sub = ps.reshape(N // GS, 4, GS // 4, 3)
    bbox = tuple(f(sub[..., a], axis=2) for a in range(3)
                 for f in (np.min, np.max))
    caps = jb.cap_defaults_3d(N)
    kw = dict(theta=0.5, softening=1e-15,
              frontier_caps=jb.frontier_schedule_3d(
                  caps["frontier_cap"], md, N),
              list_cap=caps["list_cap"], direct_cap=caps["direct_cap"],
              direct_cell_max=32)
    jres = jax.jit(functools.partial(jb._collect_lists_3d, **kw))(
        tuple(jnp.asarray(b) for b in bbox), jtree)
    tres = tb._collect_lists_3d(tuple(torch.tensor(b) for b in bbox), ttree,
                                **kw)
    return jres, tres


@pytest.fixture(scope="module", params=[("uniform", 3), ("blobs", 4)],
                ids=["uniform", "blobs"])
def lists3(request):
    return _collect_both(*_cloud(*request.param))


def test_gather_walk_direct_ranges_exact(lists3):
    (_, jr, _), (_, tr, _) = lists3
    jr = np.asarray(jr)
    assert (jr[:, :, 1] > 0).any()
    np.testing.assert_array_equal(jr, tr.numpy())


def test_gather_walk_approx_lists_equal(lists3):
    (jl, _, _), (tl, _, _) = lists3
    jl = [np.asarray(a) for a in jl]
    tl = [a.numpy() for a in tl]
    for g in range(jl[3].shape[0]):
        jv, tv = jl[3][g] > 0, tl[3][g] > 0
        assert jv.sum() == tv.sum() > 0
        for ja, ta in zip(jl, tl):
            np.testing.assert_allclose(ta[g][tv], ja[g][jv], rtol=1e-6,
                                       atol=1e-12)


def test_gather_walk_overflow_flags_equal(lists3):
    (_, _, jo), (_, _, to) = lists3
    np.testing.assert_array_equal(np.asarray(jo), to.numpy())


# -- K2 (3D) and K3 twins against the Pallas kernel -----------------------


def _runs_table(k_tile, seg_pack, seed):
    """One small 3D runs table: every source lane a real body, direct
    entries whose windows leave lanes outside [lo, hi), padded entries
    (lo == hi == 0), and a target meeting itself in a direct window."""
    rng = np.random.default_rng(seed)
    g, s, a_w, ns = 2, 256, 512, 2048
    sw = k_tile // seg_pack
    targets = rng.uniform(-0.1, 0.1, (g, s, 3)).astype(np.float32)
    approx = np.zeros((g, 8, a_w), np.float32)
    approx[0, :3, :300] = rng.uniform(-0.1, 0.1, (3, 300))
    approx[0, 3, :300] = G * rng.uniform(0.1, 0.5, 300)
    srct = np.zeros((8, ns + k_tile), np.float32)
    srct[:3, :ns] = rng.uniform(-0.1, 0.1, (3, ns))
    srct[3, :ns] = G * rng.uniform(0.1, 0.5, ns)
    srct[:3, 300] = targets[1, 7]  # excluded by d2 > 0
    # entries: (128-aligned start, lo, hi) within a window of sw lanes
    ents = [[(0, 5, sw - 3), (256, 0, sw), (1024, 17, 40), (128, 2, 2),
             (1792, 1, sw)],
            [(256, 30, sw), (384, 0, 90)]]
    t_cap = 6  # not a multiple of P: a packed step may run past it
    tiles = np.zeros((g, 3, t_cap), np.int32)
    for gi, e in enumerate(ents):
        tiles[gi, :, :len(e)] = np.array(e).T
    lens = np.array([[300, 0],
                     [-(-len(ents[0]) // seg_pack),
                      -(-len(ents[1]) // seg_pack)]], np.int32)
    return targets, approx, srct, tiles, lens


@pytest.mark.parametrize("k_tile,seg_pack", [(512, 4), (256, 1)],
                         ids=["K3-P4", "K2-3d"])
def test_runs_twin_3d_matches_jax_kernel(k_tile, seg_pack):
    args = _runs_table(k_tile, seg_pack, seed=seg_pack)
    want = np.asarray(jle.list_eval_runs(
        *(jnp.asarray(a) for a in args), softening=1e-15, k_tile=k_tile,
        seg_pack=seg_pack, interpret=True))
    got = tle.list_eval_runs(
        *(torch.tensor(a) for a in args), softening=1e-15, k_tile=k_tile,
        seg_pack=seg_pack).numpy()
    assert got.shape == want.shape == (2, 256, 3)
    assert np.isfinite(got).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, atol=FORCE_TOL * np.abs(want).max())


def test_seg_pack_needs_aligned_segments():
    args = [torch.tensor(a) for a in _runs_table(512, 4, seed=0)]
    with pytest.raises(ValueError, match="K3"):
        tle.list_eval_runs(*args, softening=1e-15, k_tile=256, seg_pack=4)


# -- the whole 3D force pass --------------------------------------------


@pytest.fixture(scope="module", params=[("uniform", 3), ("blobs", 4)],
                ids=["uniform", "blobs"])
def force_ref(request):
    m, p = _cloud(*request.param)
    want, jovf = jb.bh3_accelerations_grouped(
        jnp.asarray(p), jnp.asarray(m), g=G, group_size=GS,
        use_pallas=False, return_diagnostics=True)
    assert int(np.asarray(jovf).sum()) == 0
    return m, p, np.asarray(want)


@pytest.mark.parametrize("gate", [-1.0, float("inf")],
                         ids=["packed", "plain"])
def test_whole_3d_force_pass_matches_jax(force_ref, gate, monkeypatch):
    """seg_pack=4 at k_tile 512 with the run-length gate forced to the
    packed branch (as tests/test_list_eval.py:161 forces it) or to the
    plain one."""
    m, p, want = force_ref
    monkeypatch.setattr(tbg, "SEG_PACK_MIN_RUN_LANES", gate)
    seen = []
    orig = tle.list_eval_runs

    def spy(*a, seg_pack=1, **kw):
        seen.append(seg_pack)
        return orig(*a, seg_pack=seg_pack, **kw)

    monkeypatch.setattr(tle, "list_eval_runs", spy)
    got, tovf = tb.bh3_accelerations_grouped(
        torch.tensor(p), torch.tensor(m), g=G, group_size=GS, seg_pack=4,
        eval_k_tile=512, return_diagnostics=True)
    assert seen == [4 if gate < 0 else 1]
    assert int(tovf.sum()) == 0
    assert got.shape == (N, 3) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want,
                               atol=FORCE_TOL * np.abs(want).max())


def test_exact_bh_mode_is_2d_only():
    cfg = nbody_tpu_torch.SimConfig(n_dim=3, engine="barnes_hut",
                                    bh_mode="exact")
    with pytest.raises(ValueError, match="2D-only"):
        make_accel_fn(cfg)


# -- K1 in 3D -----------------------------------------------------------


@pytest.mark.parametrize("n", [700, 1024])
def test_allpairs_twin_3d_matches_jax_kernel(n):
    m, p = _cloud("uniform", n, n=n)
    want = np.asarray(jap.allpairs_accelerations(
        jnp.asarray(p), jnp.asarray(m), g=G, target_block=256,
        source_block=512, interpret=True))
    got = tap.allpairs_accelerations(torch.tensor(p), torch.tensor(m), g=G,
                                     source_block=512).numpy()
    assert got.shape == (n, 3)
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=1e-11)


def test_allpairs_twin_3d_matches_f64():
    """tests/test_3d.py:97-106: per-body relative error against the dense
    f64 sum under 1e-4."""
    rng = np.random.default_rng(1234)
    pos64 = rng.uniform(-0.1, 0.1, (N, 3))
    m64 = 10 ** rng.uniform(-1, np.log10(0.5), N)
    a = tap.allpairs_accelerations(
        torch.tensor(pos64, dtype=torch.float32),
        torch.tensor(m64, dtype=torch.float32), g=G).numpy()
    d = pos64[None, :, :] - pos64[:, None, :]
    r2 = (d ** 2).sum(-1)
    np.fill_diagonal(r2, 1.0)
    inv = G * m64[None, :] / r2 ** 1.5
    np.fill_diagonal(inv, 0.0)
    dense = (d * inv[:, :, None]).sum(1)
    rel = np.linalg.norm(a - dense, axis=1) / (
        np.linalg.norm(dense, axis=1) + 1e-30)
    assert rel.max() < 1e-4


# -- core modules in 3D -------------------------------------------------


@pytest.mark.parametrize("mode", ["uniform", "blobs"])
def test_random_state_3d(mode):
    cfg = nbody_tpu_torch.SimConfig(n_bodies=5000, n_dim=3, init_mode=mode,
                                    seed=2)
    s = trng.random_state(cfg, device="cpu")
    r = cfg.init
    assert s.positions.shape == s.velocities.shape == (5000, 3)
    p, v = s.positions.numpy(), s.velocities.numpy()
    assert p.min() >= r.lower_p and p.max() <= r.higher_p
    assert v.min() >= r.lower_v and v.max() <= r.higher_v
    if mode == "blobs":  # alternate bodies share a centre in all 3 axes
        assert np.abs(p[0::2] - p[0::2].mean(0)).mean(0).max() < 0.01
    # the state carries across to the JAX package and back bit for bit
    m2, p2, v2, _, _ = jax_to_numpy(nbody_tpu.state.make_state(
        *[a.numpy() for a in (s.masses, s.positions, s.velocities)]))
    t2 = from_numpy(m2, p2, v2, device="cpu")
    assert torch.equal(t2.positions, s.positions)


def test_pair_accelerations_dense_3d_matches_jax():
    m, p = _cloud("uniform", 9, n=300)
    p[7] = p[3]  # a coincident pair: force defined as 0
    want = np.asarray(jphys.pair_accelerations_dense(
        jnp.asarray(p), jnp.asarray(m), G))
    got = tphys.pair_accelerations_dense(
        torch.tensor(p), torch.tensor(m), G).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=1e-11)


def test_textio_3d_bytes_identical(tmp_path):
    m, p = _cloud("uniform", 6, n=40)
    v = (p * 1e-3).astype(np.float32)
    for mod, sub in ((jtext, "jax"), (ttext, "torch")):
        d = tmp_path / sub
        os.makedirs(d)
        mod.save_init_triplet(str(d), m, p, v)
        w = mod.PositionsWriter(str(d / "positions.txt"))
        w.append(0.0, p)
        w.append(1.0, p + v)
        w.flush()
    for name in ("positions_init.txt", "positions.txt"):
        a = (tmp_path / "jax" / name).read_bytes()
        assert a == (tmp_path / "torch" / name).read_bytes() and a
    first = (tmp_path / "torch" / "positions.txt").read_text().splitlines()[0]
    assert len(first.split()) == 5
    path = str(tmp_path / "torch" / "positions_init.txt")
    np.testing.assert_array_equal(ttext.load_vectors(path, 40, n_dim=3),
                                  jtext.load_vectors(path, 40, n_dim=3))


# -- the contract loop and the CLI --------------------------------------


@pytest.mark.parametrize("engine,n,extra", [
    ("barnes_hut", 2048, dict(group_size=512)), ("allpairs", 1024, {})],
    ids=["barnes_hut", "allpairs"])
def test_run_contract_3d_matches_jax(tmp_path, engine, n, extra):
    """3 steps from one nbody_tpu.rng state through both packages: final
    positions within 1e-6 absolute, step-0 block of the five-column
    positions.txt byte-equal."""
    jcfg = nbody_tpu.SimConfig(n_bodies=n, n_dim=3, n_steps=3,
                               engine=engine, seed=1, save_positions=True,
                               output_dir=str(tmp_path / "jax"), **extra)
    jsim = JaxSimulation(jcfg)
    m, p, v, _, _ = jax_to_numpy(jsim.state)
    tcfg = nbody_tpu_torch.SimConfig.from_dict(
        {**dataclasses.asdict(jcfg), "output_dir": str(tmp_path / "torch")})
    tsim = Simulation(tcfg, state=from_numpy(m, p, v, device="cpu"),
                      device="cpu")
    jstate, _ = jsim.run_contract()
    tstate, timing = tsim.run_contract()

    assert int(tstate.overflow) == int(jstate.overflow) == 0
    assert int(tstate.step) == 3
    pos_t = tstate.positions.numpy()
    assert pos_t.shape == (n, 3) and np.isfinite(pos_t).all()
    np.testing.assert_allclose(pos_t, np.asarray(jstate.positions), rtol=0,
                               atol=1e-6)
    jl = (tmp_path / "jax" / "positions.txt").read_text().splitlines()
    tl = (tmp_path / "torch" / "positions.txt").read_text().splitlines()
    assert len(jl) == len(tl) == 4 * n
    assert tl[:n] == jl[:n] and len(tl[0].split()) == 5


def test_cli_run_3d_prints_timing_lines():
    out = subprocess.run(
        [sys.executable, "-m", "nbody_tpu_torch", "run", "--device", "cpu",
         "--dims", "3", "--engine", "barnes_hut", "--n-bodies", "2048",
         "--steps", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=300, check=True,
    ).stdout
    for r in TIMING_RE:
        assert r.search(out), out


def test_3d_modules_import_without_jax():
    code = (
        "import sys, nbody_tpu_torch.ops.bh3d, nbody_tpu_torch.ops.tree3d, "
        "nbody_tpu_torch.cli; assert 'jax' not in sys.modules"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
