"""The port's padded two-section list evaluators (K6 ``list_eval_pallas``,
K7 ``list_eval_dynamic``: their plain twins on the CPU) and the grouped
engines' grid / dynamic / compensated routes, against nbody_tpu.

Bounds, each with its reason:

* superblock tables: exactly equal (integer work on the same ranges);
* twin against the JAX kernel in interpret mode: rtol 2e-4, atol 1e-8,
  the bound the JAX package holds the kernels to against a dense
  evaluation (tests/test_list_eval.py:75); both sides are f32 and differ
  in summation order;
* the whole force pass against the JAX package's XLA route on the same
  lists: 1e-5 of max|a|, the bound it holds its kernel routes to
  (tests/test_list_eval.py:131);
* Kahan: the compensated twin's error against a float64 evaluation of
  the same list is no larger than the plain twin's.
"""

import functools
import math
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ops import bh3d as jb3
from nbody_tpu.ops import bh_grouped as jb2
from nbody_tpu.ops import list_eval as jle
from nbody_tpu_torch.ops import bh3d as tb3
from nbody_tpu_torch.ops import bh_grouped as tb2
from nbody_tpu_torch.ops import list_eval as tle

G = 6.67e-11
EPS = 1e-15
N, GS = 2048, 512
FORCE_TOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX_KERNELS = {
    "grid": functools.partial(jle.list_eval_pallas, interpret=True),
    "grid-compensated": functools.partial(jle.list_eval_pallas,
                                          interpret=True, compensated=True),
    "dynamic": functools.partial(jle.list_eval_dynamic, interpret=True),
}
TWINS = {
    "grid": tle.list_eval_pallas,
    "grid-compensated": functools.partial(tle.list_eval_pallas,
                                          compensated=True),
    "dynamic": tle.list_eval_dynamic,
}


def _sparse_tiles(dims, rng):
    """tests/test_list_eval.py's layout: group 0 holds tile 0 only, group
    1 tiles 0 and 3 (tiles 1 and 2 empty but inside the approx length),
    group 2 nothing; one approx section over the whole list."""
    g, s, k = 3, 64, 1024
    tgt = rng.uniform(-1, 1, (g, s, dims)).astype(np.float32)
    src = np.zeros((g, 8, k), np.float32)
    for gi, ranges in {0: [(0, 100)], 1: [(0, 50), (768, 848)]}.items():
        for lo, hi in ranges:
            src[gi, :dims, lo:hi] = rng.uniform(-1, 1, (dims, hi - lo))
            src[gi, dims, lo:hi] = 1e-3
    lens = np.array([[100, 848, 0], [0, 0, 0]], np.int32)
    return tgt, src, lens, dict(section_offset=k, k_tile=256)


def _two_sections(dims, rng):
    """Both sections occupied to random lengths, a section offset that is
    no multiple of the requested k_tile (the gcd fallback: 1024 -> 512),
    a direct section reaching the list's end, non-zero data in tiles past
    each section's length (skipped whole), and an empty group."""
    g, s, off, width = 5, 96, 1536, 2560
    tgt = rng.uniform(-1, 1, (g, s, dims)).astype(np.float32)
    src = np.zeros((g, 8, off + width), np.float32)
    src[:, :dims] = rng.uniform(-1, 1, (g, dims, off + width))
    src[:, dims] = rng.uniform(1e-4, 1e-3, (g, off + width))
    a_n = np.array([1536, 700, 0, 512, 0])
    d_n = np.array([2560, 33, 1100, 0, 0])
    for gi in range(g):
        # zero gm past each occupied length inside its own tile, as the
        # engine's packed lists are; later tiles keep their data
        src[gi, dims, a_n[gi]:-(-a_n[gi] // 512) * 512] = 0.0
        d_end = off + d_n[gi]
        src[gi, dims, d_end:off + -(-d_n[gi] // 512) * 512] = 0.0
    lens = np.stack([a_n, d_n]).astype(np.int32)
    return tgt, src, lens, dict(section_offset=off, k_tile=1024)


LAYOUTS = {"sparse": _sparse_tiles, "sections": _two_sections}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("kernel", sorted(TWINS))
def test_twin_matches_jax_kernel(kernel, dims, layout):
    rng = np.random.default_rng(dims * 10 + len(layout))
    tgt, src, lens, kw = LAYOUTS[layout](dims, rng)
    want = np.asarray(JAX_KERNELS[kernel](
        jnp.asarray(tgt), jnp.asarray(src), jnp.asarray(lens),
        softening=EPS, **kw))
    got = TWINS[kernel](torch.tensor(tgt), torch.tensor(src),
                        torch.tensor(lens), softening=EPS, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-8)
    empty = np.nonzero(lens.sum(0) == 0)[0]
    assert empty.size and np.all(got.numpy()[empty] == 0.0)


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("kernel", sorted(TWINS))
def test_self_exclusion_d2_guard(kernel, dims):
    """A source bit-equal to the targets contributes nothing
    (tests/test_list_eval.py:79-94)."""
    pos = [0.25, -0.5, 0.125][:dims]
    tgt = torch.tensor([[pos] * 8], dtype=torch.float32)
    src = torch.zeros((1, 8, 256))
    src[0, :dims, 0] = torch.tensor(pos)
    src[0, dims, 0] = 1.0
    lens = torch.tensor([[1], [0]], dtype=torch.int32)
    out = TWINS[kernel](tgt, src, lens, softening=EPS, section_offset=256,
                        k_tile=256)
    assert torch.all(out == 0.0)


@pytest.mark.parametrize("s,off,k_tile,want", [
    (2048, 2048, 2048, 2048), (2048, 3072, 2048, 1024),
    (64, 1024, 256, 256), (96, 1536, 1024, 512), (2048, 6144, 512, 512),
])
def test_tile_resolution(s, off, k_tile, want):
    """The JAX wrappers' k_tile resolution (list_eval.py:259-276): the
    VMEM clamp, then a divisor of the section offset."""
    got, n_k = tle.resolve_list_tiles(s, off + 1000, off, k_tile)
    assert got == want and n_k == -(-(off + 1000) // want)


def test_section_offset_must_tile():
    with pytest.raises(ValueError, match="not tileable"):
        tle.resolve_list_tiles(64, 2000, 1000, 2048)


def test_k_tile_below_128_lanes_raises():
    with pytest.raises(ValueError, match="multiples of 128"):
        tle.resolve_list_tiles(64, 2048, 1024, 64)


@pytest.mark.parametrize("dims", [2, 3])
def test_compensation_against_float64(dims):
    """On a list of 262,144 lanes (2,048 tiles of 128) whose partial sums
    all share a sign, Kahan across tiles keeps the twin at least as close
    to a float64 evaluation of the same list as the plain running sum."""
    rng = np.random.default_rng(7)
    s, k, kt = 32, 1 << 18, 128
    tgt = np.full((1, s, dims), -4.0, np.float32)
    tgt[0, :, 0] += rng.uniform(-1, 1, s)
    src = np.zeros((1, 8, k), np.float32)
    src[0, :dims] = rng.uniform(0, 1, (dims, k))
    src[0, dims] = rng.uniform(1e-3, 2e-3, k)
    lens = np.array([[k], [0]], np.int32)
    args = (torch.tensor(tgt), torch.tensor(src), torch.tensor(lens))
    kw = dict(softening=EPS, section_offset=k, k_tile=kt)
    plain = tle.list_eval_pallas(*args, **kw).double().numpy()
    comp = tle.list_eval_pallas(*args, compensated=True, **kw)
    comp = comp.double().numpy()
    x = src[0].astype(np.float64)
    disp = x[None, :dims, :] - tgt[0, :, :, None].astype(np.float64)
    d2 = (disp ** 2).sum(1)
    w = x[dims] / (d2 * (np.sqrt(d2) + EPS))
    exact = (w[:, None, :] * disp).sum(-1)[None]
    err_p = np.abs(plain - exact).max()
    err_c = np.abs(comp - exact).max()
    assert err_c <= err_p, (err_c, err_p)
    assert err_c <= 1e-6 * np.abs(exact).max()


# -- the superblock tables ----------------------------------------------------


@pytest.mark.parametrize("dcm,cap", [(32, 4096), (128, 4096), (32, 40)],
                         ids=["dcm32", "dcm128", "overflow"])
def test_expand_ranges_superblocks_match_jax(dcm, cap):
    rng = np.random.default_rng(dcm + cap)
    g, d = 6, 48
    counts = rng.integers(0, dcm + 1, (g, d))
    counts[:, d // 2:] = 0  # zero-count padding, as the collectors emit
    counts[1] = 0
    starts = rng.integers(0, 100000, (g, d)) * (counts > 0)
    ranges = np.stack([starts, counts], -1).astype(np.int32)
    want = [np.asarray(a) for a in jb2._expand_ranges_superblocks(
        jnp.asarray(ranges), dcm, cap)]
    got = [a.numpy() for a in tb2._expand_ranges_superblocks(
        torch.tensor(ranges), dcm, cap)]
    for w, t in zip(want, got):
        assert t.shape == w.shape
    valid = want[0] >= 0
    # lo is not masked on empty entries, and the JAX package's unstable
    # sort leaves those in any order; the evaluators never read them
    # (their lanes are masked by sb_idx >= 0)
    np.testing.assert_array_equal(got[1][valid], want[1][valid])
    for i in (0, 2, 3):
        np.testing.assert_array_equal(got[i], want[i])
    assert valid.any() and not valid.all()
    assert got[3].any() == (cap == 40)


# -- the whole grouped force pass ----------------------------------------------


def _cloud(dims, seed, n=N):
    rng = np.random.default_rng(seed)
    m = (10 ** rng.uniform(-1, np.log10(0.5), n)).astype(np.float32)
    return m, rng.uniform(-0.1, 0.1, (n, dims)).astype(np.float32)


PASSES = {"2d": (2, None), "3d-gather": (3, "gather"),
          "3d-dense": (3, "dense")}
MODES = {"grid": dict(eval_mode="grid"),
         "dynamic": dict(eval_mode="dynamic"),
         "compensated": dict(compensated=True)}


@functools.lru_cache(maxsize=None)
def _jax_pass(case):
    """The JAX package's XLA route (use_pallas=False: superblock lists,
    chunked dense evaluation) on the case's cloud."""
    dims, collect = PASSES[case]
    m, p = _cloud(dims, 3)
    kw = dict(g=G, group_size=GS, use_pallas=False, return_diagnostics=True)
    if dims == 3:
        acc, ovf = jb3.bh3_accelerations_grouped(
            jnp.asarray(p), jnp.asarray(m), collect=collect, **kw)
    else:
        acc, ovf = jb2.bh_accelerations_grouped(jnp.asarray(p),
                                                jnp.asarray(m), **kw)
    return np.asarray(acc), int(np.asarray(ovf).sum())


def _spy(monkeypatch, name):
    seen = []
    orig = getattr(tle, name)

    def spy(*a, **kw):
        seen.append((a[0].shape, a[1].shape, kw))
        return orig(*a, **kw)

    monkeypatch.setattr(tle, name, spy)
    return seen


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("case", sorted(PASSES))
def test_whole_pass_matches_jax(case, mode, monkeypatch):
    dims, collect = PASSES[case]
    m, p = _cloud(dims, 3)
    want, jovf = _jax_pass(case)
    calls = {n: _spy(monkeypatch, n) for n in (
        "list_eval_pallas", "list_eval_dynamic", "list_eval_runs",
        "list_eval_runs_split")}
    kw = dict(g=G, group_size=GS, return_diagnostics=True, **MODES[mode])
    if dims == 3:
        got, tovf = tb3.bh3_accelerations_grouped(
            torch.tensor(p), torch.tensor(m), collect=collect, **kw)
    else:
        got, tovf = tb2.bh_accelerations_grouped(torch.tensor(p),
                                                 torch.tensor(m), **kw)
    used = "list_eval_dynamic" if mode == "dynamic" else "list_eval_pallas"
    assert {n: len(c) for n, c in calls.items()} == {
        n: (1 if n == used else 0) for n in calls}
    (tshape, sshape, ckw), = calls[used]
    assert tshape == (N // GS, GS, dims) and sshape[:2] == (N // GS, 8)
    assert ckw.get("compensated", False) == (mode == "compensated")
    assert ckw["section_offset"] % 2048 == 0
    assert int(tovf.sum()) == jovf == 0
    assert got.shape == (N, dims) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want,
                               atol=FORCE_TOL * np.abs(want).max())


def _captured_lists(case, monkeypatch):
    """(inputs, (src, lens)) of every ``_padded_lists`` call of one real
    dynamic-route pass on the case's cloud."""
    dims, collect = PASSES[case]
    m, p = _cloud(dims, 3)
    seen = []
    orig = tb2._padded_lists

    def spy(*a):
        out = orig(*a)
        seen.append((a, out))
        return out

    monkeypatch.setattr(tb2, "_padded_lists", spy)
    kw = dict(g=G, group_size=GS, eval_mode="dynamic")
    if dims == 3:
        tb3.bh3_accelerations_grouped(torch.tensor(p), torch.tensor(m),
                                      collect=collect, **kw)
    else:
        tb2.bh_accelerations_grouped(torch.tensor(p), torch.tensor(m), **kw)
    assert seen
    return seen


@pytest.mark.parametrize("case", sorted(PASSES))
def test_packed_lists_are_finite_in_every_lane(case, monkeypatch):
    """K6/K7 skip the gm = 0 lanes; that is exact only because such a
    lane would add w * d = 0 * (finite) = +-0: every coordinate of a
    packed list, padding included, is finite."""
    for _, (src, lens) in _captured_lists(case, monkeypatch):
        assert torch.isfinite(src).all()
        assert int(lens.min()) >= 0


@pytest.mark.parametrize("case", sorted(PASSES))
def test_packed_lists_gm_is_zero_outside_ranges_and_sections(
        case, monkeypatch):
    """gm is exactly 0 on every lane outside [0, a_n) and [off, off + d_n),
    and on every superblock lane outside its range's [lo, hi); inside, the
    lane holds its body's g * m.  So the gm > 0 lanes of the visited
    tiles, which K6/K7 evaluate, are exactly the needed lanes."""
    for (coords, lm, (sb_idx, lo, hi), sb_packed, _), (src, lens) in (
            _captured_lists(case, monkeypatch)):
        dims, off, k = len(coords), lm.shape[1], src.shape[2]
        gm = src[:, dims]
        lane = torch.arange(k)
        a_n, d_n = lens[0][:, None], lens[1][:, None]
        inside = (lane < a_n) | ((lane >= off) & (lane < off + d_n))
        assert torch.all(gm[~inside] == 0.0)
        assert torch.all(gm[:, :off][lane[:off] < a_n] > 0.0)
        e, b = (lane[off:] - off) // 8, (lane[off:] - off) % 8
        sb = sb_idx[:, e]
        body = 8 * sb + b
        in_range = (sb >= 0) & (body >= lo[:, e]) & (body < hi[:, e])
        want = torch.where(
            in_range, sb_packed[sb.clamp(min=0).long(), 8 * dims + b], 0.0)
        assert torch.equal(gm[:, off:], want)
        assert torch.all(want[in_range] > 0.0) and in_range.any()


@pytest.mark.parametrize("g,s", [(20, 2048), (64, 2048), (512, 2048),
                                 (1, 64), (9, 300), (66, 4100), (3, 1)])
def test_list_launch_shape(g, s):
    """r is the fewest slices of 1, 2, 4, 8 that make two waves (8 when
    none does), the same on every call; the blocks cover S."""
    r, per_block, blocks = tle.list_launch_shape(g, s)
    assert r in (1, 2, 4, 8)
    assert tle.list_launch_shape(g, s) == (r, per_block, blocks)
    assert per_block * r == tle.LIST_THREADS and blocks % g == 0
    assert (blocks // g - 1) * per_block < s <= blocks // g * per_block
    two_waves = 2 * tle.SMS * tle.LIST_WAVE_WARPS * 32
    assert g * s * r >= two_waves or r == 8
    assert r == 1 or g * s * r // 2 < two_waves


@pytest.mark.parametrize("dims,n", [(2, 40960), (3, 131072)])
def test_list_launch_fills_two_waves_on_the_main_passes(dims, n):
    """At the padded route's 2D N=40,960 and 3D N=131,072 passes (one call
    of G groups of S targets), the launch holds at least two waves of
    warps."""
    if dims == 2:
        s = tb2.DEFAULT_GROUP_SIZE
        g = n // s
    else:
        s = tb3.default_group_size3(n)
        g = min(n // s, tb3.EVAL_CHUNK_3D)
    r, _, blocks = tle.list_launch_shape(g, s)
    warps = blocks * tle.LIST_THREADS // 32
    assert warps >= 2 * tle.SMS * tle.LIST_WAVE_WARPS
    assert r == (8 if dims == 2 else 4)


def test_3d_packed_lists_go_in_chunks_of_64_groups(monkeypatch):
    """3D builds and evaluates the packed lists 64 groups at a time (the
    JAX package's eval_chunk); the result does not depend on it."""
    m, p = _cloud(3, 4)
    kw = dict(g=G, group_size=16, eval_mode="dynamic")
    seen = _spy(monkeypatch, "list_eval_dynamic")
    got = tb3.bh3_accelerations_grouped(torch.tensor(p), torch.tensor(m),
                                        **kw)
    assert [s[0][0] for s in seen] == [64, 64]
    monkeypatch.setattr(tb3, "EVAL_CHUNK_3D", 128)
    whole = tb3.bh3_accelerations_grouped(torch.tensor(p), torch.tensor(m),
                                          **kw)
    assert [s[0][0] for s in seen[2:]] == [128]
    assert torch.equal(got, whole)


@pytest.mark.parametrize("mode,comp,k_in,runs_k,want", [
    (None, False, None, 256, ("runs", 256)),
    (None, False, None, 512, ("runs", 512)),
    ("runs", False, 4096, 512, ("runs", 1024)),
    ("grid", False, None, 256, ("grid", 2048)),
    ("dynamic", False, 1024, 512, ("dynamic", 1024)),
    (None, True, None, 256, ("grid", 2048)),
    ("dynamic", True, None, 512, ("grid", 2048)),
])
def test_evaluator_resolution(mode, comp, k_in, runs_k, want):
    """The JAX package's resolution on its kernel route
    (bh_grouped.py:1325-1345, bh3d.py:1074-1094): compensated forces the
    grid kernel; grid and dynamic default to 2048-lane tiles; runs is
    capped at runs_k_max."""
    assert tb2.resolve_eval(mode, comp, k_in, runs_k) == want


@pytest.mark.parametrize("dims", [2, 3])
def test_split_is_off_for_padded_lists(dims, monkeypatch):
    """split_eval=True asks for quarter tables, which only the runs
    evaluator reads: grid and dynamic collect no quarter bits."""
    seen = []
    mod, walk = (tb2, "_collect_lists") if dims == 2 else (
        tb3, "_collect_lists_3d")
    orig = getattr(mod, walk)

    def spy(*a, quarter_bits, **kw):
        seen.append(quarter_bits)
        return orig(*a, quarter_bits=quarter_bits, **kw)

    monkeypatch.setattr(mod, walk, spy)
    m, p = _cloud(dims, 5, n=1024)
    fn = tb2.bh_accelerations_grouped if dims == 2 else (
        tb3.bh3_accelerations_grouped)
    kw = dict(collect="gather") if dims == 3 else {}
    fn(torch.tensor(p), torch.tensor(m), g=G, group_size=GS,
       split_eval=True, eval_mode="grid", **kw)
    assert seen == [False]


def test_cli_padded_evaluators_on_the_cpu(tmp_path):
    """--eval-mode grid / dynamic and --compensated with barnes_hut run
    through the CLI in 2D and 3D."""
    from nbody_tpu_torch import cli

    for dims in (2, 3):
        for flags in (["--eval-mode", "grid"], ["--eval-mode", "dynamic"],
                      ["--compensated"]):
            assert cli.main(["run", "--device", "cpu", "--dims", str(dims),
                             "--engine", "barnes_hut", "--n-bodies", "1024",
                             "--steps", "1", "--output-dir", str(tmp_path)]
                            + flags) == 0
            st = cli.last_simulation.state
            assert int(st.step) == 1 and torch.isfinite(st.positions).all()


def test_list_eval_modules_import_without_jax():
    code = ("import sys, nbody_tpu_torch.ops.list_eval, "
            "nbody_tpu_torch.ops.bh_grouped, nbody_tpu_torch.ops.bh3d; "
            "assert 'jax' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_k_tile_past_the_list_is_empty():
    """A K7 walk whose direct tiles would run past K (a direct length
    longer than the section) reads nothing there."""
    tgt = torch.zeros((1, 4, 2))
    src = torch.zeros((1, 8, 512))
    src[0, 0, 256:512] = 1.0
    src[0, 2, 256:512] = 1e-3
    lens = torch.tensor([[0], [1024]], dtype=torch.int32)
    kw = dict(softening=EPS, section_offset=256, k_tile=256)
    dyn = tle.list_eval_dynamic(tgt, src, lens, **kw)
    grid = tle.list_eval_pallas(tgt, src, lens, **kw)
    assert torch.equal(dyn, grid)
    assert math.isclose(float(dyn[0, 0, 0]), 256 * 1e-3, rel_tol=1e-5)
