"""What kernels K2 and K3 (``list_eval.list_eval_runs`` on the card) rest
on, checked on the CPU: the premise that makes their packed streaming
exact, on the tables real force passes hand the wrapper; the lanes each
group needs, counted two ways; and the launch shape.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``,
marked ``cuda``); here the wrapper takes the plain twin, which
``test_torch_bh_grouped.py`` and ``test_torch_3d.py`` hold to the JAX
package."""

import numpy as np
import pytest
import torch

from nbody_tpu_torch.ops import bh3d as tb3
from nbody_tpu_torch.ops import bh_grouped as tb2
from nbody_tpu_torch.ops import list_eval as tle

G = 6.67e-11
GS = 512


def _cloud(dims, seed, n=8192):
    rng = np.random.default_rng(seed)
    m = (10 ** rng.uniform(-1, np.log10(0.5), n)).astype(np.float32)
    c = rng.uniform(-0.05, 0.05, (2, dims))
    p = c[np.arange(n) % 2] + 0.004 * rng.normal(size=(n, dims))
    return torch.tensor(m), torch.tensor(p.astype(np.float32))


def _runs_tables(dims, collect, seg_pack, monkeypatch):
    """The (args, kwargs) one whole force pass hands ``list_eval_runs``,
    with the 3D run-length gate forced to the wanted branch (as
    chip_smoke.capture_tables forces it)."""
    m, p = _cloud(dims, 11 + seg_pack)
    seen = []
    orig = tle.list_eval_runs

    def spy(*a, **kw):
        seen.append((a, kw))
        return orig(*a, **kw)

    monkeypatch.setattr(tle, "list_eval_runs", spy)
    if dims == 2:
        tb2.bh_accelerations_grouped(p, m, g=G, group_size=GS)
    else:
        monkeypatch.setattr(tb2, "SEG_PACK_MIN_RUN_LANES",
                            -1.0 if seg_pack > 1 else float("inf"))
        tb3.bh3_accelerations_grouped(p, m, g=G, group_size=GS,
                                      collect=collect, split_eval=False,
                                      seg_pack=4, eval_k_tile=512)
    (a, kw), = seen
    assert kw["seg_pack"] == seg_pack
    return a, kw


def _lanes_by_entry(approx, srct, tiles, lens, k_tile, seg_pack):
    """Each group's needed lanes, entry by entry in Python."""
    sw, npad, t_cap = k_tile // seg_pack, srct.shape[1], tiles.shape[2]
    out = []
    for g in range(lens.shape[1]):
        n = min(int(lens[0, g]), approx.shape[2])
        for e in range(min(int(lens[1, g]) * seg_pack, t_cap)):
            start, lo, hi = (int(x) for x in tiles[g, :, e])
            n += max(0, min(hi, sw, npad - start) - max(lo, 0))
        out.append(n)
    return out


PASSES = [(2, None, 1), (3, "gather", 1), (3, "gather", 4), (3, "dense", 1),
          (3, "dense", 4)]
PASS_IDS = ["2d", "3d-gather-K2", "3d-gather-K3", "3d-dense-K2",
            "3d-dense-K3"]


@pytest.mark.parametrize("dims,collect,seg_pack", PASSES, ids=PASS_IDS)
def test_runs_tables_hold_the_packing_premise(dims, collect, seg_pack,
                                              monkeypatch):
    """What makes K2/K3's packed streaming exact: every approx lane past
    lens[0] inside an occupied tile is gm = 0 with finite coordinates (so
    skipping it drops +-0), and every live direct entry's clipped [lo, hi)
    lies inside its k_tile / P window and inside the source table."""
    (_, approx, srct, tiles, lens), kw = _runs_tables(dims, collect,
                                                      seg_pack, monkeypatch)
    k_tile = kw["k_tile"]
    sw = k_tile // seg_pack
    lane = torch.arange(approx.shape[2])[None]
    occupied = (-(-lens[0].long() // k_tile)) * k_tile
    tail = (lane >= lens[0, :, None]) & (lane < occupied[:, None])
    assert (approx[:, dims][tail] == 0).all()
    assert torch.isfinite(approx[:, :dims + 1]).all()
    npad, t_cap = srct.shape[1], tiles.shape[2]
    start, lo, hi = tiles.long().unbind(1)
    live = (torch.arange(t_cap)[None]
            < (lens[1, :, None].long() * seg_pack).clamp(max=t_cap))
    assert live.any()
    assert (start[live] >= 0).all() and (start[live] % 128 == 0).all()
    assert (lo[live] >= 0).all() and (lo[live] <= hi[live]).all()
    assert (hi[live] <= sw).all()
    assert (start[live] + hi[live] <= npad).all()
    # the lanes K2/K3 stage, counted two ways
    got = tle.runs_group_lanes(approx, srct, tiles, lens, k_tile=k_tile,
                               seg_pack=seg_pack)
    assert got.dtype == torch.int64 and got.shape == (lens.shape[1],)
    assert got.tolist() == _lanes_by_entry(approx, srct, tiles, lens,
                                           k_tile, seg_pack)


@pytest.mark.parametrize("seg_pack", [1, 2, 4, 8])
def test_runs_group_lanes_on_ragged_tables(seg_pack):
    """Padded entries (lo == hi == 0), entries past T, lens past the
    approx width, windows running past k_tile / P and past the source
    table, an empty group: each clipped as the kernel clips it."""
    rng = np.random.default_rng(seg_pack)
    g, a_w, npad, t_cap, k = 5, 700, 4096, 9, 256 * seg_pack
    sw = k // seg_pack
    approx = torch.zeros((g, 8, a_w))
    srct = torch.zeros((8, npad))
    tiles = torch.zeros((g, 3, t_cap), dtype=torch.int32)
    for gi in range(g):
        for e in range(t_cap):
            if e % 4 == 3:
                continue  # padded
            start = 128 * int(rng.integers(0, npad // 128))
            lo = int(rng.integers(0, sw))
            tiles[gi, :, e] = torch.tensor(
                [start, lo, lo + int(rng.integers(0, sw))], dtype=torch.int32)
    lens = torch.tensor([[0, 123, a_w, 5 * a_w, 9],
                         [0, 1, t_cap, t_cap + 4, 2]], dtype=torch.int32)
    got = tle.runs_group_lanes(approx, srct, tiles, lens, k_tile=k,
                               seg_pack=seg_pack)
    assert got.tolist() == _lanes_by_entry(approx, srct, tiles, lens, k,
                                           seg_pack)
    assert got[0] == 0 and (got[1:] > 0).all()


# (G, S) of the main path's runs passes: 2D N=40,960 (group 2,048), 3D
# N=131,072 and 229,376 (group 2,048), 262,144 (group 4,096)
MAIN_SHAPES = {"2d-40960": (20, 2048), "3d-131072": (64, 2048),
               "3d-229376": (112, 2048), "3d-262144": (64, 4096)}


@pytest.mark.parametrize("g,s", list(MAIN_SHAPES.values()) + [
    (1, 64), (9, 300), (3, 1), (512, 2048)],
    ids=list(MAIN_SHAPES) + ["1x64", "9x300", "3x1", "512x2048"])
def test_runs_launch_shape(g, s):
    """r is one of 1, 2, 4, 8, the fewest that make two waves (8 when none
    does), the same on every call; the blocks cover S; at the main path's
    shapes the grid holds at least two waves of warps."""
    r, per_block, blocks = tle.runs_launch_shape(g, s)
    assert r in (1, 2, 4, 8)
    assert tle.runs_launch_shape(g, s) == (r, per_block, blocks)
    assert per_block * r == tle.RUNS_THREADS and blocks % g == 0
    assert (blocks // g - 1) * per_block < s <= blocks // g * per_block
    two_waves = 2 * tle.SMS * tle.RUNS_WAVE_WARPS * 32
    assert g * s * r >= two_waves or r == 8
    assert r == 1 or g * s * r // 2 < two_waves
    if (g, s) in MAIN_SHAPES.values():
        assert blocks * tle.RUNS_THREADS // 32 >= (
            2 * tle.SMS * tle.RUNS_WAVE_WARPS)
    assert tle.runs_launch_shape(*MAIN_SHAPES["2d-40960"])[0] == 8
    assert tle.runs_launch_shape(*MAIN_SHAPES["3d-131072"])[0] == 4
    assert tle.runs_launch_shape(*MAIN_SHAPES["3d-262144"])[0] == 2


def test_the_main_shapes_are_the_engines():
    """MAIN_SHAPES are the engines' group sizes at those N."""
    assert tb2.DEFAULT_GROUP_SIZE == 2048
    for n in (131072, 229376, 262144):
        g, s = MAIN_SHAPES[f"3d-{n}"]
        assert tb3.default_group_size3(n) == s and n // s == g
