"""K4's schedule (``list_eval.split_schedule``), checked on the CPU: which
quarters get thread slices, the block table and the grid the launch is
sized by, on the split tables real force passes hand the wrapper and on
synthetic lanes at the 1M shape (2,048 quarters of 512 targets).

The kernel itself runs only on the card (``tests/test_torch_cuda.py``,
marked ``cuda``): there every schedule is held bit for bit to r = 1."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nbody_tpu_torch.ops import bh3d as tb3
from nbody_tpu_torch.ops import bh_grouped as tb2
from nbody_tpu_torch.ops import list_eval as tle

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_graph_gates import _no_host_reads  # noqa: E402

G = 6.67e-11
SLOTS = tle.SMS * tle.SPLIT_WAVE_BLOCKS
NQ_1M, S_1M = 2048, 2048  # the 1M default pass: 512 groups of 2,048


def _split_call(dims, seed, n=8192):
    """The (args, kwargs) one whole split force pass hands K4's wrapper."""
    rng = np.random.default_rng(seed)
    m = (10 ** rng.uniform(-1, np.log10(0.5), n)).astype(np.float32)
    c = rng.uniform(-0.05, 0.05, (2, dims))
    p = c[np.arange(n) % 2] + 0.004 * rng.normal(size=(n, dims))
    p, m = torch.tensor(p.astype(np.float32)), torch.tensor(m)
    seen = []
    orig = tle.list_eval_runs_split

    def spy(*a, **kw):
        seen.append((a, kw))
        return orig(*a, **kw)

    tle.list_eval_runs_split = spy
    try:
        kw = dict(g=G, group_size=512, split_eval=True)
        if dims == 3:
            tb3.bh3_accelerations_grouped(p, m, collect="dense", **kw)
        else:
            tb2.bh_accelerations_grouped(p, m, **kw)
    finally:
        tle.list_eval_runs_split = orig
    (a, kw), = seen
    return a, kw


def _want_slices(lanes, s):
    """Each quarter's r, one by one: the fewest whose block's chains, lanes
    / r pairs on SPLIT_THREADS threads, hold at most the pass's pairs over
    the card's block slots; 8 where none does."""
    sq = s // 4
    pairs = sum(lanes) * sq
    return [next((r for r in tle.SPLIT_SLICES
                  if tle.SPLIT_THREADS // r * n * SLOTS <= pairs), 8)
            for n in lanes]


def _check_schedule(lanes, s):
    """The schedule of ``lanes`` against its definition; returns it."""
    nq, sq = lanes.shape[0], s // 4
    with _no_host_reads():  # made on the device: capturable
        sched = tle.split_schedule(lanes, s)
    order = sched.order.long()
    assert sorted(order.tolist()) == list(range(nq))
    assert torch.equal(lanes[order], lanes.sort(descending=True,
                                                stable=True).values)
    by_quarter = dict(zip(order.tolist(), sched.slices.tolist()))
    want = _want_slices(lanes.tolist(), s)
    assert [by_quarter[i] for i in range(nq)] == want
    # the rows' blocks, in row order, and the grid sized from the shapes
    blocks = [-(-sq // tle.split_block_targets(sq, r))
              for r in sched.slices.tolist()]
    assert sched.row_start.tolist() == np.cumsum([0] + blocks).tolist()
    assert sum(blocks) <= sched.grid
    n_heavy = sum(r > 1 for r in want)
    assert n_heavy <= tle.split_heavy_rows(nq, s)
    assert sched.grid == nq * -(-sq // tle.split_block_targets(sq, 1)) + (
        tle.split_heavy_rows(nq, s)
        * (-(-sq // tle.split_block_targets(sq, 8))
           - -(-sq // tle.split_block_targets(sq, 1))))
    # the widest quarter gets the largest r; r never falls with lanes
    assert sched.slices[0] == max(want)
    assert (sched.slices[:-1] >= sched.slices[1:]).all()
    return sched


@pytest.mark.parametrize("dims", [2, 3])
def test_schedule_on_real_split_tables(dims):
    """The tables of a whole split pass at N = 8,192 (64 quarters of 128
    targets): fewer blocks than the card's slots, so every quarter that
    holds lanes is sliced; the summary reads the same schedule."""
    a, kw = _split_call(dims, 9)
    lanes = tle.split_quarter_lanes(*a[1:], k_tile=kw["k_tile"])
    s = a[0].shape[1]
    sched = _check_schedule(lanes, s)
    summary = tle.split_schedule_summary(*a, k_tile=kw["k_tile"])
    cut = sched.slices > 1
    assert summary["sliced"] == [
        (q, int(lanes[q]), r) for q, r in zip(sched.order[cut].tolist(),
                                              sched.slices[cut].tolist())]
    assert summary["pairs"] == int(lanes.sum()) * (s // 4)
    assert summary["fair_share_pairs"] == summary["pairs"] / SLOTS
    assert summary["heaviest_block_pairs_r1"] == (
        tle.SPLIT_THREADS * int(lanes.max()))
    assert summary["blocks"] == int(sched.row_start[-1])
    assert summary["grid"] == sched.grid


def _plummer_like(seed, widest=1 << 20):
    """Lanes of 2,048 quarters as a clustered 1M pass has them: a
    heavy-tailed spread (mean ~24,000) and one quarter of ``widest``."""
    rng = np.random.default_rng(seed)
    lanes = (rng.pareto(2.5, NQ_1M) * 14000 + 3000).astype(np.int64)
    lanes[rng.integers(NQ_1M)] = widest
    return torch.tensor(lanes)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_light_quarters_keep_r1_and_the_widest_is_sliced(seed):
    """At the 1M shape: every quarter whose block holds at most the fair
    share keeps r = 1 (the light path), the 1M-lane quarter gets r = 8,
    and the sliced rows are a few heavy ones."""
    lanes = _plummer_like(seed)
    sched = _check_schedule(lanes, S_1M)
    fair = int(lanes.sum()) * (S_1M // 4) / SLOTS
    r = torch.empty_like(sched.slices)
    r[sched.order.long()] = sched.slices
    light = lanes * tle.SPLIT_THREADS <= fair
    assert light.sum() > NQ_1M - 64 and (r[light] == 1).all()
    assert r[lanes.argmax()] == 8
    assert 1 <= int((r > 1).sum()) <= tle.split_heavy_rows(NQ_1M, S_1M)


def test_uniform_lanes_keep_the_light_launch():
    """Lanes within a few times of each other (a uniform 1M pass): no
    quarter is sliced, so the rows take the light path's blocks."""
    rng = np.random.default_rng(5)
    lanes = torch.tensor(rng.integers(10000, 30000, NQ_1M))
    sched = _check_schedule(lanes, S_1M)
    assert (sched.slices == 1).all()
    assert int(sched.row_start[-1]) == tle.split_launch_shape(NQ_1M,
                                                              S_1M)[2]


@pytest.mark.parametrize("s", [256, 512, 2048, 4400, 8192])
def test_grid_bound_holds_every_schedule(s):
    """The grid, from the shapes alone, holds the blocks of any lanes:
    random heavy tails, many quarters just past the fair share, one
    quarter holding everything, and no lanes at all."""
    rng = np.random.default_rng(s)
    nq = 512
    cases = [torch.tensor((rng.pareto(a, nq) * 100).astype(np.int64))
             for a in (0.5, 1.0, 3.0)]
    h = tle.split_heavy_rows(nq, s)
    for k in (h, h + 1, nq // 2):  # k equal quarters over the share
        lanes = torch.ones(nq, dtype=torch.int64)
        lanes[:k] = 10 ** 6
        cases.append(lanes[torch.tensor(rng.permutation(nq))])
    one = torch.zeros(nq, dtype=torch.int64)
    one[7] = 12345
    cases += [one, torch.zeros(nq, dtype=torch.int64)]
    for lanes in cases:
        _check_schedule(lanes, s)


@pytest.mark.parametrize("r", tle.SPLIT_SLICES)
def test_forced_slices(r):
    """A forced r gives every quarter r slices and the grid exactly its
    blocks; an r the kernel has no path for is refused."""
    lanes = _plummer_like(4)
    sq = S_1M // 4
    sched = tle.split_schedule(lanes, S_1M, r)
    assert (sched.slices == r).all()
    per = -(-sq // tle.split_block_targets(sq, r))
    assert int(sched.row_start[-1]) == sched.grid == NQ_1M * per
    assert torch.equal(sched.order, tle.split_schedule(lanes, S_1M).order)
    with pytest.raises(ValueError, match="slices=3"):
        tle.split_schedule(lanes, S_1M, 3)
