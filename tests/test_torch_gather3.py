"""The host side of the 3D gather walk's kernel (``ops/bh3d``:
``gather_widths``, ``check_gather_kernel``, ``check_gather_rows``, the
wrapper's routing and its launch counter), on the CPU at small sizes.
The kernel itself runs only on the card: ``tests/test_torch_cuda.py``
holds it to the twin bit for bit."""

import numpy as np
import pytest
import torch

from nbody_tpu_torch.ops import _cuda, bh3d, tree3d
from nbody_tpu_torch.rng import plummer
from nbody_tpu_torch.utils import profiling
from nbody_tpu_torch.utils.profiling import counter

GS = 1024  # groups of 1,024 bodies: 8 sub-boxes each
DCM = 32
# a schedule that compacts level 2, keeps every slot on levels 3-4 (the
# cap cannot bind: holes under the compacted level's tail), compacts
# again below
HYBRID = (1, 8, 20, 160, 1280, 3000, 700, 5600) + (6000,) * 14


def _uniform(n, seed):
    rng = np.random.default_rng(seed)
    m = (10 ** rng.uniform(-1, np.log10(0.5), n)).astype(np.float32)
    p = rng.uniform(-0.1, 0.1, (n, 3)).astype(np.float32)
    return torch.tensor(p), torch.tensor(m)


def _plummer(n, seed):
    m, p, _ = plummer(torch.Generator().manual_seed(seed), n)
    return p.float().contiguous(), m.float().contiguous()


def _setup(state, adaptive):
    p, m = _plummer(8192, 5) if state == "plummer" else _uniform(8192, 1)
    md = tree3d.default_max_depth3(p.shape[0])
    if adaptive:
        tree, refine, order = tree3d.build_octree_adaptive(p, m, md, DCM)
    else:
        tree, refine = tree3d.build_octree(p, m, max_depth=md), None
        order = torch.argsort(tree.codes, stable=True)
    bbox = bh3d.sub_boxes_3d(p[order].reshape(-1, GS, 3), GS // 128)
    return bbox, tree, refine


# case -> (state, adaptive, schedule: "default" or HYBRID, list and
# direct caps)
WIDTH_CASES = {
    "uniform-default": ("uniform", False, "default", (1 << 14, 1 << 13)),
    "uniform-cut": ("uniform", False, "default", (300, 100)),
    "uniform-hybrid": ("uniform", False, HYBRID, (1 << 15, 1 << 15)),
    "plummer-adaptive": ("plummer", True, "default", (1 << 15, 1 << 15)),
    "plummer-hybrid": ("plummer", True, HYBRID, (1 << 15, 1 << 15)),
}


@pytest.mark.parametrize("case", sorted(WIDTH_CASES))
def test_gather_widths_give_the_twins_list_widths(case):
    """The kernel's output widths, min(sum of ``gather_widths`` to the
    walk's last level, cap), are the twin's on every schedule: the
    default ones, caps that cut the lists, and one that compacts a level
    and then keeps every slot below it."""
    state, adaptive, sched, (lc, dc) = WIDTH_CASES[case]
    bbox, tree, refine = _setup(state, adaptive)
    md = tree.max_depth
    if sched == "default":
        sched = (bh3d.frontier_schedule_adaptive if adaptive
                 else bh3d.frontier_schedule_3d)(2048, md, 8192)
    last = md if refine is None else refine.depth
    assert last > md or not adaptive  # the Plummer state is refined
    (lx, *_), ranges, _ = bh3d._gather_lists(
        bbox, tree, theta=0.5, softening=0.01,
        frontier_caps=sched[:last + 1], list_cap=lc, direct_cap=dc,
        direct_cell_max=DCM, refine=refine)
    widths = bh3d.gather_widths(sched, last + 1)
    assert widths[0] == 1 and all(
        w == min(8 * v, c) for v, w, c in zip(widths, widths[1:], sched[1:]))
    assert lx.shape[1] == min(sum(widths), lc)
    assert ranges.shape[1] == min(sum(widths), dc)


def test_gather_widths_stop_at_the_pyramid_when_none_enters():
    """Where no group opens a crowded leaf the twin stops at the pyramid:
    its widths are the pyramid levels' alone, which the wrapper cuts the
    kernel's outputs to after its one host read."""
    bbox, tree, refine = _setup("plummer", True)
    md = tree.max_depth
    far = tuple(b + 100.0 for b in bbox)  # the root is accepted
    groups = counter("ops.bh3d.REFINE_GROUPS")
    (lx, *_), ranges, _ = bh3d._gather_lists(
        far, tree, theta=0.5, softening=0.01, frontier_caps=HYBRID,
        list_cap=1 << 15, direct_cap=1 << 15, direct_cell_max=DCM,
        refine=refine)
    assert counter("ops.bh3d.REFINE_GROUPS") == groups
    widths = bh3d.gather_widths(HYBRID, refine.depth + 1)
    assert refine.depth > md
    assert lx.shape[1] == ranges.shape[1] == sum(widths[:md + 1])


# what check_gather_kernel refuses -> (its arguments, the message)
REFUSED = {
    "levels": (dict(n_sub=16, levels=23), "at most 22"),
    "sub-boxes": (dict(n_sub=512, levels=8), "at most 256"),
    "quarters": (dict(n_sub=6, levels=8, quarter_bits=True), "Q % 4"),
    "window-refined": (dict(n_sub=16, levels=12, windowed=True,
                            refined=True), "no window"),
    "rows": (dict(n_sub=16, levels=8, level_rows=(8, 1 << 26)),
             "fewer than"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_check_gather_kernel_refuses(case):
    kw, msg = REFUSED[case]
    kw = dict(dict(quarter_bits=False, windowed=False, refined=False), **kw)
    n_sub, levels = kw.pop("n_sub"), kw.pop("levels")
    with pytest.raises(ValueError, match=msg):
        bh3d.check_gather_kernel(n_sub, levels, **kw)


@pytest.mark.parametrize("refined", [False, True])
def test_check_gather_kernel_takes_the_main_paths_walks(refined):
    """The 1M walks the main path makes: the pyramid (depth 7, windowed
    or not) and the adaptive tree to depth 21, 16 sub-boxes in
    quarters."""
    levels = tree3d.MAX_DEPTH3_WIDE + 1 if refined else 8
    rows = [8 ** lv for lv in range(8)] + [1 << 20] * (levels - 8)
    bh3d.check_gather_kernel(16, levels, quarter_bits=True,
                             windowed=not refined, refined=refined,
                             level_rows=rows)


def test_check_gather_rows():
    """Rows the kernel reads: contiguous [K, 16], or [K, 16] views of a
    wider buffer (a refined level's stride of 32 floats); no other type,
    width, stride or start."""
    cpu = torch.device("cpu")
    wide = torch.zeros((64, 32))
    bh3d.check_gather_rows(wide[:, :16].contiguous(), "rows", cpu)
    bh3d.check_gather_rows(wide[:, :16], "rows", cpu)
    bh3d.check_gather_rows(wide[:1, :16], "rows", cpu)
    bad = {
        "float32": wide[:, :16].double(),
        "shape": wide[:, :8],
        "strides": torch.zeros((64, 18))[:, :16],
        "offset": wide[:, 1:17],
    }
    for what, rows in bad.items():
        with pytest.raises(ValueError, match=what):
            bh3d.check_gather_rows(rows, "rows", cpu)


def test_gather_kernel_wrapper_refuses_cpu_tensors():
    bbox, tree, _ = _setup("uniform", False)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bh3d._gather_lists_kernel(
            bbox, tree, theta=0.5, softening=0.01,
            frontier_caps=bh3d.frontier_schedule_3d(2048, tree.max_depth,
                                                    8192),
            list_cap=4096, direct_cap=2048, direct_cell_max=DCM)


@pytest.mark.parametrize("quarter_bits", [False, True])
def test_collect_lists_3d_takes_the_twin_on_cpu(monkeypatch, quarter_bits):
    """``_collect_lists_3d`` on CPU tensors is the twin, outputs and all;
    the kernel's wrapper is never reached and its counter stays."""
    def refuse(*a, **kw):
        raise AssertionError("a CPU tensor reached the kernel's wrapper")

    bbox, tree, refine = _setup("plummer", True)
    kw = dict(theta=0.5, softening=0.01,
              frontier_caps=bh3d.frontier_schedule_adaptive(
                  2048, tree.max_depth, 8192),
              list_cap=1 << 13, direct_cap=1 << 12, direct_cell_max=DCM,
              quarter_bits=quarter_bits, return_demand=True, refine=refine)
    want = bh3d._gather_lists(bbox, tree, **kw)
    monkeypatch.setattr(bh3d, "_gather_lists_kernel", refuse)
    launches = counter("ops.bh3d.GATHER_KERNEL_LAUNCHES")
    got = bh3d._collect_lists_3d(bbox, tree, **kw)
    assert counter("ops.bh3d.GATHER_KERNEL_LAUNCHES") == launches
    assert len(got) == len(want) == (5 if quarter_bits else 4)
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    for a, b in zip(got[-1].values(), want[-1].values()):
        assert torch.equal(a, b)


def test_gather_kernel_listed_and_found_by_name():
    """The kernel's source is built with the others, its launch counter
    is one of the wrappers' counters (a graph's owner counts it a
    replay), and the benchmark's trace finds its ``__global__`` by
    name."""
    from benchmark.trace import hand_kernel_names

    assert "collect_gather3.cu" in _cuda.SOURCES
    key = "ops.bh3d.GATHER_KERNEL_LAUNCHES"
    assert key in profiling.COUNTERS
    before = counter(key)
    profiling.count(key)
    assert counter(key) == profiling.counter_values()[key] == before + 1
    profiling.count(key, -1)
    assert "gather_collect3_kernel" in hand_kernel_names()
