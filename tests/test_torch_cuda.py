"""The port's CUDA kernels against their plain twins on the card.

These need an NVIDIA GPU with nvcc (a CUDA kernel has no CPU mode): they
are marked ``cuda`` and skip elsewhere.  On a machine with the card:

    python -m pytest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from nbody_tpu_torch.ops import allpairs, bh_grouped, list_eval
from nbody_tpu_torch.utils.profiling import counter

pytestmark = pytest.mark.cuda

G = 6.67e-11
TOL = 1e-5  # of max|a|: f32 both sides, summation order differs

# counters (utils/profiling.COUNTERS) the tests read
HOST_READS = "ops._graph.HOST_READS"
REFINE_GROUPS = "ops.bh3d.REFINE_GROUPS"
GATHER_KERNEL = "ops.bh3d.GATHER_KERNEL_LAUNCHES"
DENSE_PASS, DENSE_KERNEL = (f"ops.collect_dense3.{c}" for c in (
    "DENSE_PASSES", "DENSE_KERNEL_LAUNCHES"))
DENSE_COUNTERS = (DENSE_PASS, DENSE_KERNEL, "ops.collect_dense3.SPILL_PASSES",
                  "ops.collect_dense3.ESCAPED_GROUPS")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _cloud(n, seed, device):
    rng = np.random.default_rng(seed)
    m = (10 ** rng.uniform(-1, np.log10(0.5), n)).astype(np.float32)
    p = rng.uniform(-0.1, 0.1, (n, 2)).astype(np.float32)
    return torch.tensor(p, device=device), torch.tensor(m, device=device)


@pytest.mark.parametrize("n,soft,comp", [
    (700, 0.0, False), (4099, 0.0, False), (4099, 1e-3, False),
    (4099, 0.0, True)])
def test_k1_matches_twin(cuda, n, soft, comp):
    p, m = _cloud(n, n, cuda)
    before = counter("ops.allpairs.KERNEL_LAUNCHES")
    got = allpairs.allpairs_accelerations_vs(
        p, p, m, g=G, softening=soft, target_block=128, source_block=512,
        compensated=comp)
    want = allpairs.allpairs_accelerations_plain(
        p, p, m, g=G, softening=soft, source_block=512, compensated=comp)
    assert counter("ops.allpairs.KERNEL_LAUNCHES") == before + 1
    assert (got - want).abs().max() <= TOL * want.abs().max()


def test_k1_rejects_what_it_cannot_take(cuda):
    p, m = _cloud(256, 1, cuda)
    with pytest.raises(ValueError, match="float32"):
        allpairs.allpairs_accelerations(p.double(), m.double(), g=G)
    with pytest.raises(ValueError, match="contiguous"):
        pt = p.t().contiguous().t()
        allpairs.allpairs_accelerations_vs(pt, pt, m, g=G)
    with pytest.raises(ValueError, match="K1's blocks hold"):
        allpairs.allpairs_accelerations(p, m, g=G, target_block=100)


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("nt,ns,sb", [
    (700, 700, 128), (700, 700, 768), (4099, 4099, 500), (4099, 4099, 512),
    (33, 10000, 128), (33, 10000, 500)])
@pytest.mark.parametrize("soft,comp", [(0.0, False), (1e-3, False),
                                       (0.0, True)])
def test_k1_every_shape_gives_the_same_bits(cuda, dims, nt, ns, sb, soft,
                                           comp):
    """Every slice count (target_block) and the default shape give equal
    bits: each unit's partial is summed whole, partials in unit order; on
    ragged N, ragged tiles and Kahan chunks, and nt != ns (targets apart
    from the sources)."""
    cloud = _cloud if dims == 2 else _cloud3
    p, m = cloud(ns, ns + sb, cuda)
    t = p if nt == ns else cloud(nt, nt + 1, cuda)[0]
    kw = dict(g=G, softening=soft, source_block=sb, compensated=comp)
    before = counter("ops.allpairs.KERNEL_LAUNCHES")
    ref = allpairs.allpairs_accelerations_vs(t, p, m, **kw)
    for tb in allpairs.allpairs_target_blocks():
        got = allpairs.allpairs_accelerations_vs(t, p, m, target_block=tb,
                                                 **kw)
        assert torch.equal(got, ref), f"target_block={tb}"
    assert counter("ops.allpairs.KERNEL_LAUNCHES") == before + 5
    want = allpairs.allpairs_accelerations_plain(t, p, m, **kw)
    assert (ref - want).abs().max() <= TOL * want.abs().max()


def test_k1_subnormal_d2_counts_as_coincident(cuda):
    """A pair at d2 = 1e-40 (bodies 1e-20 apart) is dropped, as on the
    TPU, which flushes subnormals: the result stays finite, and each of
    the two feels only the third body."""
    p = torch.tensor([[0.0, 0.0], [1e-20, 0.0], [0.05, -0.03]], device=cuda)
    m = torch.ones(3, device=cuda)
    got = allpairs.allpairs_accelerations(p, m, g=G)
    assert torch.isfinite(got).all()
    for i, keep in ((0, [0, 2]), (1, [1, 2]), (2, [0, 1, 2])):
        want = allpairs.allpairs_accelerations_plain(
            p[i:i + 1].cpu(), p[keep].cpu(), m[keep].cpu(), g=G)
        assert torch.allclose(got[i:i + 1].cpu(), want, rtol=1e-6, atol=0)


def test_k2_matches_twin_on_engine_tables(cuda):
    p, m = _cloud(8192, 2, cuda)
    seen = {}
    orig = list_eval.list_eval_runs

    def spy(*a, **kw):
        seen["a"], seen["kw"] = a, kw
        return orig(*a, **kw)

    list_eval.list_eval_runs = spy
    try:
        bh_grouped.bh_accelerations_grouped(p, m, g=G, group_size=512)
    finally:
        list_eval.list_eval_runs = orig
    before = counter("ops.list_eval.KERNEL_LAUNCHES")
    got = list_eval.list_eval_runs(*seen["a"], **seen["kw"])
    want = list_eval.list_eval_runs_plain(*seen["a"], **seen["kw"])
    assert counter("ops.list_eval.KERNEL_LAUNCHES") == before + 1
    assert (got - want).abs().max() <= TOL * want.abs().max()


def test_grouped_bh_on_card_matches_cpu(cuda):
    p, m = _cloud(8192, 3, cuda)
    got, ovf = bh_grouped.bh_accelerations_grouped(
        p, m, g=G, group_size=512, return_diagnostics=True)
    want = bh_grouped.bh_accelerations_grouped(p.cpu(), m.cpu(), g=G,
                                               group_size=512)
    assert int(ovf.sum()) == 0
    assert (got.cpu() - want).abs().max() <= TOL * want.abs().max()


def _cloud3(n, seed, device):
    rng = np.random.default_rng(seed)
    m = (10 ** rng.uniform(-1, np.log10(0.5), n)).astype(np.float32)
    p = rng.uniform(-0.1, 0.1, (n, 3)).astype(np.float32)
    return torch.tensor(p, device=device), torch.tensor(m, device=device)


@pytest.mark.parametrize("n,soft,comp", [
    (700, 0.0, False), (4099, 0.0, False), (4099, 1e-3, False),
    (4099, 0.0, True)])
def test_k1_3d_matches_twin(cuda, n, soft, comp):
    p, m = _cloud3(n, n, cuda)
    before = counter("ops.allpairs.KERNEL_LAUNCHES")
    got = allpairs.allpairs_accelerations_vs(
        p, p, m, g=G, softening=soft, target_block=128, source_block=512,
        compensated=comp)
    want = allpairs.allpairs_accelerations_plain(
        p, p, m, g=G, softening=soft, source_block=512, compensated=comp)
    assert counter("ops.allpairs.KERNEL_LAUNCHES") == before + 1
    assert got.shape == (n, 3)
    assert (got - want).abs().max() <= TOL * want.abs().max()


def _tables3(p, m, seg_pack, monkeypatch):
    """The (args, kwargs) one 3D grouped-BH pass hands the runs wrapper,
    with the run-length gate forced to the wanted branch."""
    from nbody_tpu_torch.ops import bh3d

    monkeypatch.setattr(bh_grouped, "SEG_PACK_MIN_RUN_LANES",
                        -1.0 if seg_pack > 1 else float("inf"))
    seen = {}
    orig = list_eval.list_eval_runs

    def spy(*a, **kw):
        seen["a"], seen["kw"] = a, kw
        return orig(*a, **kw)

    monkeypatch.setattr(list_eval, "list_eval_runs", spy)
    bh3d.bh3_accelerations_grouped(p, m, g=G, group_size=512, seg_pack=4,
                                   eval_k_tile=512)
    monkeypatch.setattr(list_eval, "list_eval_runs", orig)
    assert seen["kw"]["seg_pack"] == seg_pack
    return seen["a"], seen["kw"]


@pytest.mark.parametrize("seg_pack", [1, 4], ids=["K2-3d", "K3"])
def test_runs_kernels_3d_match_twin(cuda, monkeypatch, seg_pack):
    p, m = _cloud3(8192, 4, cuda)
    a, kw = _tables3(p, m, seg_pack, monkeypatch)
    key = "KERNEL_LAUNCHES" if seg_pack == 1 else "PACKED_LAUNCHES"
    before = counter(f"ops.list_eval.{key}")
    got = list_eval.list_eval_runs(*a, **kw)
    want = list_eval.list_eval_runs_plain(*a, **kw)
    assert counter(f"ops.list_eval.{key}") == before + 1
    assert (got - want).abs().max() <= TOL * want.abs().max()


def test_k3_matches_k2_on_the_same_runs(cuda, monkeypatch):
    p, m = _cloud3(8192, 5, cuda)
    a4, kw4 = _tables3(p, m, 4, monkeypatch)
    packed = list_eval.list_eval_runs(*a4, **kw4)
    a, kw = _tables3(p, m, 1, monkeypatch)
    plain = list_eval.list_eval_runs(*a, **kw)
    assert (packed - plain).abs().max() <= TOL * plain.abs().max()


def _at_slices(monkeypatch, r):
    """Force K2/K3's launch shape to r slices per target."""
    per = list_eval.RUNS_THREADS // r
    monkeypatch.setattr(list_eval, "runs_launch_shape",
                        lambda g, s: (r, per, g * -(-s // per)))


def _every_slice_count(monkeypatch, args, kw):
    """K2/K3 at r = 1, 2, 4, 8 slices: the results, which must be one."""
    orig = list_eval.runs_launch_shape
    outs = []
    for r in (1, 2, 4, 8):
        _at_slices(monkeypatch, r)
        outs.append(list_eval.list_eval_runs(*args, **kw))
    monkeypatch.setattr(list_eval, "runs_launch_shape", orig)
    torch.cuda.synchronize()
    return outs


@pytest.mark.parametrize("seg_pack", [1, 4], ids=["K2-3d", "K3"])
def test_runs_kernels_every_slice_count_on_engine_tables(cuda, monkeypatch,
                                                         seg_pack):
    p, m = _cloud3(8192, 9, cuda)
    a, kw = _tables3(p, m, seg_pack, monkeypatch)
    outs = _every_slice_count(monkeypatch, a, kw)
    want = list_eval.list_eval_runs_plain(*a, **kw)
    for got in outs:
        assert torch.equal(got, outs[0])
    assert (outs[0] - want).abs().max() <= TOL * want.abs().max()
    need = int(list_eval.runs_group_lanes(*a[1:], k_tile=kw["k_tile"],
                                          seg_pack=seg_pack).sum())
    assert list_eval.runs_lanes_staged(*a, **kw) == need > 0


def _ragged_runs_tables(dims, seed, device, seg_pack, case):
    """Synthetic K2/K3 tables.  Groups: empty, approx only, direct only,
    both with lens[1] past ceil(T / P), both, one approx lane.  Direct
    entries: random 128-aligned windows of the k_tile / P segment, some
    padded (lo == hi == 0), some empty (lo == hi); every source lane a
    real body, so the windows' masks matter; approx lanes past lens[0]
    gm = 0, as the engine leaves them.  ``case``: "mixed" (windows of any
    width: units straddle the staged rounds), "many-units" (1-8 lanes:
    more units than a round's slots and more pieces than one table),
    "big-k" (k_tile 16,384, past what one block could stage whole; windows
    of up to 1,024 lanes anywhere in it and at most 2,100 approx lanes, so
    that the kernel's lane-order sums stay within 1e-5 x max|a| of the
    twin's tree-ordered ones)."""
    rng = np.random.default_rng(seed)
    k = max({"mixed": 512, "many-units": 1024, "big-k": 16384}[case],
            128 * seg_pack)
    t_cap = {"mixed": 40, "many-units": 700, "big-k": 12}[case]
    sw = k // seg_pack
    max_w = {"mixed": sw, "many-units": 8, "big-k": min(sw, 1024)}[case]
    g, s, ns = 6, 300, 1 << 15
    a_w = 3 * k
    targets = rng.uniform(-0.1, 0.1, (g, s, dims)).astype(np.float32)
    approx = np.zeros((g, 8, a_w), np.float32)
    approx[:, :dims] = rng.uniform(-0.1, 0.1, (g, dims, a_w))
    srct = np.zeros((8, ns + k), np.float32)
    srct[:dims, :ns] = rng.uniform(-0.1, 0.1, (dims, ns))
    srct[dims, :ns] = G * rng.uniform(0.1, 0.5, ns)
    srct[:dims, 300] = targets[4, 7]  # excluded by d2 > 0
    tiles = np.zeros((g, 3, t_cap), np.int32)
    for gi in range(g):
        for e in range(t_cap):
            if e % 5 == 4:
                continue  # padded
            start = 128 * int(rng.integers(0, ns // 128))
            lo = int(rng.integers(0, sw))
            width = int(rng.integers(case == "many-units", max_w + 1))
            tiles[gi, :, e] = (start, lo, min(sw, lo + width))
    steps = -(-t_cap // seg_pack)
    a_n = ([0, 1500, 0, 2100, 700, 1] if case == "big-k"
           else [0, 2 * k + 77, 0, a_w, k // 3, 1])
    lens = np.array([a_n, [0, 0, steps, steps + 3, steps // 2, steps]],
                    np.int32)
    for gi in range(g):
        approx[gi, dims, :a_n[gi]] = G * rng.uniform(0.1, 0.5, a_n[gi])
    return [torch.tensor(x, device=device)
            for x in (targets, approx, srct, tiles, lens)], k


@pytest.mark.parametrize("case", ["mixed", "many-units", "big-k"])
@pytest.mark.parametrize("seg_pack", [1, 2, 4, 8])
@pytest.mark.parametrize("dims", [2, 3])
def test_runs_kernels_on_ragged_tables(cuda, monkeypatch, dims, seg_pack,
                                       case):
    """K2 / K3 at every slice count: bit-equal to each other, within
    1e-5 x max|a| of the twin, staging exactly the lanes the tables
    need."""
    args, k = _ragged_runs_tables(dims, seg_pack + dims, cuda, seg_pack,
                                  case)
    kw = dict(softening=1e-15, k_tile=k, seg_pack=seg_pack)
    key = "KERNEL_LAUNCHES" if seg_pack == 1 else "PACKED_LAUNCHES"
    before = counter(f"ops.list_eval.{key}")
    outs = _every_slice_count(monkeypatch, args, kw)
    assert counter(f"ops.list_eval.{key}") == before + 4
    want = list_eval.list_eval_runs_plain(*args, **kw)
    assert want[0].abs().max() == 0 and want.abs().max() > 0
    for got in outs:
        assert torch.equal(got, outs[0])
    assert torch.isfinite(outs[0]).all()
    assert (outs[0] - want).abs().max() <= TOL * want.abs().max()
    _, approx, srct, tiles, lens = (a.cpu() for a in args)
    need = 0
    for gi in range(lens.shape[1]):
        need += min(int(lens[0, gi]), approx.shape[2])
        for e in range(min(int(lens[1, gi]) * seg_pack, tiles.shape[2])):
            start, lo, hi = (int(x) for x in tiles[gi, :, e])
            need += max(0, min(hi, k // seg_pack, srct.shape[1] - start)
                        - max(lo, 0))
    assert int(list_eval.runs_group_lanes(*args[1:], k_tile=k,
                                          seg_pack=seg_pack).sum()) == need
    assert list_eval.runs_lanes_staged(*args, **kw) == need


def test_grouped_bh_3d_on_card_matches_cpu(cuda):
    from nbody_tpu_torch.ops import bh3d

    p, m = _cloud3(8192, 6, cuda)
    got, ovf = bh3d.bh3_accelerations_grouped(
        p, m, g=G, group_size=512, seg_pack=4, eval_k_tile=512,
        return_diagnostics=True)
    want = bh3d.bh3_accelerations_grouped(p.cpu(), m.cpu(), g=G,
                                          group_size=512, seg_pack=4,
                                          eval_k_tile=512)
    assert int(ovf.sum()) == 0
    assert (got.cpu() - want).abs().max() <= TOL * want.abs().max()


def _split_tables(dims, seed, device):
    """Synthetic K4 tables with ragged lens: per quarter, approx, ext and
    direct sections each empty, partial or full; direct entries whose
    windows leave real bodies outside [lo, hi); lens past the tables."""
    rng = np.random.default_rng(seed)
    g, s, a_w, e_w, ns, k = 3, 512, 700, 300, 8192, 256
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
    t_cap = 6
    tiles = np.zeros((4 * g, 3, t_cap), np.int32)
    lens = np.zeros((3, 4 * g), np.int32)
    for i in range(4 * g):
        lens[0, i] = (0, 123, a_w, 5 * a_w)[(i // 4) % 4]  # per group
        lens[1, i] = (0, 1, 257, e_w, 4 * e_w)[i % 5]  # past E: clamped
        ext[i, dims, :min(lens[1, i], e_w)] = G * rng.uniform(
            0.1, 0.5, min(lens[1, i], e_w))
        n_d = (0, 2, t_cap, t_cap + 3)[i % 4]  # past T: clamped
        for j in range(min(n_d, t_cap)):
            start = 128 * int(rng.integers(0, ns // 128))
            lo = int(rng.integers(0, k // 2))
            tiles[i, :, j] = (start, lo, int(rng.integers(lo, k + 1)))
        lens[2, i] = n_d
    for gi in range(g):  # gm = 0 past the group's approx lanes, as built
        approx[gi, dims, lens[0, 4 * gi]:] = 0.0
    return [torch.tensor(a, device=device)
            for a in (targets, approx, ext, srct, tiles, lens)], k


@pytest.mark.parametrize("dims", [2, 3])
def test_k4_matches_twin_on_ragged_tables(cuda, dims):
    args, k = _split_tables(dims, dims, cuda)
    before = counter("ops.list_eval.SPLIT_LAUNCHES")
    got = list_eval.list_eval_runs_split(*args, softening=1e-15, k_tile=k)
    want = list_eval.list_eval_runs_split_plain(*args, softening=1e-15,
                                                k_tile=k)
    torch.cuda.synchronize()
    assert counter("ops.list_eval.SPLIT_LAUNCHES") == before + 1
    assert torch.isfinite(got).all() and want.abs().max() > 0
    assert (got - want).abs().max() <= TOL * want.abs().max()


def _split_engine_tables(p, m, monkeypatch):
    """The (args, kwargs) one 3D dense + split grouped-BH pass hands K4."""
    from nbody_tpu_torch.ops import bh3d

    seen = {}
    orig = list_eval.list_eval_runs_split

    def spy(*a, **kw):
        seen["a"], seen["kw"] = a, kw
        return orig(*a, **kw)

    monkeypatch.setattr(list_eval, "list_eval_runs_split", spy)
    bh3d.bh3_accelerations_grouped(p, m, g=G, group_size=512,
                                   collect="dense", split_eval=True)
    monkeypatch.setattr(list_eval, "list_eval_runs_split", orig)
    return seen["a"], seen["kw"]


def test_k4_matches_twin_on_engine_tables(cuda, monkeypatch):
    p, m = _cloud3(32768, 7, cuda)
    a, kw = _split_engine_tables(p, m, monkeypatch)
    assert a[2].shape[0] == 4 * a[0].shape[0]  # [4G, 8, E]
    before = counter("ops.list_eval.SPLIT_LAUNCHES")
    got = list_eval.list_eval_runs_split(*a, **kw)
    want = list_eval.list_eval_runs_split_plain(*a, **kw)
    assert counter("ops.list_eval.SPLIT_LAUNCHES") == before + 1
    assert (got - want).abs().max() <= TOL * want.abs().max()


def test_cuda_tensors_never_reach_the_twins(cuda, monkeypatch):
    """The split pass on the card launches K4, the runs passes K2 and K3,
    and never a twin; on the CPU the same passes are the twins'; the two
    agree."""
    from nbody_tpu_torch.ops import bh3d

    def refuse(*a, **kw):
        raise AssertionError("a CUDA tensor reached a plain twin")

    p, m = _cloud3(8192, 8, cuda)
    passes = (("SPLIT_LAUNCHES", -1.0, dict(collect="dense",
                                            split_eval=True)),
              ("KERNEL_LAUNCHES", float("inf"), dict(split_eval=False)),
              ("PACKED_LAUNCHES", -1.0, dict(split_eval=False, seg_pack=4,
                                             eval_k_tile=512)))
    for key, gate, kw in passes:
        monkeypatch.setattr(bh_grouped, "SEG_PACK_MIN_RUN_LANES", gate)
        want = bh3d.bh3_accelerations_grouped(p.cpu(), m.cpu(), g=G,
                                              group_size=512, **kw)
        with monkeypatch.context() as mp:
            for name in ("list_eval_runs_plain",
                         "list_eval_runs_split_plain"):
                mp.setattr(list_eval, name, refuse)
            before = counter(f"ops.list_eval.{key}")
            got, ovf = bh3d.bh3_accelerations_grouped(
                p, m, g=G, group_size=512, return_diagnostics=True, **kw)
            torch.cuda.synchronize()
            assert counter(f"ops.list_eval.{key}") == before + 1
        assert int(ovf.sum()) == 0
        assert (got.cpu() - want).abs().max() <= TOL * want.abs().max()


def test_k4_rejects_what_it_cannot_take(cuda):
    args, k = _split_tables(3, 0, cuda)
    with pytest.raises(ValueError, match="int32"):
        list_eval.list_eval_runs_split(*args[:5], args[5].long(),
                                       softening=0.0, k_tile=k)
    with pytest.raises(ValueError, match="4G"):
        list_eval.list_eval_runs_split(args[0], args[1], args[2][:4],
                                       *args[3:], softening=0.0, k_tile=k)
    # a k_tile past what a block's shared memory could stage whole now
    # runs: the kernel streams every tile through one chunk
    got = list_eval.list_eval_runs_split(*args, softening=0.0,
                                         k_tile=1 << 15)
    want = list_eval.list_eval_runs_split_plain(*args, softening=0.0,
                                                k_tile=1 << 15)
    assert torch.isfinite(got).all() and want.abs().max() > 0
    assert (got - want).abs().max() <= TOL * want.abs().max()


def _packed_split_tables(dims, seed, device, s, k, t_cap, sections,
                         width=(40, 256)):
    """K4 tables for the packed streaming: per quarter, ``sections[i %
    len]`` names which of approx / ext / direct it holds ("a", "e", "d");
    direct entries are ``width``-lane windows at random starts (so they
    straddle 512-lane chunks), some empty (lo == hi); the approx and
    extension tails past lens are gm = 0, as the engine leaves them."""
    rng = np.random.default_rng(seed)
    g, a_w, e_w, ns = 2, 3 * k + 77, 2 * k + 5, 1 << 14
    targets = rng.uniform(-0.1, 0.1, (g, s, dims)).astype(np.float32)
    approx = np.zeros((g, 8, a_w), np.float32)
    approx[:, :dims] = rng.uniform(-0.1, 0.1, (g, dims, a_w))
    ext = np.zeros((4 * g, 8, e_w), np.float32)
    ext[:, :dims] = rng.uniform(-0.1, 0.1, (4 * g, dims, e_w))
    srct = np.zeros((8, ns + k), np.float32)
    srct[:dims, :ns] = rng.uniform(-0.1, 0.1, (dims, ns))
    srct[dims, :ns] = G * rng.uniform(0.1, 0.5, ns)
    tiles = np.zeros((4 * g, 3, t_cap), np.int32)
    lens = np.zeros((3, 4 * g), np.int32)
    a_n = [int(rng.integers(1, a_w + 1)) for _ in range(g)]
    for gi in range(g):
        approx[gi, dims, :a_n[gi]] = G * rng.uniform(0.1, 0.5, a_n[gi])
    for i in range(4 * g):
        sec = sections[i % len(sections)]
        if "a" in sec:
            lens[0, i] = a_n[i // 4]
        if "e" in sec:
            lens[1, i] = int(rng.integers(1, e_w + 1))
            ext[i, dims, :lens[1, i]] = G * rng.uniform(0.1, 0.5, lens[1, i])
        if "d" in sec:
            for j in range(t_cap):
                start = 128 * int(rng.integers(0, ns // 128))
                lo = int(rng.integers(0, k))
                hi = min(k, lo + int(rng.integers(*width)))
                tiles[i, :, j] = (start, lo, hi if j % 7 else lo)
            lens[2, i] = t_cap
    return [torch.tensor(a, device=device)
            for a in (targets, approx, ext, srct, tiles, lens)]


def _lanes_needed(args, k):
    """The lanes K4 must stage, summed over the quarters: approx and
    extension lanes below lens, direct [lo, hi) clipped to the window and
    the source table."""
    _, approx, ext, srct, tiles, lens = (a.cpu() for a in args)
    a_w, e_w, npad, t_cap = (approx.shape[2], ext.shape[2], srct.shape[1],
                             tiles.shape[2])
    total = 0
    for i in range(lens.shape[1]):
        total += min(int(lens[0, i]), a_w) + min(int(lens[1, i]), e_w)
        for e in range(min(int(lens[2, i]), t_cap)):
            start, lo, hi = (int(x) for x in tiles[i, :, e])
            total += max(0, min(hi, k, npad - start) - max(lo, 0))
    return total


PACKED_CASES = {
    # (S, k_tile, entries a quarter, sections a quarter)
    "straddle": (512, 256, 40, ["aed"]),
    "no-direct": (512, 256, 12, ["ae", "aed", "a", "e"]),
    "only-direct": (512, 256, 12, ["d", "aed"]),
    "k-past-chunk": (512, 2048, 12, ["aed", "d"]),
    "many-units": (256, 256, 700, ["aed", "d"]),
    "five-blocks-a-quarter": (4400, 512, 30, ["aed", "ad"]),
}


@pytest.mark.parametrize("case", sorted(PACKED_CASES))
@pytest.mark.parametrize("dims", [2, 3])
def test_k4_packed_streaming_matches_twin(cuda, dims, case):
    s, k, t_cap, sections = PACKED_CASES[case]
    args = _packed_split_tables(dims, len(case) + dims, cuda, s, k, t_cap,
                                sections)
    before = counter("ops.list_eval.SPLIT_LAUNCHES")
    got = list_eval.list_eval_runs_split(*args, softening=1e-15, k_tile=k)
    want = list_eval.list_eval_runs_split_plain(*args, softening=1e-15,
                                                k_tile=k)
    torch.cuda.synchronize()
    assert counter("ops.list_eval.SPLIT_LAUNCHES") == before + 1
    assert torch.isfinite(got).all() and want.abs().max() > 0
    assert (got - want).abs().max() <= TOL * want.abs().max()
    # the kernel stages exactly the lanes the tables need
    need = _lanes_needed(args, k)
    assert list_eval.split_lanes_staged(
        *args, softening=1e-15, k_tile=k) == need
    assert int(list_eval.split_quarter_lanes(*args[1:], k_tile=k).sum()) == (
        need)


# -- K5, K6 and K7 ---------------------------------------------------------------


@pytest.mark.parametrize("n", [1037, 65536])
@pytest.mark.parametrize("dims", [2, 3])
def test_k5_matches_twin(cuda, dims, n):
    rng = np.random.default_rng(n + dims)
    p = torch.tensor(rng.uniform(-0.1, 0.1, (n, dims)), dtype=torch.float32,
                     device=cuda)
    m = torch.tensor(10 ** rng.uniform(-1, np.log10(0.5), n),
                     dtype=torch.float32, device=cuda)
    before = counter("ops.allpairs.POTENTIAL_LAUNCHES")
    got = allpairs.allpairs_potential(p, m, g=G)
    want = allpairs.allpairs_potential_plain(p, m, g=G)
    assert counter("ops.allpairs.POTENTIAL_LAUNCHES") == before + 1
    assert (got - want).abs().max() <= TOL * want.abs().max()


@pytest.mark.parametrize("n", [1037, 5000, 70001])
@pytest.mark.parametrize("dims", [2, 3])
def test_k5_every_shape_matches_twin_and_each_other(cuda, monkeypatch, dims,
                                                    n):
    """K5 at every launch shape the shape function can pick, at N that
    leave a partial block and a partial source tile: each within TOL of
    the twin, and all bit-equal (every shape sums in the same order)."""
    rng = np.random.default_rng(n + 10 * dims)
    p = torch.tensor(rng.uniform(-0.1, 0.1, (n, dims)), dtype=torch.float32,
                     device=cuda)
    mass = 10 ** rng.uniform(-1, np.log10(0.5), n)
    mass[::13] = 0.0  # massless bodies are never staged
    m = torch.tensor(mass, dtype=torch.float32, device=cuda)
    want = allpairs.allpairs_potential_plain(p, m, g=G)
    outs = []
    tpt = allpairs.POTENTIAL_TARGETS_PER_THREAD
    for slices in allpairs.POTENTIAL_SLICES:
        monkeypatch.setattr(allpairs, "potential_launch_shape",
                            lambda n_, r=slices: (tpt, r, 0))
        outs.append(allpairs.allpairs_potential(p, m, g=G))
        assert (outs[-1] - want).abs().max() <= TOL * want.abs().max()
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


def test_potential_energy_scalable_takes_k5_on_the_card(cuda):
    from nbody_tpu_torch import physics
    from nbody_tpu_torch.state import from_numpy

    rng = np.random.default_rng(3)
    n = 8192
    st = from_numpy(10 ** rng.uniform(-1, np.log10(0.5), n),
                    rng.uniform(-0.1, 0.1, (n, 3)), np.zeros((n, 3)),
                    device="cpu")
    want = physics.potential_energy_scalable(st, G)
    before = counter("ops.allpairs.POTENTIAL_LAUNCHES")
    got = physics.potential_energy_scalable(
        from_numpy(st.masses, st.positions, st.velocities, device=cuda), G)
    assert counter("ops.allpairs.POTENTIAL_LAUNCHES") == before + 1
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


@pytest.mark.parametrize("dtype,launches", [(torch.float64, 0),
                                            (torch.bfloat16, 1)])
def test_potential_energy_scalable_dtypes_on_the_card(cuda, dtype, launches):
    """float64 keeps the chunked precision route on the card; bfloat16 is
    evaluated in float32 by K5 (within bfloat16's rounding of the
    inputs)."""
    from nbody_tpu_torch import physics
    from nbody_tpu_torch.state import from_numpy

    rng = np.random.default_rng(5)
    n = 8192
    args = (10 ** rng.uniform(-1, np.log10(0.5), n),
            rng.uniform(-0.1, 0.1, (n, 2)), np.zeros((n, 2)))
    want = physics.potential_energy_scalable(
        from_numpy(*args, dtype=torch.float64, device="cpu"), G)
    before = counter("ops.allpairs.POTENTIAL_LAUNCHES")
    got = physics.potential_energy_scalable(
        from_numpy(*args, dtype=dtype, device=cuda), G)
    assert counter("ops.allpairs.POTENTIAL_LAUNCHES") == before + launches
    rel = 1e-12 if dtype == torch.float64 else 2e-2
    assert abs(float(got) - float(want)) <= rel * abs(float(want))


def _packed_lists(dims, seed, device, g=9, s=300, off=4096, width=6144):
    """A two-section packed list [G, 8, K] with random occupied lengths,
    zero gm past each length inside its tile and data in later tiles."""
    rng = np.random.default_rng(seed)
    tgt = rng.uniform(-1, 1, (g, s, dims)).astype(np.float32)
    src = np.zeros((g, 8, off + width), np.float32)
    src[:, :dims] = rng.uniform(-1, 1, (g, dims, off + width))
    src[:, dims] = rng.uniform(1e-4, 1e-3, (g, off + width))
    a_n = rng.integers(0, off + 1, g)
    d_n = rng.integers(0, width + 1, g)
    a_n[0], d_n[0] = 0, 0
    for gi in range(g):
        src[gi, dims, a_n[gi]:-(-a_n[gi] // 2048) * 2048] = 0.0
        src[gi, dims, off + d_n[gi]:off + -(-d_n[gi] // 2048) * 2048] = 0.0
    lens = np.stack([a_n, d_n]).astype(np.int32)
    return [torch.tensor(a, device=device) for a in (tgt, src, lens)], off


PADDED = {
    "K6": (lambda *a, **kw: list_eval.list_eval_pallas(*a, **kw),
           lambda *a, **kw: list_eval.list_eval_pallas_plain(*a, **kw),
           "GRID_LAUNCHES", {}),
    "K6-compensated": (
        lambda *a, **kw: list_eval.list_eval_pallas(*a, **kw),
        lambda *a, **kw: list_eval.list_eval_pallas_plain(*a, **kw),
        "GRID_LAUNCHES", {"compensated": True}),
    "K7": (lambda *a, **kw: list_eval.list_eval_dynamic(*a, **kw),
           lambda *a, **kw: list_eval.list_eval_dynamic_plain(*a, **kw),
           "DYNAMIC_LAUNCHES", {}),
}


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("kernel", sorted(PADDED))
def test_padded_list_kernels_match_twin(cuda, kernel, dims):
    fn, twin, key, extra = PADDED[kernel]
    args, off = _packed_lists(dims, dims, cuda)
    kw = dict(softening=1e-15, section_offset=off, k_tile=2048, **extra)
    before = counter(f"ops.list_eval.{key}")
    got = fn(*args, **kw)
    want = twin(*args, **kw)
    assert counter(f"ops.list_eval.{key}") == before + 1
    assert torch.all(got[0] == 0.0)  # the empty group
    assert (got - want).abs().max() <= TOL * want.abs().max()


@pytest.mark.parametrize("s", [64, 270336], ids=["r8", "r1"])
def test_k6_compensation_against_float64(cuda, s):
    """On the card, as tests/test_torch_list_eval.py checks the twin:
    Kahan across 2,048 tiles of 128 lanes is at least as close to a
    float64 evaluation as the plain running sum, with 8 slices per target
    (S = 64) and with one (S = 270,336; the first 64 targets compared)."""
    assert list_eval.list_launch_shape(1, s)[0] == (8 if s == 64 else 1)
    rng = np.random.default_rng(7)
    k = 1 << 18
    tgt = np.full((1, s, 2), -4.0, np.float32)
    tgt[0, :, 0] += rng.uniform(-1, 1, s)
    src = np.zeros((1, 8, k), np.float32)
    src[0, :2] = rng.uniform(0, 1, (2, k))
    src[0, 2] = rng.uniform(1e-3, 2e-3, k)
    args = [torch.tensor(a, device=cuda) for a in (
        tgt, src, np.array([[k], [0]], np.int32))]
    kw = dict(softening=1e-15, section_offset=k, k_tile=128)
    plain = list_eval.list_eval_pallas(*args, **kw)[:, :64]
    plain = plain.double().cpu().numpy()
    comp = list_eval.list_eval_pallas(*args, compensated=True, **kw)[:, :64]
    comp = comp.double().cpu().numpy()
    x = src[0].astype(np.float64)
    disp = x[None, :2, :] - tgt[0, :64, :, None].astype(np.float64)
    d2 = (disp ** 2).sum(1)
    exact = ((x[2] / (d2 * (np.sqrt(d2) + 1e-15)))[:, None, :]
             * disp).sum(-1)[None]
    err_p, err_c = (np.abs(a - exact).max() for a in (plain, comp))
    assert err_c <= err_p and err_c <= 1e-6 * np.abs(exact).max()


def _live_lane_lists(dims, seed, device, g, s):
    """A packed list [G, 8, K] (section offset 4,096, direct section of
    6,144 lanes, 2,048-lane tiles) whose gm is 0 on random 8-lane blocks
    and past each section's length inside its tile (data in later tiles).
    Group 0 is empty, group 1 has a_n = 0, group 2 d_n = 0, group 3 an
    occupied approx tile without a live lane; group 4's first targets sit
    on a direct lane with gm = 0 and on one with gm > 0 (the d2 > 0
    guard)."""
    rng = np.random.default_rng(seed)
    off, width, kt = 4096, 6144, 2048
    k = off + width
    tgt = rng.uniform(-1, 1, (g, s, dims)).astype(np.float32)
    src = np.zeros((g, 8, k), np.float32)
    src[:, :dims] = rng.uniform(-1, 1, (g, dims, k))
    src[:, dims] = rng.uniform(1e-4, 1e-3, (g, k))
    src[:, dims] *= np.repeat(rng.random((g, k // 8)) < 0.5, 8, axis=1)
    a_n = rng.integers(1, off + 1, g)
    d_n = rng.integers(1, width + 1, g)
    a_n[0] = d_n[0] = a_n[1] = d_n[2] = 0
    a_n[3] = off
    src[3, dims, kt:2 * kt] = 0.0
    d_n[4] = max(d_n[4], 8 * 16)
    for j in range(16):
        lane = off + 8 * j
        src[4, :dims, lane:lane + 2] = tgt[4, j, :, None]
        src[4, dims, lane:lane + 2] = (0.0, 5e-4)
    for gi in range(g):
        src[gi, dims, a_n[gi]:-(-a_n[gi] // kt) * kt] = 0.0
        src[gi, dims, off + d_n[gi]:off + -(-d_n[gi] // kt) * kt] = 0.0
    lens = np.stack([a_n, d_n]).astype(np.int32)
    return [torch.tensor(a, device=device) for a in (tgt, src, lens)], off


# (G, S) making the launch-shape function pick 1 and 8 slices per target;
# neither S is a multiple of the block's targets (256, 32)
LIVE_SHAPES = {"r1": (66, 4100), "r8": (9, 300)}


@pytest.mark.parametrize("shape", sorted(LIVE_SHAPES))
@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("kernel", sorted(PADDED))
def test_padded_list_kernels_on_live_lane_lists(cuda, kernel, dims, shape):
    g, s = LIVE_SHAPES[shape]
    assert list_eval.list_launch_shape(g, s)[0] == int(shape[1:])
    fn, twin, key, extra = PADDED[kernel]
    args, off = _live_lane_lists(dims, dims + g, cuda, g, s)
    kw = dict(softening=1e-15, section_offset=off, k_tile=2048, **extra)
    before = counter(f"ops.list_eval.{key}")
    got = fn(*args, **kw)
    want = twin(*args, **kw)
    torch.cuda.synchronize()
    assert counter(f"ops.list_eval.{key}") == before + 1
    assert torch.all(got[0] == 0.0) and torch.isfinite(got).all()
    assert want[1:4].abs().min() > 0  # a_n = 0, d_n = 0, an empty tile
    assert (got - want).abs().max() <= TOL * want.abs().max()


@pytest.mark.parametrize("shape", sorted(LIVE_SHAPES))
@pytest.mark.parametrize("dims", [2, 3])
def test_k6_and_k7_are_bit_equal(cuda, dims, shape):
    """On a list whose approx tiles end before the direct section, K6's
    skip rule and K7's walk visit the same tiles in the same order."""
    g, s = LIVE_SHAPES[shape]
    args, off = _live_lane_lists(dims, 10 + dims + g, cuda, g, s)
    kw = dict(softening=1e-15, section_offset=off, k_tile=2048)
    assert torch.equal(list_eval.list_eval_pallas(*args, **kw),
                       list_eval.list_eval_dynamic(*args, **kw))


def test_padded_list_kernels_take_tiles_past_shared_memory(cuda):
    """K6/K7 stream a tile in chunks, so a 16,384-lane tile (256 KB as
    whole float4, more than a block's 227 KB of shared memory) is taken."""
    args, off = _packed_lists(2, 4, cuda, g=3, s=64, off=16384,
                              width=16384)
    kw = dict(softening=1e-15, section_offset=off, k_tile=16384)
    assert list_eval.resolve_list_tiles(64, 2 * off, off, 16384)[0] == 16384
    for fn, twin, _, extra in PADDED.values():
        got, want = fn(*args, **kw, **extra), twin(*args, **kw, **extra)
        assert (got - want).abs().max() <= TOL * want.abs().max()


@pytest.mark.parametrize("mode", ["grid", "dynamic", "compensated"])
def test_padded_routes_never_reach_the_twins(cuda, monkeypatch, mode):
    """A 3D force pass on the grid / dynamic / compensated route launches
    K6 or K7 on the card and never a twin; it agrees with the CPU pass."""
    from nbody_tpu_torch.ops import bh3d

    p, m = _cloud3(8192, 9, cuda)
    kw = dict(g=G, group_size=512, eval_mode=None if mode == "compensated"
              else mode, compensated=mode == "compensated")
    want = bh3d.bh3_accelerations_grouped(p.cpu(), m.cpu(), **kw)

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain twin")

    for name in ("list_eval_pallas_plain", "list_eval_dynamic_plain",
                 "list_eval_runs_plain"):
        monkeypatch.setattr(list_eval, name, refuse)
    key = "DYNAMIC_LAUNCHES" if mode == "dynamic" else "GRID_LAUNCHES"
    before = (counter(f"ops.list_eval.{key}"),
              counter("ops.list_eval.KERNEL_LAUNCHES"))
    got, ovf = bh3d.bh3_accelerations_grouped(p, m, return_diagnostics=True,
                                              **kw)
    torch.cuda.synchronize()
    assert counter(f"ops.list_eval.{key}") == before[0] + 1
    assert counter("ops.list_eval.KERNEL_LAUNCHES") == before[1]
    assert int(ovf.sum()) == 0
    assert (got.cpu() - want).abs().max() <= TOL * want.abs().max()


def test_padded_list_kernels_reject_what_they_cannot_take(cuda):
    args, off = _packed_lists(2, 1, cuda)
    kw = dict(softening=0.0, section_offset=off)
    with pytest.raises(ValueError, match="int32"):
        list_eval.list_eval_pallas(*args[:2], args[2].long(), **kw)
    with pytest.raises(ValueError, match="float32"):
        list_eval.list_eval_dynamic(args[0].double(), *args[1:], **kw)
    with pytest.raises(ValueError, match="not tileable"):
        list_eval.list_eval_dynamic(*args, softening=0.0, section_offset=100)


# -- the fused run as a CUDA graph, and the exact per-body Barnes-Hut ------

def _sim_pair(cuda, **kw):
    """Two Simulations of one config from one initial state on the card."""
    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.models.simulation import Simulation
    from nbody_tpu_torch.rng import random_state
    from nbody_tpu_torch.state import SimState

    cfg = SimConfig(seed=2, **kw)
    s0 = random_state(cfg, device=cuda)

    def copy():
        return SimState(**{f: getattr(s0, f).clone() for f in (
            "masses", "positions", "velocities", "time", "step",
            "overflow")})

    return s0, Simulation(cfg, state=copy()), Simulation(cfg, state=copy())


@pytest.mark.parametrize("engine,n,counter", [
    ("barnes_hut", 8192, ("list_eval", "KERNEL_LAUNCHES")),
    ("allpairs", 4096, ("allpairs", "KERNEL_LAUNCHES"))])
def test_graph_route_equals_eager_loop(cuda, engine, n, counter):
    """The graph replays the eager step's kernels in its order: a fused
    run without overflow ends bit-equal to the contract loop, and each
    replay counts its kernels' launches (warm-up 1 + 3 replays)."""
    from nbody_tpu_torch.utils import profiling

    name = "ops.{}.{}".format(*counter)
    s0, eager, fused = _sim_pair(cuda, n_bodies=n, n_steps=3, engine=engine)
    loop, _ = eager.run_contract()
    before = profiling.counter(name)
    final = fused.run_scan()
    torch.cuda.synchronize()
    assert fused.last_scan_route == "graph"
    assert profiling.counter(name) - before == 4
    assert torch.equal(final.positions, loop.positions)
    assert torch.equal(final.velocities, loop.velocities)
    assert int(final.step) == 3 and float(final.time) == 3.0
    np.testing.assert_array_equal(fused.last_scan_overflow, [0, 0, 0])
    _, _, traj_sim = _sim_pair(cuda, n_bodies=n, n_steps=3, engine=engine)
    final_t, traj = traj_sim.run_scan_trajectory()
    assert traj.shape == (4, n, 2)
    assert torch.equal(traj[0], s0.positions)
    assert torch.equal(traj[-1], loop.positions)
    assert torch.equal(final_t.positions, loop.positions)


@pytest.mark.parametrize("theta,cap", [(0.5, 256), (0.05, 16)])
def test_exact_bh_on_the_card_matches_cpu(cuda, theta, cap):
    from nbody_tpu_torch.ops import barnes_hut

    p, m = _cloud(8192, 21, cuda)
    kw = dict(g=G, theta=theta, frontier_cap=cap, return_diagnostics=True)
    got, ovf = barnes_hut.bh_accelerations(p, m, **kw)
    want, want_ovf = barnes_hut.bh_accelerations(p.cpu(), m.cpu(), **kw)
    assert (got.cpu() - want).abs().max() <= TOL * want.abs().max()
    assert torch.equal(ovf.cpu(), want_ovf)
    assert bool(want_ovf.any()) == (cap == 16)


def test_capture_with_a_host_read_raises(cuda):
    """A step that reads the host cannot be captured, and run_scan raises
    rather than falling back to a step-by-step run."""
    from nbody_tpu_torch.physics import integrate

    _, sim, _ = _sim_pair(cuda, n_bodies=1024, n_steps=2, engine="allpairs")

    def step(state):
        if state.positions.abs().max().item() < 0:  # a deliberate sync
            raise AssertionError
        return integrate(state, torch.zeros_like(state.positions), 1.0)

    sim.step_fn = step
    with pytest.raises(RuntimeError):
        sim.run_scan()
    torch.cuda.synchronize()


# -- the gates as conditional nodes, and the leaf sums ---------------------

def test_device_if_runs_its_branch_on_the_replays_that_take_it(cuda):
    """One IF node around a K1 launch and an allocating op: the branch's
    writes land only on replays whose predicate is true, its launches and
    its device-counted value count only then (settle); the capture
    itself counts nothing."""
    from nbody_tpu_torch.ops import _graph
    from nbody_tpu_torch.utils import profiling

    p, m = _cloud(2048, 5, cuda)
    out = torch.zeros_like(p)
    pred = torch.zeros((), dtype=torch.bool, device=cuda)

    def branch():
        out.copy_(allpairs.allpairs_accelerations(p, m, g=G) * 2)

    branch()
    want = out.clone()
    counts = _graph.CaptureCounts(cuda)
    graph = torch.cuda.CUDAGraph()
    before = profiling.counter_values()
    with _graph.counting(counts), torch.cuda.graph(graph):
        assert _graph.device_if(pred, branch, "k1") is None
        profiling.count("ops.collect_dense3.ESCAPED_GROUPS",
                        pred.to(torch.int64) * 3)
    key = "ops.allpairs.KERNEL_LAUNCHES"
    assert profiling.counter_values() == before
    assert counts.slots[0] == {key: 1} and counts.per_replay == {}
    for v in (False, True, True, False):
        pred.fill_(v)
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want) if v else not out.any()
    escaped = counter("ops.collect_dense3.ESCAPED_GROUPS")
    k1 = counter("ops.allpairs.KERNEL_LAUNCHES")
    assert counts.settle() == {"k1": 2, "collect_dense3.ESCAPED_GROUPS": 6}
    assert counter("ops.allpairs.KERNEL_LAUNCHES") - k1 == 2
    assert counter("ops.collect_dense3.ESCAPED_GROUPS") - escaped == 6


def test_failed_capture_leaves_later_branch_pools_intact(cuda):
    """A capture that meets a host read raises; the allocator entry torch
    leaves for its pool is released (``_graph.capture``), so a later
    graph's branch pool can be torn down (it aborted the process
    before)."""
    import gc

    from nbody_tpu_torch.ops import _graph
    from nbody_tpu_torch.physics import integrate

    _, sim, _ = _sim_pair(cuda, n_bodies=1024, n_steps=2, engine="allpairs")

    def step(state):
        if state.positions.abs().max().item() < 0:  # a deliberate sync
            raise AssertionError
        return integrate(state, torch.zeros_like(state.positions), 1.0)

    sim.step_fn = step
    with pytest.raises(RuntimeError):
        sim.run_scan()
    out = torch.zeros(4, device=cuda)
    pred = torch.ones((), dtype=torch.bool, device=cuda)
    counts = _graph.CaptureCounts(cuda)
    graph = torch.cuda.CUDAGraph()
    with _graph.counting(counts):
        _graph.capture(graph, lambda: _graph.device_if(
            pred, lambda: out.copy_(torch.arange(4, device=cuda) * 2.0)),
            cuda)
    graph.replay()
    torch.cuda.synchronize()
    assert out.tolist() == [0.0, 2.0, 4.0, 6.0]
    del counts, graph
    gc.collect()
    torch.cuda.synchronize()


# route -> (config, forced seg_pack, tiny windows, the branch it must take)
GATED = {
    "plain-K2": (dict(n_bodies=4096, group_size=512, direct_cell_max=32),
                 4, False, "plain (K2)"),
    "packed-K3": (dict(n_bodies=4096, group_size=512, direct_cell_max=64),
                  4, False, "packed (K3)"),
    "dense": (dict(n_bodies=8192, collect3="dense"), None, False, None),
    "dense-spill": (dict(n_bodies=8192, collect3="dense", group_size=512,
                         init_mode="blobs"), None, True, "spill"),
}


@pytest.mark.parametrize("route", list(GATED))
def test_3d_graph_equals_loop_on_gated_routes(cuda, monkeypatch, route):
    """3D Barnes-Hut through the packing gate and the dense collector's
    spill gate, fused as one CUDA graph, ends bit-equal to the loop with
    the retry off, and its branch counts show the branch it took."""
    from nbody_tpu_torch.ops import bh3d, collect_dense3

    kw, seg_pack, tiny, branch = GATED[route]
    if seg_pack:
        orig = bh3d.resolve_route_3d
        monkeypatch.setattr(bh3d, "resolve_route_3d", lambda *a, **k: orig(
            *a, **dict(k, seg_pack=seg_pack, eval_k_tile=512)))
    if tiny:
        monkeypatch.setattr(collect_dense3, "window_schedule_3d",
                            lambda md: (1, 2, 4, 6, 6, 6, 6, 6)[:md + 1])
    _, eager, fused = _sim_pair(cuda, n_dim=3, engine="barnes_hut",
                                n_steps=3, adaptive_caps=False, **kw)
    loop, _ = eager.run_contract()
    final = fused.run_scan()
    torch.cuda.synchronize()
    assert fused.last_scan_route == "graph"
    assert torch.equal(final.positions, loop.positions)
    assert torch.equal(final.velocities, loop.velocities)
    taken = fused.last_branch_counts
    if branch is not None:
        assert taken[branch] > 0, taken
    if route == "dense":
        assert taken["spill"] == 0
    if tiny:
        assert taken["collect_dense3.ESCAPED_GROUPS"] > 0


@pytest.mark.parametrize("case", ["2d-uniform", "3d-heavy", "one-leaf",
                                  "f64"])
def test_leaf_sums_bit_equal_to_twin_and_deterministic(cuda, case):
    from nbody_tpu_torch.ops import tree

    w, n_leaf, n = (8, 4 ** 7, 40960) if case == "2d-uniform" else (
        16, 8 ** 6, 200000)
    rng = np.random.default_rng(7)
    codes = rng.integers(0, n_leaf, n)
    if case == "3d-heavy":
        codes = np.where(rng.random(n) < 0.8, rng.integers(0, 5, n) * 999,
                         codes)
    elif case == "one-leaf":
        codes[:] = 12
    dtype = torch.float64 if case == "f64" else torch.float32
    rows = torch.tensor(rng.uniform(-0.1, 0.5, (n, w)), dtype=dtype,
                        device=cuda)
    lengths = torch.tensor(np.bincount(codes, minlength=n_leaf),
                           dtype=torch.int64, device=cuda)
    before = counter("ops.tree.LEAF_SUM_LAUNCHES")
    got = tree.leaf_sums(rows, lengths)
    again = tree.leaf_sums(rows, lengths)
    assert counter("ops.tree.LEAF_SUM_LAUNCHES") == before + 2
    want = tree.leaf_sums_plain(rows, lengths)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, again)
    assert torch.equal(got.cpu(), tree.leaf_sums_plain(rows.cpu(),
                                                       lengths.cpu()))


@pytest.mark.parametrize("case", ["around-c", "around-c-f64", "around-c-2d",
                                  "heavy-f64", "narrow"])
def test_leaf_sums_bit_equal_to_twin_around_the_chunk(cuda, case):
    """Leaves of C - 1, C, C + 1 and 2C + 1 rows (C = tree.LEAF_CHUNK)
    among light and medium ones, heavy leaves in f64, and rows narrower
    than 16 bytes (padded by the wrapper): the kernels give the two-level
    twin's bits, the same at every launch, and the CPU twin's."""
    from nbody_tpu_torch.ops import tree

    c = tree.LEAF_CHUNK
    rng = np.random.default_rng(11)
    w = {"around-c-2d": 8, "narrow": 2}.get(case, 16)
    if case == "heavy-f64":
        n_leaf, n = 8 ** 6, 200000
        codes = np.where(rng.random(n) < 0.8, rng.integers(0, 5, n) * 999,
                         rng.integers(0, n_leaf, n))
        lengths = np.bincount(codes, minlength=n_leaf)
        assert lengths.max() > c
    else:
        lengths = np.concatenate([
            rng.integers(0, 3, 1000),
            [c - 1, 0, c, 33, c + 1, 1, 2 * c + 1, 32, 31, 200],
            rng.integers(0, 40, 1000)])
    dtype = torch.float64 if "f64" in case else torch.float32
    rows = torch.tensor(rng.uniform(-0.1, 0.5, (int(lengths.sum()), w)),
                        dtype=dtype, device=cuda)
    lengths = torch.tensor(lengths, dtype=torch.int64, device=cuda)
    before = counter("ops.tree.LEAF_SUM_LAUNCHES")
    got = tree.leaf_sums(rows, lengths)
    again = tree.leaf_sums(rows, lengths)
    assert counter("ops.tree.LEAF_SUM_LAUNCHES") == before + 2
    want = tree.leaf_sums_plain(rows, lengths)
    torch.cuda.synchronize()
    assert got.shape == (lengths.shape[0], w)
    assert torch.equal(got, want)
    assert torch.equal(got, again)
    assert torch.equal(got.cpu(), tree.leaf_sums_plain(rows.cpu(),
                                                       lengths.cpu()))


def test_leaf_sums_graph_replay_equals_eager(cuda):
    """The wrapper captured in a CUDA graph (``_graph.capture``, counting
    into a ``CaptureCounts``): a replay on new rows gives the eager
    call's bits on them."""
    from nbody_tpu_torch.ops import _graph, tree

    c = tree.LEAF_CHUNK
    rng = np.random.default_rng(12)
    lengths = np.concatenate([rng.integers(0, 3, 8 ** 5 - 3),
                              [3 * c + 5, c + 1, 40]])
    lengths = torch.tensor(rng.permutation(lengths), dtype=torch.int64,
                           device=cuda)
    n = int(lengths.sum())
    rows = torch.tensor(rng.uniform(-0.1, 0.5, (n, 16)),
                        dtype=torch.float32, device=cuda)
    tree.leaf_sums(rows, lengths)  # warm: builds and sizes the grids
    graph, box = torch.cuda.CUDAGraph(), {}
    with _graph.counting(_graph.CaptureCounts(cuda)):
        _graph.capture(graph, lambda: box.setdefault(
            "out", tree.leaf_sums(rows, lengths)), cuda)
    rows.copy_(torch.tensor(rng.uniform(-0.1, 0.5, (n, 16)),
                            dtype=torch.float32, device=cuda))
    before = counter("ops.tree.LEAF_SUM_LAUNCHES")
    graph.replay()
    # a replay runs no wrapper
    assert counter("ops.tree.LEAF_SUM_LAUNCHES") == before
    want = tree.leaf_sums(rows, lengths)
    torch.cuda.synchronize()
    assert torch.equal(box["out"], want)
    assert torch.equal(want, tree.leaf_sums_plain(rows, lengths))


# -- the program's spans and counters (utils/profiling.py) -----------------

STAGES = ("nbody.tree", "nbody.collect", "nbody.eval", "nbody.integrate")
CAPTURE_PARTS = ("nbody.capture.warm", "nbody.capture.enter",
                 "nbody.capture.trace", "nbody.capture.end")


def _profiled(fn):
    """``fn()`` under torch.profiler (host and card): (its result, the
    spans it recorded)."""
    from nbody_tpu_torch.utils import profiling

    profiling.clear()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        # the switch a span reads, and the profiler's own Python flag
        assert profiling.enabled()
        assert torch.autograd.profiler._is_profiler_enabled
        out = fn()
    recs = profiling.spans()
    profiling.clear()
    return out, recs


def _ancestors(rec, by_id):
    names = []
    while rec.parent is not None:
        rec = by_id[rec.parent]
        names.append(rec.name)
    return names


def test_spans_off_call_no_record_function_and_no_event(cuda, monkeypatch):
    from nbody_tpu_torch.utils import profiling

    calls = []
    record_function, event = torch.profiler.record_function, torch.cuda.Event

    def spy(name, make):
        def made(*a, **kw):
            calls.append(name)
            return make(*a, **kw)
        return made

    monkeypatch.setattr(torch.profiler, "record_function",
                        spy("record_function", record_function))
    monkeypatch.setattr(torch.cuda, "Event", spy("Event", event))
    profiling.clear()
    _, loop, fused = _sim_pair(cuda, n_bodies=8192, n_steps=2,
                               engine="barnes_hut")
    loop.run_contract()
    fused.run_scan()
    torch.cuda.synchronize()
    assert fused.last_scan_route == "graph"
    assert calls == [] and profiling.spans() == []


def test_capture_spans_split_the_capture(cuda):
    """The fused run's capture: the warm step, then two captures (the
    relaxed throwaway and the real one), each entered, traced and ended;
    the parts tile ``nbody.capture``, which is what ``last_capture_ms``
    times.  Stream times exist outside capture only."""
    import collections

    _, _, fused = _sim_pair(cuda, n_bodies=8192, n_steps=3,
                            engine="barnes_hut")
    _, recs = _profiled(fused.run_scan)
    assert fused.last_scan_route == "graph"
    names = collections.Counter(r.name for r in recs)
    assert {k: names[k] for k in ("nbody.run", "nbody.capture",
                                  "nbody.replay", *CAPTURE_PARTS)} == {
        "nbody.run": 1, "nbody.capture": 1, "nbody.replay": 1,
        "nbody.capture.warm": 1, "nbody.capture.enter": 2,
        "nbody.capture.trace": 2, "nbody.capture.end": 2}
    # the warm step, the throwaway capture, the capture: a step's stages
    # three times, none during the replays
    assert all(names[s] == 3 for s in STAGES)
    by_id = {r.id: r for r in recs}
    (capture,) = [r for r in recs if r.name == "nbody.capture"]
    parts = sum(r.host_ms for r in recs if r.name in CAPTURE_PARTS)
    assert 0.95 <= parts / capture.host_ms <= 1.02
    assert capture.host_ms == pytest.approx(fused.last_capture_ms, rel=0.02)
    assert capture.stream_ms > 0
    for r in recs:
        traced = "nbody.capture.trace" in _ancestors(r, by_id)
        if r.name in STAGES:
            assert (r.stream_ms is None) == traced, r
        if r.name in CAPTURE_PARTS[1:]:
            assert r.stream_ms is None
    (replay,) = [r for r in recs if r.name == "nbody.replay"]
    assert replay.stream_ms > 0 and replay.counters is not None


def test_loop_spans_tile_the_step_on_the_stream(cuda):
    """The contract loop's stages carry stream times that fit inside
    their step's, and the host reads are a gate a pass plus the overflow
    count's read."""
    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.models.simulation import Simulation

    cfg = SimConfig(n_bodies=8192, n_dim=3, n_steps=2, engine="barnes_hut",
                    collect3="dense", seed=3)
    sim = Simulation(cfg, device=cuda)
    reads = counter("ops._graph.HOST_READS")
    _, recs = _profiled(sim.run_contract)
    reads = counter("ops._graph.HOST_READS") - reads
    by_id = {r.id: r for r in recs}
    steps = [r for r in recs if r.name == "nbody.step"]
    assert len(steps) == 2
    for step in steps:
        inside = [r for r in recs if r.parent == step.id]
        assert sorted(r.name for r in inside) == sorted(STAGES)
        assert all(r.stream_ms > 0 for r in inside)
        assert sum(r.stream_ms for r in inside) <= step.stream_ms * 1.001
    (run,) = [r for r in recs if r.name == "nbody.run"]
    assert run.counters["ops._graph.HOST_READS"] == reads
    assert reads == 2 * cfg.n_steps + sim.last_retried_steps
    assert all(by_id[r.parent].name in ("nbody.step", "nbody.retry")
               for r in recs if r.name == "nbody.tree")


# -- the dense 3D collector's kernel (csrc/collect_dense3.cu) --------------

TINY_WINDOWS = (1, 2, 4, 6, 6, 6, 6, 6)  # escapes groups: the spill pass


def _dense_setup(n, seed, blobs, gs, device):
    """An octree of n bodies on the card, its spatial pyramid, the group
    sub-bboxes (Q = max(4, gs / 128), as ops/bh3d cuts them) and the
    walk's parameters at n's defaults; uniform in [-0.1, 0.1]^3, or two
    tight Gaussian blobs."""
    from nbody_tpu_torch.ops import bh3d, collect_dense3, tree3d

    rng = np.random.default_rng(seed)
    m = (10 ** rng.uniform(-1, np.log10(0.5), n)).astype(np.float32)
    if blobs:
        c = rng.uniform(-0.05, 0.05, (2, 3))
        p = np.clip(np.concatenate([
            rng.normal(c[0], 0.004, (n // 2, 3)),
            rng.normal(c[1], 0.004, (n - n // 2, 3))]), -0.1, 0.1)
    else:
        p = rng.uniform(-0.1, 0.1, (n, 3))
    p = torch.tensor(p.astype(np.float32), device=device)
    m = torch.tensor(m, device=device)
    md = tree3d.default_max_depth3(n)
    tree = tree3d.build_octree(p, m, max_depth=md)
    spyr = collect_dense3.build_spatial_pyramid(tree)
    ps = p[torch.argsort(tree.codes, stable=True)]
    q = max(4, gs // 128)
    sub = ps.reshape(n // gs, q, gs // q, 3)
    bbox = tuple(f(sub[..., a], 2) for a in range(3)
                 for f in (torch.amin, torch.amax))
    caps = bh3d.cap_defaults_3d(n)
    kw = dict(theta=0.5, softening=1e-15, list_cap=caps["list_cap"],
              direct_cap=caps["direct_cap"],
              direct_cell_max=bh3d.direct_cell_max_default(n),
              frontier_caps=bh3d.frontier_schedule_3d(caps["frontier_cap"],
                                                      md, n))
    return tree, spyr, bbox, kw


def _same_bits(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


# case -> (blobs, quarter_bits, tiny windows, (list_cap, direct_cap))
DENSE_KERNEL_CASES = {
    "uniform": (False, False, False, None),
    "uniform-quarters": (False, True, False, None),
    "blobs": (True, False, False, None),
    "blobs-quarters": (True, True, False, None),
    "tiny-windows": (False, True, True, None),
    "tiny-windows-blobs": (True, False, True, None),
    "truncated-rows": (True, True, False, (64, 16)),
}


@pytest.mark.parametrize("case", sorted(DENSE_KERNEL_CASES))
def test_dense_kernel_bit_equal_to_twin(cuda, case):
    """The kernel's lists, padding included, its overflow and escape
    flags equal the torch twin's bit for bit on the same walk: the
    default and a tiny window schedule, quarter bits on and off, and caps
    that cut rows."""
    from nbody_tpu_torch.ops import collect_dense3 as cd

    blobs, quarters, tiny, caps = DENSE_KERNEL_CASES[case]
    _, spyr, bbox, kw = _dense_setup(32768, 5, blobs, 2048, cuda)
    md = spyr.max_depth
    sched = TINY_WINDOWS[:md + 1] if tiny else cd.window_schedule_3d(md)
    origins = cd._window_origins(bbox, spyr.bounds, sched)
    walk = dict(theta=kw["theta"], softening=kw["softening"],
                list_cap=kw["list_cap"], direct_cap=kw["direct_cap"],
                direct_cell_max=kw["direct_cell_max"], quarter_bits=quarters)
    if caps:
        walk.update(list_cap=caps[0], direct_cap=caps[1])
    before = counter("ops.collect_dense3.DENSE_KERNEL_LAUNCHES")
    got, g_ovf, g_esc = cd._dense_lists_kernel(bbox, spyr, origins, sched,
                                               **walk)
    want, w_ovf, w_esc = cd._dense_lists(bbox, spyr, origins, sched, **walk)
    torch.cuda.synchronize()
    assert counter("ops.collect_dense3.DENSE_KERNEL_LAUNCHES") == before + 1
    assert len(got) == len(want) == (11 if quarters else 6)
    for k, (a, b) in enumerate(zip(got, want)):
        assert _same_bits(a, b), f"output {k}"
    assert torch.equal(g_ovf, w_ovf) and torch.equal(g_esc, w_esc)
    # each case reaches what it names
    assert bool(w_esc.any()) or not tiny
    assert bool(w_ovf.any()) == (caps is not None)
    assert (want[5] > 0).any() and (want[3] > 0).any()
    if quarters:
        assert (want[6] > 0).any()


@pytest.mark.parametrize("quarters", [False, True])
def test_dense_collector_spill_on_card_equals_twin_route(cuda, monkeypatch,
                                                         quarters):
    """The whole collector with tiny windows (groups escape and the gather
    walk collects them again) gives the same bits through the kernel as
    through the twin on the same tensors; one launch a pass."""
    from nbody_tpu_torch.ops import collect_dense3 as cd

    tree, spyr, bbox, kw = _dense_setup(32768, 6, False, 512, cuda)
    g = bbox[0].shape[0]

    def run():
        res = cd.collect_lists_3d_dense(
            bbox, tree, spyr, window_schedule=TINY_WINDOWS[:spyr.max_depth
                                                           + 1],
            spill_cap=g, quarter_bits=quarters, **kw)
        flat = [*res[0], res[1], res[2]]
        if quarters:
            flat += [res[3]["bits"], *res[3]["com"], res[3]["mass"]]
        return flat

    passes, launches, spills, escaped = map(counter, DENSE_COUNTERS)
    got = run()
    torch.cuda.synchronize()
    assert counter(DENSE_KERNEL) - launches == counter(DENSE_PASS) - passes
    assert counter(DENSE_PASS) - passes == 1
    assert counter(DENSE_COUNTERS[2]) == spills + 1 and counter(
        DENSE_COUNTERS[3]) > escaped
    with monkeypatch.context() as mp:
        mp.setattr(cd, "_dense_lists_kernel", cd._dense_lists)
        want = run()
    assert counter(DENSE_KERNEL) - launches == 1
    for k, (a, b) in enumerate(zip(got, want)):
        assert _same_bits(a, b), f"output {k}"


def test_dense_pass_launches_the_kernel_never_the_twin(cuda, monkeypatch):
    """A 3D dense force pass on the card: DENSE_KERNEL_LAUNCHES rises by
    exactly DENSE_PASSES's rise, and the twin is never called."""
    from nbody_tpu_torch.ops import bh3d, collect_dense3 as cd

    def refuse(*a, **kw):
        raise AssertionError("a CUDA tensor reached the dense twin")

    monkeypatch.setattr(cd, "_dense_lists", refuse)
    p, m = _cloud3(8192, 9, cuda)
    passes, launches = counter(DENSE_PASS), counter(DENSE_KERNEL)
    _, ovf = bh3d.bh3_accelerations_grouped(p, m, g=G, group_size=512,
                                            collect="dense",
                                            return_diagnostics=True)
    torch.cuda.synchronize()
    assert counter(DENSE_PASS) - passes == 1
    assert counter(DENSE_KERNEL) - launches == counter(DENSE_PASS) - passes
    assert int(ovf.sum()) == 0


def _evolved_plummer(cuda, n=131072, steps=3):
    """A Plummer sphere after ``steps`` steps of the adaptive engine on
    the card: (config, positions, masses)."""
    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.models.simulation import Simulation

    cfg = SimConfig(n_bodies=n, n_dim=3, engine="barnes_hut_adaptive",
                    init_mode="plummer", seed=5, n_steps=steps, g=1.0,
                    softening=0.01, dt=1.0 / 64)
    sim = Simulation(cfg, device=cuda)
    sim.run_contract()
    return cfg, sim.state.positions, sim.state.masses


def test_adaptive_refinement_bit_equal_to_cpu(cuda):
    """The adaptive tree of an evolved Plummer sphere on the card (Morton
    codes, sort, pyramid and the refinement's rows on the leaf-sums
    kernels, starts and child ranges) is the CPU build's (the sums'
    twin) bit for bit, and the same at every build; the refinement sums
    a level a kernel call."""
    from nbody_tpu_torch.ops import bh3d, tree3d

    cfg, p, m = _evolved_plummer(cuda)
    md = cfg.resolved_max_depth
    dcm = bh3d.direct_cell_max_default(cfg.n_bodies)
    before = counter("ops.tree.LEAF_SUM_LAUNCHES")
    t_g, r_g, o_g = tree3d.build_octree_adaptive(p, m, md, dcm)
    assert r_g.n_cells > 0 and r_g.depth > md
    assert counter("ops.tree.LEAF_SUM_LAUNCHES") == before + 1 + len(r_g.raw)
    again = tree3d.build_octree_adaptive(p, m, md, dcm)
    t_w, r_w, o_w = tree3d.build_octree_adaptive(p.cpu(), m.cpu(), md, dcm)
    assert torch.equal(o_g.cpu(), o_w) and torch.equal(again[2], o_g)
    for a, b, c in zip(t_g.raw, t_w.raw, again[0].raw):
        assert torch.equal(a.cpu(), b) and torch.equal(a, c)
    assert len(r_g.raw) == len(r_w.raw) == len(again[1].raw)
    for got, want, twice in ((r_g.raw, r_w.raw, again[1].raw),
                             (r_g.start, r_w.start, again[1].start),
                             (r_g.child, r_w.child, again[1].child)):
        for a, b, c in zip(got, want, twice):
            assert torch.equal(a.cpu(), b) and torch.equal(a, c)


def test_adaptive_pass_matches_its_reference(cuda):
    """A force pass of the adaptive engine on the card (quarter split,
    the evaluator's kernels) against ``adaptive_bh.py`` on two groups:
    f32 against f64, within 1e-3 of the reference's scale; the pass
    reads the host twice (the level sizes, the groups that enter)."""
    from benchmark.check import force_gap
    from benchmark.reference.adaptive_bh import AdaptiveBH
    from nbody_tpu_torch.models.engines import make_accel_fn

    cfg, p, m = _evolved_plummer(cuda)
    cfg = cfg.replace(split_eval=True)
    reads, groups = counter(HOST_READS), counter(REFINE_GROUPS)
    acc = make_accel_fn(cfg)(p, m)
    torch.cuda.synchronize()
    assert counter(HOST_READS) == reads + 2
    assert counter(REFINE_GROUPS) > groups
    ref = AdaptiveBH(p, m, g=1.0, theta=cfg.theta, group_size=2048,
                     sub_boxes=16, direct_cell_max=32, quarter_split=True,
                     softening=0.01)
    for grp in (0, ref.n_groups // 2):
        idx, want = ref.accelerations(grp)
        assert force_gap(acc[idx].double(), want[torch.float64]) < 1e-3


# -- the 3D gather walk's kernel (csrc/collect_gather3.cu) -----------------

def _gather_setup(state, cuda):
    """A gather walk's inputs on the card: (bbox, tree, walk kwargs) at the
    state's defaults.  "uniform": 65,536 bodies in a cube (the pyramid
    alone, the 3D caps); "plummer": the evolved Plummer sphere of
    131,072 with its refinement (the adaptive engine's caps)."""
    from nbody_tpu_torch.ops import bh3d, tree3d

    if state == "plummer":
        cfg, p, m = _evolved_plummer(cuda)
        n, md, soft = cfg.n_bodies, cfg.resolved_max_depth, cfg.softening
        dcm = bh3d.direct_cell_max_default(n)
        tree, refine, order = tree3d.build_octree_adaptive(p, m, md, dcm)
        caps = bh3d.cap_defaults_adaptive(n)
        sched = bh3d.frontier_schedule_adaptive(caps["frontier_cap"], md, n)
    else:
        n, soft = 65536, 1e-15
        p, m = _cloud3(n, 11, cuda)
        md = tree3d.default_max_depth3(n)
        dcm = bh3d.direct_cell_max_default(n)
        tree, refine = tree3d.build_octree(p, m, max_depth=md), None
        order = torch.argsort(tree.codes, stable=True)
        caps = bh3d.cap_defaults_3d(n)
        sched = bh3d.frontier_schedule_3d(caps["frontier_cap"], md, n)
    route = bh3d.resolve_route_3d(n, n)
    bbox = bh3d.sub_boxes_3d(p[order].reshape(-1, route.group_size, 3),
                             route.n_sub)
    kw = dict(theta=0.5, softening=soft, frontier_caps=sched,
              list_cap=caps["list_cap"], direct_cap=caps["direct_cap"],
              direct_cell_max=dcm, refine=refine)
    return bbox, tree, kw


def _walk_outputs(res):
    """Every output of a gather walk, flat: lists, ranges, overflow, the
    quarters dict's tensors and the demand dict's."""
    flat = [*res[0], res[1], res[2]]
    for extra in res[3:]:
        flat += ([extra["bits"], *extra["com"], extra["mass"]]
                 if "bits" in extra else
                 [extra["frontier"], extra["approx"], extra["direct"]])
    return flat


# case -> (state, quarter_bits, window, return_demand, cut caps, groups
# moved far off so that none enters the refinement)
GATHER_KERNEL_CASES = {
    "uniform": ("uniform", False, False, False, False, False),
    "uniform-quarters": ("uniform", True, False, False, False, False),
    "uniform-window": ("uniform", True, True, False, False, False),
    "uniform-demand": ("uniform", False, False, True, False, False),
    "plummer-refine": ("plummer", True, False, False, False, False),
    "plummer-refine-demand": ("plummer", False, False, True, False, False),
    "plummer-cut-caps": ("plummer", True, False, True, True, False),
    "plummer-none-enter": ("plummer", True, False, True, False, True),
}


@pytest.mark.parametrize("case", sorted(GATHER_KERNEL_CASES))
def test_gather_kernel_bit_equal_to_twin(cuda, case):
    """The kernel's lists, every slot past the counts included, its
    ranges, overflow flags, quarter payload and demand equal the torch
    twin's bit for bit on the same walk, widths included: the pyramid
    alone and with a refinement, quarter bits on and off, a window,
    caps cut so that a frontier, the approx and the direct list each
    overflow, and a walk that no group carries into the refinement; one
    launch a walk, and the same groups counted as entering."""
    from nbody_tpu_torch.ops import bh3d

    state, quarters, window, demand, cut, far = GATHER_KERNEL_CASES[case]
    bbox, tree, kw = _gather_setup(state, cuda)
    kw.update(quarter_bits=quarters, return_demand=demand)
    if window:
        leaves = 8 ** tree.max_depth
        kw["window_cells"] = (
            torch.tensor(leaves // 5, dtype=torch.int32, device=cuda),
            torch.tensor(3 * leaves // 5, dtype=torch.int32, device=cuda))
    if cut:
        md = tree.max_depth
        kw.update(frontier_caps=bh3d.frontier_schedule_adaptive(
            512, md, 131072), list_cap=700, direct_cap=300)
    if far:  # every group's sub-boxes far off: the root is accepted
        bbox = tuple(b + 100.0 for b in bbox)
    before, groups = counter(GATHER_KERNEL), counter(REFINE_GROUPS)
    reads = counter(HOST_READS)
    got = _walk_outputs(bh3d._gather_lists_kernel(bbox, tree, **kw))
    entered = counter(REFINE_GROUPS) - groups
    kernel_reads = counter(HOST_READS) - reads
    want = _walk_outputs(bh3d._gather_lists(bbox, tree, **kw))
    torch.cuda.synchronize()
    assert counter(GATHER_KERNEL) == before + 1
    assert counter(REFINE_GROUPS) - groups == 2 * entered
    assert counter(HOST_READS) - reads == 2 * kernel_reads
    assert kernel_reads == (1 if state == "plummer" else 0)
    assert len(got) == len(want)
    for k, (a, b) in enumerate(zip(got, want)):
        assert _same_bits(a, b), f"output {k}"
    # each case reaches what it names
    (lx, ly, lz, lm), ranges, overflow = want[:4], want[4], want[5]
    assert (lm > 0).any() and (ranges[..., 1] > 0).any() or far
    # a window opens its outer close cells down to the leaves, whose
    # aggregates may overflow the approx list
    assert bool(overflow.any()) == cut or window
    assert (entered == 0) == (state == "uniform" or far)
    if far:
        widths = bh3d.gather_widths(kw["frontier_caps"], tree.max_depth + 1)
        assert lx.shape[1] == min(sum(widths), kw["list_cap"])
    if quarters and not far:
        assert (want[6] > 0).any()
    if cut:
        stats = want[-3:]
        widths = bh3d.gather_widths(kw["frontier_caps"],
                                    len(stats[0]) + 1)
        assert any(int(d) > w for d, w in zip(stats[0], widths[1:]))
        assert int(stats[1]) > kw["list_cap"]
        assert int(stats[2]) > kw["direct_cap"]
    if window:
        kw.pop("window_cells")
        free = bh3d._gather_lists(bbox, tree, **kw)[1]
        assert int((free[..., 1] > 0).sum()) > int((ranges[..., 1] > 0).sum())


def test_gather_walk_on_card_never_calls_the_twin(cuda, monkeypatch):
    """3D force passes that collect by the gather walk (below the dense
    collector's N, and the adaptive engine's every group) launch the
    kernel once a pass and never reach the twin."""
    from nbody_tpu_torch.models.engines import make_accel_fn
    from nbody_tpu_torch.ops import bh3d

    def refuse(*a, **kw):
        raise AssertionError("a CUDA tensor reached the gather walk's twin")

    cfg, pp, mp = _evolved_plummer(cuda, n=32768, steps=1)
    monkeypatch.setattr(bh3d, "_gather_lists", refuse)
    p, m = _cloud3(8192, 9, cuda)
    before = counter(GATHER_KERNEL)
    _, ovf = bh3d.bh3_accelerations_grouped(p, m, g=G, group_size=512,
                                            collect="gather",
                                            return_diagnostics=True)
    make_accel_fn(cfg)(pp, mp)
    torch.cuda.synchronize()
    assert counter(GATHER_KERNEL) == before + 2
    assert int(ovf.sum()) == 0


@pytest.mark.parametrize("quarters", [False, True])
def test_gather_kernel_in_the_dense_spill_pass(cuda, monkeypatch, quarters):
    """The dense collector with tiny windows: its spill pass collects the
    escaped rows through the gather walk's kernel (one launch a spill
    pass), and the whole collector's outputs equal the same pass with
    the walk on the twin."""
    from nbody_tpu_torch.ops import bh3d, collect_dense3 as cd

    tree, spyr, bbox, kw = _dense_setup(32768, 6, True, 512, cuda)

    def run():
        res = cd.collect_lists_3d_dense(
            bbox, tree, spyr,
            window_schedule=TINY_WINDOWS[:spyr.max_depth + 1],
            spill_cap=16, quarter_bits=quarters, **kw)
        return _walk_outputs(res)

    spills, launches = counter(DENSE_COUNTERS[2]), counter(GATHER_KERNEL)
    got = run()
    torch.cuda.synchronize()
    assert counter(DENSE_COUNTERS[2]) == spills + 1
    assert counter(GATHER_KERNEL) == launches + 1
    with monkeypatch.context() as mp:
        mp.setattr(bh3d, "_gather_lists_kernel", bh3d._gather_lists)
        want = run()
    assert counter(GATHER_KERNEL) == launches + 1
    for k, (a, b) in enumerate(zip(got, want)):
        assert _same_bits(a, b), f"output {k}"


def test_gather_kernel_counts_once_a_replay(cuda):
    """The walk captured in a CUDA graph (no host read without a
    refinement): each replay gives the eager bits, and the launch
    counter, a tally, rises by one a replay once the graph's owner adds
    its per-replay counts."""
    from nbody_tpu_torch.ops import _graph, bh3d

    bbox, tree, kw = _gather_setup("uniform", cuda)
    kw.update(quarter_bits=True)
    want = _walk_outputs(bh3d._collect_lists_3d(bbox, tree, **kw))
    counts = _graph.CaptureCounts(cuda)
    graph, box = torch.cuda.CUDAGraph(), {}
    before = counter(GATHER_KERNEL)
    with _graph.counting(counts):
        _graph.capture(graph, lambda: box.setdefault(
            "out", bh3d._collect_lists_3d(bbox, tree, **kw)), cuda)
    assert counter(GATHER_KERNEL) == before
    assert counts.per_replay == {GATHER_KERNEL: 1}
    for _ in range(2):
        graph.replay()
    counts.replayed(2)
    torch.cuda.synchronize()
    assert counter(GATHER_KERNEL) == before + 2
    for k, (a, b) in enumerate(zip(_walk_outputs(box["out"]), want)):
        assert _same_bits(a, b), f"output {k}"
