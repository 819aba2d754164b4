"""The port's CUDA kernels against their plain twins on the card.

These need an NVIDIA GPU with nvcc (a CUDA kernel has no CPU mode): they
are marked ``cuda`` and skip elsewhere.  On a machine with the card:

    python -m pytest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from nbody_tpu_torch.ops import allpairs, bh_grouped, list_eval

pytestmark = pytest.mark.cuda

G = 6.67e-11
TOL = 1e-5  # of max|a|: f32 both sides, summation order differs


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
    before = allpairs.KERNEL_LAUNCHES
    got = allpairs.allpairs_accelerations_vs(
        p, p, m, g=G, softening=soft, target_block=128, source_block=512,
        compensated=comp)
    want = allpairs.allpairs_accelerations_plain(
        p, p, m, g=G, softening=soft, source_block=512, compensated=comp)
    assert allpairs.KERNEL_LAUNCHES == before + 1
    assert (got - want).abs().max() <= TOL * want.abs().max()


def test_k1_rejects_what_it_cannot_take(cuda):
    p, m = _cloud(256, 1, cuda)
    with pytest.raises(ValueError, match="float32"):
        allpairs.allpairs_accelerations(p.double(), m.double(), g=G)
    with pytest.raises(ValueError, match="contiguous"):
        pt = p.t().contiguous().t()
        allpairs.allpairs_accelerations_vs(pt, pt, m, g=G)
    with pytest.raises(ValueError, match="threads per block"):
        allpairs.allpairs_accelerations(p, m, g=G, target_block=100)


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
    before = list_eval.KERNEL_LAUNCHES
    got = list_eval.list_eval_runs(*seen["a"], **seen["kw"])
    want = list_eval.list_eval_runs_plain(*seen["a"], **seen["kw"])
    assert list_eval.KERNEL_LAUNCHES == before + 1
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
    before = allpairs.KERNEL_LAUNCHES
    got = allpairs.allpairs_accelerations_vs(
        p, p, m, g=G, softening=soft, target_block=128, source_block=512,
        compensated=comp)
    want = allpairs.allpairs_accelerations_plain(
        p, p, m, g=G, softening=soft, source_block=512, compensated=comp)
    assert allpairs.KERNEL_LAUNCHES == before + 1
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
    counter = "KERNEL_LAUNCHES" if seg_pack == 1 else "PACKED_LAUNCHES"
    before = getattr(list_eval, counter)
    got = list_eval.list_eval_runs(*a, **kw)
    want = list_eval.list_eval_runs_plain(*a, **kw)
    assert getattr(list_eval, counter) == before + 1
    assert (got - want).abs().max() <= TOL * want.abs().max()


def test_k3_matches_k2_on_the_same_runs(cuda, monkeypatch):
    p, m = _cloud3(8192, 5, cuda)
    a4, kw4 = _tables3(p, m, 4, monkeypatch)
    packed = list_eval.list_eval_runs(*a4, **kw4)
    a, kw = _tables3(p, m, 1, monkeypatch)
    plain = list_eval.list_eval_runs(*a, **kw)
    assert (packed - plain).abs().max() <= TOL * plain.abs().max()


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
    return [torch.tensor(a, device=device)
            for a in (targets, approx, ext, srct, tiles, lens)], k


@pytest.mark.parametrize("dims", [2, 3])
def test_k4_matches_twin_on_ragged_tables(cuda, dims):
    args, k = _split_tables(dims, dims, cuda)
    before = list_eval.SPLIT_LAUNCHES
    got = list_eval.list_eval_runs_split(*args, softening=1e-15, k_tile=k)
    want = list_eval.list_eval_runs_split_plain(*args, softening=1e-15,
                                                k_tile=k)
    torch.cuda.synchronize()
    assert list_eval.SPLIT_LAUNCHES == before + 1
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
    before = list_eval.SPLIT_LAUNCHES
    got = list_eval.list_eval_runs_split(*a, **kw)
    want = list_eval.list_eval_runs_split_plain(*a, **kw)
    assert list_eval.SPLIT_LAUNCHES == before + 1
    assert (got - want).abs().max() <= TOL * want.abs().max()


def test_cuda_tensors_never_reach_the_twins(cuda, monkeypatch):
    """The split pass on the card launches K4 and never a twin; on the
    CPU the same pass is the twins'; the two agree."""
    from nbody_tpu_torch.ops import bh3d

    def refuse(*a, **kw):
        raise AssertionError("a CUDA tensor reached a plain twin")

    p, m = _cloud3(8192, 8, cuda)
    want = bh3d.bh3_accelerations_grouped(p.cpu(), m.cpu(), g=G,
                                          group_size=512, collect="dense",
                                          split_eval=True)
    for name in ("list_eval_runs_plain", "list_eval_runs_split_plain"):
        monkeypatch.setattr(list_eval, name, refuse)
    before = list_eval.SPLIT_LAUNCHES
    got, ovf = bh3d.bh3_accelerations_grouped(
        p, m, g=G, group_size=512, collect="dense", split_eval=True,
        return_diagnostics=True)
    torch.cuda.synchronize()
    assert list_eval.SPLIT_LAUNCHES == before + 1
    assert int(ovf.sum()) == 0
    assert (got.cpu() - want).abs().max() <= TOL * want.abs().max()


def test_k4_rejects_what_it_cannot_take(cuda):
    args, k = _split_tables(3, 0, cuda)
    with pytest.raises(ValueError, match="int32"):
        list_eval.list_eval_runs_split(*args[:5], args[5].long(),
                                       softening=0.0, k_tile=k)
    with pytest.raises(ValueError, match="shared memory"):
        list_eval.list_eval_runs_split(*args, softening=0.0, k_tile=1 << 15)
    with pytest.raises(ValueError, match="4G"):
        list_eval.list_eval_runs_split(args[0], args[1], args[2][:4],
                                       *args[3:], softening=0.0, k_tile=k)
