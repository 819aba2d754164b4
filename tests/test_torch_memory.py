"""The port's memory and communication models
(nbody_tpu_torch.parallel.memory) against nbody_tpu.parallel.memory, and
against the collectives a port step actually issues.

Integer byte counts and mode names, so every comparison is exact.  The
checks of tests/test_memory_gate.py and tests/test_comm_model.py that
rest on the arithmetic alone are ported as they are; their checks against
the JAX package's traced jaxpr become checks against the collectives a
port step records on thread ranks (``collectives.RecordingAxis``).
"""

import numpy as np
import pytest
import torch

import nbody_tpu
from nbody_tpu.parallel import memory as jmem
from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.parallel import make_sharded_step, memory, shard_state
from nbody_tpu_torch.parallel.collectives import RecordingAxis
from nbody_tpu_torch.parallel.mesh import (
    Mesh,
    run_ranks,
    thread_meshes,
    thread_meshes_2d,
)
from nbody_tpu_torch.state import from_numpy

MODES = ("dp_allpairs", "ring_allpairs", "dp_barnes_hut",
         "dp_barnes_hut_grouped", "dp_barnes_hut_sharded",
         "dp_barnes_hut_grouped3", "dp_barnes_hut_sharded3",
         "dp2d_allpairs")
BH_MODES = ("grouped", "sharded", "dp_barnes_hut_grouped",
            "dp_barnes_hut_sharded", "dp_barnes_hut_grouped3",
            "dp_barnes_hut_sharded3")


def _configs(dims):
    """Pairs of (port, JAX) configs over body counts and depths, the
    default depth included."""
    out = []
    for n in (1024, 65536, 1 << 20, 3 * (1 << 18) + 5):
        for depth in (None, 4, 7):
            kw = dict(n_bodies=n, n_dim=dims, max_depth=depth)
            out.append((SimConfig(**kw), nbody_tpu.SimConfig(**kw)))
    return out


@pytest.mark.parametrize("n_dev", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("dims", [2, 3])
def test_models_equal_jax(dims, n_dev):
    for cfg, jcfg in _configs(dims):
        assert memory.tree_bytes(cfg) == jmem.tree_bytes(jcfg)
        for mode in BH_MODES:
            assert memory.source_bytes(cfg, n_dev, mode) == (
                jmem.source_bytes(jcfg, n_dev, mode))
            assert memory.per_chip_bytes(cfg, n_dev, mode) == (
                jmem.per_chip_bytes(jcfg, n_dev, mode))
        for hbm in (None, 1 << 24, 1 << 30, 80 * 10**9):
            assert memory.choose_bh_mode(cfg, n_dev, hbm_bytes=hbm) == (
                jmem.choose_bh_mode(jcfg, n_dev, hbm_bytes=hbm))
            c2, j2 = cfg.replace(hbm_bytes=hbm), jcfg.replace(hbm_bytes=hbm)
            assert memory.choose_bh_mode(c2, n_dev) == (
                jmem.choose_bh_mode(j2, n_dev))
        for mode in MODES:
            for sp in (1, 2):
                assert memory.collective_inventory(cfg, n_dev, mode, sp) == (
                    jmem.collective_inventory(jcfg, n_dev, mode, sp))
                assert memory.comm_bytes_per_step(cfg, n_dev, mode, sp) == (
                    jmem.comm_bytes_per_step(jcfg, n_dev, mode, sp))
    with pytest.raises(ValueError, match="unknown mode"):
        memory.collective_inventory(SimConfig(), n_dev, "dp_nothing")


def test_cpu_budget_is_the_jax_default():
    assert memory.device_memory_bytes("cpu") == memory.HBM_BYTES_DEFAULT
    assert memory.device_memory_bytes(None) == jmem.HBM_BYTES_DEFAULT


def test_card_budget_is_the_card_memory(monkeypatch):
    """On a CUDA device the budget is the card's memory: an 80 GB card
    keeps 2D grouped up to ~1.3 billion bodies (the JAX package's 16 GiB
    default switches near 268 million)."""

    class Props:
        total_memory = 85_031_714_816  # 79.2 GiB: an 80 GB card

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: Props)
    dev = torch.device("cuda", 0)
    assert memory.device_memory_bytes(dev) == Props.total_memory
    for n, want in ((1_300_000_000, "dp_barnes_hut_grouped"),
                    (1_340_000_000, "dp_barnes_hut_sharded")):
        assert memory.choose_bh_mode(SimConfig(n_bodies=n), 8,
                                     device=dev) == want
    assert memory.choose_bh_mode(SimConfig(n_bodies=300_000_000), 8) == (
        "dp_barnes_hut_sharded")
    # --hbm-gb (config.hbm_bytes) still wins over the card
    cfg = SimConfig(n_bodies=65536, hbm_bytes=memory.tree_bytes(
        SimConfig(n_bodies=65536)) * 4 + 65536 * 8)
    assert memory.choose_bh_mode(cfg, 8, device=dev) == (
        "dp_barnes_hut_sharded")


def test_gate_decisions():
    """tests/test_memory_gate.py's decisions, on the port's gate."""
    small = SimConfig(n_bodies=65536)
    assert memory.choose_bh_mode(small, 8) == "dp_barnes_hut_grouped"
    tiny = memory.tree_bytes(small) * 4 + 65536 * 8
    assert memory.choose_bh_mode(small, 8, hbm_bytes=tiny) == (
        "dp_barnes_hut_sharded")
    small3 = SimConfig(n_bodies=65536, n_dim=3, max_depth=5)
    assert memory.choose_bh_mode(small3, 8) == "dp_barnes_hut_grouped3"
    tiny3 = memory.tree_bytes(small3) * 4 + 65536 * 8
    assert memory.choose_bh_mode(small3, 8, hbm_bytes=tiny3) == (
        "dp_barnes_hut_sharded3")
    assert memory.per_chip_bytes(small, 8, "grouped") == (
        memory.tree_bytes(small) + memory.source_bytes(small, 8, "grouped"))
    # the config's budget alone flips it; an explicit argument still wins
    assert memory.choose_bh_mode(small.replace(hbm_bytes=tiny), 8) == (
        "dp_barnes_hut_sharded")
    assert memory.choose_bh_mode(small.replace(hbm_bytes=tiny), 8,
                                 hbm_bytes=64 * 1024**3) == (
        "dp_barnes_hut_grouped")


def test_sharded_sources_scale_with_devices():
    cfg = SimConfig(n_bodies=1 << 20)
    rows = 4 * 4
    for n_dev in (4, 8, 64):
        sh = memory.source_bytes(cfg, n_dev, "dp_barnes_hut_sharded")
        assert sh <= 2 * 3 * -(-cfg.n_bodies // n_dev) * rows
    gr = memory.source_bytes(cfg, 8, "dp_barnes_hut_grouped")
    assert gr == cfg.n_bodies * rows
    assert memory.source_bytes(cfg, 8, "dp_barnes_hut_sharded") < gr
    assert memory.source_bytes(cfg, 64, "dp_barnes_hut_sharded") < gr // 8


def test_sharded_comm_is_o_n_over_devices_plus_tree():
    """tests/test_comm_model.py's claim: doubling N at fixed depth grows
    sharded comm by the two halo slabs only, grouped by D - 1 slabs."""
    d = 8
    base = SimConfig(n_bodies=1 << 18, max_depth=9)
    dbl = SimConfig(n_bodies=1 << 19, max_depth=9)
    slab_growth = (1 << 19) // d - (1 << 18) // d
    sh = memory.comm_bytes_per_step(base, d, "dp_barnes_hut_sharded")
    sh2 = memory.comm_bytes_per_step(dbl, d, "dp_barnes_hut_sharded")
    assert sh2 - sh == 2 * slab_growth * 16
    gr = memory.comm_bytes_per_step(base, d, "dp_barnes_hut_grouped")
    gr2 = memory.comm_bytes_per_step(dbl, d, "dp_barnes_hut_grouped")
    assert gr2 - gr == (d - 1) * slab_growth * 12
    # the psum'd pyramid depends on depth only
    a = SimConfig(n_bodies=1 << 16, max_depth=8)
    b = SimConfig(n_bodies=1 << 18, max_depth=8)
    pa = [p for op, p in memory.collective_inventory(a, 8, "dp_barnes_hut")
          if op == "psum"]
    pb = [p for op, p in memory.collective_inventory(b, 8, "dp_barnes_hut")
          if op == "psum"]
    assert pa == pb and max(pa) == 4**8 * 8 * 4


def _recorded(mode, dims, n_dev, n=1024):
    """The collectives rank 0 issues in one step of ``mode`` (op, payload
    bytes), recorded on thread ranks."""
    rng = np.random.default_rng(0)
    state = from_numpy(rng.uniform(0.1, 0.5, n).astype(np.float32),
                       rng.uniform(-0.1, 0.1, (n, dims)).astype(np.float32),
                       np.zeros((n, dims), np.float32), device="cpu")
    cfg = SimConfig(n_bodies=n, n_dim=dims,
                    engine="allpairs" if "allpairs" in mode else "barnes_hut")
    if mode == "dp2d_allpairs":
        meshes = thread_meshes_2d(n_dev // 2, 2, "cpu")
    else:
        meshes = thread_meshes(n_dev, "cpu")
    logs = [[] for _ in meshes]
    meshes = [Mesh({k: RecordingAxis(ax, log) for k, ax in m.axes.items()},
                   m.device) for m, log in zip(meshes, logs)]

    def rank(mesh):
        make_sharded_step(cfg, mesh, mode)(shard_state(state, mesh))

    run_ranks(rank, meshes)
    return cfg, sorted(logs[0])


@pytest.mark.parametrize("n_dev", [2, 8])
@pytest.mark.parametrize("mode", MODES)
def test_recorded_collectives_equal_inventory(mode, n_dev):
    """tests/test_comm_model.py's inventory check on the port: the model
    lists exactly the collectives (and per-rank operand bytes) one step
    issues; n_dev == 2 is the sharded modes' single-halo case."""
    dims = 3 if mode.endswith("3") else 2
    cfg, got = _recorded(mode, dims, n_dev)
    if mode == "dp2d_allpairs":
        want = memory.collective_inventory(cfg, n_dev // 2, mode, sp=2)
    else:
        want = memory.collective_inventory(cfg, n_dev, mode)
    assert got == sorted(want)
