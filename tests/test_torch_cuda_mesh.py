"""The fused run of the multi-device steps on the card: a rank's sharded
step as one CUDA graph, its NCCL collectives captured in it, on an NCCL
process group of this process alone.

These need an NVIDIA GPU with nvcc and NCCL: they are marked ``cuda``
and skip elsewhere.  On a machine with the card:

    python -m pytest -m cuda tests/test_torch_cuda_mesh.py -q

Bounds: the graph replays the eager step's kernels and collectives in
its order, so every comparison is bit for bit.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

MODES = ("dp_allpairs", "ring_allpairs", "dp_barnes_hut",
         "dp_barnes_hut_grouped", "dp_barnes_hut_sharded",
         "dp_barnes_hut_grouped3", "dp_barnes_hut_sharded3",
         "dp2d_allpairs")
STEPS = 3


@pytest.fixture(scope="module")
def nccl1(tmp_path_factory):
    """An NCCL process group of this process alone, on card 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: NCCL and the CUDA kernels have no "
                    "CPU mode")
    import torch.distributed as dist

    torch.cuda.set_device(0)
    init = tmp_path_factory.mktemp("nccl1") / "pg"
    dist.init_process_group("nccl", init_method=f"file://{init}",
                            world_size=1, rank=0)
    yield torch.device("cuda", 0)
    dist.destroy_process_group()


def _setup(mode: str, device):
    """(config, global state, mesh) of ``mode`` at a small N: a
    Morton-sorted uniform cloud."""
    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.ops.tree import morton_codes, root_bounds
    from nbody_tpu_torch.ops.tree3d import morton_codes_3d, root_bounds_3d
    from nbody_tpu_torch.parallel import make_mesh, make_mesh_2d
    from nbody_tpu_torch.state import from_numpy

    dims = 3 if mode.endswith("3") else 2
    n = 4096
    rng = np.random.default_rng(17)
    m = (10 ** rng.uniform(-1, np.log10(0.5), n)).astype(np.float32)
    p = rng.uniform(-0.1, 0.1, (n, dims)).astype(np.float32)
    v = rng.uniform(-1e-4, 1e-4, (n, dims)).astype(np.float32)
    pt = torch.from_numpy(p)
    if dims == 2:
        codes = morton_codes(pt, root_bounds(pt), 9)
    else:
        codes = morton_codes_3d(pt, root_bounds_3d(pt), 5)
    o = torch.argsort(codes, stable=True).numpy()
    cfg = SimConfig(n_bodies=n, n_dim=dims, n_steps=STEPS,
                    engine="allpairs" if "allpairs" in mode else "barnes_hut",
                    bh_mode="exact" if mode == "dp_barnes_hut" else "grouped")
    mesh = make_mesh_2d(1, 1) if mode == "dp2d_allpairs" else make_mesh(1)
    return cfg, from_numpy(m[o], p[o], v[o], device=device), mesh


def _eager(step, slab, steps):
    """``steps`` eager steps of ``step``, no retry: (positions after each
    step, stacked from the slab's; final state; per-step overflow)."""
    rows, ovf = [slab.positions], []
    for _ in range(steps):
        slab = step(slab)
        rows.append(slab.positions)
        ovf.append(int(slab.overflow))
    return torch.stack(rows), slab, np.asarray(ovf)


@pytest.mark.parametrize("mode", MODES)
def test_mesh_graph_equals_eager_steps(nccl1, mode):
    from nbody_tpu_torch.models.simulation import Simulation
    from nbody_tpu_torch.parallel import make_sharded_step, shard_state

    cfg, state, mesh = _setup(mode, nccl1)
    step = make_sharded_step(cfg, mesh, mode)
    sim = Simulation(cfg, state=shard_state(state, mesh), step_fn=step,
                     mesh=mesh)
    assert sim.fused_gate() is None
    final = sim.run_scan()
    torch.cuda.synchronize()
    assert sim.last_scan_route == "graph"
    _, want, ovf = _eager(step, shard_state(state, mesh), STEPS)
    assert torch.equal(final.positions, want.positions)
    assert torch.equal(final.velocities, want.velocities)
    assert int(final.step) == STEPS
    np.testing.assert_array_equal(sim.last_scan_overflow, ovf)


def test_mesh_trajectory_rows_equal_eager_rows(nccl1):
    from nbody_tpu_torch.models.simulation import Simulation
    from nbody_tpu_torch.parallel import make_sharded_step, shard_state

    mode = "dp_barnes_hut_sharded"
    cfg, state, mesh = _setup(mode, nccl1)
    step = make_sharded_step(cfg, mesh, mode)
    sim = Simulation(cfg, state=shard_state(state, mesh), step_fn=step,
                     mesh=mesh)
    final, traj = sim.run_scan_trajectory()
    assert sim.last_scan_route == "graph"
    rows, want, _ = _eager(step, shard_state(state, mesh), STEPS)
    assert torch.equal(traj, rows)
    assert torch.equal(final.positions, want.positions)


def test_failed_mesh_capture_raises_and_leaves_the_group_usable(nccl1):
    """A mesh step that reads the host cannot be captured: run_scan raises
    (no step-by-step route behind it), and the group still runs a graph
    of a sharded step afterwards."""
    from nbody_tpu_torch.models.simulation import Simulation
    from nbody_tpu_torch.parallel import make_sharded_step, shard_state
    from nbody_tpu_torch.physics import integrate

    cfg, state, mesh = _setup("dp_allpairs", nccl1)
    ax = mesh.axes["dp"]

    def step(s):
        if s.positions.abs().max().item() < 0:  # a deliberate sync
            raise AssertionError
        acc = ax.psum(torch.zeros_like(s.positions))
        return integrate(s, acc, cfg.dt)

    sim = Simulation(cfg, state=shard_state(state, mesh), step_fn=step,
                     mesh=mesh)
    with pytest.raises(RuntimeError):
        sim.run_scan()
    assert sim.last_scan_route != "eager"
    torch.cuda.synchronize()
    good = make_sharded_step(cfg, mesh, "dp_allpairs")
    sim = Simulation(cfg, state=shard_state(state, mesh), step_fn=good,
                     mesh=mesh)
    final = sim.run_scan()
    assert sim.last_scan_route == "graph"
    _, want, _ = _eager(good, shard_state(state, mesh), STEPS)
    assert torch.equal(final.positions, want.positions)


def test_collectives_counted_once_per_replay(nccl1):
    """dp_allpairs captured with its NCCL all-gathers: the replays count
    two a step (positions and masses), the run also the eager warm
    step's two."""
    from nbody_tpu_torch.models.simulation import Simulation
    from nbody_tpu_torch.parallel import make_sharded_step, shard_state
    from nbody_tpu_torch.utils import profiling

    cfg, state, mesh = _setup("dp_allpairs", nccl1)
    step = make_sharded_step(cfg, mesh, "dp_allpairs")
    sim = Simulation(cfg, state=shard_state(state, mesh), step_fn=step,
                     mesh=mesh)
    profiling.clear()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        sim.run_scan()
    recs = {r.name: r for r in profiling.spans()}
    profiling.clear()
    assert sim.last_scan_route == "graph"
    n = cfg.n_bodies  # one rank holds every body
    key = "parallel.collectives.ALL_GATHER"
    replay, run = recs["nbody.replay"].counters, recs["nbody.run"].counters
    assert replay[f"{key}_CALLS"] == 2 * STEPS
    assert replay[f"{key}_BYTES"] == STEPS * (n * 2 * 4 + n * 4)
    assert run[f"{key}_CALLS"] == 2 * (STEPS + 1)
    assert run[f"{key}_BYTES"] == (STEPS + 1) * (n * 2 * 4 + n * 4)
