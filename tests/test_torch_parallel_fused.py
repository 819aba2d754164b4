"""The fused run (``Simulation.run_scan``) of the multi-device steps on
the CPU: what a rank's CUDA graph of its sharded step needs and gives.
The graph itself exists only on the card (tests/test_torch_cuda_mesh.py,
chip_smoke.py phase 7d).

* Each of the eight sharded steps reads no host, on two thread ranks and
  on a one-rank gloo group, under tests/test_torch_graph_gates.py's
  guard (the only read allowed: a 3D gate's, ``_graph._host_value``,
  which a graph turns into a conditional node): the precondition of
  capture that the CPU can check.
* ``fused_gate()``: None for a process-group mesh, whose fused run on the
  card is one graph a rank; a stated reason for thread ranks.
* ``run_scan`` under a mesh of two thread ranks against the JAX
  package's ``run_scan`` of the same sharded step on conftest's fake CPU
  mesh: 5e-6 x max|p| after 3 steps, the bound of tests/test_parallel.py
  for these modes (f32 both sides; K1's twin and the JAX package's dense
  XLA route sum in other orders), per-step overflow counts equal.  The
  grouped and sharded modes, whose JAX side takes 70-90 s a case to
  compile here, are held bit for bit to the port's own eager step loop,
  which tests/test_torch_parallel_grouped.py holds to JAX.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import nbody_tpu
from nbody_tpu.models.simulation import Simulation as JaxSimulation
from nbody_tpu.parallel import make_mesh as jmake_mesh
from nbody_tpu.parallel import make_mesh_2d as jmake_mesh_2d
from nbody_tpu.parallel import make_sharded_step as jmake_step
from nbody_tpu.parallel import shard_state as jshard_state
from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.models.simulation import THREAD_GATE, Simulation
from nbody_tpu_torch.parallel import (
    make_mesh,
    make_mesh_2d,
    make_sharded_step,
    shard_state,
)
from nbody_tpu_torch.parallel.collectives import RecordingAxis
from nbody_tpu_torch.parallel.mesh import (
    Mesh,
    gather_state,
    run_ranks,
    thread_meshes,
    thread_meshes_2d,
)
from nbody_tpu_torch.state import from_numpy

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_graph_gates import _no_host_reads  # noqa: E402
from test_torch_parallel import MODES, _grid  # noqa: E402

STEPS = 3


def _meshes(mode: str, n_dev: int):
    if mode == "dp2d_allpairs":
        return thread_meshes_2d(max(n_dev // 2, 1), 2 if n_dev > 1 else 1,
                                "cpu")
    return thread_meshes(n_dev, "cpu")


def _setup(mode: str):
    """(config, global state) of ``mode`` at a small N: a Morton-sorted
    jittered grid (contiguous slabs: real windows)."""
    dims = 3 if mode.endswith("3") else 2
    m, p, v = _grid(32 if dims == 2 else 10, dims, seed=5)
    cfg = SimConfig(n_bodies=m.shape[0], n_dim=dims, group_size=96,
                    n_steps=STEPS,
                    engine="allpairs" if "allpairs" in mode else "barnes_hut",
                    bh_mode="exact" if mode == "dp_barnes_hut" else "grouped")
    return cfg, from_numpy(m, p, v, device="cpu")


@pytest.fixture(scope="module")
def gloo1(tmp_path_factory):
    """A gloo process group of this process alone."""
    init = tmp_path_factory.mktemp("gloo1") / "pg"
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            world_size=1, rank=0)
    yield
    dist.destroy_process_group()


# -- (a) no host read in a sharded step ---------------------------------------

@pytest.mark.parametrize("ranks", ["threads2", "gloo1"])
@pytest.mark.parametrize("mode", MODES)
def test_sharded_step_reads_no_host(mode, ranks, request):
    cfg, state = _setup(mode)
    if ranks == "gloo1":
        request.getfixturevalue("gloo1")
        meshes = [make_mesh_2d(1, 1) if mode == "dp2d_allpairs"
                  else make_mesh(1)]
    else:
        meshes = _meshes(mode, 2)
    slabs = [shard_state(state, mesh) for mesh in meshes]

    def rank(mesh):
        slab = slabs[meshes.index(mesh)]
        return make_sharded_step(cfg, mesh, mode)(slab)

    # the steps are built under the guard too: they bind the kernels'
    # wrappers as they are built
    with _no_host_reads() as seen:
        new = run_ranks(rank, meshes)
    for s, slab in zip(new, slabs):
        assert s.positions.shape == slab.positions.shape
        assert torch.isfinite(s.positions).all()
        assert int(s.step) == 1
    if mode != "dp_barnes_hut":  # the exact BH launches no kernel
        # every rank went through its kernel's wrapper (the twin here)
        wrapper = ("allpairs_accelerations_vs" if cfg.engine == "allpairs"
                   else "list_eval_runs")
        assert seen.get(wrapper, 0) >= len(meshes)


# -- (b) the route of a fused run under a mesh ---------------------------------

def test_fused_gate_takes_process_groups_and_names_thread_ranks(gloo1):
    cfg, state = _setup("dp_allpairs")
    pg = make_mesh(1)
    threads = thread_meshes(2, "cpu")

    def gate(mesh):
        return Simulation(cfg, state=shard_state(state, mesh),
                          step_fn=make_sharded_step(cfg, mesh, "dp_allpairs"),
                          mesh=mesh).fused_gate()

    def recorded(mesh):
        return Mesh({k: RecordingAxis(ax, []) for k, ax in mesh.axes.items()},
                    mesh.device)

    assert Simulation(cfg, state=state).fused_gate() is None
    assert gate(pg) is None
    assert gate(recorded(pg)) is None
    assert gate(make_mesh_2d(1, 1)) is None
    assert gate(threads[0]) == THREAD_GATE
    assert gate(recorded(threads[1])) == THREAD_GATE
    assert "thread ranks" in THREAD_GATE


# -- (c) run_scan under a mesh ----------------------------------------------

def _rank_scan(mode, cfg, state, meshes, trajectory=False):
    """``run_scan`` (or ``run_scan_trajectory``) of ``mode`` on the thread
    ranks ``meshes``; returns rank 0's (gathered final positions,
    per-step overflow counts, route, trajectory or None)."""

    def rank(mesh):
        sim = Simulation(cfg, state=shard_state(state, mesh),
                         step_fn=make_sharded_step(cfg, mesh, mode),
                         mesh=mesh)
        traj = None
        if trajectory:
            final, traj = sim.run_scan_trajectory()
        else:
            final = sim.run_scan()
        return (gather_state(final, mesh).positions, sim.last_scan_overflow,
                sim.last_scan_route, traj)

    return run_ranks(rank, meshes)[0]


def _rank_loop(mode, cfg, state, meshes):
    """The same sharded step stepped eagerly, no retry; returns rank 0's
    (gathered positions after each step, per-step overflow counts)."""

    def rank(mesh):
        s = shard_state(state, mesh)
        step = make_sharded_step(cfg, mesh, mode)
        rows, ovf = [gather_state(s, mesh).positions], []
        for _ in range(cfg.n_steps):
            s = step(s)
            rows.append(gather_state(s, mesh).positions)
            ovf.append(int(s.overflow))
        return torch.stack(rows), np.asarray(ovf)

    return run_ranks(rank, meshes)[0]


@pytest.mark.parametrize("mode", ["dp_allpairs", "ring_allpairs",
                                  "dp2d_allpairs", "dp_barnes_hut"])
def test_mesh_run_scan_matches_jax(mode):
    """Two ranks (dp2d: 1x2) against the JAX package's fused run of its
    sharded step on two devices of its fake CPU mesh, from
    tests/test_parallel.py's cloud."""
    rng = np.random.default_rng(42)
    n = 512
    cloud = ((10 ** rng.uniform(-1, np.log10(0.5), n)).astype(np.float32),
             rng.uniform(-0.1, 0.1, (n, 2)).astype(np.float32),
             rng.uniform(-1e-4, 1e-4, (n, 2)).astype(np.float32))
    kw = dict(n_bodies=n, n_steps=STEPS, engine="allpairs", dt=1.0,
              group_size=256, group_chunk=8)
    jcfg = nbody_tpu.SimConfig(**kw)
    jstate = nbody_tpu.make_state(*cloud)
    if mode == "dp2d_allpairs":
        jstep = jmake_step(jcfg, jmake_mesh_2d(1, 2), mode)
    else:
        jmesh = jmake_mesh(2)
        jstep = jmake_step(jcfg, jmesh, mode)
        jstate = jshard_state(jstate, jmesh)
    jsim = JaxSimulation(jcfg, state=jstate, step_fn=jstep)
    want = np.asarray(jsim.run_scan().positions)
    got, ovf, route, _ = _rank_scan(mode, SimConfig(**kw),
                                    from_numpy(*cloud, device="cpu"),
                                    _meshes(mode, 2))
    assert route == "eager"  # the CPU; on the card a graph
    np.testing.assert_allclose(got.numpy(), want,
                               atol=5e-6 * np.abs(want).max())
    np.testing.assert_array_equal(ovf, jsim.last_scan_overflow)
    np.testing.assert_array_equal(ovf, np.zeros(STEPS))


@pytest.mark.parametrize("mode", ["dp_barnes_hut_grouped",
                                  "dp_barnes_hut_sharded",
                                  "dp_barnes_hut_grouped3",
                                  "dp_barnes_hut_sharded3"])
def test_mesh_run_scan_equals_the_eager_steps(mode):
    cfg, state = _setup(mode)
    got, ovf, _, _ = _rank_scan(mode, cfg, state, _meshes(mode, 2))
    rows, want_ovf = _rank_loop(mode, cfg, state, _meshes(mode, 2))
    assert torch.equal(got, rows[-1])
    np.testing.assert_array_equal(ovf, want_ovf)


def test_mesh_trajectory_rows_equal_the_eager_steps():
    """The trajectory holds every rank's bodies, gathered once after the
    run, row k the positions after k steps."""
    mode = "dp_barnes_hut_sharded"
    cfg, state = _setup(mode)
    final, _, _, traj = _rank_scan(mode, cfg, state, _meshes(mode, 2),
                                   trajectory=True)
    rows, _ = _rank_loop(mode, cfg, state, _meshes(mode, 2))
    assert traj.shape == (STEPS + 1, cfg.n_bodies, 2)
    assert torch.equal(traj, rows)
    assert torch.equal(traj[-1], final)
