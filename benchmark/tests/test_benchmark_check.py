"""The check that decides ``correct``: the plain reference agrees with
the program, the bfloat16 control fails it, and a run whose timed path
is broken underneath comes out not correct (on the CPU, small sizes)."""

import contextlib
import functools
import types

import pytest
import torch

from benchmark import cells, check, harness, run, states
from benchmark.reference import gravity

# the 3D cell's reference at the program's route for 8,192 bodies (depth
# 5, direct cells up to 32 bodies, no quarter split)
SMALL_3D = dict(max_depth=5, group_size=2048, sub_boxes=16,
                direct_cell_max=32, quarter_split=False)


MESH = "allpairs_strong.fused4"


def small_cell(name: str, n: int, traffic: str = None) -> cells.Cell:
    """The cell ``name`` at ``n`` bodies and 3 steps a run (with the
    traffic mix ``traffic`` in place of its own)."""
    cell = cells.load_cell(name)
    if traffic:
        cell.traffic = cells.load_json(
            cells.ROOT / "benchmark" / "traffic" / f"{traffic}.json")
    cell.config["n_bodies"] = n
    if cell.config["n_dim"] == 3:
        cell.config["reference"].update(SMALL_3D)
    if cell.devices > 1:
        cell.config["devices"] = 2
    cell.traffic["steps_per_run"] = 3
    return cell


def one_run(cell: cells.Cell, seconds: float = 0.5) -> dict:
    parts = [harness.run_rank(cell, 2**31 + 77, seconds, False,
                              torch.device("cpu"), 0.0)]
    return run.result(cell, parts, traced=False)


def step_gap(positions, masses, step, cfg, units=99):
    """force_gap of one program step against the reference."""
    new = step(positions, masses)
    idx, acc = gravity.answers(positions, masses, cfg, units,
                               torch.Generator().manual_seed(0))
    return check.force_gap(new[idx].double(), acc[torch.float64])


@pytest.mark.parametrize("dims,n,opts,ref", [
    (2, 4096, {}, dict(max_depth=9, group_size=2048, sub_boxes=16,
                       direct_cell_max=32, quarter_split=False)),
    (3, 8192, {}, SMALL_3D),
    # the 1M route's quarter split and dense collector, forced small
    (3, 16384, dict(split_eval=True, direct_cell_max=128,
                    collect3="dense", max_depth=5),
     dict(max_depth=5, group_size=2048, sub_boxes=16, direct_cell_max=128,
          quarter_split=True)),
])
def test_grouped_reference_matches_the_program(dims, n, opts, ref):
    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.models.engines import make_accel_fn

    cfg = dict(cells.load_cell("bh2d_ref.fused").config, n_bodies=n,
               n_dim=dims, reference=dict(module="gravity",
                                          method="grouped_bh", **ref))
    m, p, _ = states.make_bodies(cfg, 5, 0, "cpu")
    accel = make_accel_fn(SimConfig(n_bodies=n, n_dim=dims,
                                    engine="barnes_hut", **opts))
    assert step_gap(p, m, accel, cfg) < 1e-4


def test_direct_reference_matches_the_program():
    from nbody_tpu_torch.ops.allpairs import allpairs_accelerations_vs

    cfg = dict(cells.load_cell(MESH).config, n_bodies=3000)
    m, p, _ = states.make_bodies(cfg, 5, 0, "cpu")
    assert step_gap(p, m, lambda p_, m_: allpairs_accelerations_vs(
        p_, p_, m_, g=cfg["g"], softening=0.0), cfg, units=3) < 1e-4


@pytest.mark.parametrize("name,n", [("bh2d_ref.fused", 4096),
                                    ("bh3d_1m.loop", 8192),
                                    (MESH, 2048)])
def test_the_control_fails_where_the_program_passes(name, n):
    cell = small_cell(name, n)
    cell.config["devices"] = 1
    program = harness.Program(cell, torch.device("cpu"))
    numbers = check.check(program, 3, [], control=True, runs=[0])
    limit = cell.config["check"]["force_gap_limit"]
    assert numbers.force_gap < limit / 10
    assert numbers.control_gap > 3 * limit


# -- faults planted under the timed path -------------------------------

def _unchanged(integrate):
    def faulty(state, acc, dt, overflow=None):
        out = integrate(state, acc, dt, overflow)
        return types.SimpleNamespace(**{**out.__dict__,
                                        "positions": state.positions,
                                        "velocities": state.velocities})
    return faulty


def _half(integrate):
    def faulty(state, acc, dt, overflow=None):
        acc = acc.clone()
        acc[acc.shape[0] // 2:] = 0  # half of the batch left out
        return integrate(state, acc, dt, overflow)
    return faulty


def _altered(integrate):
    def faulty(state, acc, dt, overflow=None):
        acc = acc.clone()
        acc[0] = -acc[0]  # one answer altered where it is produced
        return integrate(state, acc, dt, overflow)
    return faulty


FAULTS = {"unchanged": _unchanged, "half": _half, "altered": _altered}


@contextlib.contextmanager
def planted(fault: str):
    """The fault in the step of every entry (the engines' integrator,
    and the sharded steps'; ``exchange``: the all-gather returns this
    rank's own slab in every rank's place)."""
    from nbody_tpu_torch.models import simulation
    from nbody_tpu_torch.parallel import collectives, steps
    from nbody_tpu_torch.state import SimState

    saved = (simulation.integrate, steps.integrate,
             collectives.ProcessAxis.all_gather)
    try:
        if fault == "exchange":
            collectives.ProcessAxis.all_gather = (
                lambda self, t: torch.cat([t] * self.size))
        else:
            wrap = FAULTS[fault](simulation.integrate)

            def as_state(*a, **k):
                out = wrap(*a, **k)
                return out if isinstance(out, SimState) else SimState(
                    **out.__dict__)
            simulation.integrate = steps.integrate = as_state
        yield
    finally:
        (simulation.integrate, steps.integrate,
         collectives.ProcessAxis.all_gather) = saved


@pytest.mark.parametrize("name,n,traffic", [("bh2d_ref.fused", 4096, None),
                                            ("bh2d_ref.fused", 4096, "loop"),
                                            ("bh3d_1m.loop", 4096, None)])
def test_sound_and_broken_runs(name, n, traffic):
    cell = small_cell(name, n, traffic)
    cell.config["check"]["units"] = 99  # every group at this size
    assert one_run(cell)["correct"] is True
    for fault in FAULTS:
        with planted(fault):
            out = one_run(cell)
        assert out["correct"] is False, (name, fault, out["check"])


def mesh_entry(rank, *args, fault=None):
    """A mesh rank with ``fault`` planted (None: sound)."""
    with planted(fault) if fault else contextlib.nullcontext():
        harness.rank_entry(rank, *args)


@pytest.mark.parametrize("fault,trace", [(None, 0), (None, 1),
                                         ("exchange", 0), ("half", 0),
                                         ("altered", 0), ("unchanged", 0)])
def test_mesh_runs(fault, trace):
    cell = small_cell(MESH, 1024)
    cell.config["check"]["units"] = 1  # every body of each rank's slab
    args = types.SimpleNamespace(seed=2**33 + 5, seconds=0.5, trace=trace)
    parts = run.run_ranks(cell, args, "cpu",
                          entry=functools.partial(mesh_entry, fault=fault))
    assert run.children() == []  # the ranks and the resource tracker
    out = run.result(cell, parts, traced=bool(trace))
    assert out["correct"] is (fault is None), (fault, out["check"])
    if trace:  # the CPU's trace holds no device operation, and no graph
        assert out["metrics"] == {} and out["device"]["window_s"] > 0
