"""The port's fused runs (``Simulation.run_scan`` / ``run_scan_trajectory``
and ``run --fused``) on the CPU, where they run step by step with the
fused semantics: no adaptive retry, per-step overflow counts kept on the
device and warned about after the run, the trajectory written once.

Against the contract loop: the same steps, so the same bits (positions,
positions.txt, quadtree dumps).  Against nbody_tpu's ``run_scan``:
final positions within the JAX package's all-pairs bound (rtol 5e-4,
atol 1e-11, tests/test_allpairs.py) on the motion from the initial
state.  The card captures every single-device step as a CUDA graph, its
gates as conditional nodes: the graph itself runs only on the card
(tests/test_torch_cuda.py); that the step reads the host only inside
its gates is checked in tests/test_torch_graph_gates.py."""

import dataclasses

import numpy as np
import pytest
import torch

import nbody_tpu
import nbody_tpu_torch
from nbody_tpu.models.simulation import Simulation as JaxSimulation
from nbody_tpu.state import to_numpy as jax_to_numpy
from nbody_tpu_torch import cli
from nbody_tpu_torch.models.simulation import Simulation
from nbody_tpu_torch.state import from_numpy


@pytest.mark.parametrize("engine,n,extra", [
    ("naive", 64, []), ("barnes_hut", 1024, []),
    ("barnes_hut", 512, ["--bh-mode", "exact"]),
], ids=["naive", "barnes_hut", "exact"])
def test_fused_honors_side_effects(tmp_path, capsys, engine, n, extra):
    """--fused writes the same positions.txt and tree dumps as the
    contract loop (savePositions every step, project.cu:909; dumps at the
    first step and the top of the last, project.cu:962-965)."""
    common = ["run", "--device", "cpu", "--engine", engine, "--n-bodies",
              str(n), "--steps", "3", "--seed", "5", "--save-positions",
              "--save-tree-dumps", *extra]
    loop_dir, fused_dir = tmp_path / "loop", tmp_path / "fused"
    assert cli.main(common + ["--output-dir", str(loop_dir)]) == 0
    loop = cli.last_simulation.state.positions.clone()
    assert cli.main(common + ["--output-dir", str(fused_dir), "--fused"]) == 0
    fused = cli.last_simulation
    out = capsys.readouterr().out
    assert torch.equal(fused.state.positions, loop)
    assert fused.last_scan_route == "eager"
    for name in ("positions.txt", "quadtree_init.txt", "quadtree_final.txt"):
        a = (loop_dir / name).read_text()
        assert a == (fused_dir / name).read_text(), name
    assert "GPU total computation took" in out
    assert "GPU parallel computation took" in out


def test_fused_warns_on_unsupported(tmp_path, capsys):
    rc = cli.main([
        "run", "--device", "cpu", "--engine", "naive", "--n-bodies", "64",
        "--steps", "2", "--fused", "--checkpoint-every", "1",
        "--metrics-csv", "m.csv", "--output-dir", str(tmp_path)])
    assert rc == 0
    err = capsys.readouterr().err
    assert ("WARNING: --checkpoint-every, --metrics-csv ignored under "
            "--fused (needs per-step host sync); rerun without --fused for "
            "those outputs") in err
    assert not (tmp_path / "checkpoint.npz").exists()
    assert not (tmp_path / "m.csv").exists()


def test_fused_overflow_counts_and_no_retry(capsys):
    """A run capped to overflow keeps every overflowed step (no 4x
    retry), counts per step, and warns after the run in the JAX package's
    words; its steps equal the contract loop's with the retry off."""
    cfg = nbody_tpu_torch.SimConfig(
        n_bodies=1024, n_steps=2, engine="barnes_hut", group_size=256,
        list_cap=1, seed=3)
    sim = Simulation(cfg, device="cpu")
    final = sim.run_scan()
    err = capsys.readouterr().err
    counts = sim.last_scan_overflow
    assert counts.shape == (2,) and (counts > 0).all()
    assert "retrying" not in err
    assert (f"WARNING: step 0: traversal caps overflowed for {counts[0]} "
            "bodies (forces drop interactions); fused runs do NOT retry — "
            "raise --frontier-cap / list/direct caps or rerun without "
            "--fused for the adaptive-caps retry") in err
    loop, _ = Simulation(cfg.replace(adaptive_caps=False),
                         device="cpu").run_contract()
    assert torch.equal(final.positions, loop.positions)
    assert int(loop.overflow) == counts[-1]


@pytest.mark.parametrize("engine,n", [("naive", 256), ("allpairs", 512)])
def test_run_scan_matches_jax(engine, n):
    jcfg = nbody_tpu.SimConfig(n_bodies=n, n_steps=3, engine=engine, seed=6)
    jsim = JaxSimulation(jcfg)
    m, p, v, _, _ = jax_to_numpy(jsim.state)
    tcfg = nbody_tpu_torch.SimConfig.from_dict(dataclasses.asdict(jcfg))
    tsim = Simulation(tcfg, state=from_numpy(m, p, v, device="cpu"))
    jfinal = jsim.run_scan()
    tfinal = tsim.run_scan()
    assert int(tfinal.step) == 3 and float(tfinal.time) == 3.0
    np.testing.assert_array_equal(tsim.last_scan_overflow, [0, 0, 0])
    np.testing.assert_array_equal(jsim.last_scan_overflow, [0, 0, 0])
    np.testing.assert_allclose(tfinal.positions.numpy() - p,
                               np.asarray(jfinal.positions) - p,
                               rtol=5e-4, atol=1e-11)


def test_run_scan_trajectory_rows():
    cfg = nbody_tpu_torch.SimConfig(n_bodies=300, n_steps=4, engine="naive",
                                    seed=2)
    sim = Simulation(cfg, device="cpu")
    p0 = sim.state.positions.clone()
    final, traj = sim.run_scan_trajectory()
    assert traj.shape == (5, 300, 2)
    assert torch.equal(traj[0], p0) and torch.equal(traj[-1], final.positions)
    again = Simulation(cfg, device="cpu")
    for k in range(1, 5):
        again.state = again.step_fn(again.state)
        assert torch.equal(traj[k], again.state.positions)


def test_fused_3d_run_equals_loop(tmp_path, capsys):
    """3D Barnes-Hut fused, step by step on the CPU, bit-equal to the
    contract loop on a run that does not overflow; its 2D-only dumps are
    skipped with the JAX package's warning."""
    common = ["run", "--device", "cpu", "--dims", "3", "--engine",
              "barnes_hut", "--n-bodies", "1024", "--steps", "2", "--seed",
              "1", "--output-dir", str(tmp_path)]
    assert cli.main(common) == 0
    loop = cli.last_simulation.state
    assert int(loop.overflow) == 0
    assert cli.main(common + ["--fused", "--save-tree-dumps"]) == 0
    assert torch.equal(cli.last_simulation.state.positions, loop.positions)
    assert "skipping dumps" in capsys.readouterr().err
