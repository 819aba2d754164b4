"""The port's contract loop and CLI (nbody_tpu_torch.models.simulation,
nbody_tpu_torch.cli) against nbody_tpu's on the same initial state (CPU)."""

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import nbody_tpu
import nbody_tpu_torch
from nbody_tpu.models.simulation import Simulation as JaxSimulation
from nbody_tpu.state import to_numpy as jax_to_numpy
from nbody_tpu_torch import cli
from nbody_tpu_torch.models.simulation import Simulation
from nbody_tpu_torch.state import from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMING_RE = (
    re.compile(r"GPU total computation took\s+(\d+)\s+milliseconds"),
    re.compile(r"GPU parallel computation took\s+(\d+)\s+microseconds"),
)


@pytest.mark.parametrize("engine,n", [("allpairs", 1024), ("barnes_hut", 2048)])
def test_run_contract_matches_jax(tmp_path, engine, n):
    """3 steps from one nbody_tpu.rng state through both packages.

    Bound: 1e-6 absolute on positions in the 0.2-wide box (f32
    accelerations agree to ~1e-6 relative; 3 steps of dt=1 at these sizes
    stay clear of the close encounters that make longer runs chaotic),
    and at least the step-0 block of positions.txt byte for byte."""
    jcfg = nbody_tpu.SimConfig(n_bodies=n, n_steps=3, engine=engine, seed=1,
                               save_positions=True,
                               output_dir=str(tmp_path / "jax"))
    jsim = JaxSimulation(jcfg)
    m, p, v, _, _ = jax_to_numpy(jsim.state)
    tcfg = nbody_tpu_torch.SimConfig.from_dict(
        {**dataclasses.asdict(jcfg), "output_dir": str(tmp_path / "torch")})
    tsim = Simulation(tcfg, state=from_numpy(m, p, v, device="cpu"),
                      device="cpu")
    jstate, jtiming = jsim.run_contract()
    tstate, ttiming = tsim.run_contract()

    assert int(tstate.overflow) == int(jstate.overflow) == 0
    assert int(tstate.step) == 3 and float(tstate.time) == 3.0
    pos_t = tstate.positions.numpy()
    assert np.isfinite(pos_t).all()
    np.testing.assert_allclose(pos_t, np.asarray(jstate.positions), rtol=0,
                               atol=1e-6)
    jl = (tmp_path / "jax" / "positions.txt").read_text().splitlines()
    tl = (tmp_path / "torch" / "positions.txt").read_text().splitlines()
    assert len(jl) == len(tl) == 4 * n
    assert tl[:n] == jl[:n]  # step 0: byte-equal
    for line in (ttiming.total_line(), ttiming.parallel_line()):
        assert any(r.search(line) for r in TIMING_RE)


def test_naive_engine_matches_allpairs():
    from nbody_tpu_torch.models.engines import make_accel_fn

    cfg = nbody_tpu_torch.SimConfig(n_bodies=600, seed=2)
    s = nbody_tpu_torch.random_state(cfg, device="cpu")
    a = make_accel_fn(cfg.replace(engine="naive"))(s.positions, s.masses)
    b = make_accel_fn(cfg.replace(engine="allpairs"))(s.positions, s.masses)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-4, atol=1e-11)


@pytest.mark.parametrize("list_cap,cleared", [(8, True), (1, False)])
def test_adaptive_retry(capsys, list_cap, cleared):
    """A step whose caps overflow is recomputed at 4x caps; if that still
    overflows, the step keeps its count and warns."""
    cfg = nbody_tpu_torch.SimConfig(
        n_bodies=1024, n_steps=1, engine="barnes_hut", group_size=256,
        list_cap=list_cap, seed=3)
    state, _ = Simulation(cfg, device="cpu").run_contract()
    err = capsys.readouterr().err
    assert "retrying with 4x caps" in err
    assert (int(state.overflow) == 0) == cleared
    assert ("WARNING: step 0" in err) == (not cleared)


@pytest.mark.parametrize("engine,n", [("allpairs", 1024), ("barnes_hut", 2048)])
def test_cli_run_prints_timing_lines(engine, n):
    out = subprocess.run(
        [sys.executable, "-m", "nbody_tpu_torch", "run", "--device", "cpu",
         "--engine", engine, "--n-bodies", str(n), "--steps", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=300, check=True,
    ).stdout
    for r in TIMING_RE:
        assert r.search(out), out


def test_cli_in_process_save_outputs(tmp_path, capsys):
    rc = cli.main(["run", "--device", "cpu", "--engine", "allpairs",
                   "--n-bodies", "600", "--steps", "2", "--save-positions",
                   "--save-init", "--output-dir", str(tmp_path),
                   "--verbose-occupancy"])
    assert rc == 0
    assert int(cli.last_simulation.state.step) == 2
    assert len((tmp_path / "positions.txt").read_text().splitlines()) == 1800
    assert (tmp_path / "masses_init.txt").exists()
    assert "occupancy[allpairs]" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [
    ["--bh-mode", "exact"], ["--devices", "2"],
    ["--fused"], ["--save-tree-dumps"],
], ids=lambda f: "_".join(f))
def test_unported_flag_raises(flags, tmp_path):
    """No flag is refused any more: the ones the port once refused
    (--bh-mode exact, --fused, --save-tree-dumps, and --devices > 1, two
    gloo ranks here) run through."""
    argv = ["run", "--device", "cpu", "--n-bodies", "64", "--steps", "1",
            "--output-dir", str(tmp_path)] + flags
    assert cli.main(argv) == 0
