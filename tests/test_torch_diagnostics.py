"""The port's diagnostics: the potential (kernel K5's twin and
``physics.potential_energy_scalable``), the metrics CSV, tree statistics
and checkpoints / resume, against nbody_tpu on the same inputs (CPU).

Bounds, each with its reason:

* per-body potential against the JAX kernel in interpret mode: 1e-5 of
  max|phi| (both f32; summation order differs);
* potential energy: rtol 1e-5 against the JAX package (f32 sums of
  N^2 terms in another order), rtol 1e-12 against float64 numpy in the
  float64 branch;
* metrics rows: integers exactly, floats rtol 1e-5; the CSV header byte
  for byte; tree statistics exactly (integer counts of the same trees);
* checkpoints and resumed runs: bit for bit.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbody_tpu
import nbody_tpu_torch
from nbody_tpu import physics as jphys
from nbody_tpu.models.simulation import Simulation as JaxSimulation
from nbody_tpu.ops import allpairs as jap
from nbody_tpu.state import make_state as jax_make_state
from nbody_tpu.state import to_numpy as jax_to_numpy
from nbody_tpu.utils import checkpoint as jck
from nbody_tpu.utils import metrics as jmet
from nbody_tpu_torch import cli
from nbody_tpu_torch import physics as tphys
from nbody_tpu_torch.models.simulation import Simulation
from nbody_tpu_torch.ops import allpairs as tap
from nbody_tpu_torch.state import from_numpy
from nbody_tpu_torch.utils import checkpoint as tck
from nbody_tpu_torch.utils import metrics as tmet

G = 6.67e-11
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bodies(n, dims, seed, blobs=False):
    rng = np.random.default_rng(seed)
    m = (10 ** rng.uniform(-1, np.log10(0.5), n)).astype(np.float32)
    if blobs:
        c = rng.uniform(-0.05, 0.05, (2, dims))
        p = c[np.arange(n) % 2] + 0.004 * rng.normal(size=(n, dims))
    else:
        p = rng.uniform(-0.1, 0.1, (n, dims))
    v = rng.uniform(-1e-4, 1e-4, (n, dims))
    return m, p.astype(np.float32), v.astype(np.float32)


def _states(n, dims, seed, **kw):
    m, p, v = _bodies(n, dims, seed, **kw)
    return (jax_make_state(m, p, v, time=2.0, step=2),
            from_numpy(m, p, v, time=2.0, step=2, device="cpu"))


# -- the potential -------------------------------------------------------------


@pytest.mark.parametrize("n", [999, 1037])
@pytest.mark.parametrize("dims", [2, 3])
def test_k5_twin_matches_jax_kernel(dims, n):
    """K5's twin against the Pallas kernel in interpret mode, at ragged N
    (the JAX wrapper pads targets and sources with the far sentinel)."""
    m, p, _ = _bodies(n, dims, n + dims)
    p[3] = p[7]  # a coincident pair: d2 == 0 drops it both ways
    want = np.asarray(jap.allpairs_potential(
        jnp.asarray(p), jnp.asarray(m), g=G, interpret=True))
    got = tap.allpairs_potential(torch.tensor(p), torch.tensor(m), g=G)
    assert got.shape == (n,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("n,dims", [(500, 2), (2000, 3), (4096, 2),
                                    (5000, 2), (4500, 3)])
def test_potential_energy_scalable_matches_jax(n, dims):
    """The dense branch (N <= 4,096) and the chunked branch (a CPU
    state) against the JAX package's same branches."""
    js, ts = _states(n, dims, n)
    want = float(jphys.potential_energy_scalable(js, G))
    got = float(tphys.potential_energy_scalable(ts, G))
    assert got < 0 and np.isclose(got, want, rtol=1e-5, atol=0)


def test_potential_energy_float64_branch():
    """A float64 state takes the chunked path and keeps float64."""
    m, p, v = _bodies(4200, 3, 11)
    st = from_numpy(m, p, v, dtype=torch.float64, device="cpu")
    got = tphys.potential_energy_scalable(st, G)
    assert got.dtype == torch.float64
    p64, m64 = p.astype(np.float64), m.astype(np.float64)
    pe = 0.0
    for i0 in range(0, len(m), 600):
        d = np.sqrt(((p64[None] - p64[i0:i0 + 600, None]) ** 2).sum(-1))
        with np.errstate(divide="ignore"):
            w = np.where(d > 0, -G * m64[None] / d, 0.0)
        pe += 0.5 * (m64[i0:i0 + 600] * w.sum(1)).sum()
    assert np.isclose(float(got), pe, rtol=1e-12, atol=0)


def test_k5_twin_takes_float64_and_returns_float32():
    """On the CPU the wrapper takes its twin for any float type and gives
    K5's f32 result; no kernel launch is counted."""
    m, p, _ = _bodies(600, 2, 1)
    phi = tap.allpairs_potential(torch.tensor(p, dtype=torch.float64),
                                 torch.tensor(m, dtype=torch.float64), g=G)
    assert phi.dtype == torch.float32
    assert tap.POTENTIAL_LAUNCHES == 0


@pytest.mark.parametrize("n", [1, 1037, 4097, 40960, 65536, 135168, 262144,
                               1 << 20])
def test_k5_launch_shape_is_a_plain_function_of_n(n):
    """K5's launch shape: in the kernel's sets, the same on every call,
    blocks covering N, and the fewest slices whose sums in flight fill 95%
    of the card's thread slots (else the most)."""
    tpt, r, blocks = tap.potential_launch_shape(n)
    assert tpt == tap.POTENTIAL_TARGETS_PER_THREAD == 2
    assert r in tap.POTENTIAL_SLICES == (1, 2, 4, 8)
    assert tap.potential_launch_shape(n) == (tpt, r, blocks)
    per_block = tap.POTENTIAL_THREADS // r * tpt
    assert blocks == -(-n // per_block) and blocks * per_block >= n
    slots = tap.SMS * tap.SM_THREADS
    assert n * r >= 0.95 * slots or r == 8
    assert r == 1 or n * (r // 2) < 0.95 * slots


@pytest.mark.parametrize("dims,n,want", [(2, 40960, (2, 8, 640)),
                                         (3, 262144, (2, 1, 512))])
def test_k5_launch_shape_on_the_metrics_runs(dims, n, want):
    """At the metrics runs' sizes: 3D N=262,144 is one near-full wave of
    blocks (512 of 528 at four blocks an SM); 2D N=40,960 gives each target
    eight threads, so its 327,680 sums in flight fill more than the card's
    270,336 thread slots (more waves of one-target threads measured slower
    on the H100: PERF.md)."""
    got = tap.potential_launch_shape(n)
    assert got == want
    waves = got[2] / (tap.SMS * tap.POTENTIAL_WAVE_BLOCKS)
    if dims == 3:
        assert 0.95 <= waves <= 1.0
    else:
        assert n * got[1] > tap.SMS * tap.SM_THREADS and waves > 1


# -- tree statistics and the metrics CSV ----------------------------------------


@pytest.mark.parametrize("blobs", [False, True], ids=["uniform", "blobs"])
@pytest.mark.parametrize("dims", [2, 3])
def test_tree_stats_match_jax(dims, blobs):
    m, p, _ = _bodies(3000, dims, 5, blobs=blobs)
    if dims == 2:
        want = jmet.tree_stats(jnp.asarray(p), jnp.asarray(m), max_depth=9)
        got = tmet.tree_stats(torch.tensor(p), torch.tensor(m), max_depth=9)
    else:
        want = jmet.tree_stats_3d(jnp.asarray(p), jnp.asarray(m))
        got = tmet.tree_stats_3d(torch.tensor(p), torch.tensor(m))
    assert got == want
    assert got["nodes"] > 1 and got["max_depth"] > 0


@pytest.mark.parametrize("n,dims", [(1500, 2), (5000, 2), (4500, 3)])
def test_metrics_rows_match_jax(tmp_path, n, dims):
    js, ts = _states(n, dims, n + 1)
    stats_fn = (jmet.tree_stats, tmet.tree_stats) if dims == 2 else (
        jmet.tree_stats_3d, tmet.tree_stats_3d)
    jw = jmet.MetricsWriter(str(tmp_path / "jax.csv"), g=G)
    tw = tmet.MetricsWriter(str(tmp_path / "torch.csv"), g=G)
    jw.record(js, stats_fn[0](js.positions, js.masses))
    tw.record(ts, stats_fn[1](ts.positions, ts.masses))
    jw.record(js)  # no tree statistics: empty columns
    tw.record(ts)
    for jrow, trow in zip(jw.rows, tw.rows):
        assert list(trow) == list(jrow) == tmet.MetricsWriter.FIELDS
        for k in ("step", "tree_nodes", "tree_max_depth"):
            assert trow[k] == jrow[k] and type(trow[k]) is type(jrow[k])
        for k in ("time", "kinetic_energy", "potential_energy",
                  "total_energy", "momentum_x", "momentum_y"):
            assert isinstance(trow[k], float)
            assert np.isclose(trow[k], jrow[k], rtol=1e-5, atol=0), k
    jw.flush()
    tw.flush()
    jtext = (tmp_path / "jax.csv").read_bytes()
    ttext = (tmp_path / "torch.csv").read_bytes()
    assert ttext.splitlines()[0] == jtext.splitlines()[0]
    assert len(ttext.splitlines()) == 3


def test_metrics_without_potential():
    _, ts = _states(300, 2, 3)
    w = tmet.MetricsWriter("unused.csv", g=G, with_potential=False)
    w.record(ts)
    assert np.isnan(w.rows[0]["potential_energy"])
    assert np.isnan(w.rows[0]["total_energy"])


@pytest.mark.parametrize("engine,dims,tree", [
    ("barnes_hut", 2, True), ("barnes_hut", 3, True),
    ("barnes_hut", 2, False), ("allpairs", 2, True)])
def test_run_contract_metrics_match_jax(tmp_path, engine, dims, tree):
    """3 steps from one nbody_tpu.rng state through both contract loops
    with a metrics CSV: 4 rows (step 0 included), tree columns only for
    barnes_hut with metrics_tree, values as in the JAX package's file."""
    jcfg = nbody_tpu.SimConfig(n_bodies=1024, n_dim=dims, n_steps=3,
                               engine=engine, seed=4, metrics_csv="m.csv",
                               metrics_tree=tree,
                               output_dir=str(tmp_path / "jax"))
    jsim = JaxSimulation(jcfg)
    m, p, v, _, _ = jax_to_numpy(jsim.state)
    tcfg = nbody_tpu_torch.SimConfig.from_dict(
        {**dataclasses.asdict(jcfg), "output_dir": str(tmp_path / "torch")})
    Simulation(tcfg, state=from_numpy(m, p, v, device="cpu"),
               device="cpu").run_contract()
    jsim.run_contract()
    rows = []
    for side in ("jax", "torch"):
        lines = (tmp_path / side / "m.csv").read_text().splitlines()
        rows.append([ln.split(",") for ln in lines])
    jrows, trows = rows
    assert trows[0] == jrows[0] and len(trows) == len(jrows) == 5
    filled = tree and engine == "barnes_hut"
    for k, (jr, tr) in enumerate(zip(jrows[1:], trows[1:])):
        assert tr[0] == jr[0]
        assert (tr[7] != "") == filled and tr[7:] == jr[7:]
        np.testing.assert_allclose([float(x) for x in tr[1:5]],
                                   [float(x) for x in jr[1:5]], rtol=1e-5)
        # the net momentum is a sum that cancels to ~1e-2 of its terms,
        # so the states' f32 drift after a step shows 10x larger in it
        np.testing.assert_allclose([float(x) for x in tr[5:7]],
                                   [float(x) for x in jr[5:7]],
                                   rtol=1e-5 if k == 0 else 1e-4)


# -- checkpoints ---------------------------------------------------------------


def _assert_states_equal(a, b):
    for k in ("masses", "positions", "velocities"):
        x, y = np.asarray(getattr(a, k)), np.asarray(getattr(b, k))
        assert x.dtype == y.dtype and np.array_equal(x, y), k
    assert float(a.time) == float(b.time) and int(a.step) == int(b.step)


@pytest.mark.parametrize("dims", [2, 3])
def test_checkpoint_written_by_jax_loads_in_the_port(tmp_path, dims):
    js, _ = _states(100, dims, 8)
    path = str(tmp_path / "j.npz")
    jck.save_checkpoint(path, js)
    ts = tck.load_checkpoint(path, device="cpu")
    assert ts.dtype == torch.float32 and ts.step.dtype == torch.int32
    _assert_states_equal(
        jax_make_state(ts.masses.numpy(), ts.positions.numpy(),
                       ts.velocities.numpy(), time=float(ts.time),
                       step=int(ts.step)), js)


@pytest.mark.parametrize("dims", [2, 3])
def test_checkpoint_written_by_the_port_loads_in_jax(tmp_path, dims):
    _, ts = _states(100, dims, 9)
    ts.time = ts.time + 0.1  # a time that is no integer
    path = str(tmp_path / "t.npz")
    tck.save_checkpoint(path, ts)
    with np.load(path) as z:
        assert sorted(z.files) == ["masses", "positions", "step", "time",
                                   "velocities"]
        assert z["time"].shape == z["step"].shape == ()
        assert z["time"].dtype == np.float32 and z["step"].dtype == np.int32
    js = jck.load_checkpoint(path)
    assert np.float32(js.time) == np.float32(ts.time)
    for k in ("masses", "positions", "velocities"):
        assert np.array_equal(np.asarray(getattr(js, k)),
                              getattr(ts, k).numpy())
    assert not os.path.exists(path + ".tmp.npz")


@pytest.mark.parametrize("engine", ["naive", "barnes_hut"])
def test_resume_continues_identically(tmp_path, engine):
    """tests/test_checkpoint.py:31-53 for the port: 3 steps, checkpoint,
    3 more from the file, against 6 straight steps, bit for bit."""
    cfg = nbody_tpu_torch.SimConfig(n_bodies=512, n_steps=6, engine=engine,
                                    seed=5)
    full, _ = Simulation(cfg, device="cpu").run_contract()
    ck = str(tmp_path / "mid.npz")
    Simulation(cfg.replace(n_steps=3, checkpoint_every=3,
                           checkpoint_path=ck), device="cpu").run_contract()
    mid = tck.load_checkpoint(ck, device="cpu")
    assert int(mid.step) == 3
    resumed, _ = Simulation(cfg.replace(n_steps=3), state=mid).run_contract()
    assert torch.equal(resumed.positions, full.positions)
    assert torch.equal(resumed.velocities, full.velocities)
    assert int(resumed.step) == 6 and float(resumed.time) == float(full.time)


def test_cli_metrics_checkpoint_resume(tmp_path, capsys):
    """--metrics-csv, --checkpoint-every and --resume through the CLI: 4
    steps then 2 resumed equal 6 straight steps; --resume wins over
    --load-init."""
    out = str(tmp_path)
    base = ["run", "--device", "cpu", "--engine", "barnes_hut",
            "--n-bodies", "1024", "--seed", "9", "--output-dir", out]
    assert cli.main(base + ["--steps", "4", "--checkpoint-every", "2",
                            "--metrics-csv", "m.csv"]) == 0
    lines = (tmp_path / "m.csv").read_text().splitlines()
    assert len(lines) == 6 and lines[0].startswith("step,time,")
    assert cli.main(base + ["--steps", "2", "--resume",
                            str(tmp_path / "checkpoint.npz"), "--load-init",
                            str(tmp_path / "missing"), "--metrics-csv",
                            "r.csv", "--no-metrics-tree"]) == 0
    resumed = cli.last_simulation.state
    rl = (tmp_path / "r.csv").read_text().splitlines()
    assert [r.split(",")[0] for r in rl[1:]] == ["4", "5", "6"]
    assert all(r.endswith(",,") for r in rl[1:])
    assert cli.main(["run", "--device", "cpu", "--engine", "barnes_hut",
                     "--n-bodies", "1024", "--seed", "9", "--steps", "6",
                     "--output-dir", str(tmp_path / "straight")]) == 0
    straight = cli.last_simulation.state
    assert torch.equal(resumed.positions, straight.positions)
    assert int(resumed.step) == 6
    assert "GPU total computation took" in capsys.readouterr().out


def test_diagnostics_modules_import_without_jax():
    code = ("import sys, nbody_tpu_torch.utils.metrics, "
            "nbody_tpu_torch.utils.checkpoint, nbody_tpu_torch.ops.allpairs; "
            "assert 'jax' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
