"""The port's ``sweep`` and ``plot`` verbs (nbody_tpu_torch.bench.sweeps,
nbody_tpu_torch.bench.plots) on the CPU.

The results files are parsed with the regexes of tests/test_cli.py (the
reference's analysis layer, plot_first_scale.py:55-59 and
plot_second_scale.py:19-20), and ``_parse_scaling_results`` must return
exactly the JAX package's records, on a file the port wrote and on one
the JAX package's own ``sweep`` wrote.
"""

import re
import statistics
import time

import pytest

from nbody_tpu.bench import plots as jplots
from nbody_tpu.cli import main as jmain
from nbody_tpu_torch.bench import plots as tplots
from nbody_tpu_torch.bench import sweeps
from nbody_tpu_torch.cli import main
from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.models.simulation import Simulation
from nbody_tpu_torch.rng import random_state

# tests/test_cli.py's regexes
PARALLEL_RE = re.compile(
    r"GPU parallel computation took\s+(\d+)\s+microseconds"
)
CONFIG_RE = re.compile(r"^\s*(\d+)\s*,\s*([^,]+)\s*,\s*(\d+)\s*,")
CONFIG5_RE = re.compile(r"^\s*(\d+)\s*,\s*(\d+)\s*,\s*(\d+)\s*,\s*(\d+)\s*,")


def _parallel_by_thread(lines):
    """plot_first_scale.py's parse: config lines set the thread context,
    timing lines attach to it."""
    times, last = {}, None
    for line in lines:
        if "n_bodies" in line.lower():
            continue
        m = CONFIG_RE.search(line)
        if m:
            last = int(m.group(2))
            continue
        m = PARALLEL_RE.search(line)
        if m and last is not None:
            times.setdefault(last, []).append(int(m.group(1)))
    return times


@pytest.fixture(scope="module")
def strong_file(tmp_path_factory):
    """A strong sweep at device counts 1 and 2 (two gloo processes)."""
    path = tmp_path_factory.mktemp("strong") / "res.txt"
    rc = main(["sweep", "--device", "cpu", "--experiment", "strong",
               "--engine", "allpairs", "--n-bodies", "64", "--steps", "2",
               "--repeats", "1", "--device-counts", "1,2",
               "--results-file", str(path)])
    assert rc == 0
    return path


def test_sweep_strong_format(strong_file):
    lines = strong_file.read_text().splitlines()
    assert lines[0].startswith("n_bodies, n_threads, n_simulations")
    assert set(_parallel_by_thread(lines)) == {1, 2}
    assert lines[-1].startswith("# backend: cpu, gloo processes")


def test_timed_contract_excludes_the_first_step():
    """Every sweep point (and BASELINE configs 4-5) is timed by
    ``timed_contract``: a first step that is slow, as a process's first
    step on the card is (~1.2 s), stays out of the timed loop."""
    cfg = SimConfig(n_bodies=64, n_steps=3, engine="allpairs")
    sim = Simulation(cfg, state=random_state(cfg, device="cpu"))
    inner, calls = sim.step_fn, []

    def step(state):
        calls.append(time.perf_counter())
        if len(calls) == 1:
            time.sleep(0.5)
        return inner(state)

    sim.step_fn = step
    timing, _ = sweeps.timed_contract(sim)
    assert len(calls) == 4
    assert timing.parallel_us < 0.5e6


def test_sweep_d1_and_d2_points_time_alike(tmp_path, monkeypatch):
    """The D = 1 point (this process) and the D = 2 point (two gloo
    processes) of a strong sweep go through the same warm timing: the
    D = 1 point calls ``timed_contract`` once a repeat, and the D = 2
    point's ms/step is at most 10x the D = 1 point's.  Warm, D = 2 reads
    1.5x here (grouped BH, 1,024 bodies: ~40 against ~58 ms/step); a
    cold first step of the card's size in only one of them would put
    2 timed steps 10-30x apart."""
    timed, spied = sweeps.timed_contract, []

    def spy(sim):
        spied.append(sim.config.n_bodies)
        return timed(sim)

    monkeypatch.setattr(sweeps, "timed_contract", spy)
    path = tmp_path / "res.txt"
    assert main(["sweep", "--device", "cpu", "--experiment", "strong",
                 "--engine", "barnes_hut", "--n-bodies", "1024", "--steps",
                 "2", "--repeats", "2", "--device-counts", "1,2",
                 "--results-file", str(path)]) == 0
    assert spied == [1024, 1024]
    per_step = {}
    for _, procs, par_us, _ in tplots._parse_scaling_results(str(path))[0]:
        per_step.setdefault(procs, []).append(par_us / 2)
    d1, d2 = (statistics.median(per_step[d]) for d in (1, 2))
    assert d2 <= 10 * d1, (d1, d2)


def test_sweep_bodies_format(tmp_path):
    path = tmp_path / "res2.txt"
    rc = main(["sweep", "--device", "cpu", "--experiment", "bodies",
               "--engine", "naive", "--steps", "2", "--repeats", "2",
               "--body-counts", "32,64", "--results-file", str(path)])
    assert rc == 0
    lines = path.read_text().splitlines()
    configs = [m for line in lines if (m := CONFIG5_RE.search(line))]
    assert sorted(int(m.group(1)) for m in configs) == [32, 32, 64, 64]
    assert sorted(int(m.group(4)) for m in configs) == [1, 1, 2, 2]


def test_sweep_tiles_axis(tmp_path):
    path = tmp_path / "tiles.txt"
    rc = main(["sweep", "--device", "cpu", "--sweep-axis", "tiles",
               "--engine", "allpairs", "--n-bodies", "512", "--steps", "1",
               "--repeats", "1", "--results-file", str(path)])
    assert rc == 0
    lines = path.read_text().splitlines()
    assert set(_parallel_by_thread(lines)) == {64, 128, 256, 512}
    assert lines[-1] == "# backend: cpu single-device, axis=tiles"


def test_sweep_group_chunk_axis_exits_2(tmp_path, capsys):
    path = tmp_path / "gc.txt"
    rc = main(["sweep", "--device", "cpu", "--sweep-axis", "group-chunk",
               "--engine", "barnes_hut", "--results-file", str(path)])
    assert rc == 2
    assert "group_chunk" in capsys.readouterr().err
    assert not path.exists()


def test_parse_matches_jax_on_a_port_file(strong_file):
    got = tplots._parse_scaling_results(str(strong_file))
    assert got == jplots._parse_scaling_results(str(strong_file))
    assert [r[1] for r in got[0]] == [1, 2]


def test_parse_matches_jax_on_a_jax_file(tmp_path, capsys):
    path = tmp_path / "jax.txt"
    assert jmain(["sweep", "--experiment", "weak", "--engine", "naive",
                  "--n-bodies", "32", "--steps", "1", "--repeats", "2",
                  "--device-counts", "1,2", "--results-file",
                  str(path)]) == 0
    # the reference scripts' product thread fields (plot_first_scale.py
    # :103-116), as a first_scaling_script.sh file carries them
    with open(path, "a") as f:
        f.write("40000, 1024*16, 10, \n\nGPU total computation took 9 "
                "milliseconds.\n\nGPU parallel computation took 8123 "
                "microseconds.\n")
    got = tplots._parse_scaling_results(str(path))
    assert got == jplots._parse_scaling_results(str(path))
    assert len(got[0]) == 5 and got[0][-1][1] == 1024 * 16


def test_plot_verb_writes_pngs(tmp_path, strong_file, capsys):
    out2, out3 = tmp_path / "r2", tmp_path / "r3"
    assert main(["run", "--device", "cpu", "--n-bodies", "256", "--steps",
                 "2", "--save-positions", "--save-tree-dumps",
                 "--output-dir", str(out2)]) == 0
    assert main(["run", "--device", "cpu", "--dims", "3", "--n-bodies",
                 "256", "--steps", "2", "--save-positions", "--output-dir",
                 str(out3)]) == 0
    pngs = {
        "positions": tmp_path / "traj.png",
        "positions-3d": tmp_path / "traj3.png",
        "quadtree": tmp_path / "tree.png",
    }
    for flag, src in (("positions", out2 / "positions.txt"),
                      ("positions-3d", out3 / "positions.txt"),
                      ("quadtree", out2 / "quadtree_init.txt")):
        assert main(["plot", f"--{flag}", str(src), "--out",
                     str(pngs[flag])]) == 0
        assert pngs[flag].stat().st_size > 0
    prefix = tmp_path / "strong"
    assert main(["plot", "--analysis", str(strong_file), "--out",
                 str(prefix)]) == 0
    for kind in ("runtime", "speedup", "efficiency"):
        assert (tmp_path / f"strong_{kind}.png").stat().st_size > 0
    assert main(["plot"]) == 2
