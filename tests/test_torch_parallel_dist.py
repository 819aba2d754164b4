"""The port's multi-device steps over torch.distributed processes: two
gloo ranks on the CPU (rendezvous through a file, no port), against the
thread group, and ``run --devices`` through the CLI.

Bounds: the process group gives the thread group's bits (at D=2 every
reduction is a two-term sum, which commutes); the CLI's outputs are
counted exactly.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from nbody_tpu_torch import cli
from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.ops.tree import morton_codes, root_bounds
from nbody_tpu_torch.ops.tree3d import morton_codes_3d, root_bounds_3d
from nbody_tpu_torch.parallel import (
    make_mesh,
    make_mesh_2d,
    make_sharded_step,
    shard_state,
)
from nbody_tpu_torch.parallel.mesh import (
    gather_state,
    run_ranks,
    spawn,
    thread_meshes,
    thread_meshes_2d,
)
from nbody_tpu_torch.state import from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("dp_allpairs", "ring_allpairs", "dp_barnes_hut",
         "dp_barnes_hut_grouped", "dp_barnes_hut_sharded",
         "dp_barnes_hut_grouped3", "dp_barnes_hut_sharded3",
         "dp2d_allpairs")
N, STEPS = 1024, 2


def _dims(mode):
    return 3 if mode.endswith("3") else 2


def _state(dims):
    """A Morton-sorted uniform cloud (contiguous slabs: real windows)."""
    rng = np.random.default_rng(11)
    m = (10 ** rng.uniform(-1, np.log10(0.5), N)).astype(np.float32)
    p = rng.uniform(-0.1, 0.1, (N, dims)).astype(np.float32)
    v = rng.uniform(-1e-4, 1e-4, (N, dims)).astype(np.float32)
    pt = torch.from_numpy(p)
    if dims == 2:
        codes = morton_codes(pt, root_bounds(pt), 9)
    else:
        codes = morton_codes_3d(pt, root_bounds_3d(pt), 5)
    o = torch.argsort(codes, stable=True).numpy()
    return from_numpy(m[o], p[o], v[o], device="cpu")


def _config(mode):
    return SimConfig(n_bodies=N, n_dim=_dims(mode), group_size=96,
                     engine="allpairs" if "allpairs" in mode
                     else "barnes_hut")


def _run(mode, mesh):
    s = shard_state(_state(_dims(mode)), mesh)
    step = make_sharded_step(_config(mode), mesh, mode)
    for _ in range(STEPS):
        s = step(s)
    return gather_state(s, mesh).positions, int(s.overflow)


def _gloo_rank(rank, out_dir):
    """One gloo rank: every mode, its gathered positions kept by rank 0."""
    got = {}
    for mode in MODES:
        mesh = make_mesh_2d(1, 2) if mode == "dp2d_allpairs" else make_mesh(2)
        assert mesh.device == torch.device("cpu")
        pos, ovf = _run(mode, mesh)
        got[mode] = pos.numpy()
        got[f"{mode}/overflow"] = np.int64(ovf)
    if rank == 0:
        np.savez(os.path.join(out_dir, "gloo.npz"), **got)


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """ONE spawn of two gloo processes for every mode."""
    d = tmp_path_factory.mktemp("gloo")
    spawn(_gloo_rank, 2, (str(d),), device_type="cpu", init_dir=str(d))
    assert not [f for f in os.listdir(d) if f.startswith(".nbody_pg")]
    return dict(np.load(d / "gloo.npz"))


@pytest.mark.parametrize("mode", MODES)
def test_process_group_gives_the_thread_group_bits(gloo, mode):
    meshes = (thread_meshes_2d(1, 2, "cpu") if mode == "dp2d_allpairs"
              else thread_meshes(2, "cpu"))
    pos, ovf = run_ranks(lambda mesh: _run(mode, mesh), meshes)[0]
    assert np.array_equal(gloo[mode], pos.numpy())
    assert int(gloo[f"{mode}/overflow"]) == ovf


def _cli(args, tmp_path):
    return subprocess.run(
        [sys.executable, "-m", "nbody_tpu_torch", "run", "--device", "cpu",
         "--output-dir", str(tmp_path), *args],
        cwd=REPO, capture_output=True, text=True, timeout=600)


def test_cli_two_ranks_print_once_and_write_every_body(tmp_path):
    proc = _cli(["--devices", "2", "--mode", "dp_barnes_hut_sharded",
                 "--n-bodies", "2048", "--steps", "2", "--save-positions"],
                tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert len(re.findall(r"GPU total computation took \d+ milliseconds",
                          proc.stdout)) == 1
    assert len(re.findall(r"GPU parallel computation took \d+ microseconds",
                          proc.stdout)) == 1
    # steps 0, 1, 2, every one of the 2,048 bodies
    rows = (tmp_path / "positions.txt").read_text().splitlines()
    assert len(rows) == 3 * 2048
    assert not [f for f in os.listdir(tmp_path) if f.startswith(".nbody_pg")]


@pytest.mark.parametrize("mode", MODES)
def test_cli_runs_every_mode(mode, tmp_path):
    argv = ["run", "--device", "cpu", "--devices", "2", "--mode", mode,
            "--dims", str(_dims(mode)), "--n-bodies", "512", "--steps", "1",
            "--output-dir", str(tmp_path)]
    assert cli.main(argv) == 0


@pytest.mark.parametrize("mode,dims", [
    ("dp_barnes_hut_grouped", 3), ("dp_barnes_hut", 3),
    ("dp_barnes_hut_sharded", 3), ("dp_barnes_hut_grouped3", 2),
    ("dp_barnes_hut_sharded3", 2)])
def test_cli_refuses_a_mode_of_the_other_dimension(mode, dims, tmp_path,
                                                    capsys):
    argv = ["run", "--device", "cpu", "--devices", "2", "--mode", mode,
            "--dims", str(dims), "--n-bodies", "512", "--steps", "1",
            "--output-dir", str(tmp_path)]
    assert cli.main(argv) == 2
    assert f"--mode {mode} is {5 - dims}D-only" in capsys.readouterr().err


def test_cli_needs_a_card_a_rank(tmp_path):
    """More ranks than visible cards raise, naming both counts; nothing
    falls back to the CPU."""
    visible = torch.cuda.device_count()
    n = max(2, visible + 1)
    with pytest.raises(RuntimeError, match=rf"{n} ranks.* {visible} CUDA"):
        cli.main(["run", "--device", "cuda", "--devices", str(n),
                  "--engine", "allpairs", "--n-bodies", "512",
                  "--output-dir", str(tmp_path)])


@pytest.mark.parametrize("fused", [False, True], ids=["loop", "fused"])
def test_cli_two_ranks_write_every_output_once(fused, tmp_path):
    """Rank 0 writes the dumps, the metrics CSV and the checkpoint from
    the gathered state (the loop), or the gathered trajectory and dumps
    (--fused, which runs the sharded step step by step)."""
    extra = ["--fused"] if fused else ["--metrics-csv", "m.csv",
                                       "--checkpoint-every", "2"]
    argv = ["run", "--device", "cpu", "--devices", "2", "--mode",
            "dp_barnes_hut_grouped", "--n-bodies", "512", "--steps", "2",
            "--save-positions", "--save-tree-dumps",
            "--output-dir", str(tmp_path), *extra]
    assert cli.main(argv) == 0
    rows = (tmp_path / "positions.txt").read_text().splitlines()
    assert len(rows) == 3 * 512
    assert (tmp_path / "quadtree_init.txt").stat().st_size > 0
    assert (tmp_path / "quadtree_final.txt").stat().st_size > 0
    if not fused:
        csv = (tmp_path / "m.csv").read_text().splitlines()
        assert len(csv) == 1 + 3  # header, steps 0-2
        ckpt = np.load(tmp_path / "checkpoint.npz")
        assert ckpt["positions"].shape == (512, 2)
