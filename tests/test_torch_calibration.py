"""The port's calibration scripts and examples (nbody_tpu_torch.scripts,
nbody_tpu_torch.examples) against nbody_tpu on the CPU.

* ``return_demand`` in both collectors: the dicts of the JAX package's
  walks (run through its XLA route, jitted as its own tests run it)
  exactly, 2D and 3D, uniform and blobs, N=4,096; the merged-run count
  equals the JAX package's ``merge_ranges`` on the JAX ranges; with
  ``return_demand=False`` the walk's outputs are bit-equal to its first
  three items with it on (the demand is read from tensors the walk
  computes anyway).
* ``windows.py`` at 3D N=4,096 prints the JAX script's lines exactly.
* ``phase_split`` and both examples run end to end at N <= 2,048.
"""

import contextlib
import functools
import importlib.util
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ops import bh3d as jb3
from nbody_tpu.ops import bh_grouped as jb2
from nbody_tpu.ops import experiments as jx
from nbody_tpu.ops import tree as jt2
from nbody_tpu.ops import tree3d as jt3
from nbody_tpu_torch.ops import bh3d as tb3
from nbody_tpu_torch.ops import bh_grouped as tb2
from nbody_tpu_torch.ops import tree as tt2
from nbody_tpu_torch.ops import tree3d as tt3
from nbody_tpu_torch.scripts import demand, phase_split, windows

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, GS = 4096, 2048


def _jax_script(name: str):
    """scripts/<name>.py of the JAX package, imported from its file."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_demand(dims: int, init: str):
    """The JAX walk's demand dict and ranges on the demand script's state
    (scripts/demand.py: fmul 2, list/direct caps 4096)."""
    m, p = demand.initial_cloud(N, dims, init, np.random.default_rng(0))
    m, p = m.astype(np.float32), p.astype(np.float32)
    if dims == 3:
        md = jt3.default_max_depth3(N)
        tree = jt3.build_octree(jnp.asarray(p), jnp.asarray(m), max_depth=md)
        sched = jb3.frontier_schedule_3d(jb3.frontier_peak_3d(N), md, N)
        walk, dcm, kids = (jb3._collect_lists_3d,
                           jb3.direct_cell_max_default(N), 8)
    else:
        md = 9
        tree = jt2.build_quadtree(jnp.asarray(p), jnp.asarray(m),
                                  max_depth=md)
        sched = jb2.frontier_schedule(jb2.frontier_peak(N), md, N)
        walk, dcm, kids = jb2._collect_lists, 32, 4
    ps = p[np.argsort(np.asarray(tree.codes), kind="stable")]
    n_sub = max(4, GS // 128)
    sub = ps.reshape(-1, n_sub, GS // n_sub, dims)
    bbox = tuple(jnp.asarray(f(sub[..., a], axis=2)) for a in range(dims)
                 for f in (np.min, np.max))
    kw = dict(theta=0.5, softening=1e-15,
              frontier_caps=tuple(min(kids**lv, 2 * c)
                                  for lv, c in enumerate(sched)),
              list_cap=4096, direct_cap=4096, direct_cell_max=dcm,
              return_demand=True)
    out = jax.jit(functools.partial(walk, **kw))(bbox, tree)
    return out[3], np.asarray(out[1])


@pytest.mark.parametrize("init", ["uniform", "blobs"])
@pytest.mark.parametrize("dims", [2, 3])
def test_return_demand_matches_jax(dims, init, capsys):
    got = demand.run(N, dims, init=init, device="cpu")
    want, jranges = _jax_demand(dims, init)
    assert got["frontier"] == np.asarray(want["frontier"]).tolist()
    assert got["approx"] == int(want["approx"])
    assert got["direct"] == int(want["direct"])
    merged, _ = jx.merge_ranges(jnp.asarray(jranges))
    assert got["runs"] == int((np.asarray(merged)[:, :, 1] > 0).sum(1).max())
    assert got["direct"] > 0 and max(got["frontier"]) > 0
    assert "frontier demand entering levels" in capsys.readouterr().out


@pytest.mark.parametrize("dims", [2, 3])
def test_return_demand_off_leaves_the_walk_unchanged(dims):
    rng = np.random.default_rng(5)
    p = torch.tensor(rng.uniform(-0.1, 0.1, (N, dims)), dtype=torch.float32)
    m = torch.tensor(10 ** rng.uniform(-1, np.log10(0.5), N),
                     dtype=torch.float32)
    if dims == 3:
        md = tt3.default_max_depth3(N)
        tree = tt3.build_octree(p, m, max_depth=md)
        walk = tb3._collect_lists_3d
        caps = tb3.frontier_schedule_3d(tb3.frontier_peak_3d(N), md, N)
    else:
        tree = tt2.build_quadtree(p, m, max_depth=9)
        walk = tb2._collect_lists
        caps = tb2.frontier_schedule(tb2.frontier_peak(N), 9, N)
    sub = p[torch.argsort(tree.codes, stable=True)].reshape(-1, 16, 128, dims)
    bbox = tuple(f(sub[..., a], 2) for a in range(dims)
                 for f in (torch.amin, torch.amax))
    kw = dict(theta=0.5, softening=1e-15, frontier_caps=caps, list_cap=4096,
              direct_cap=2048, direct_cell_max=32, quarter_bits=True)
    off = walk(bbox, tree, **kw)
    on = walk(bbox, tree, return_demand=True, **kw)
    assert len(off) == 4 and len(on) == 5
    assert set(on[4]) == {"frontier", "approx", "direct"}
    flat = [(off[0], on[0]), ([off[1]], [on[1]]), ([off[2]], [on[2]]),
            ([off[3]["bits"], off[3]["mass"], *off[3]["com"]],
             [on[3]["bits"], on[3]["mass"], *on[3]["com"]])]
    for a, b in flat:
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_windows_prints_jax_lines():
    jax_windows = _jax_script("windows")
    want, got = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(want):
        jax_windows.run(N)
    with contextlib.redirect_stdout(got):
        windows.run(N, device="cpu")
    assert got.getvalue() == want.getvalue()
    rows = [ln for ln in got.getvalue().splitlines() if "|" in ln
            and not ln.startswith("#")]
    assert len(rows) == tt3.default_max_depth3(N) + 1


@pytest.mark.parametrize("dims,collect", [(2, None), (3, "dense")])
def test_phase_split_runs(dims, collect, capsys):
    out = phase_split.split(2048, dims, collect=collect, reps=1,
                            device="cpu")
    assert set(out["stages"]) == set(phase_split.STAGES)
    assert set(out["spread"]) == {*phase_split.STAGES, "rest", "sum",
                                  "full", "pass"}
    for k, v in out["spread"].items():
        assert v["min"] <= v["median"] <= v["max"], k
    assert out["stages"]["evaluate"] > 0 and out["kernel_ms"] > 0
    assert out["spread"]["full"]["median"] > 0 and out["pass_ms"] > 0
    assert out["collector"] == ("collect_lists_3d_dense" if collect
                                else "_collect_lists")
    assert "ms/pass" in capsys.readouterr().out


def test_examples_run(tmp_path, capsys):
    from nbody_tpu_torch.examples import reference_experiment, three_d_demo

    three_d_demo.run(str(tmp_path / "3d"), n_bodies=512, device="cpu")
    reference_experiment.run(str(tmp_path / "ref"), n_bodies=1024,
                             device="cpu")
    for f in ("3d/positions.txt", "3d/plot_3d.png", "ref/positions.txt",
              "ref/quadtree_init.txt", "ref/quadtree_init_png.png",
              "ref/quadtree_final_png.png", "ref/trajectories.png",
              "ref/metrics.csv"):
        assert (tmp_path / f).stat().st_size > 0, f
    assert "artifacts in" in capsys.readouterr().out
