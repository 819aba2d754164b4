"""The port's host contracts against nbody_tpu's (CPU): the f64 oracle,
the native C++ engine's bindings, the text formats, the quadtree dumps of
``run_contract``, the ``compare`` verb's verdicts and the debug checks.

The oracle is the same NumPy code in both packages, so it must give the
same bits; the native library is the same source built the same way, so
its dumps and trajectories must be byte- and bit-equal.  Those tests
skip only where the native toolchain is missing, as tests/test_native.py
does."""

import dataclasses
import re

import numpy as np
import pytest
import torch

import nbody_tpu
import nbody_tpu_torch
from nbody_tpu.models import oracle as joracle
from nbody_tpu.models.simulation import Simulation as JaxSimulation
from nbody_tpu.state import to_numpy as jax_to_numpy
from nbody_tpu.utils import textio as jtext
from nbody_tpu_torch import cli
from nbody_tpu_torch.models import oracle as toracle
from nbody_tpu_torch.models.simulation import Simulation
from nbody_tpu_torch.physics import pair_accelerations_dense
from nbody_tpu_torch.state import from_numpy, make_state
from nbody_tpu_torch.utils import textio as ttext
from nbody_tpu_torch.utils.debug import checked_accel, validate_state

G = 6.67e-11


def _cloud(n, seed=0):
    rng = np.random.default_rng(seed)
    masses = 10 ** rng.uniform(-1, np.log10(0.5), n)
    positions = rng.uniform(-0.1, 0.1, (n, 2))
    velocities = rng.uniform(-1e-4, 1e-4, (n, 2))
    return masses, positions, velocities


def _natives():
    """(JAX package's native module, the port's), or skip."""
    from nbody_tpu.utils import native as jnative
    from nbody_tpu_torch.utils import native as tnative

    for mod in (jnative, tnative):
        try:
            mod.load()
        except mod.NativeUnavailable as e:
            pytest.skip(f"native toolchain unavailable: {e}")
    return jnative, tnative


def test_oracle_bit_equal_to_jax():
    masses, positions, velocities = _cloud(300, seed=2)
    for fn, kw in ((lambda m: m.bh_accelerations, dict(theta=0.5)),
                   (lambda m: m.naive_accelerations, {})):
        np.testing.assert_array_equal(
            fn(toracle)(positions, masses, g=G, **kw),
            fn(joracle)(positions, masses, g=G, **kw))
    np.testing.assert_array_equal(
        toracle.simulate(positions, velocities, masses, 2, g=G,
                         engine="barnes_hut"),
        joracle.simulate(positions, velocities, masses, 2, g=G,
                         engine="barnes_hut"))
    assert toracle.compute_root_bounds(positions) == (
        joracle.compute_root_bounds(positions))
    for max_depth in (9, 2):
        tl = toracle.AdaptiveQuadtree(max_depth=max_depth).build(
            positions, masses).dump_lines(positions)
        jl = joracle.AdaptiveQuadtree(max_depth=max_depth).build(
            positions, masses).dump_lines(positions)
        assert tl == jl


def test_native_tree_dump_and_simulate_equal_to_jax():
    jnative, tnative = _natives()
    masses, positions, velocities = _cloud(500, seed=5)
    text = tnative.tree_dump(positions, masses, max_depth=9)
    assert text == jnative.tree_dump(positions, masses, max_depth=9)
    tree = toracle.AdaptiveQuadtree(max_depth=9).build(positions, masses)
    assert text == "\n".join(tree.dump_lines(positions)) + "\n"
    for engine in ("barnes_hut", "naive"):
        tp, tv = tnative.simulate(positions, velocities, masses, 3, 1.0, G,
                                  engine=engine)
        jp, jv = jnative.simulate(positions, velocities, masses, 3, 1.0, G,
                                  engine=engine)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(
        tnative.bh_accelerations(positions, masses, g=G),
        jnative.bh_accelerations(positions, masses, g=G))
    np.testing.assert_array_equal(
        tnative.naive_accelerations(positions, masses, g=G),
        jnative.naive_accelerations(positions, masses, g=G))


def test_native_builds_into_the_build_directory():
    _, tnative = _natives()
    path = tnative._target()
    assert path.exists()
    assert path.parent.parts[-2:] == ("build", "nbody_tpu_torch")


def test_textio_functions_byte_equal_to_jax(tmp_path):
    for v in (1.0, -0.046444, 1e-7, 123456.789, 0.0):
        assert ttext.cxx_to_string(v) == jtext.cxx_to_string(v)
    masses, positions, velocities = _cloud(5, seed=1)
    assert ttext.format_bodies(masses, positions, velocities) == (
        jtext.format_bodies(masses, positions, velocities))
    w = ttext.PositionsWriter(str(tmp_path / "positions.txt"))
    w.append(0.0, positions)
    w.append(1.0, positions + 0.5)
    w.flush()
    np.testing.assert_array_equal(
        ttext.read_positions_file(str(tmp_path / "positions.txt")),
        jtext.read_positions_file(str(tmp_path / "positions.txt")))


def test_run_contract_dumps_match_jax(tmp_path):
    """Quadtree dumps at the first and last steps: the first byte-equal
    to the JAX package's on the same state, the last the oracle's dump of
    the positions at the top of the last step."""
    jcfg = nbody_tpu.SimConfig(n_bodies=300, n_steps=3, engine="barnes_hut",
                               seed=4, save_tree_dumps=True,
                               output_dir=str(tmp_path / "jax"))
    jsim = JaxSimulation(jcfg)
    m, p, v, _, _ = jax_to_numpy(jsim.state)
    tcfg = nbody_tpu_torch.SimConfig.from_dict(
        {**dataclasses.asdict(jcfg), "output_dir": str(tmp_path / "torch"),
         "n_steps": 2})
    tsim = Simulation(tcfg, state=from_numpy(m, p, v, device="cpu"),
                      device="cpu")
    jsim.run_contract()
    before_last = tsim.step_fn(tsim.state)  # the state the last dump sees
    tsim.run_contract()
    init = (tmp_path / "torch" / "quadtree_init.txt").read_text()
    assert init == (tmp_path / "jax" / "quadtree_init.txt").read_text()
    pos = before_last.positions.double().numpy()
    tree = toracle.AdaptiveQuadtree(max_depth=9).build(pos, m)
    assert (tmp_path / "torch" / "quadtree_final.txt").read_text() == (
        "\n".join(tree.dump_lines(pos)) + "\n")


def test_run_contract_dumps_skip_in_3d_with_jax_warning(tmp_path, capsys):
    cfg = nbody_tpu_torch.SimConfig(n_bodies=256, n_dim=3, n_steps=1,
                                    engine="allpairs", save_tree_dumps=True,
                                    output_dir=str(tmp_path))
    Simulation(cfg, device="cpu").run_contract()
    err = capsys.readouterr().err
    assert ("WARNING: --save-tree-dumps is 2D-only (the quadtree dump "
            "contract, TraverseTreeToFile project.cu:485-533, has no 3D "
            "analogue in the reference); skipping dumps") in err
    assert not list(tmp_path.glob("quadtree_*"))


def test_compare_engines_verdicts(capsys):
    """The checkEqual workflow (project.cu:1070-1092): two engines, one
    init, the verdict lines and return codes of the JAX CLI."""
    common = ["compare", "--device", "cpu", "--n-bodies", "96", "--steps",
              "3", "--seed", "3"]
    # f64 native C++ against the f64 oracle: a bit-faithful pair
    rc = cli.main(common + ["--engine-a", "native", "--engine-b", "oracle"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "The final positions are the same." in out
    assert "total computation took" in out

    rc = cli.main(common + ["--engine-a", "oracle_naive", "--engine-b",
                            "naive"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "!!!!! The final positions are NOT the same !!!!!" in out
    assert re.search(r"Difference at index \[\d+\]\[\d+\]:", out)

    rc = cli.main(common + ["--engine-a", "oracle_naive", "--engine-b",
                            "naive", "--tol", "1e-5"])
    assert rc == 0
    assert "The final positions are the same." in capsys.readouterr().out

    rc = cli.main(common + ["--dims", "3", "--engine-a", "oracle"])
    assert rc == 2
    assert "2D-only host engines" in capsys.readouterr().err


def test_compare_exact_bh_against_oracle(capsys):
    """The exact per-body BH, run fused, against the f64 oracle's BH."""
    rc = cli.main(["compare", "--device", "cpu", "--n-bodies", "256",
                   "--steps", "2", "--seed", "1", "--engine-a", "oracle",
                   "--engine-b", "barnes_hut", "--bh-mode", "exact",
                   "--tol", "1e-6"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "oracle total computation took" in out
    assert "barnes_hut total computation took" in out


def _state(n=64, seed=0, positions=None):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-0.1, 0.1, (n, 2)) if positions is None else positions
    return make_state(10 ** rng.uniform(-1, 0, n), p,
                      rng.uniform(-1e-4, 1e-4, (n, 2)), device="cpu")


def test_validate_state_rejects_bad():
    state = _state()
    validate_state(state)  # fine
    p = state.positions.numpy().copy()
    p[3, 0] = np.nan
    with pytest.raises(ValueError, match="non-finite positions"):
        validate_state(_state(positions=p))
    neg = _state()
    neg.masses[5] = -1.0
    with pytest.raises(ValueError, match="negative masses"):
        validate_state(neg)
    bad = _state()
    bad.velocities = bad.velocities[:10]
    with pytest.raises(ValueError, match="shape mismatch"):
        validate_state(bad)


def test_checked_accel_flags_nonfinite():
    p = torch.tensor([[0.0, 0.0], [1.0, 0.0]])
    m = torch.tensor([1.0, 1.0])

    def bad_accel(positions, masses):
        return pair_accelerations_dense(positions, masses, g=G) / 0.0

    with pytest.raises(FloatingPointError, match="non-finite acceleration"):
        checked_accel(bad_accel)(p, m)

    def good_accel(positions, masses):
        return pair_accelerations_dense(positions, masses, g=G)

    acc = checked_accel(good_accel)(p, m)
    assert torch.isfinite(acc).all()
