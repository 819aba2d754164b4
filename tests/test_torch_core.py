"""nbody_tpu_torch core modules against nbody_tpu on the same numpy inputs:
config, state, rng, physics, text I/O and timing lines (CPU)."""

import dataclasses
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbody_tpu
import nbody_tpu_torch
from nbody_tpu import physics as jphys
from nbody_tpu.models import oracle
from nbody_tpu.state import make_state as jmake_state
from nbody_tpu.utils import textio as jtext
from nbody_tpu.utils import timing as jtiming
from nbody_tpu_torch import physics as tphys
from nbody_tpu_torch import rng as trng
from nbody_tpu_torch.state import from_numpy, to_numpy
from nbody_tpu_torch.utils import textio as ttext
from nbody_tpu_torch.utils import timing as ttiming

G = 6.67e-11
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bodies(n, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    m = (10 ** rng.uniform(-1, np.log10(0.5), n)).astype(dtype)
    p = rng.uniform(-0.1, 0.1, (n, 2)).astype(dtype)
    v = rng.uniform(-1e-4, 1e-4, (n, 2)).astype(dtype)
    return m, p, v


def test_port_imports_without_jax():
    code = (
        "import sys, nbody_tpu_torch, nbody_tpu_torch.cli, "
        "nbody_tpu_torch.models.simulation, nbody_tpu_torch.ops.bh_grouped, "
        "nbody_tpu_torch.ops.experiments, nbody_tpu_torch.ops.barnes_hut, "
        "nbody_tpu_torch.models.oracle, nbody_tpu_torch.utils.native, "
        "nbody_tpu_torch.utils.debug, nbody_tpu_torch.utils.profiling, "
        "nbody_tpu_torch.parallel, nbody_tpu_torch.parallel.collectives, "
        "nbody_tpu_torch.bench.headline, nbody_tpu_torch.bench.baseline, "
        "nbody_tpu_torch.bench.sweeps, nbody_tpu_torch.bench.plots, "
        "nbody_tpu_torch.scripts.demand, nbody_tpu_torch.scripts.windows, "
        "nbody_tpu_torch.scripts.phase_split, "
        "nbody_tpu_torch.examples.three_d_demo, "
        "nbody_tpu_torch.examples.reference_experiment; "
        "assert 'jax' not in sys.modules, 'jax imported'; "
        "assert 'matplotlib' not in sys.modules, 'matplotlib imported'; "
        "bad = [m for m in sys.modules if m.split('.')[0] == 'nbody_tpu']; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_tf32_pinned_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("cls", ["SimConfig", "InitRanges", "MeshConfig"])
def test_config_fields_and_defaults_match(cls):
    jc, tc = getattr(nbody_tpu, cls), getattr(nbody_tpu_torch, cls)
    jf = [(f.name, f.default, f.default_factory) for f in
          dataclasses.fields(jc)]
    tf = [(f.name, f.default, f.default_factory) for f in
          dataclasses.fields(tc)]
    assert [f[0] for f in jf] == [f[0] for f in tf]
    assert dataclasses.asdict(jc()) == dataclasses.asdict(tc())


def test_config_carries_across_through_asdict():
    jcfg = nbody_tpu.SimConfig(n_bodies=4096, engine="barnes_hut",
                               theta=0.7, group_size=512, seed=3)
    tcfg = nbody_tpu_torch.SimConfig.from_dict(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.resolved_max_depth == jcfg.resolved_max_depth == 9
    assert tcfg.resolved_direct_cell_max == jcfg.resolved_direct_cell_max
    assert tcfg.n_tree_nodes == jcfg.n_tree_nodes
    assert tcfg.torch_dtype() == torch.float32


def test_state_round_trip_from_jax():
    m, p, v = _bodies(100)
    jstate = jmake_state(m, p, v, time=2.0, step=3)
    tstate = from_numpy(*nbody_tpu.state.to_numpy(jstate)[:3], time=2.0,
                        step=3, device="cpu")
    for a, b in zip(nbody_tpu.state.to_numpy(jstate), to_numpy(tstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert int(tstate.overflow) == 0 and tstate.step.dtype == torch.int32
    with pytest.raises(ValueError):
        from_numpy(m, p[:, :1], v, device="cpu")


@pytest.mark.parametrize("fn", ["state.make_state", "state.from_numpy",
                                "rng.random_state",
                                "utils.checkpoint.load_checkpoint"])
def test_state_helpers_default_to_the_card(fn):
    """A state made without a device lands on the card, as Simulation and
    the CLI default to: the kernels' CPU twins never run by accident."""
    import importlib
    import inspect

    mod, name = fn.rsplit(".", 1)
    helper = getattr(importlib.import_module(f"nbody_tpu_torch.{mod}"), name)
    assert inspect.signature(helper).parameters["device"].default == "cuda"


def test_make_state_on_the_cpu_keeps_cpu_tensors_there():
    from nbody_tpu_torch.state import make_state

    m, p, v = (torch.tensor(a) for a in _bodies(50))
    st = make_state(m, p, v, time=1.5, device="cpu")
    for t in (st.masses, st.positions, st.velocities, st.time, st.step,
              st.overflow):
        assert t.device.type == "cpu"
    assert torch.equal(st.positions, p) and float(st.time) == 1.5


@pytest.mark.parametrize("mode", ["uniform", "blobs"])
def test_rng_ranges_and_log_uniform_masses(mode):
    cfg = nbody_tpu_torch.SimConfig(n_bodies=20000, init_mode=mode, seed=5)
    s = trng.random_state(cfg, device="cpu")
    r = cfg.init
    m = s.masses.numpy()
    assert m.min() >= r.lower_m * (1 - 1e-6)
    assert m.max() <= r.higher_m * (1 + 1e-6)
    # log-uniform: log10(m) is uniform, so its mean is the midpoint
    mid = 0.5 * (np.log10(r.lower_m) + np.log10(r.higher_m))
    assert abs(np.log10(m).mean() - mid) < 0.01
    p, v = s.positions.numpy(), s.velocities.numpy()
    assert p.min() >= r.lower_p and p.max() <= r.higher_p
    assert v.min() >= r.lower_v and v.max() <= r.higher_v
    if mode == "uniform":
        assert abs(p.mean()) < 0.005
    else:  # two tight clusters: alternate bodies share a centre
        assert np.abs(p[0::2] - p[0::2].mean(0)).mean() < 0.01
    again = trng.random_state(cfg, device="cpu")
    assert torch.equal(again.positions, s.positions)


@pytest.mark.parametrize("softening", [0.0, 1e-3])
def test_pair_accelerations_dense_matches_jax(softening):
    m, p, _ = _bodies(300, seed=1)
    p[7] = p[3]  # a coincident pair: force defined as 0
    want = np.asarray(jphys.pair_accelerations_dense(
        jnp.asarray(p), jnp.asarray(m), G, softening=softening))
    got = tphys.pair_accelerations_dense(
        torch.tensor(p), torch.tensor(m), G, softening=softening).numpy()
    # f32 on both sides, reduction order differs: the JAX kernel test's
    # tolerance (tests/test_allpairs.py)
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=1e-11)


def test_pair_accelerations_chunked_f32_matches_jax():
    m, p, _ = _bodies(700, seed=2)
    want = np.asarray(jphys.pair_accelerations_chunked(
        jnp.asarray(p), jnp.asarray(m), G, chunk=128))
    got = tphys.pair_accelerations_chunked(
        torch.tensor(p), torch.tensor(m), G, chunk=128).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=1e-11)


def test_pair_accelerations_chunked_f64_matches_oracle():
    m, p, _ = _bodies(500, seed=3, dtype=np.float64)
    want = oracle.naive_accelerations(p, m, g=G)
    got = tphys.pair_accelerations_chunked(
        torch.tensor(p), torch.tensor(m), G, chunk=96).numpy()
    # both f64: only summation order differs
    np.testing.assert_allclose(got, want, rtol=1e-9,
                               atol=1e-12 * np.abs(want).max())


def test_integrate_energies_momentum_match_jax():
    m, p, v = _bodies(256, seed=4)
    acc = np.random.default_rng(9).normal(size=(256, 2)).astype(np.float32)
    js = jmake_state(m, p, v)
    ts = from_numpy(m, p, v, device="cpu")
    js2 = jphys.integrate(js, jnp.asarray(acc), 0.5)
    ts2 = tphys.integrate(ts, torch.tensor(acc), 0.5)
    # identical elementwise f32 ops: bit-equal
    np.testing.assert_array_equal(np.asarray(js2.positions),
                                  ts2.positions.numpy())
    np.testing.assert_array_equal(np.asarray(js2.velocities),
                                  ts2.velocities.numpy())
    assert float(ts2.time) == float(js2.time) and int(ts2.step) == 1
    for jf, tf in ((jphys.kinetic_energy, tphys.kinetic_energy),
                   (jphys.total_momentum, tphys.total_momentum)):
        np.testing.assert_allclose(tf(ts2).numpy(), np.asarray(jf(js2)),
                                   rtol=1e-5)
    np.testing.assert_allclose(
        float(tphys.potential_energy(ts2, G)),
        float(jphys.potential_energy(js2, G)), rtol=1e-5)


def _write_all(mod, d, m, p, v):
    mod.save_init_triplet(d, m, p, v)
    w = mod.PositionsWriter(os.path.join(d, "positions.txt"))
    w.append(0.0, p)
    w.append(1.0, p + v)
    w.flush()


@pytest.mark.parametrize(
    "name", ["masses_init.txt", "positions_init.txt", "velocities_init.txt",
             "positions.txt"])
def test_textio_bytes_identical(tmp_path, name):
    m, p, v = _bodies(50, seed=6)
    for mod, sub in ((jtext, "jax"), (ttext, "torch")):
        os.makedirs(tmp_path / sub)
        _write_all(mod, str(tmp_path / sub), m, p, v)
    a = (tmp_path / "jax" / name).read_bytes()
    b = (tmp_path / "torch" / name).read_bytes()
    assert a == b and len(a) > 0


def test_textio_load_and_check_equal(tmp_path, capsys):
    m, p, v = _bodies(20, seed=8)
    ttext.save_init_triplet(str(tmp_path), m, p, v)
    got = ttext.load_init_triplet(
        *(str(tmp_path / f) for f in ("masses_init.txt", "positions_init.txt",
                                      "velocities_init.txt")), 20)
    want = jtext.load_init_triplet(
        *(str(tmp_path / f) for f in ("masses_init.txt", "positions_init.txt",
                                      "velocities_init.txt")), 20)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    capsys.readouterr()
    for q in (p, p + 1.0):
        verdict = ttext.check_equal(p, q, "positions")
        out = capsys.readouterr().out
        assert verdict == jtext.check_equal(p, q, "positions")
        assert out == capsys.readouterr().out


def test_timing_lines_match_plotters_regex():
    # the regexes of nbody_tpu/bench/plots.py (plot_first_scale.py:58-59)
    par_re = re.compile(r"GPU parallel computation took\s+(\d+)\s+microseconds")
    tot_re = re.compile(r"GPU total computation took\s+(\d+)\s+milliseconds")
    t = ttiming.RunTiming(total_ms=12.7, parallel_us=3456.9)
    assert tot_re.search(t.total_line()).group(1) == "12"
    assert par_re.search(t.parallel_line()).group(1) == "3456"
    assert t.report() == jtiming.RunTiming(12.7, 3456.9).report()
    w = ttiming.Stopwatch()
    w.start()
    w.stop()
    assert w.accum_us >= 0.0
