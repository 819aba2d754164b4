"""The port's ``bench`` verb and BASELINE configs
(nbody_tpu_torch.bench.headline, nbody_tpu_torch.bench.baseline) on the
CPU.

* ``bench --device cpu``: one last JSON line with the JAX package's five
  keys and the port's; without a card and without ``--device cpu`` the
  entry points exit non-zero and print no result line.
* Config 1 on a triplet the port's textio wrote, against the JAX
  package's ``config1`` on the same triplet: the same step-25/45/100
  error keys, the f32 errors within 1e-4 and the f64 errors within 1e-9
  (all relative to the largest coordinate) at steps 25 and 45, where the
  config's pass flags bind (the reference's own CPU and GPU runs part
  "around 45th iteration", observations.txt:43), and equal flags.  The
  triplet is tests/test_parallel.py's jittered grid (bounded
  separations) at 1,024 bodies: on clouds of the reference's uniform
  distribution a close encounter before step 25 amplifies the two
  packages' summation orders past the f32 bound (seeds 0 / 2: q995 at
  step 25 1.016e-3 against 7.93e-4, 4.63e-3 against 5.07e-3), as it
  does the f64 ones by step 100 on the grid too (1.7e-8 apart), so at
  step 100 the keys are held to be present and finite.
* Config 2 and configs 4-5 at a reduced N; the results file's atomic
  write, the merge of a partial rerun and a failed rerun that keeps the
  good record.
"""

import json
import math

import numpy as np
import pytest
import torch

import nbody_tpu.bench.baseline as jbaseline
from nbody_tpu_torch.bench import baseline, headline
from nbody_tpu_torch.cli import main
from nbody_tpu_torch.utils.textio import save_init_triplet

JAX_KEYS = {"metric", "value", "unit", "vs_baseline", "backend"}
PORT_KEYS = {"card", "power_limit", "n", "steps", "repeats",
             "allpairs2d_loop_ms", "allpairs2d_fused_ms", "bh2d_loop_ms",
             "bh2d_fused_ms", "bh2d_overflowed_bodies", "bh3d_loop_ms",
             "bh3d_fused_ms", "bh3d_large_loop_ms", "bh3d_large_fused_ms",
             "bh3d_large_n",
             "bh3d_large_route", "bh3d_large_retried_steps"}
CPU = torch.device("cpu")


def test_bench_cpu_prints_one_json_line_last(capsys):
    # the verb's entry point at 1 run of 1 step; the verb itself fixes 5
    # runs of 10 steps
    assert headline.main("cpu", repeats=1, steps=1) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    line = json.loads(lines[-1])
    assert set(line) == JAX_KEYS | PORT_KEYS
    assert line["backend"] == "cpu" and line["n"] == 2048
    assert line["metric"] == "allpairs_pairwise_interactions_per_sec_n2048"
    assert line["unit"] == "pairs/s/chip"
    assert line["bh3d_large_n"] == 4 * 2048
    for key, v in line.items():
        if key.endswith("_ms") or key in ("value", "vs_baseline"):
            assert math.isfinite(v) and v > 0, key
    assert line["value"] == pytest.approx(
        2048**2 / (line["allpairs2d_fused_ms"] / 1e3))
    assert line["vs_baseline"] == pytest.approx(line["value"] / 1e10)


@pytest.mark.parametrize("flag", ["--repeats", "--steps"])
def test_bench_verb_fixes_its_method(flag, capsys):
    with pytest.raises(SystemExit) as e:
        main(["bench", "--device", "cpu", flag, "1"])
    assert e.value.code == 2
    assert not capsys.readouterr().out.strip()


@pytest.mark.parametrize("argv", [
    ["bench"],
    ["sweep", "--engine", "allpairs", "--n-bodies", "64", "--repeats", "1"],
    ["baseline"],
], ids=["bench", "sweep", "baseline"])
def test_no_card_no_result(argv, monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    if argv[0] == "baseline":
        rc = baseline.main([])
    else:
        rc = main(argv)
    out, err = capsys.readouterr()
    assert rc != 0
    assert "torch.cuda.is_available() is False" in err
    assert not out.strip()
    assert not list(tmp_path.iterdir())


@pytest.fixture(scope="module")
def triplet(tmp_path_factory):
    """tests/test_parallel.py's jittered 32 x 32 grid, with masses and
    velocities of the reference's ranges."""
    rng = np.random.default_rng(3)
    axes = np.meshgrid(np.arange(32), np.arange(32))
    p = np.stack(axes, -1).reshape(-1, 2).astype(np.float64)
    p = (p + rng.uniform(0.25, 0.75, p.shape)) / 32 * 0.2 - 0.1
    m = 10 ** rng.uniform(-1, np.log10(0.5), 1024)
    v = rng.uniform(-1e-4, 1e-4, (1024, 2))
    d = tmp_path_factory.mktemp("triplet")
    save_init_triplet(str(d), m, p, v)
    return d


def test_config1_matches_jax(triplet, monkeypatch):
    got = baseline.config1(CPU, ref_dir=str(triplet))
    monkeypatch.setattr(jbaseline, "REF_DIR", str(triplet))
    want = jbaseline.config1()
    assert set(got) - {"seconds"} <= set(want) | {"seconds"}
    assert set(got["f32_err_by_step"]) == set(want["f32_err_by_step"]) == {
        25, 45, 100}
    assert set(got["f64_q995_rel_by_step"]) == {25, 45, 100}
    for step in (25, 45):
        for key in ("rms_rel", "q995_rel"):
            assert abs(got["f32_err_by_step"][step][key]
                       - want["f32_err_by_step"][step][key]) <= 1e-4
        assert abs(got["f64_q995_rel_by_step"][step]
                   - want["f64_q995_rel_by_step"][step]) <= 1e-9
    assert np.isfinite(got["f64_q995_rel_by_step"][100])
    assert np.isfinite(list(got["f32_err_by_step"][100].values())).all()
    for key in ("pass_1e-3_at_step45_f64", "pass_1e-3_at_step25_f32"):
        assert got[key] == want[key]


def test_config1_without_triplet_is_an_error_record(tmp_path, monkeypatch):
    monkeypatch.delenv("NBODY_REFERENCE_DIR", raising=False)
    out = tmp_path / "r.json"
    rec, = baseline.run_configs({1}, CPU, str(out))
    assert "NBODY_REFERENCE_DIR is not set" in rec["error"]
    monkeypatch.setenv("NBODY_REFERENCE_DIR", str(tmp_path))
    rec, = baseline.run_configs({1}, CPU, str(out))
    assert "masses_init.txt" in rec["error"]


def test_config2_at_a_reduced_n():
    rec = baseline.config2(CPU, n=1024)
    assert rec["n"] == 1024 and rec["pairs_per_sec"] > 0
    # the JAX kernel test's bound against f64 (tests/test_allpairs.py:62)
    assert rec["max_rel_err_vs_dense"] <= 2e-4


@pytest.mark.parametrize("weak", [False, True], ids=["strong", "weak"])
def test_configs_4_5_time_the_reachable_points(weak, tmp_path):
    rec = baseline.config45(CPU, weak, n=1024, out_dir=str(tmp_path))
    assert rec["config"] == (5 if weak else 4)
    pt, = rec["points"]
    assert (pt["devices"], pt["n"], pt["label"]) == (1, 1024, "cpu")
    assert pt["step_seconds"] > 0 and pt["retried_steps"] == 0
    assert pt["comm_bytes_per_step_per_chip"] == 0
    assert [d["devices"] for d in rec["not_run"]] == [2, 4, 8]
    assert "projection_real_hardware" not in rec
    assert not list(tmp_path.iterdir())


def test_rerun_merges_atomically(tmp_path):
    out = tmp_path / "r.json"
    prior = [{"config": c, "mark": "old"} for c in (1, 2, 3, 4, 5)]
    out.write_text(json.dumps(prior))
    report = baseline.run_configs({2}, CPU, str(out), n2=512)
    assert [r["config"] for r in report] == [1, 2, 3, 4, 5]
    assert json.loads(out.read_text()) == report
    assert "mark" not in report[1] and report[1]["n"] == 512
    assert all(r["mark"] == "old" for r in report if r["config"] != 2)
    assert [p.name for p in tmp_path.iterdir()] == ["r.json"]


def test_failed_rerun_keeps_the_good_record(tmp_path, monkeypatch):
    out = tmp_path / "r.json"
    good = baseline.run_configs({2}, CPU, str(out), n2=512)[0]

    def broken(device, n=16384):
        raise RuntimeError("card lost")

    monkeypatch.setattr(baseline, "config2", broken)
    rec, = baseline.run_configs({2}, CPU, str(out))
    assert rec == {**good, "last_error": "RuntimeError: card lost"}
    assert json.loads(out.read_text()) == [rec]
    # a config that never had a good record keeps its error
    assert baseline.merge([], [{"config": 3, "error": "x"}]) == [
        {"config": 3, "error": "x"}]


def test_baseline_exit_code_says_a_config_failed(tmp_path, monkeypatch,
                                                 capsys):
    out = str(tmp_path / "r.json")
    argv = ["--configs", "2", "--device", "cpu", "--out", out]
    monkeypatch.setattr(baseline, "config2",
                        lambda device, n=16384: {"config": 2, "n": n})
    assert baseline.main(argv) == 0

    def broken(device, n=16384):
        raise RuntimeError("card lost")

    monkeypatch.setattr(baseline, "config2", broken)
    assert baseline.main(argv) == 1
    assert "configs [2] failed" in capsys.readouterr().err
    # the good record is kept, the failure beside it
    rec, = json.loads(open(out).read())
    assert rec["n"] == 16384 and rec["last_error"] == (
        "RuntimeError: card lost")
    # a config of an earlier run that failed does not fail this run
    monkeypatch.setattr(baseline, "config3",
                        lambda device, out_dir, n=65536: {"config": 3})
    assert baseline.main(["--configs", "3", "--device", "cpu", "--out",
                          out]) == 0
