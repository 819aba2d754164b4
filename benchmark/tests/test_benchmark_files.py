"""The benchmark's files: found by name, valid, and free of JAX."""

import dataclasses
import hashlib
import json
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from benchmark import cells, harness, roofline, run, states

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def spec():
    return cells.benchmark_spec(ROOT)


def test_every_cell_finds_its_files():
    for w in spec()["workloads"]:
        cell = cells.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["entry"] in ("run_scan", "run_contract")
        assert cell.traffic["metric"] in {m.name for m in cell.end_to_end}
        assert "setup_s" in {m.name for m in cell.end_to_end}
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert callable(cells.metric_module(m.name).read)


def test_spec_names_units_and_lengths():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    metrics = s["end_to_end"] + s["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in s["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["source"]) <= 200 and len(c["why"]) <= 200
        assert (ROOT / c["file"]).is_file()
    for w in s["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    four = [w for w in s["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(s["workloads"]) // 4)
    for m in s["per_layer"]:
        moved = [e for e in s["end_to_end"] if e["name"] == m["moves"]][0]
        assert set(m["workloads"]) <= set(moved.get("workloads", [
            w["name"] for w in s["workloads"]]))
    assert len(json.dumps(s)) < 64 * 1024


# a distribution that a configuration can name: equal masses, the
# reference's position and velocity ranges
EQUAL_MASSES = textwrap.dedent("""
    import torch


    def make(config, gen, device):
        n, d = int(config["n_bodies"]), int(config["n_dim"])
        u = torch.rand((n, 2 * d), generator=gen, device=device)
        return (torch.full((n,), 0.25, device=device),
                ((u[:, :d] - 0.5) * 0.2).contiguous(),
                ((u[:, d:] - 0.5) * 2e-4).contiguous())
""")


def new_cell_root(root: Path) -> dict:
    """A checkout at ``root`` with the benchmark's files and a new cell,
    ``bh2d_small.short``, made of new files and entries alone: its
    configuration names a new initial distribution and a program
    setting.  {path: bytes} of the files that were there."""
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    s = spec()
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    cfg = json.loads((ROOT / "benchmark/configs/bh2d_ref.json").read_text())
    cfg.update(name="bh2d_small", n_bodies=8192,
               program={"max_depth": 8})
    cfg["init"]["distribution"] = "equal_masses"
    cfg["reference"]["max_depth"] = 8
    (root / "benchmark/configs/bh2d_small.json").write_text(
        json.dumps(cfg))
    (root / "benchmark/inits/equal_masses.py").write_text(EQUAL_MASSES)
    (root / "benchmark/traffic/short.json").write_text(json.dumps(
        {"entry": "run_contract", "steps_per_run": 2,
         "metric": "loop_step_ms"}))
    (root / "benchmark/metrics/runs_done.short.py").write_text(
        "def read(r):\n    return float(r.runs)\n")
    s["configs"].append({"name": "bh2d_small", "source": "x",
                         "file": "benchmark/configs/bh2d_small.json",
                         "reduced": ["n_bodies"], "why": "x"})
    s["workloads"].append({"name": "bh2d_small.short",
                           "config": "bh2d_small", "traffic": "short",
                           "chips": 1, "why": "x"})
    for m in s["end_to_end"]:
        if m["name"] == "loop_step_ms":
            m["workloads"].append("bh2d_small.short")
    s["per_layer"].append({"name": "runs_done.short", "unit": "runs",
                           "better": "higher", "source": "program_counter",
                           "layer": "x", "moves": "loop_step_ms",
                           "workloads": ["bh2d_small.short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(s))
    return before


def test_a_new_cell_needs_no_edit(tmp_path):
    """A new configuration, initial distribution, program setting,
    traffic mix and per-layer metric are new files and entries; no file
    that is there changes, and a run of the new cell goes through."""
    before = new_cell_root(tmp_path)
    cell = cells.load_cell("bh2d_small.short", root=tmp_path)
    assert cell.config["n_bodies"] == 8192 and cell.traffic[
        "steps_per_run"] == 2
    program = harness.Program(cell, torch.device("cpu"))
    assert program.sim_config == parent_sim_config(cell).replace(
        max_depth=8)
    masses, positions, _ = states.make_bodies(cell.config, 2**40 + 3, 0,
                                              "cpu", root=tmp_path)
    assert bool((masses == 0.25).all()) and positions.shape == (8192, 2)
    cell.config["n_bodies"] = 2048
    part = harness.run_rank(cell, 2**40 + 3, 0.2, False,
                            torch.device("cpu"), 0.0)
    out = run.result(cell, [part], traced=False)
    assert out["correct"] is True and out["attempted"] >= 2
    assert [m.name for m in cell.per_layer] == ["runs_done.short"]
    readings = harness.Readings(config=cell.config, runs=7, steps=14,
                                retried_steps=0, capture_ms=[])
    assert cells.merge_metrics(cell, [cells.read_metrics(
        cell, readings)]) == {"runs_done.short": {"value": 7.0,
                                                  "unit": "runs"}}
    after = {p: p.read_bytes() for p in before}
    assert after == before


def parent_sim_config(cell: cells.Cell):
    """``Program.sim_config`` as the harness built it before a
    configuration could name program settings (a frozen copy)."""
    from nbody_tpu_torch.config import MeshConfig, SimConfig
    from nbody_tpu_torch.models.engines import resolved_caps

    c = cell.config
    opts = {k: float(c[k]) for k in ("theta", "dt", "g", "softening")
            if k in c}
    sim = SimConfig(
        n_bodies=int(c["n_bodies"]), n_dim=int(c["n_dim"]),
        engine=c["engine"], dtype=c["dtype"],
        n_steps=int(cell.traffic["steps_per_run"]),
        mesh=MeshConfig(dp=cell.devices), **opts)
    scale = cell.traffic.get("cap_scale", {})
    if scale:
        caps = resolved_caps(sim)
        sim = sim.replace(**{k: int(f) * caps[k] for k, f in scale.items()})
    return sim


@pytest.mark.parametrize("workload", [w["name"]
                                      for w in spec()["workloads"]])
def test_existing_sim_configs_are_the_parents(workload):
    cell = cells.load_cell(workload)
    sim = harness.Program(cell, torch.device("cpu")).sim_config
    assert dataclasses.asdict(sim) == dataclasses.asdict(
        parent_sim_config(cell))


# sha256 of (masses, positions, velocities) of seeds 0-2, runs 0-1, at
# full size on the CPU, as the harness drew them before a configuration
# could name its distribution (frozen)
PARENT_STATES = {
    "bh2d_ref":
        "cb351c6cd7b2aea3e2f7ca1fecc9f53dc5a490ad509bfca6e098a9f9abf6feb2",
    "bh3d_1m":
        "7258936fa7c58b4e9fd8a53a483b778c42e65be9147df6590c68f550d2efc251",
    "allpairs_strong":
        "284ecf67bd3fceae9667063b70b420b0103cc15a5054b5c1ddc222fc4c8dc31d",
}


@pytest.mark.parametrize("config", sorted(PARENT_STATES))
def test_existing_states_are_the_parents(config):
    cfg = cells.load_json(ROOT / "benchmark" / "configs" / f"{config}.json")
    assert states.distribution(cfg) == "uniform"
    named = dict(cfg, init=dict(cfg["init"], distribution="uniform"))
    for c in (cfg, named):
        h = hashlib.sha256()
        for seed in range(3):
            for index in range(2):
                for t in states.make_bodies(c, seed, index, "cpu"):
                    h.update(t.numpy().tobytes())
        assert h.hexdigest() == PARENT_STATES[config]


@pytest.mark.parametrize("key,value,name", [
    ("init", {"distribution": "no_such_init"}, "no_such_init"),
    ("init", {"distribution": "../configs/x"}, "../configs/x"),
    ("program", {"no_such_field": 1}, "no_such_field"),
    ("program", {"init": {"lower_m": 0.2}}, "init"),
    ("program", {"mesh": {"dp": 2}}, "mesh"),
    ("program", {"theta": 0.4}, "theta"),
    ("program", {"list_cap": [4096]}, "list_cap"),
])
def test_unknown_names_stop_set_up(key, value, name):
    """A distribution with no file, a program setting that SimConfig
    lacks, a nested one, one set elsewhere or one not a scalar stops a
    run at set-up, with the name in the error."""
    cell = cells.load_cell("bh2d_ref.fused")
    cell.config = dict(cell.config, n_bodies=256, **{key: value})
    with pytest.raises(ValueError, match=re.escape(repr(name))):
        harness.run_rank(cell, 1, 0.1, False, torch.device("cpu"), 0.0)


def test_k1_operations_and_bytes():
    assert roofline.allpairs_ops(2) == 12 and roofline.allpairs_ops(3) == 17
    t, s = 65536, 262144
    clock = 1.98e9
    fp32 = t * s * 12 / roofline.PEAK_FP32
    sfu = t * s / (16 * 132 * clock)
    assert roofline.allpairs_bound_s(t, s, 2, clock) == pytest.approx(
        max(fp32, sfu))
    nbytes = 4 * (t * 2 * 2 + s * 3)
    assert nbytes / roofline.PEAK_BYTES < sfu  # bound by the rsqrt units


def test_state_ranges_and_determinism():
    cfg = cells.load_cell("bh2d_ref.fused").config
    cfg = dict(cfg, n_bodies=20000)
    seed = 2**31 + 12345
    m, p, v = states.make_bodies(cfg, seed, 3, "cpu")
    assert m.dtype == torch.float32 and p.shape == (20000, 2)
    assert 0.1 <= float(m.min()) and float(m.max()) <= 0.5
    assert -0.1 <= float(p.min()) and float(p.max()) <= 0.1
    assert -1e-4 <= float(v.min()) and float(v.max()) <= 1e-4
    # log-uniform masses: half below the geometric mean of the range
    assert abs(float((m < (0.1 * 0.5) ** 0.5).float().mean()) - 0.5) < 0.02
    m2, p2, v2 = states.make_bodies(cfg, seed, 3, "cpu")
    assert torch.equal(m, m2) and torch.equal(p, p2) and torch.equal(v, v2)
    assert not torch.equal(p, states.make_bodies(cfg, seed, 4, "cpu")[1])
    assert not torch.equal(p, states.make_bodies(cfg, seed + 1, 3,
                                                 "cpu")[1])


def _part(**kw):
    part = dict(window_epoch=0.0, setup_s=9.5, run_s=2.0, runs=10,
                steps=100, failed=0, memory_peak_bytes=123, run_ms=[1.0],
                capture_ms=[0.0], scan_ms=[0.0], kind="NVIDIA H100",
                check=dict(final_mismatches=0, update_mismatches=0,
                           force_gap=1e-3, control_gap=0.0,
                           steps_compared=10, steps_failed=0))
    part.update(kw)
    return part


def test_result_line_keys():
    cell = cells.load_cell("bh3d_1m.loop")
    out = run.result(cell, [_part()], traced=False)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "check"]
    assert out["correct"] is True and out["attempted"] == 100
    assert out["metrics"] == {
        "loop_step_ms": {"value": 20.0, "unit": "ms/step"},
        "setup_s": {"value": 9.5, "unit": "s"}}
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert out["check"]["force_gap"] == {
        "value": 1e-3, "limit": cell.config["check"]["force_gap_limit"]}
    traced = run.result(cell, [_part(
        per_layer={"device_idle_share.loop": 0.5},
        busy_s=1.0, window_s=2.0,
        breakdown={"device_ops": [], "idle_gaps": []})], traced=True)
    assert list(traced) == ["correct", "attempted", "failed", "metrics",
                            "device", "breakdown", "check"]
    assert traced["device"]["busy_s"] == 1.0
    assert traced["metrics"] == {"device_idle_share.loop": {
        "value": 0.5, "unit": "fraction"}}
    bad = run.result(cell, [_part(check=dict(
        _part()["check"], final_mismatches=1))], traced=False)
    assert bad["correct"] is False


def test_nccl_ms_takes_each_collective_on_the_rank_that_came_last():
    """Rank 0 waited 3 ms for its peers in the first all-gather and rank
    1 in the second: the transfer alone is the least time of each."""
    cell = cells.load_cell("allpairs_strong.fused4")
    ranks = [{"nccl_ms.mesh": {"steps": 2, "seconds": s},
              "device_idle_share.mesh": idle}
             for s, idle in (([3e-3, 2e-5], 0.1), ([1e-5, 3e-3], 0.2),
                             ([2e-5, 3e-5], 0.3))]
    out = cells.merge_metrics(cell, ranks)
    assert out["nccl_ms.mesh"] == {"value": pytest.approx(0.015),
                                   "unit": "ms/step"}
    # a metric without ``merge`` is rank 0's
    assert out["device_idle_share.mesh"]["value"] == 0.1
    # ranks that ran different collectives, or a rank with none: no number
    ranks[2]["nccl_ms.mesh"]["seconds"].append(1e-5)
    assert "nccl_ms.mesh" not in cells.merge_metrics(cell, ranks)
    del ranks[2]["nccl_ms.mesh"]
    assert "nccl_ms.mesh" not in cells.merge_metrics(cell, ranks)


def test_forbidden_modules_compare_top_level_names_whole(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "nbody_tpu_torch.fake", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "nbody_tpu.fake", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert harness.forbidden_modules() == ["jax", "nbody_tpu"]


def test_import_guard():
    """A cell's set-up imports and every initial distribution, in a fresh
    interpreter on the CPU, load neither JAX nor the JAX package."""
    code = textwrap.dedent("""
        import sys, torch
        from benchmark import cells, check, control, harness, run, trace
        from benchmark import readers, roofline, states
        for path in sorted((cells.ROOT / "benchmark" / "inits").glob(
                "*.py")):
            cells.init_module(path.stem)
        states.make_bodies({"n_bodies": 64, "n_dim": 3,
                            "init": {"distribution": "plummer"}}, 1, 0,
                           "cpu")
        for w in cells.benchmark_spec()["workloads"]:
            cell = cells.load_cell(w["name"])
            cell.config["devices"] = 1
            program = harness.Program(cell, torch.device("cpu"))
            program.state(states.make_bodies(dict(cell.config,
                                                  n_bodies=64), 1, 0, "cpu"))
            for m in cell.per_layer:
                cells.metric_module(m.name)
        import nbody_tpu_torch.parallel, nbody_tpu_torch.models.simulation
        print(sorted({m.split(".")[0] for m in sys.modules}))
        print(harness.forbidden_modules())
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    top, found = out.stdout.strip().splitlines()[-2:]
    assert found == "[]", top
    assert "nbody_tpu_torch" in top
    for name in ("jax", "jaxlib", "flax", "nbody_tpu"):
        assert f"'{name}'" not in top


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "-m", "benchmark.run",
                          "--workload", "bh2d_ref.fused", "--seed", "1",
                          "--seconds", "1"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert out.returncode == 3 and out.stdout == ""
