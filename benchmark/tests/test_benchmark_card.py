"""On the card: one short run of a cell end to end (skips without one).

    python -m pytest --noconftest -m cuda benchmark/tests -q
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures the port "
                    "on the card and prints no result without one")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_runs_on_the_card(card, trace):
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "bh2d_ref.fused", "--seed", str(2**32 + trace), "--seconds", "2",
         "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["kind"] == torch.cuda.get_device_name(0)
    if trace:
        assert line["device"]["busy_s"] > 0
        assert "device_idle_share.fused" in line["metrics"]
    else:
        assert set(line["metrics"]) == {"fused_step_ms", "setup_s"}


@pytest.mark.cuda
def test_a_new_cell_runs_with_no_edit(card, tmp_path):
    """A cell whose configuration names a new initial distribution and a
    program setting, in files of its own, runs end to end."""
    from benchmark.tests.test_benchmark_files import new_cell_root

    before = new_cell_root(tmp_path)
    path = os.environ.get("PYTHONPATH", "")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + ([path] if path else [])))
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "bh2d_small.short", "--seed", str(2**33 + 1), "--seconds", "2"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["attempted"] >= 2
    assert set(line["metrics"]) == {"loop_step_ms", "setup_s"}
    assert {p: p.read_bytes() for p in before} == before
