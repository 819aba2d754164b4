"""The port's grouped and sharded multi-device modes, 2D and 3D, at D = 2
and 4 thread ranks of one CPU process against the port's single-device
grouped step on a Morton-sorted jittered grid: 5e-5 x max|p| after 3
steps (tests/test_parallel.py's bound for the window mode: local groups
and the window gate change which cells open, a BH-class difference the
grid's bounded separations keep small).

A file of its own, apart from tests/test_torch_parallel.py (whose grids
and thread-rank helpers it uses): each case takes 70-90 s on the CPU, so
under ``--dist loadfile`` these eight cases and the rest of that file run
on two workers.
"""

import pytest

from nbody_tpu_torch.config import MeshConfig, SimConfig
from nbody_tpu_torch.state import from_numpy
from test_torch_parallel import _grid, run_threads, single_device


@pytest.fixture(scope="module")
def grids():
    return {2: _grid(48, 2), 3: _grid(12, 3)}


@pytest.mark.parametrize("n_dev", [2, 4])
@pytest.mark.parametrize("mode", ["dp_barnes_hut_grouped",
                                  "dp_barnes_hut_sharded",
                                  "dp_barnes_hut_grouped3",
                                  "dp_barnes_hut_sharded3"])
def test_grouped_and_sharded_match_single_device(grids, mode, n_dev):
    dims = 3 if mode.endswith("3") else 2
    m, p, v = grids[dims]
    cfg = SimConfig(n_bodies=m.shape[0], n_dim=dims, engine="barnes_hut",
                    group_size=96, mesh=MeshConfig(dp=n_dev))
    state = from_numpy(m, p, v, device="cpu")
    want = single_device(cfg, state, 3)
    got, ovf = run_threads(mode, cfg, state, n_dev, 3)
    assert ovf == 0
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 5e-5 * scale
