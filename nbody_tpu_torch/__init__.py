"""nbody_tpu_torch — the PyTorch / CUDA port of nbody_tpu for one NVIDIA
H100.

A second package beside the JAX reference ``nbody_tpu``, with the same
module layout and public names: the ``run`` and ``compare`` paths in 2D
and 3D for every engine, on one device or sharded over several
(``parallel/``, torch.distributed).  The JAX package's seven Pallas
kernels are hand-written CUDA C++ for ``sm_90a`` (``csrc/``); everything
else is eager PyTorch on explicit devices.  Imports torch and numpy,
never jax.

Float32 matrix products and convolutions are pinned to full f32 (no
TF32) for every user of the package: a TF32 product would truncate sums
the physics relies on being exact.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .config import InitRanges, MeshConfig, SimConfig  # noqa: E402
from .physics import (  # noqa: E402
    integrate,
    kinetic_energy,
    potential_energy,
    total_momentum,
)
from .rng import random_state  # noqa: E402
from .state import SimState, from_numpy, make_state, to_numpy  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "InitRanges",
    "MeshConfig",
    "SimConfig",
    "SimState",
    "from_numpy",
    "integrate",
    "kinetic_energy",
    "make_state",
    "potential_energy",
    "random_state",
    "to_numpy",
    "total_momentum",
]
