"""Multi-device steps of the port over ``torch.distributed`` (counterpart
of ``nbody_tpu.parallel``): the meshes and the rank launcher
(``mesh.py``), the collectives (``collectives.py``), the eight sharded
step builders (``steps.py``) and the memory and communication models
(``memory.py``)."""

from .memory import choose_bh_mode, per_chip_bytes, source_bytes, tree_bytes
from .mesh import make_mesh, make_mesh_2d, shard_state
from .steps import STEP_BUILDERS, make_sharded_step

__all__ = [
    "STEP_BUILDERS",
    "choose_bh_mode",
    "make_mesh",
    "make_mesh_2d",
    "make_sharded_step",
    "per_chip_bytes",
    "shard_state",
    "source_bytes",
    "tree_bytes",
]
