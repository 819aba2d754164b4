"""3D octree demo: the generalisation the reference names but never built
(the port of ``examples/three_d_demo.py``).

The reference is 2D-only (``N_DIM = 2``, project.cu:28); its report names
the octree / ``N_DIM = 3`` extension (project_report.pdf p.8) and its
``plot_3d.py`` is non-functional as committed.  This script runs the 3D
grouped Barnes-Hut engine end to end through ``run``, writes the
five-column ``time body x y z`` trajectory file (the exact schema
plot_3d.py parses), and renders it with ``plot --positions-3d``.

    python -m nbody_tpu_torch.examples.three_d_demo [out_dir] [n_bodies]
        [--device cpu]
"""

import argparse
import os

from nbody_tpu_torch.cli import main as cli


def run(out_dir: str = "three_d_out", n_bodies: int = 4096,
        device: str = "cuda") -> None:
    os.makedirs(out_dir, exist_ok=True)
    rc = cli([
        "run", "--device", device, "--dims", "3", "--engine", "barnes_hut",
        "--n-bodies", str(n_bodies), "--steps", "10", "--theta", "0.5",
        "--save-positions", "--save-init", "--output-dir", out_dir,
    ])
    if rc:
        raise SystemExit(rc)
    rc = cli([
        "plot", "--positions-3d", os.path.join(out_dir, "positions.txt"),
        "--out", os.path.join(out_dir, "plot_3d.png"),
    ])
    if rc:
        raise SystemExit(rc)
    print(f"wrote {out_dir}/positions.txt and {out_dir}/plot_3d.png")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir", nargs="?", default="three_d_out")
    ap.add_argument("n_bodies", nargs="?", type=int, default=4096)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    run(a.out_dir, a.n_bodies, a.device)
