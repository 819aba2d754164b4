"""End-to-end reproduction of the reference's experiment pipeline (the
port of ``examples/reference_experiment.py``).

The reference workflow (README.md:14-35) is: initialise (or load) a body
cloud -> run the Barnes-Hut simulation writing positions + quadtree dumps
-> render the dumps.  This script does the same through the port's CLI,
using the reference's golden fixtures from ``$NBODY_REFERENCE_DIR`` when
that directory holds them, and renders with the scalable plotters (the
produced files also feed the reference's own plot_quadtree.py /
plot_2d.py unchanged).

    python -m nbody_tpu_torch.examples.reference_experiment [out_dir]
        [n_bodies] [--device cpu]
"""

import argparse
import os

from nbody_tpu_torch.cli import main as cli


def run(out_dir: str = "reference_experiment_out", n_bodies: int = 40960,
        device: str = "cuda") -> None:
    os.makedirs(out_dir, exist_ok=True)
    args = [
        "run", "--device", device, "--engine", "barnes_hut",
        "--steps", "10", "--theta", "0.5", "--save-positions",
        "--save-tree-dumps", "--metrics-csv", "metrics.csv",
        "--output-dir", out_dir, "--n-bodies", str(n_bodies),
    ]
    ref = os.environ.get("NBODY_REFERENCE_DIR")
    if ref and os.path.exists(os.path.join(ref, "masses_init.txt")):
        args += ["--load-init", ref]
    else:
        args += ["--save-init"]
    if cli(args):
        raise SystemExit(1)

    # render (the same files also work with the reference's plotters)
    for plot in (
        ["--quadtree", os.path.join(out_dir, "quadtree_init.txt")],
        ["--quadtree", os.path.join(out_dir, "quadtree_final.txt")],
        ["--positions", os.path.join(out_dir, "positions.txt"),
         "--out", os.path.join(out_dir, "trajectories.png")],
    ):
        if cli(["plot", *plot]):
            raise SystemExit(1)
    print(f"artifacts in {out_dir}/: positions.txt, quadtree_*.txt(+png), "
          "metrics.csv, trajectories.png")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir", nargs="?", default="reference_experiment_out")
    ap.add_argument("n_bodies", nargs="?", type=int, default=40960)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    run(a.out_dir, a.n_bodies, a.device)
