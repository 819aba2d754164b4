"""The readings the check's limits are set from, at a cell's own size:

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3

For each seed, one run through the cell's entry and its check: the
program's ``force_gap`` (the lower reading: the largest over a dozen
seeds or more) and the control's, the reference itself evaluated in
bfloat16 on the same states and bodies (the upper reading: the smallest
over three seeds or more).  Prints one JSON line a seed (on a mesh, the
largest over the ranks).  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from . import cells, check, harness, states
from .run import run_mesh, stop_children


def readings(cell: cells.Cell, seeds, device: torch.device,
             mesh=None) -> list:
    """[{seed, force_gap, control_gap, final_mismatches,
    update_mismatches, steps_compared, steps_failed}] of one rank."""
    program = harness.Program(cell, device, mesh)
    out = []
    for seed in seeds:
        final, _ = program.run(program.state(states.make_bodies(
            cell.config, seed, 0, device, cell.root)), program.steps)
        finals = [(final.positions.clone(), final.velocities.clone())]
        del final
        numbers = check.check(program, seed, finals, control=True,
                              runs=[0])
        out.append(dict(seed=seed, **numbers.__dict__))
    return out


def rank_entry(rank: int, cell: cells.Cell, seeds, out_dir: str,
               device_type: str) -> None:
    from nbody_tpu_torch.parallel import make_mesh

    device = (torch.device("cuda", rank) if device_type == "cuda"
              else torch.device("cpu"))
    rows = readings(cell, seeds, device, make_mesh(cell.devices))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rows, f)


def run(cell: cells.Cell, seeds, device_type: str) -> list:
    if cell.devices == 1:
        return readings(cell, seeds, torch.device(device_type, 0)
                        if device_type == "cuda" else torch.device("cpu"))
    merged = []
    for rows in zip(*run_mesh(cell, device_type, rank_entry, seeds)):
        row = dict(rows[0])
        for key in ("force_gap", "control_gap"):
            row[key] = max(r[key] for r in rows)
        for key in ("final_mismatches", "update_mismatches"):
            row[key] = sum(r[key] for r in rows)
        merged.append(row)
    return merged


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated whole numbers")
    args = p.parse_args(argv)
    cell = cells.load_cell(args.workload)
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell.chips):
        print(f"ERROR: {cell.name} needs {cell.chips} CUDA device(s)",
              file=sys.stderr)
        return 3
    t0 = time.perf_counter()
    try:
        rows = run(cell, [int(s) for s in args.seeds.split(",")], "cuda")
    finally:
        stop_children()
    for row in rows:
        print(json.dumps(dict(workload=cell.name, **row)), flush=True)
    print(f"{len(rows)} seeds in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
