"""Whether the timed path's answers are right: the comparison that
decides ``correct``.

A run's answer is its final state after ``steps_per_run`` steps.  The
workload is chaotic, so a reference run of its own would part ways with
the program's; the reference follows the program step by step instead:

1. For a sample of the window's runs, drawn from the seed, the program's
   own entry (the same ``Simulation`` call, one step a call) steps the
   run's initial state again, and the chain's last state has to equal
   the run's final state from the window bit for bit
   (``final_mismatches``, limit 0): so the chain's states are the timed
   run's states.
2. Each step k -> k+1 of the chain: the positions have to be the
   integrator's p + v' dt of the new velocities, elementwise in the
   state's precision (``update_mismatches``, limit 0; dt = 1 makes it
   exact whatever the order of the program's operations).
3. The acceleration the program applied, (v' - v) / dt, against the
   plain reference's at the program's own state k, on a sample of bodies
   drawn from the seed (every rank's own bodies on a mesh): the widest
   gap |a - a_ref| / max(|a_ref|, median |a_ref|) over the sample and
   the steps (``force_gap``, limit set in the configuration from the
   program's and the control's readings).  A step the program reports
   overflowed is counted as failed and not compared.

With ``control`` the same sample is also evaluated by the reference in
bfloat16, the control that has to fail (``control_gap``).
"""

from __future__ import annotations

import dataclasses

import torch

from . import states
from .reference import gravity

# stream indices of the check's draws (far from any run index)
PICK_STREAM = 1 << 40
SAMPLE_STREAM = 1 << 41


@dataclasses.dataclass
class Numbers:
    final_mismatches: int = 0
    update_mismatches: int = 0
    force_gap: float = 0.0
    control_gap: float = 0.0
    steps_compared: int = 0
    steps_failed: int = 0


def force_gap(acc: torch.Tensor, ref: torch.Tensor) -> float:
    """max_i |acc_i - ref_i| / max(|ref_i|, median_j |ref_j|)."""
    norm = ref.norm(dim=1)
    scale = torch.maximum(norm, norm.median()).clamp(min=1e-300)
    return float(((acc - ref).norm(dim=1) / scale).max())


def picked_runs(seed: int, n_runs: int, count: int) -> list:
    gen = torch.Generator().manual_seed(states.run_seed(seed, PICK_STREAM))
    return sorted(torch.randperm(n_runs, generator=gen)[:count].tolist())


def check(program, seed: int, finals: list, control: bool = False,
          runs=None) -> Numbers:
    """The numbers of the check of ``program``'s window (``finals``: each
    run's final (positions, velocities) in run order; ``runs``: the runs
    to check, default the configuration's sample)."""
    cfg = program.cell.config
    spec = cfg["check"]
    dt = float(cfg["dt"])
    dtypes = (torch.float64, torch.bfloat16) if control else (
        torch.float64,)
    out = Numbers()
    if runs is None:
        runs = picked_runs(seed, len(finals), int(spec["runs"]))
    for r in runs:
        state = program.state(states.make_bodies(
            cfg, seed, r, program.device, program.cell.root))
        for k in range(program.steps):
            new, info = program.run(state, 1)
            pos, vel = state.positions, state.velocities
            new_pos, new_vel = new.positions.clone(), new.velocities.clone()
            out.update_mismatches += int(
                (new_pos != pos + new_vel * dt).sum())
            if info["failed"]:
                out.steps_failed += 1
            else:
                lo, hi = program.slab()
                gen = torch.Generator().manual_seed(states.run_seed(
                    seed, SAMPLE_STREAM + 1000 * r + k))
                idx, acc = gravity.answers(
                    program.gather(pos), program.gather(state.masses), cfg,
                    int(spec["units"]), gen, targets=(lo, hi),
                    dtypes=dtypes)
                applied = (new_vel.double() - vel.double())[idx - lo] / dt
                out.force_gap = max(out.force_gap,
                                    force_gap(applied, acc[torch.float64]))
                if control:
                    out.control_gap = max(out.control_gap, force_gap(
                        acc[torch.bfloat16], acc[torch.float64]))
                out.steps_compared += 1
            state = dataclasses.replace(new, positions=new_pos,
                                        velocities=new_vel)
        if r < len(finals):
            f_pos, f_vel = finals[r]
            out.final_mismatches += int((state.positions != f_pos).sum()
                                        + (state.velocities != f_vel).sum())
    return out


def limits(config: dict) -> dict:
    return {"final_mismatches": 0, "update_mismatches": 0,
            "force_gap": float(config["check"]["force_gap_limit"])}


def verdict(numbers: dict, config: dict) -> bool:
    """True when every number is within its limit and something was
    compared."""
    lim = limits(config)
    return (numbers["steps_compared"] > 0
            and all(numbers[k] <= v for k, v in lim.items()))
