"""The ``bench`` verb: the headline benchmark line of the port
(counterpart of ``nbody_tpu.bench.headline``).

    python -m nbody_tpu_torch bench [--device cuda|cpu]

Prints ONE JSON line, the last on stdout, with the JAX package's five
keys (``metric``, ``value``, ``unit``, ``vs_baseline``, ``backend``) and
the port's own: the card's name and ``nvidia-smi`` power limit, and
ms/step of the loop (``Simulation.run_contract``, a host sync every
step) and the fused run (``Simulation.run_scan``: one CUDA graph of the
step, replayed) side by side for

* all-pairs 2D at N (kernel K1),
* grouped Barnes-Hut 2D at N, tree build included (K2), with the bodies
  whose caps overflowed in the fused run,
* grouped Barnes-Hut 3D at N (K2, the fused run a graph),
* grouped Barnes-Hut 3D at 4N (the dense collector; K2 or K3 by the
  run-length gate), with its route and the steps the loop retried at 4x
  caps.  Its gates (segment packing, the spill pass) are conditional
  nodes of the fused run's graph.

N is 65,536 on the card and 2,048 on ``--device cpu``, the JAX package's
sizes (``nbody_tpu/bench/headline.py:180``).  ``value`` is N^2 over the
fused all-pairs ms/step: the graph replays the step with no host
crossing, as the JAX package's slope method cancels dispatch; baseline
1e10 pairs/s (BASELINE.json).

Method: on the card a warm-up run of every case first (it builds the
kernels and captures the graph), then the median of ``REPEATS`` (5) runs
of ``STEPS`` (10) steps, each from the same seeded state; min and max go
to stderr.  The verb takes no flag that changes them (tests pass smaller
counts to :func:`main`).  Without a card and without ``--device cpu`` it exits 1, prints
the reason on stderr and prints no JSON line: no fallback measures
somewhere else.  Energy drift is not scored (see ROADMAP Queue C).
"""

from __future__ import annotations

import contextlib
import io
import json
import statistics
import sys

BASELINE_PAIRS_PER_SEC = 1e10  # BASELINE.json north star
SIZES = {"cuda": 65536, "cpu": 2048}
REPEATS = 5  # timed runs a case; the median is reported
STEPS = 10  # steps a timed run


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def _run_once(config, device, fused: bool):
    """(ms/step, Simulation, retried steps) of one run of
    ``config.n_steps`` steps from the config's seeded state."""
    from ..models.simulation import Simulation
    from ..rng import random_state

    sim = Simulation(config, state=random_state(config, device=device))
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        if fused:
            sim.run_scan()
            ms = sim.last_scan_ms / config.n_steps
        else:
            _, timing = sim.run_contract()
            ms = timing.parallel_us / 1e3 / config.n_steps
    text = err.getvalue()
    if text:
        sys.stderr.write(text)
    return ms, sim, text.count("retrying with 4x caps")


def _timed(tag: str, config, device, fused: bool, repeats: int):
    """Median ms/step over ``repeats`` runs after one warm-up run on the
    card (the CPU has no kernel to build and no graph to capture); returns
    (median, the last run's Simulation, retried steps over the runs)."""
    if device.type == "cuda":
        _run_once(config, device, fused)
    times, retried = [], 0
    for _ in range(repeats):
        ms, sim, r = _run_once(config, device, fused)
        times.append(ms)
        retried += r
    med = statistics.median(times)
    log(f"bench: {tag} {'fused' if fused else 'loop'}: median "
        f"{med:.3f} ms/step (min {min(times):.3f}, max {max(times):.3f}; "
        f"{repeats} runs of {config.n_steps} steps)")
    return med, sim, retried


def route_3d(n: int) -> str:
    """The 3D default route at N bodies, as the engine resolves it."""
    from ..ops.bh3d import resolve_route_3d

    r = resolve_route_3d(n, n)
    kernel = ("K4 (quarter split)" if r.split_eval else
              "K2 or K3 (run-length gate)" if r.seg_pack > 1 else "K2")
    return (f"{'dense' if r.dense else 'gather'} collector, group "
            f"{r.group_size}, {r.eval_mode} evaluator: {kernel}")


def measure(device, repeats: int = REPEATS, steps: int = STEPS) -> dict:
    """The headline measurement on ``device`` (a torch.device); returns
    the JSON line's dict."""
    from ..config import SimConfig
    from . import card_info

    n = SIZES["cuda" if device.type == "cuda" else "cpu"]
    card, limit = card_info(device)
    log(f"bench: device {device} ({card or 'cpu'}, power limit "
        f"{limit or 'n/a'}), N={n}, {repeats} runs of {steps} steps")
    base = SimConfig(n_bodies=n, n_steps=steps, seed=0)
    out = {}
    for key, cfg in (
            ("allpairs2d", base.replace(engine="allpairs")),
            ("bh2d", base.replace(engine="barnes_hut")),
            ("bh3d", base.replace(engine="barnes_hut", n_dim=3))):
        for fused in (False, True):
            ms, sim, _ = _timed(key, cfg, device, fused, repeats)
            out[f"{key}_{'fused' if fused else 'loop'}_ms"] = ms
        if key == "bh2d":
            out["bh2d_overflowed_bodies"] = int(sim.last_scan_overflow.sum())
    big = base.replace(engine="barnes_hut", n_dim=3, n_bodies=4 * n)
    ms, _, retried = _timed("bh3d_large", big, device, False, repeats)
    fused_ms, _, _ = _timed("bh3d_large", big, device, True, repeats)
    out.update(bh3d_large_loop_ms=ms, bh3d_large_fused_ms=fused_ms,
               bh3d_large_n=4 * n, bh3d_large_route=route_3d(4 * n),
               bh3d_large_retried_steps=retried)
    pairs_per_sec = n * n / (out["allpairs2d_fused_ms"] / 1e3)
    log(f"bench: all-pairs {pairs_per_sec / 1e9:.1f} Gpairs/s (fused)")
    return {
        "metric": f"allpairs_pairwise_interactions_per_sec_n{n}",
        "value": pairs_per_sec,
        "unit": "pairs/s/chip",
        "vs_baseline": pairs_per_sec / BASELINE_PAIRS_PER_SEC,
        "backend": device.type,
        "card": card,
        "power_limit": limit,
        "n": n,
        "steps": steps,
        "repeats": repeats,
        **out,
    }


def main(device_name: str = "cuda", repeats: int = REPEATS,
         steps: int = STEPS) -> int:
    from . import DeviceUnavailable, measurement_device

    try:
        device = measurement_device(device_name)
    except DeviceUnavailable as e:
        log(f"bench: {e}")
        return 1
    result = measure(device, repeats=repeats, steps=steps)
    print(json.dumps(result), flush=True)
    return 0
