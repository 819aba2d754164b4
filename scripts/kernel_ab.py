#!/usr/bin/env python3
"""Time and fingerprint kernels K1 (all-pairs), K5 (the potential), K2 /
K3 (the runs evaluator) and K4 (the quarter-split evaluator) of several
checkouts of nbody_tpu_torch on one GPU, in the order given:

    python3 scripts/kernel_ab.py PARENT_TREE . . PARENT_TREE

Each tree runs in a fresh process with that tree first on ``sys.path``
(its kernels built from its own ``csrc``).  Per tree, on the states of
``random_state`` (seed 0): K1 at 2D and 3D N=65,536 at the tree's default
shape (unsoftened; compensated too in 2D) and the all-pairs step at both
(mean of 10); K5 at 2D N=40,960 and 3D N=262,144; K2 on the
tables of the 2D N=40,960 default force pass and K2 / K3 on those of the
3D N=131,072 pass (the run-length gate forced each way), with the 2D
40,960 and 3D 131,072 default steps (mean of 5); K4 on the tables of the
3D N=1,048,576 default force pass and that step (mean of 2); the tree
builds' leaf sums (``ops/tree.leaf_sums``) on the five inputs of
``chip_smoke.py`` phase 9 (2D 40,960 and 3D 1,048,576 uniform, 3D
262,144 blobs, 3D 1,048,576 after 10 contract-loop steps, 1,048,576 rows
in one leaf; CUDA events, and the device time of the kernels a call by
torch.profiler), the step on that evolved state (mean of 3) and the fused
3D runs of phase 6c (``Simulation.run_scan``, 10 steps, seed 7:
131,072, 229,376, 262,144 uniform and blobs, 1,048,576; ms/step).  The
evolved state is taken by the first tree and saved in
``build/kernel_ab_evolved.pt`` beside this script's checkout, which the
other trees load, so every tree sums the same rows.  Kernels: CUDA
events, mean of 10 (K4: 5) launches after a warm-up.  Each kernel's
inputs and output get a SHA-256 digest of their bytes, so two trees'
kernels can be held bit for bit.  One JSON line per tree, after the
card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import io
import json
import os
import subprocess
import sys

G = 6.67e-11


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _child() -> None:
    import torch

    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.models.engines import make_accel_fn
    from nbody_tpu_torch.ops import (_cuda, allpairs, bh3d, bh_grouped,
                                     list_eval)
    from nbody_tpu_torch.physics import integrate
    from nbody_tpu_torch.rng import random_state

    dev = torch.device("cuda", 0)
    _cuda.library()

    def cuda_ms(fn, reps):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    out = {"tree": os.environ["AB_TREE"]}

    def step_ms(cfg, st, reps):
        accel = make_accel_fn(cfg, return_diagnostics=True)

        def step():
            acc, ovf = accel(st.positions, st.masses)
            return integrate(st, acc, cfg.dt, overflow=ovf.sum())

        return cuda_ms(step, reps=reps)

    for dims, comp in ((2, False), (3, False), (2, True)):
        n = 65536
        st = random_state(SimConfig(n_bodies=n, n_dim=dims), device=dev)
        p, m = st.positions, st.masses
        key = f"k1_{dims}d{'_comp' if comp else ''}"
        out[f"{key}_ms"] = cuda_ms(lambda: allpairs.allpairs_accelerations(
            p, m, g=G, source_block=1024, compensated=comp), reps=10)
        out[f"{key}_in"] = _digest(p, m)
        out[f"{key}_out"] = _digest(allpairs.allpairs_accelerations(
            p, m, g=G, source_block=1024, compensated=comp))
        if not comp:
            out[f"step{dims}d_allpairs_{n}_ms"] = step_ms(
                SimConfig(n_bodies=n, n_dim=dims, engine="allpairs"), st,
                reps=10)

    for dims, n in ((2, 40960), (3, 262144)):
        st = random_state(SimConfig(n_bodies=n, n_dim=dims), device=dev)
        p, m = st.positions, st.masses
        key = f"k5_{dims}d"
        out[f"{key}_ms"] = cuda_ms(
            lambda: allpairs.allpairs_potential(p, m, g=G), reps=10)
        out[f"{key}_in"] = _digest(p, m)
        out[f"{key}_out"] = _digest(allpairs.allpairs_potential(p, m, g=G))

    # K2 / K3 on the tables of the default force passes at 2D N=40,960 and
    # 3D N=131,072 (the run-length gate forced each way), and those steps
    for key, dims, n, gate in (("k2_2d", 2, 40960, None),
                               ("k2_3d", 3, 131072, "plain"),
                               ("k3_3d", 3, 131072, "packed")):
        st = random_state(SimConfig(n_bodies=n, n_dim=dims), device=dev)
        seen, orig = [], list_eval.list_eval_runs
        thr = bh_grouped.SEG_PACK_MIN_RUN_LANES

        def spy(*a, **k):
            seen.append((a, k))
            return orig(*a, **k)

        list_eval.list_eval_runs = spy
        if gate is not None:
            bh_grouped.SEG_PACK_MIN_RUN_LANES = (
                -1.0 if gate == "packed" else float("inf"))
        try:
            if dims == 3:
                bh3d.bh3_accelerations_grouped(st.positions, st.masses, g=G)
            else:
                bh_grouped.bh_accelerations_grouped(st.positions, st.masses,
                                                    g=G, group_size=2048)
        finally:
            list_eval.list_eval_runs = orig
            bh_grouped.SEG_PACK_MIN_RUN_LANES = thr
        (a, k), = seen
        out[f"{key}_ms"] = cuda_ms(lambda: orig(*a, **k), reps=10)
        out[f"{key}_in"] = _digest(*a)
        out[f"{key}_out"] = _digest(orig(*a, **k))
        if gate != "packed":
            out[f"step{dims}d_{n}_ms"] = step_ms(
                SimConfig(n_bodies=n, n_dim=dims, engine="barnes_hut"), st,
                reps=5)

    n1m = 1 << 20
    st = random_state(SimConfig(n_bodies=n1m, n_dim=3), device=dev)
    seen, orig = [], list_eval.list_eval_runs_split

    def spy(*a, **k):
        seen.append((a, k))
        return orig(*a, **k)

    list_eval.list_eval_runs_split = spy
    try:
        bh3d.bh3_accelerations_grouped(st.positions, st.masses, g=G)
    finally:
        list_eval.list_eval_runs_split = orig
    (a, k), = seen
    out["k4_ms"] = cuda_ms(lambda: orig(*a, **k), reps=5)
    out["k4_in"] = _digest(*a)
    out["k4_out"] = _digest(orig(*a, **k))

    out["step1m_ms"] = step_ms(
        SimConfig(n_bodies=n1m, n_dim=3, engine="barnes_hut"), st, reps=2)

    _leaf_sums(out, dev, cuda_ms, step_ms)
    print(json.dumps(out), flush=True)


def _device_ms(fn, reps: int) -> float:
    """The device time of ``fn``'s kernels a call (torch.profiler, after a
    warm-up): what a CUDA graph replay of it costs, the host's launch
    work left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / reps / 1e3


def _leaf_sums(out: dict, dev, cuda_ms, step_ms) -> None:
    """The leaf sums on phase 9's five inputs, the evolved 1M step and
    phase 6c's fused 3D runs, into ``out``."""
    import torch

    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.models.simulation import Simulation
    from nbody_tpu_torch.ops import tree, tree3d
    from nbody_tpu_torch.rng import random_state
    from nbody_tpu_torch.state import SimState

    def inputs_of(p, m, dims, depth):
        """The (rows, lengths) a tree build hands the leaf sums."""
        seen, mod = [], tree if dims == 2 else tree3d
        orig = mod.leaf_sums

        def spy(rows, lengths):
            seen.append((rows, lengths))
            return orig(rows, lengths)

        mod.leaf_sums = spy
        try:
            if dims == 2:
                tree.build_quadtree(p, m, max_depth=depth)
            else:
                tree3d.build_octree(p, m, max_depth=depth)
        finally:
            mod.leaf_sums = orig
        return seen[0]

    n1m = 1 << 20
    cfg1m = SimConfig(n_bodies=n1m, n_dim=3, engine="barnes_hut", seed=7,
                      n_steps=10)
    path = os.environ["AB_STATE"]
    if os.path.exists(path):
        evolved = SimState(**{k: v.to(dev)
                              for k, v in torch.load(path).items()})
    else:
        sim = Simulation(cfg1m, device=dev)
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()):
            sim.run_contract()
        evolved = sim.state
        torch.save({f.name: getattr(evolved, f.name).cpu()
                    for f in dataclasses.fields(evolved)}, path)
    inputs = {}
    for key, cfg in (("2d_40960", SimConfig(n_bodies=40960)),
                     ("3d_1m", cfg1m),
                     ("3d_262144_blobs", SimConfig(
                         n_bodies=262144, n_dim=3, init_mode="blobs"))):
        st = random_state(cfg, device=dev)
        inputs[key] = inputs_of(st.positions, st.masses, cfg.n_dim,
                                cfg.resolved_max_depth)
    inputs["3d_1m_evolved"] = inputs_of(evolved.positions, evolved.masses,
                                        3, cfg1m.resolved_max_depth)
    rows = torch.rand((n1m, 16), generator=torch.Generator().manual_seed(9))
    lengths = torch.zeros(8 ** 7, dtype=torch.int64)
    lengths[12345] = n1m
    inputs["3d_one_leaf"] = (rows.to(dev), lengths.to(dev))
    for key, (rows, lengths) in inputs.items():
        out[f"leaf_{key}_ms"] = cuda_ms(
            lambda: tree.leaf_sums(rows, lengths), reps=10)
        out[f"leaf_{key}_device_ms"] = _device_ms(
            lambda: tree.leaf_sums(rows, lengths), reps=10)
        out[f"leaf_{key}_in"] = _digest(rows, lengths)
        out[f"leaf_{key}_out"] = _digest(tree.leaf_sums(rows, lengths))
    out["step1m_evolved_ms"] = step_ms(cfg1m, evolved, reps=3)

    for n, extra in ((131072, {}), (229376, {}), (262144, {}),
                     (262144, {"init_mode": "blobs"}), (n1m, {})):
        sim = Simulation(SimConfig(n_bodies=n, n_dim=3, engine="barnes_hut",
                                   seed=7, n_steps=10, **extra), device=dev)
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()):
            final = sim.run_scan()
        key = f"fused3d_{n}{'_blobs' if extra else ''}"
        out[f"{key}_ms"] = sim.last_scan_ms / 10
        out[f"{key}_route"] = sim.last_scan_route
        out[f"{key}_out"] = _digest(final.positions)


def main(trees) -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    state = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "build", "kernel_ab_evolved.pt")
    os.makedirs(os.path.dirname(state), exist_ok=True)
    if os.path.exists(state):
        os.remove(state)
    for tree in trees:
        path = os.path.abspath(tree)
        env = dict(os.environ, AB_TREE=tree, AB_STATE=state,
                   PYTHONPATH=os.pathsep.join(
            [path] + [p for p in os.environ.get("PYTHONPATH", "").split(
                os.pathsep) if p]))
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--child"], env=env, cwd=path).returncode
        if rc != 0:
            print(f"{tree}: exited {rc}", flush=True)
            return rc
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--child"]:
        _child()
    else:
        sys.exit(main(sys.argv[1:] or ["."]))
