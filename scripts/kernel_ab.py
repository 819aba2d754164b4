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
3D N=1,048,576 default force pass and that step (mean of 2).  Kernels:
CUDA events, mean of 10 (K4: 5) launches after a warm-up.  Each kernel's
inputs and output get a SHA-256 digest of their bytes, so two trees'
kernels can be held bit for bit.  One JSON line per tree, after the
card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import hashlib
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
    print(json.dumps(out), flush=True)


def main(trees) -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    for tree in trees:
        path = os.path.abspath(tree)
        env = dict(os.environ, AB_TREE=tree, PYTHONPATH=os.pathsep.join(
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
