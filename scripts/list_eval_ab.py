#!/usr/bin/env python3
"""Time the padded-list kernels K6 / K6 compensated / K7 of several
checkouts of nbody_tpu_torch on one GPU, in the order given:

    python3 scripts/list_eval_ab.py PARENT_TREE . . PARENT_TREE

Each tree runs in a fresh process with that tree first on ``sys.path``
(its kernels built from its own ``csrc``).  Per tree: each kernel on the
packed lists of the 2D N=40,960 and 3D N=131,072 force passes (CUDA
events, mean of 10 after a warm-up), and the 3D N=1,048,576 step on
``eval_mode="dynamic"`` (CUDA events, and a ``torch.profiler`` split of
two steps into K7 and the rest).  One JSON line per tree, after the
card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

G = 6.67e-11


def _child() -> None:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.models.engines import make_accel_fn
    from nbody_tpu_torch.ops import _cuda, bh3d, bh_grouped, list_eval
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
    modes = {"k6": ("list_eval_pallas", {"eval_mode": "grid"}),
             "k6c": ("list_eval_pallas", {"compensated": True}),
             "k7": ("list_eval_dynamic", {"eval_mode": "dynamic"})}
    for dims, n in ((2, 40960), (3, 131072)):
        st = random_state(SimConfig(n_bodies=n, n_dim=dims), device=dev)
        for key, (name, kw) in modes.items():
            seen, orig = [], getattr(list_eval, name)

            def spy(*a, **k):
                seen.append((a, k))
                return orig(*a, **k)

            setattr(list_eval, name, spy)
            try:
                if dims == 3:
                    bh3d.bh3_accelerations_grouped(st.positions, st.masses,
                                                   g=G, **kw)
                else:
                    bh_grouped.bh_accelerations_grouped(
                        st.positions, st.masses, g=G, group_size=2048, **kw)
            finally:
                setattr(list_eval, name, orig)
            out[f"{key}_{dims}d_ms"] = cuda_ms(
                lambda: [orig(*a, **k) for a, k in seen], reps=10)

    cfg = SimConfig(n_bodies=1 << 20, n_dim=3, engine="barnes_hut",
                    eval_mode="dynamic")
    st = random_state(SimConfig(n_bodies=1 << 20, n_dim=3), device=dev)
    accel = make_accel_fn(cfg, return_diagnostics=True)

    def step():
        acc, ovf = accel(st.positions, st.masses)
        return integrate(st, acc, cfg.dt, overflow=ovf.sum())

    out["dyn1m_step_ms"] = cuda_ms(step, reps=2)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        out["dyn1m_wall_ms"] = (time.perf_counter() - w0) / 2 * 1e3
    kern = {e.key: e.self_device_time_total / 2e3
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
    out["dyn1m_busy_ms"] = sum(kern.values())
    out["dyn1m_k7_ms"] = sum(t for k, t in kern.items()
                             if "list_eval_kernel" in k)
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
