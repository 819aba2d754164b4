#!/usr/bin/env python3
"""Time variants of kernels K2/K3 (``csrc/runs_eval.cu`` with its round
shape edited) against the shipped build on one GPU:

    python3 scripts/runs_variants.py CHUNK:SLOTS:MINBLOCKS ...

A variant sets ``kRunsChunk`` (lanes staged a round), ``kRunsSlotFloats``
(the round's slot floats) and the second ``__launch_bounds__`` argument
(blocks an SM is asked to hold); each is built by its own ``nvcc`` into
``build/runs_variants/`` and swapped in for ``nbody_runs_eval``.  The
tables are those of the default force passes on the ``random_state``
states (seed 0) at 2D N=40,960, 3D N=131,072 (the run-length gate forced
to K2 and to K3) and 3D N=262,144 (the gate's own pick).  Per table and
build: the mean time of 5 launches after a warm-up (CUDA events) at every
slice count, and whether the output equals the shipped kernel's at its
picked shape bit for bit.  Prints the card's ``nvidia-smi`` name and
power limit, then one JSON line per build.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

G = 6.67e-11
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _variant(chunk: int, slots: int, min_blocks: int) -> str:
    """Build one variant; returns the library's path."""
    from nbody_tpu_torch.ops import _cuda

    src = open(os.path.join(_cuda.CSRC, "runs_eval.cu")).read()
    for pat, val in ((r"(constexpr int kRunsChunk = )\d+", chunk),
                     (r"(constexpr int kRunsSlotFloats = )\d+", slots),
                     (r"(__launch_bounds__\(kRunsThreads, )\d+", min_blocks)):
        src, n = re.subn(pat, rf"\g<1>{val}", src)
        if n != 1:
            raise RuntimeError(f"{pat} not found once in runs_eval.cu")
    out_dir = os.path.join(REPO, "build", "runs_variants")
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{chunk}_{slots}_{min_blocks}"
    cu = os.path.join(out_dir, f"runs_eval_{tag}.cu")
    with open(cu, "w") as f:
        f.write(src)
    lib = os.path.join(out_dir, f"librunsvar_{tag}.so")
    cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC), "-o",
           lib, cu]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    regs = re.findall(r"runs_kernelILi(\d)ELi(\d)E.*?Used (\d+) registers.*?"
                      r"(\d+) bytes smem", res.stdout + res.stderr, re.S)
    return lib, {f"{d}d_p{p}": (int(r), int(s)) for d, p, r, s in regs}


def _tables(dev):
    import torch  # noqa: F401

    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.ops import bh3d, bh_grouped, list_eval
    from nbody_tpu_torch.rng import random_state

    out = {}
    for key, dims, n, gate in (("k2_2d_40960", 2, 40960, None),
                               ("k2_3d_131072", 3, 131072, "plain"),
                               ("k3_3d_131072", 3, 131072, "packed"),
                               ("auto_3d_262144", 3, 262144, None)):
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
        out[key] = seen[0]
    return out


def main(specs) -> int:
    import torch

    from nbody_tpu_torch.ops import _cuda, list_eval

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    shipped = _cuda.library()
    tables = _tables(dev)
    ref = {k: list_eval.list_eval_runs(*a, **kw)
           for k, (a, kw) in tables.items()}

    def cuda_ms(fn, reps=5):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    builds = [("shipped", None, {})]
    for spec in specs:
        chunk, slots, mb = (int(x) for x in spec.split(":"))
        path, regs = _variant(chunk, slots, mb)
        builds.append((spec, path, regs))
    orig_lib, orig_shape = _cuda.library, list_eval.runs_launch_shape
    for name, path, regs in builds:
        lib = shipped if path is None else _cuda._Library(
            [path] + [str(_cuda._target(_cuda.CSRC / s))
                      for s in _cuda.SOURCES])
        res = {"build": name, "registers_smem": regs}
        _cuda.library = lambda lib=lib: lib
        try:
            for key, (a, kw) in tables.items():
                same = torch.equal(list_eval.list_eval_runs(*a, **kw),
                                   ref[key])
                times = {}
                for r in (1, 2, 4, 8):
                    per = list_eval.RUNS_THREADS // r
                    list_eval.runs_launch_shape = (
                        lambda g, s, r=r, per=per: (r, per, g * -(-s // per)))
                    same &= torch.equal(list_eval.list_eval_runs(*a, **kw),
                                        ref[key])
                    times[f"r={r}"] = cuda_ms(
                        lambda: list_eval.list_eval_runs(*a, **kw))
                    list_eval.runs_launch_shape = orig_shape
                res[key] = {"bit_equal": bool(same), **times}
        finally:
            _cuda.library, list_eval.runs_launch_shape = orig_lib, orig_shape
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.exit(main(sys.argv[1:]))
