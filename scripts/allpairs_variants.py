#!/usr/bin/env python3
"""Time variants of the all-pairs kernel K1 (``csrc/allpairs.cu`` with its
targets a thread edited) against the shipped build on one GPU:

    python3 scripts/allpairs_variants.py TARGETS ...

A variant sets ``kApTargets`` (the targets each thread holds; the shipped
value is ``ops.allpairs.ALLPAIRS_TARGETS_PER_THREAD``); each is built by
its own ``nvcc`` into ``build/allpairs_variants/`` and swapped in for
``nbody_allpairs_accel``.  The inputs are the ``random_state`` states
(seed 0) at 2D and 3D N=16,384, 65,536 and 1,048,576, unsoftened, tiles of
1,024 sources (the engine's default).  Per state and build: the mean time
of the launches after a warm-up (CUDA events; 10 launches, 2 at 1,048,576)
at every slice count, the launch-shape function's pick marked, and whether
every output equals the shipped kernel's at its picked shape bit for bit.
Prints the card's ``nvidia-smi`` name and power limit, then one JSON line
per build with its ptxas registers and spill bytes per instantiation.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

G = 6.67e-11
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = (16384, 65536, 1 << 20)


def _variant(targets: int):
    """Build one variant; returns the library's path and its ptxas
    {instantiation: (registers, spill bytes)}."""
    from nbody_tpu_torch.ops import _cuda

    src = open(os.path.join(_cuda.CSRC, "allpairs.cu")).read()
    src, n = re.subn(r"(constexpr int kApTargets = )\d+", rf"\g<1>{targets}",
                     src)
    if n != 1:
        raise RuntimeError("kApTargets not found once in allpairs.cu")
    out_dir = os.path.join(REPO, "build", "allpairs_variants")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, f"allpairs_t{targets}.cu")
    with open(cu, "w") as f:
        f.write(src)
    lib = os.path.join(out_dir, f"liballpairsvar_t{targets}.so")
    cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC), "-o",
           lib, cu]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    return lib, _registers(res.stdout + res.stderr)


def _registers(log: str) -> dict:
    """{"DIMS_SOFT_COMP": (registers, spill bytes)} of K1's instantiations
    in a ``ptxas -v`` report."""
    out, cur, spill = {}, None, 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"allpairs_kernelILi(\d)ELb([01])ELb([01])E", line)
            cur = None if m is None else "_".join(m.groups())
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = int(m[1]) + int(m[2])
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur], cur = (int(m[1]), spill), None
    return out


def main(specs) -> int:
    import torch

    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.ops import _cuda, allpairs
    from nbody_tpu_torch.rng import random_state

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    shipped = _cuda.library()
    states = {}
    for dims in (2, 3):
        for n in SIZES:
            st = random_state(SimConfig(n_bodies=n, n_dim=dims), device=dev)
            states[f"{dims}d_{n}"] = (st.positions, st.masses)

    def k1(p, m):
        return allpairs.allpairs_accelerations(p, m, g=G, source_block=1024)

    ref = {k: k1(*v) for k, v in states.items()}

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

    builds = [("shipped", None, _registers(_cuda.build_log))]
    for spec in specs:
        path, regs = _variant(int(spec))
        builds.append((f"targets={spec}", path, regs))
    orig_lib = _cuda.library
    orig_shape = allpairs.allpairs_launch_shape
    for name, path, regs in builds:
        lib = shipped if path is None else _cuda._Library(
            [path] + [str(_cuda._target(_cuda.CSRC / s))
                      for s in _cuda.SOURCES])
        res = {"build": name, "registers_spills": regs}
        _cuda.library = lambda lib=lib: lib
        try:
            for key, (p, m) in states.items():
                n = p.shape[0]
                pick = orig_shape(n, n, 1024, False)[1]
                same, times = True, {}
                for r in allpairs.ALLPAIRS_SLICES:
                    allpairs.allpairs_launch_shape = (
                        lambda *a, r=r: (0, r, 0))
                    same &= torch.equal(k1(p, m), ref[key])
                    times[f"r={r}{'*' if r == pick else ''}"] = cuda_ms(
                        lambda: k1(p, m), reps=2 if n > 65536 else 10)
                    allpairs.allpairs_launch_shape = orig_shape
                res[key] = {"bit_equal": bool(same), **times}
        finally:
            _cuda.library = orig_lib
            allpairs.allpairs_launch_shape = orig_shape
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.exit(main(sys.argv[1:]))
