#!/usr/bin/env python3
"""Time variants of the leaf sums' chunk adds (``stage_sum`` in
``csrc/tree_sums.cu``: the serial adds of one shared-memory stage) and of
their ring against the shipped build on one GPU:

    python3 scripts/leaf_sums_variants.py [VARIANT ...]

Each variant replaces the body of ``stage_sum`` (``BODIES``) or the
ring's stages and their size (``RINGS``; default: all), is built by its
own ``nvcc`` into ``build/leaf_sums_variants/`` and called through its
own ``nbody_leaf_sums``.  Inputs, f32, 16 columns, 8^7 leaves: 1,048,576
rows in one leaf (64 chains of 16,384 adds) and in 2,097,152 uniform
leaves (no chunk).  Per input and build: the mean time of 10 calls
(CUDA events, the second of two passes; the wrapper's cumsum included),
and whether the output equals the shipped build's bit for bit.  The f32,
16-column kernel's SASS of each build is written beside it, to
``build/leaf_sums_variants/leaf_sums_sass_<variant>.txt``.  Prints the card's
``nvidia-smi`` name and power limit, then one JSON line per build.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)  # the checkout's nbody_tpu_torch

HEAD = ("template <typename T>\n__device__ __forceinline__ T stage_sum("
        "T acc, const T* st, int m, int w) {\n")
BODIES = {
    # the shipped body
    "shipped": None,
    # the next 16 rows load while these 16 are added (a row past m is +0,
    # which leaves acc's bits)
    "pipe16": """  T v[16];
#pragma unroll
  for (int u = 0; u < 16; ++u) v[u] = u < m ? st[u * w] : T(0);
  for (int r = 0; r < m; r += 16) {
    T nv[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      nv[u] = r + 16 + u < m ? st[(r + 16 + u) * w] : T(0);
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) acc = add_rn(acc, v[u]);
#pragma unroll
    for (int u = 0; u < 16; ++u) v[u] = nv[u];
  }
  return acc;
""",
    # no adds: the stages' copies and waits alone (not the sums)
    "no_adds": """  return acc;
""",
    # the adds alone: every row adds the stage's first value (not the
    # sums; their bits differ): how fast the chain runs with no loads
    "chain_only": """  const T x = st[0];
#pragma unroll 16
  for (int r = 0; r < m; ++r) acc = add_rn(acc, x);
  return acc;
""",
}


# the ring's shape: (stages, bytes a stage) for the shipped body; 8 x 16
# KB leaves room for one block an SM
RINGS = {"ring8x16k": (8, 16384), "ring2x32k": (2, 32768)}


def _build(name: str) -> str:
    """Build one variant (the shipped source when its body is None);
    returns the library's path."""
    from nbody_tpu_torch.ops import _cuda

    src = open(os.path.join(_cuda.CSRC, "tree_sums.cu")).read()
    body = BODIES.get(name)
    if name in RINGS:
        for pat, val in zip((r"(constexpr int kStages = )\d+",
                             r"(constexpr int kStageBytes = )\d+"),
                            RINGS[name]):
            src, k = re.subn(pat, rf"\g<1>{val}", src)
            if k != 1:
                raise RuntimeError(f"{pat} not found once in tree_sums.cu")
    if body is not None:
        start = src.index(HEAD) + len(HEAD)
        end = src.index("\n}\n", start) + 1
        src = src[:start] + body + src[end:]
    out_dir = os.path.join(REPO, "build", "leaf_sums_variants")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, f"tree_sums_{name}.cu")
    with open(cu, "w") as f:
        f.write(src)
    lib = os.path.join(out_dir, f"libleafvar_{name}.so")
    cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", lib, cu]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    sass = subprocess.run(
        [os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump"), "-sass",
         lib], capture_output=True, text=True).stdout
    keep, out = False, []
    for line in sass.splitlines():
        if "Function" in line:
            keep = "leaf_sums_kernelIfLi16EiE" in line
        if keep:
            out.append(line)
    with open(os.path.join(out_dir, f"leaf_sums_sass_{name}.txt"),
              "w") as f:
        f.write("\n".join(out))
    regs = re.search(r"leaf_sums_kernelIfLi16EiE.*?Used (\d+) registers",
                     res.stdout + res.stderr, re.S)
    return lib, int(regs.group(1)) if regs else None


def main(names) -> int:
    import torch

    from nbody_tpu_torch.ops import tree

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    n, n_leaf, w = 1 << 20, 8 ** 7, 16
    gen = torch.Generator().manual_seed(9)
    rows = torch.rand((n, w), generator=gen).to(dev)
    one = torch.zeros(n_leaf, dtype=torch.int64)
    one[12345] = n
    uniform = torch.bincount(torch.randint(0, n_leaf, (n,), generator=gen),
                             minlength=n_leaf)
    inputs = {"one_leaf": one.to(dev), "uniform": uniform.to(dev)}

    def call(fn, lengths):
        ends = torch.cumsum(lengths, 0)
        out = torch.empty((n_leaf, w), device=dev)
        partials = torch.empty((2 * (n // tree.LEAF_CHUNK), w), device=dev)
        code = fn(rows.data_ptr(), ends.data_ptr(), out.data_ptr(),
                  partials.data_ptr(), n, n_leaf, w, 0,
                  torch.cuda.current_stream(dev).cuda_stream)
        if code != 0:
            raise RuntimeError(f"nbody_leaf_sums returned {code}")
        return out

    want = {k: tree.leaf_sums(rows, v) for k, v in inputs.items()}
    for name in names:
        lib, regs = _build(name)
        fn = ctypes.CDLL(lib).nbody_leaf_sums
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes, fn.restype = [p, p, p, p, ll, ll, i, i, p], i
        rec = {"variant": name, "registers": regs}
        for key, lengths in inputs.items():
            got = call(fn, lengths)
            for _ in range(2):  # the second pass is kept: the first build
                # timed read ~30% slow in a first pass
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(10):
                    call(fn, lengths)
                end.record()
                torch.cuda.synchronize()
            rec[f"{key}_ms"] = start.elapsed_time(end) / 10
            rec[f"{key}_equal"] = bool(torch.equal(got, want[key]))
        clk = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        rec["sm_clock_after"] = clk.stdout.strip()
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or list(BODIES) + list(RINGS)))
