#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (nbody_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing what it found; the first failure exits non-zero:

0. the card: ``nvidia-smi`` name and power limit, torch's device name;
1. build the CUDA kernels from nbody_tpu_torch/csrc (one nvcc per
   source, started together, sm_90a);
2. kernel K1 (all-pairs) against its plain PyTorch twin on the card,
   with each case's launch shape (targets per thread, slices per target,
   blocks), blocks per SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
   waves and the ptxas registers and spills;
   2b. K1's 3D instantiation, at N=65,536 and a ragged N;
   2c. K5 (the potential) against its twin in 2D and 3D at N=65,536 and
   a ragged N, with its launch shape (targets per thread, slices per
   target, blocks), blocks per SM
   (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), waves and the
   ptxas registers and spills, and ``physics.potential_energy_scalable``
   on the card;
3. kernel K2 (grouped Barnes-Hut runs evaluation) against its twin on
   the tables of a real 2D grouped-BH state;
   3b. K2 (3D) and K3 (segment-packed) against their twins, and K3
   against K2, on the packed and plain tables of one 3D grouped-BH state
   at N=131,072 (both built from the same merged runs); for each K2/K3
   call of 3, 3b, 5 and 5b, its launch (slices per target, blocks, blocks
   per SM, waves, ptxas registers and spills) and the lanes the kernel
   staged (its own count) against the lanes the tables need, which must
   be equal;
   3c. K4 (quarter-split evaluation) against its twin on the tables of
   a real 3D state at N=1,048,576 (the default route: dense collector,
   split on), and K4's 2D instantiation on a 2D state with
   ``split_eval=True``; for both, the launch shape, blocks per SM, waves,
   registers and spills, the lanes the kernel staged (its own count)
   against the lanes the tables need, which must be equal, and the
   schedule (quarters given thread slices, the heaviest block against the
   fair share) with K4's device time at it and at r = 1 forced, which
   must give the same bits (``--only-phase-3c`` runs phases 0, 1 and
   3c);
   3d. K6, K6 compensated and K7 (the padded two-section list
   evaluators) against their twins on the packed lists of a real 2D
   state at N=40,960 and a 3D state at N=131,072, with each call's
   lanes (evaluated, gm > 0 in visited tiles, against needed and
   visited), slices per target, blocks, waves, blocks per SM
   (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and the ptxas
   registers and spills; K6 bit-equal to K7 on the same lists; and K6
   against K7 against the default runs route on the whole force pass;
4. the 2D main path: ``nbody_tpu_torch.cli.main(["run", ...])`` for
   barnes_hut at N=40,960 and allpairs at N=65,536, 10 steps each;
   4b. the 3D main path below the dense band: ``run --dims 3`` for
   barnes_hut at N=131,072, at the smallest N of [131,072, 262,144) whose
   initial state the run-length gate sends to K3, and at N=65,536 (below
   the packing N gate: K2), and allpairs at N=65,536 (K1), 10 steps each;
   4c. the 3D default route at scale: ``run --dims 3`` barnes_hut at
   N=262,144 (dense collector, K2 or K3) and N=1,048,576 (dense
   collector, K4), printing escaped groups, retried steps and peak
   device memory;
   4d. the diagnostics: ``run`` barnes_hut 2D at N=40,960 with
   ``--metrics-csv`` and ``--checkpoint-every 5`` (11 rows, K5 launched
   11 times), 5 steps and 5 more from ``--resume`` bit-equal to the 10
   straight steps, and ``run --dims 3`` at N=262,144 with ``--metrics-csv``;
   K5 against its twin on each metrics run's first and last states, and
   the CSV's potential energy of those steps against the twin's;
   4e. the padded-list evaluators on the main path: ``run`` barnes_hut
   with ``--eval-mode grid``, ``--eval-mode dynamic`` and ``--compensated``
   at 2D N=40,960 and 3D N=131,072 (K6 or K7 launched, K2-K4 not).
   Every run has the kernels' launch counters reset just before it and
   read just after; each run is then replayed in lockstep against the
   plain twins;
5. times on the card (CUDA events, after a warm-up), kernel beside twin,
   K1 at every slice count in 2D and 3D and compensated in 2D (all
   bit-equal), the all-pairs step at N=65,536 with its device busy time
   and idle share by the profiler, K2 at every slice count (all
   bit-equal) and its device time by the profiler;
   5b. the same for the 3D kernels (K2 and K3 at every slice count) and
   the 3D grouped-BH step;
   5c. K4 beside its twin and K2, the 3D step at both sizes, the gates'
   A/Bs (dense vs gather collector, split on vs off) and a
   ``torch.profiler`` split of the 1,048,576-body step;
   5d. K5 (on the metrics runs' last states, at every launch shape its
   shape function can pick, all bit-equal), K6, K6 compensated and K7
   beside their twins and K2 (with the share of the pairs they evaluate
   that are padding, and of the lanes they visit that they skip), K6 at
   every slice count, and one 3D step at N=1,048,576 on the dynamic
   route (K7) against the default (K4), with peak memory and a
   ``torch.profiler`` split into K7 and the rest, beside the packed
   lists' build;
6. the fused runs (``run --fused``: a CUDA graph of the step, captured
   once and replayed, the 3D gates conditional nodes in it), each held
   bit for bit (SHA-256 of the final positions) to the contract loop
   from the same seed (with its 4x retry off when a fused step
   overflowed), with both ms/step, the capture time, the fused run's
   kernel launches (a replay's outside the branches, and the replays
   that took each branch) and peak device memory: 6a 2D grouped BH at
   N=40,960 and 65,536 with ``--save-positions`` (byte-equal), and a
   profiler view of the graph's replays; 6b all-pairs N=65,536 in 2D and
   3D, and 2D ``--eval-mode grid|dynamic`` / ``--compensated`` at
   40,960; 6c 3D BH at 131,072 (the packing gate's plain branch, K2),
   229,376 (its packed branch, K3), 262,144 uniform (the dense
   collector, spill branch not taken), 262,144 ``--init-mode blobs``
   (spill branch taken, escaped groups > 0) and 1,048,576 (K4), each
   route "graph", and the profiler over replays at 131,072 and 262,144
   (``python3 chip_smoke.py --only-phase-6c`` runs phases 0, 1 and 6c); 6d
   ``--bh-mode exact`` at 2D 40,960: one force pass against the native
   f64 engine (2e-4 x max|a| wherever its own f32 CPU run meets that;
   elsewhere that run's error + 1e-5 x max|a|) and against its CPU run
   (1e-5 x max|a|, equal overflow flags), then eager against fused;
   6e ``--save-tree-dumps`` (the 40,960 runs of 6a: both dumps
   byte-equal); 6f ``compare
   --engine-a native --engine-b barnes_hut`` at 40,960, 2 steps, with
   the verdict, return code and both engines' times;
7. the multi-device steps (``nbody_tpu_torch/parallel``): 7a each of the
   eight sharded modes on an NCCL process group of one rank, bit for bit
   (SHA-256) its single-device step (the sharded modes: the grouped pass
   with the whole cloud's window); 7b each mode on D = 2 and 4 thread
   ranks of this process on the one card (all-pairs modes at 2D 65,536
   from ``random_state``, the exact BH at 2D 40,960, the grouped and
   sharded modes at 2D and 3D 262,144 from a Morton-sorted jittered
   grid; ``dp_barnes_hut_sharded3`` also at 1,048,576 on 4 ranks, 2
   steps) against its single-device step within the JAX package's bound
   (tests/test_parallel.py), with its K1-K7 launches (each mode must
   launch its kernel and call no twin), the collectives its first step
   recorded against ``parallel.memory.collective_inventory`` (equal),
   peak memory, overflowed and retried steps, and ms/step labelled as D
   ranks serialised on one card; 7c ``run --devices min(cards, 4)``
   and ``run --devices min(cards, 4) --fused`` per mode at 65,536, 10
   steps, from one seed, through the CLI's entry (``cli.main``), its
   ranks spawned over NCCL, one card a rank, when two or more cards are
   visible: contract lines once, ``positions.txt`` of every body, rank
   0's graph line, the final positions bit-equal where no float is summed across ranks and
   within the mode's bound elsewhere (the loop's 4x retry off where a
   fused step overflowed), both ms/step, both runs' overflowed bodies
   per step, and the loop's ms/step again from the same state once its
   communicators exist; 7d each mode's fused run on
   7a's group of one rank at 7b's sizes, ``Simulation.run_scan`` with
   the sharded step and the mesh as one CUDA graph (the collectives
   captured; route ``graph``), 10 replays bit for bit (SHA-256, and the
   per-step overflow counts) against 10 eager steps of the same step,
   with both ms/step, the capture time, the launches a replay, the
   branches taken and peak memory.
   ``python3 chip_smoke.py --only-phase-7`` runs phases 0, 1 and 7 alone;
8. the tooling (``nbody_tpu_torch/bench``, ``nbody_tpu_torch/scripts``):
   8a ``python -m nbody_tpu_torch bench`` as a subprocess, its last line
   a JSON object whose numbers are all present, finite and positive, on
   backend ``cuda`` and phase 0's card; the same measurement in-process
   must launch K1, K2 and the runs wrapper in 3D (K2 or K3) at both of
   its 3D sizes and call no plain twin, and its fused all-pairs ms/step must lie within 1.0-1.5x
   of one K1 launch at the bench's N by CUDA events; 8b ``sweep``:
   strong at 2D BH 40,960 (device counts 1, or the visible cards up to 4),
   bodies at 40,960 and 65,536, the tiles axis at all-pairs 65,536, 2
   repeats of 10 steps, every requested point in the results file as the
   port's ``_parse_scaling_results`` reads it (no ``plot``: the card's
   machine has no matplotlib); 8c ``python -m
   nbody_tpu_torch.bench.baseline --configs 1,2,3,4,5`` into
   build/chip_smoke/, exit 1: config 1 the error record naming the
   missing triplet, config 2 within 2e-4 of the dense form, config 3 with 0
   overflowed bodies and its dump, configs 4-5 with their one-card
   point; 8d ``scripts.demand`` on evolved states (2D 40,960, 3D 131,072,
   10 steps); 8e ``scripts.phase_split`` at 2D 65,536 and 3D 262,144 (21
   rounds), every stage's median positive, the evaluate stage's least
   round (CUDA events around the runs wrapper in the pass) within 0.9-3x
   the wrapper alone on the same inputs, and the stages' sum at most 1.2x the pass
   timed alone.
   ``python3 chip_smoke.py --only-phase-8`` runs phases 0, 1 and 8 alone;
9. the tree builds' leaf sums (``ops/tree.leaf_sums``, csrc/tree_sums.cu)
   against the twin (``leaf_sums_plain``: the two-level order of
   ``tree.LEAF_CHUNK``-row chunks), bit for bit, and against themselves,
   on the inputs the tree build hands them at 2D 40,960 uniform, 3D
   1,048,576 uniform, 3D 262,144 blobs and 3D 1,048,576 after 10
   contract-loop steps, on 1,048,576 rows in one leaf, and on leaves of
   C - 1, C, C + 1 and 2C + 1 rows in f32 and f64; on leaves of at most
   C rows bit-equal to ``torch.segment_reduce``, on longer ones within
   the two-level order's f32/f64 rounding bound of an f64 sum (the gap
   to segment_reduce and both errors printed); each timed beside the
   twin and the library call, with its bound; and the evolved 1M step
   with the leaf sums on the twin and on the kernels, in turns
   (``--only-phase-9`` runs phases 0, 1 and 9).
11. the adaptive engine's refinement (``tree3d.refine_octree``) on a 1M
   Plummer sphere after 5 steps: card against CPU bit for bit, its sums
   and the build timed alone beside the sums' bound, and one force pass
   with its launches counted (the pyramid's leaf sums, one a refined
   level, one K4) and K4 against its plain twin on that pass's tables,
   for the group of the widest quarter and seven more, and against
   itself at r = 1 forced bit for bit, with its schedule and device time
   at both (``--only-phase-11`` runs phases 0, 1 and 11).
12. the 3D gather walk's kernel (``csrc/collect_gather3.cu``) against its
   twin at the main path's three shapes (the 1M Plummer pass across the
   refinement, the bh3d 1M spill pass, the 4x-cap retry pass on the
   evolved uniform 1M state): every output bit for bit, its time by
   events and on the device beside its bound and the twin's, its
   launches in a 1M Plummer run and a bh3d 1M run (one a pass, one a
   spill pass, one a retry), and both force passes with the walk on the
   twin and on the kernel, in turns (``--only-phase-12`` runs phases 0,
   1 and 12).

The summary gives each kernel its bound: the larger of the FP32 work
over 67 TFLOP/s, the special-function work (rsqrt, and the reciprocal of
an IEEE divide) over 16 per SM per clock at the SM clock ``nvidia-smi``
reads, and the bytes each input is read and each output written once
over 3.35 TB/s, for the pairs this run's inputs need (no tile padding:
approx lanes, direct [lo, hi) lanes, no self-pairs); the leaf sums'
entry (not a TPU kernel) is timed on the evolved 1M state, beside
``torch.segment_reduce`` as its library call.

The line before the last is the kernel summary JSON, the last line
``{"ok": true, "device": {...}}``.  There is no CPU path: without CUDA,
or outside a checkout that holds nbody_tpu_torch, it exits 1 and prints
no result.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

G = 6.67e-11
# Kernel vs twin, and the whole grouped-BH path: |kernel - twin| at most
# 1e-5 of the largest |a| — the bound the JAX package holds its runs
# evaluator to against its XLA route (tests/test_list_eval.py:131).  Both
# sides are f32 and differ only in summation order.
KERNEL_TOL = 1e-5
# Main-path runs, kernels vs twins, in lockstep: the reference's workload
# is chaotic (unsoftened close encounters at dt=1 eject bodies, which
# moves the root bounds and so every Morton group), so two free runs that
# differ in rounding part ways and their final positions say nothing about
# the kernels.  Instead the states of the kernel run go through both
# force passes: the accelerations must agree within KERNEL_TOL x max|a|,
# and the positions after the last compared step within
# KERNEL_TOL x max|a| x dt^2 plus 4 ulp of the largest coordinate (the
# rounding of p + v dt).


# The card's peaks the bounds are taken against (NVIDIA's H100 SXM data
# sheet): FP32 outside the tensor cores, HBM3 bandwidth, and the special
# function units, 16 results per SM per clock on 132 SMs.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
SFU_PER_SM_CLOCK = 16 * 132
# FP32 operations and special-function operations per pair, by kernel
# family and dimension: all-pairs (K1, softening 0: D subtractions, 2D - 1
# for d2, 3 for gm * inv_d^3, 2D for the sums; one rsqrt), the potential
# (K5: D, 2D - 1, one product, one add; one rsqrt) and the Barnes-Hut
# pair (K2-K4, K6, K7: D, 2D - 1, d, d + eps, d2 * (...), the divide,
# 2D for the sums; rsqrt and the divide's reciprocal).
PAIR_OPS = {"allpairs": (lambda d: 5 * d + 2, 1),
            "potential": (lambda d: 3 * d + 1, 1),
            "bh": (lambda d: 5 * d + 3, 2)}
OUT_DIR = os.path.join("build", "chip_smoke")


def bound(kind: str, dims: int, pairs: int, nbytes: int,
          sm_clock_hz: float):
    """(bound_ms, bound_by) of ``pairs`` pair evaluations moving
    ``nbytes``: the larger of the operations' and the bytes' times."""
    flops, sfu = PAIR_OPS[kind]
    t_ops = max(pairs * flops(dims) / PEAK_FP32,
                pairs * sfu / (SFU_PER_SM_CLOCK * sm_clock_hz))
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "bytes" if t_bytes > t_ops else "operations")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cloud(n: int, seed: int, device, dims: int = 2):
    """Bodies of the reference's distribution (project.cu:30-35)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    lo, hi = math.log10(0.1), math.log10(0.5)
    m = 10 ** (lo + (hi - lo) * torch.rand(n, generator=gen))
    p = -0.1 + 0.2 * torch.rand((n, dims), generator=gen)
    return p.to(device), m.to(device)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name: str, got, want) -> float:
    import torch

    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    ok = torch.isfinite(got).all() and err <= KERNEL_TOL * scale
    print(f"  {name}: max|kernel - twin| = {err:.3e}, max|twin| = "
          f"{scale:.3e}, bound {KERNEL_TOL:g} x max|twin| -> "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{name} disagrees with its twin")
    return err


@contextlib.contextmanager
def spying(module, name: str, seen: list):
    """Record the (args, kwargs) of every call of ``module.name``."""
    orig = getattr(module, name)

    def spy(*a, **kw):
        seen.append((a, kw))
        return orig(*a, **kw)

    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, orig)


def capture_tables(positions, masses, gate=None, **kw3):
    """The (args, kwargs) that one grouped-BH force pass hands the runs
    wrapper (K2 or K3), and the mean merged-run length.  ``gate`` forces
    the 3D run-length gate: "packed", "plain" or None (its own choice);
    ``kw3`` goes to the 3D engine."""
    from nbody_tpu_torch.ops import bh3d, bh_grouped, experiments, list_eval

    runs, seen = [], []
    thr = bh_grouped.SEG_PACK_MIN_RUN_LANES
    if gate is not None:
        bh_grouped.SEG_PACK_MIN_RUN_LANES = (
            -1.0 if gate == "packed" else float("inf"))
    try:
        with spying(list_eval, "list_eval_runs", seen), \
                spying(experiments, "merge_ranges", runs):
            if positions.shape[1] == 3:
                bh3d.bh3_accelerations_grouped(positions, masses, g=G,
                                               **kw3)
            else:
                bh_grouped.bh_accelerations_grouped(positions, masses, g=G,
                                                    group_size=2048)
    finally:
        bh_grouped.SEG_PACK_MIN_RUN_LANES = thr
    counts = experiments.merge_ranges(*runs[0][0], **runs[0][1])[0][:, :, 1]
    mean_len = float(counts.sum()) / max(int((counts > 0).sum()), 1)
    return seen[0][0], seen[0][1], mean_len


def capture_split(positions, masses, **kw):
    """The (args, kwargs) that one grouped-BH force pass hands the K4
    wrapper: 3D at the resolved defaults, 2D with ``kw`` (split_eval)."""
    from nbody_tpu_torch.ops import bh3d, bh_grouped, list_eval

    seen = []
    with spying(list_eval, "list_eval_runs_split", seen):
        if positions.shape[1] == 3:
            bh3d.bh3_accelerations_grouped(positions, masses, g=G, **kw)
        else:
            bh_grouped.bh_accelerations_grouped(positions, masses, g=G, **kw)
    if len(seen) != 1:
        fail(f"one force pass called K4's wrapper {len(seen)} times")
    return seen[0]


def direct_fill(args):
    """(direct tiles, mean live lanes per direct tile) of a runs or split
    table."""
    import torch

    tiles, lens = args[-2], args[-1]
    t_cap = tiles.shape[2]
    n_d = lens[-1].clamp(max=t_cap)
    live = torch.arange(t_cap, device=tiles.device)[None] < n_d[:, None]
    span = (tiles[:, 2] - tiles[:, 1]).clamp(min=0) * live
    n = int(n_d.sum())
    return n, float(span.sum()) / max(n, 1)


def pairs_needed(args, split: bool, seg_pack: int = 1) -> int:
    """Pairs a runs or split evaluation needs, from its tables: per group
    (K2/K3) or quarter (K4), each target against the approx lanes and the
    direct [lo, hi) lanes of lens[-1] x P entries (K4 also the extension
    lanes); no lane a tile's padding adds."""
    import torch

    tgt, approx = args[0], args[1]
    tiles, lens = args[-2], args[-1]
    a_w, t_cap = approx.shape[2], tiles.shape[2]
    span = (tiles[:, 2] - tiles[:, 1]).clamp(min=0)  # [rows, T]
    n_d = (lens[-1] * seg_pack).clamp(max=t_cap)
    live = torch.arange(t_cap, device=tiles.device)[None] < n_d[:, None]
    total = lens[0].clamp(max=a_w) + (span * live).sum(1)
    per_row = tgt.shape[1]
    if split:
        total = total + lens[1].clamp(max=args[2].shape[2])
        per_row //= 4
    return int(total.sum()) * per_row


def runs_bytes(args) -> int:
    """Bytes a runs or split evaluation must move: targets and outputs
    once, the coordinate and gm rows of its lists and source table, its
    tile tables and lens."""
    tgt = args[0]
    rows = tgt.shape[2] + 1
    lists = sum(a.shape[0] * rows * a.shape[2] for a in args[1:-3])
    srct = rows * args[-3].shape[1]
    return 4 * (2 * tgt.numel() + lists + srct + args[-2].numel()
                + args[-1].numel())


def capture_padded(positions, masses, mode: str, **kw):
    """The (args, kwargs) of every call one grouped-BH force pass makes to
    the K6 or K7 wrapper: ``mode`` is "grid", "dynamic" or "compensated";
    ``kw`` goes to the engine."""
    from nbody_tpu_torch.ops import bh3d, bh_grouped, list_eval

    name = "list_eval_dynamic" if mode == "dynamic" else "list_eval_pallas"
    kw = dict(kw, **({"compensated": True} if mode == "compensated"
                     else {"eval_mode": mode}))
    seen = []
    with spying(list_eval, name, seen):
        if positions.shape[1] == 3:
            bh3d.bh3_accelerations_grouped(positions, masses, g=G, **kw)
        else:
            bh_grouped.bh_accelerations_grouped(positions, masses, g=G,
                                                group_size=2048, **kw)
    return seen


def padded_work(args, kw, dynamic: bool):
    """(S, lanes needed, lanes evaluated, lanes visited, bytes) of one
    K6/K7 call; each lane pairs with the group's S targets.  Needed: the
    gm > 0 lanes inside the approx section [0, a_n) and the direct section
    [off, off + d_n), that is the approx cells and the superblock lanes
    inside their range's [lo, hi) (K2's direct lanes); the bytes are those
    lanes' coordinates and gm, the targets and the outputs once.
    Evaluated: the gm > 0 lanes of the tiles the walk visits, which the
    kernel stages and pairs.  Visited: every lane of those tiles."""
    import torch

    from nbody_tpu_torch.ops import list_eval

    tgt, src, lens = args
    g, s, dims = tgt.shape
    k = src.shape[2]
    off = kw["section_offset"]
    lane = torch.arange(k, device=src.device)
    a_n, d_n = lens[0, :, None], lens[1, :, None]
    inside = (lane < a_n) | ((lane >= off) & (lane < off + d_n))
    live = src[:, dims] > 0
    needed = int((live & inside).sum())
    k_tile, n_k = list_eval.resolve_list_tiles(s, k, off,
                                               kw.get("k_tile", 2048))
    visits = torch.zeros((g, n_k), dtype=torch.int64)
    for gi, (a, d) in enumerate(lens.t().tolist()):
        for j in list_eval._occupied_tiles(a, d, k_tile, off // k_tile, n_k,
                                           dynamic):
            visits[gi, j] += 1
    per_lane = visits.to(src.device)[:, lane // k_tile]  # [G, K]
    return (s, needed, int((live * per_lane).sum()), int(per_lane.sum()),
            4 * (needed * (dims + 1) + 2 * tgt.numel() + lens.numel()))


MODE_IDS = {"grid": 0, "compensated": 1, "dynamic": 2}  # list_eval.cu


def ptxas_report(log: str, pattern: str, key) -> dict:
    """{key(match): (registers, spill bytes stored + loaded)} of the kernel
    instantiations whose mangled names match ``pattern`` in a ``ptxas -v``
    report."""
    out, cur, spill = {}, None, 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(pattern, line)
            cur = None if m is None else key(m)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = int(m[1]) + int(m[2])
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur] = (int(m[1]), spill)
            cur = None
    return out


def ptxas_list_eval(log: str) -> dict:
    """{(dims, mode id): (registers, spills)} of the K6/K7
    instantiations."""
    return ptxas_report(
        log, r"list_eval_kernelILi(\d)ELb([01])ELb([01])E",
        lambda m: (int(m[1]), 2 if m[3] == "1" else int(m[2])))


def ptxas_allpairs(log: str) -> dict:
    """{(dims, softened, compensated): (registers, spills)} of the K1
    instantiations."""
    return ptxas_report(
        log, r"allpairs_kernelILi(\d)ELb([01])ELb([01])E",
        lambda m: (int(m[1]), m[2] == "1", m[3] == "1"))


def k1_launch(nt: int, ns: int, source_block: int, softening: float,
              compensated: bool, dims: int, ptx: dict) -> dict:
    """K1's launch on nt targets and ns sources: targets per thread,
    slices per target, blocks, blocks one SM holds, waves, registers,
    spills."""
    import torch

    from nbody_tpu_torch.ops import allpairs

    tpt, r, blocks = allpairs.allpairs_launch_shape(nt, ns, source_block,
                                                    compensated)
    per_sm = allpairs.allpairs_occupancy(dims, softening, compensated)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    regs, spill = ptx.get((dims, softening != 0, compensated), (None, None))
    return {"targets_per_thread": tpt, "slices": r, "blocks": blocks,
            "blocks_per_sm": per_sm, "waves": blocks / (per_sm * sms),
            "registers": regs, "spill_bytes": spill}


def k1_slice_sweep(name: str, p, m, source_block: int, compensated: bool,
                   card: str) -> dict:
    """K1 at every slice count (target_block) on one cloud, the shape
    function's pick marked: {"r=..": ms}; fail unless every count gives the
    picked shape's bits."""
    import torch

    from nbody_tpu_torch.ops import allpairs

    kw = dict(g=G, source_block=source_block, compensated=compensated)
    n = p.shape[0]
    pick = allpairs.allpairs_launch_shape(n, n, source_block, compensated)[1]
    ref = allpairs.allpairs_accelerations_vs(p, p, m, **kw)
    sweep = {}
    for tb, r in sorted(allpairs.allpairs_target_blocks().items(),
                        key=lambda kv: kv[1]):
        if not torch.equal(allpairs.allpairs_accelerations_vs(
                p, p, m, target_block=tb, **kw), ref):
            fail(f"{name} at {r} slices differs in bits from the picked "
                 "shape")
        sweep[f"r={r}"] = cuda_ms(lambda: allpairs.allpairs_accelerations_vs(
            p, p, m, target_block=tb, **kw), reps=5)
    print(f"  {name} by slices per target: "
          + ", ".join(f"{k}{'*' if k == f'r={pick}' else ''} {t:.3f}"
                      for k, t in sweep.items())
          + f" ms, all bit-equal (* the launch-shape function's pick)  "
          f"[{card}]", flush=True)
    return sweep


def k5_launch(n: int, dims: int, ptx: dict) -> dict:
    """K5's launch on N bodies: targets per thread, slices per target,
    blocks, blocks one SM holds, waves, registers, spills."""
    import torch

    from nbody_tpu_torch.ops import allpairs

    tpt, r, blocks = allpairs.potential_launch_shape(n)
    per_sm = allpairs.potential_occupancy(dims)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    regs, spill = ptx.get(dims, (None, None))
    return {"targets_per_thread": tpt, "slices": r, "blocks": blocks,
            "blocks_per_sm": per_sm, "waves": blocks / (per_sm * sms),
            "registers": regs, "spill_bytes": spill}


def k4_launch(args, kw, ptx: dict) -> dict:
    """K4's launch on one call's tables (the light path's shape, and the
    blocks and grid of the schedule, with its sliced quarters), and the
    lanes it stages (counted by the kernel) against the lanes the tables
    need."""
    import torch

    from nbody_tpu_torch.ops import list_eval

    g, s, dims = args[0].shape
    tpt, per_q, _ = list_eval.split_launch_shape(4 * g, s)
    sched = list_eval.split_schedule_summary(*args, k_tile=kw["k_tile"])
    per_sm = list_eval.split_occupancy(dims)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    regs, spill = ptx.get(dims, (None, None))
    need = int(list_eval.split_quarter_lanes(
        *args[1:], k_tile=kw["k_tile"]).sum())
    return {"targets_per_thread": tpt, "blocks_per_quarter": per_q,
            "blocks": sched["blocks"], "grid": sched["grid"],
            "sliced_quarters": len(sched["sliced"]),
            "blocks_per_sm": per_sm,
            "waves": sched["blocks"] / (per_sm * sms), "registers": regs,
            "spill_bytes": spill,
            "lanes_staged": list_eval.split_lanes_staged(*args, **kw),
            "lanes_needed": need}


def k4_schedule(name: str, args, kw, card: str) -> dict:
    """K4's schedule on one call's tables (the quarters given r > 1, the
    heaviest block's pairs against the fair share) and its device time
    at that schedule and with r = 1 forced on every quarter (the light
    path alone: the launch before thread slices), by the profiler; fail
    unless both give the same bits."""
    import torch

    from nbody_tpu_torch.ops import list_eval

    sched = list_eval.split_schedule_summary(*args, k_tile=kw["k_tile"])
    by_r = {}
    for _, _, r in sched["sliced"]:
        by_r[r] = by_r.get(r, 0) + 1
    print(f"  {name} schedule: {len(sched['sliced'])} quarters sliced "
          f"(quarters by r: {dict(sorted(by_r.items()))}; the heaviest "
          f"(quarter, lanes, r): {sched['sliced'][:4]}); heaviest block "
          f"{sched['heaviest_block_pairs']:.4g} pairs (at r = 1: "
          f"{sched['heaviest_block_pairs_r1']:.4g}) against a fair share "
          f"of {sched['fair_share_pairs']:.4g} ({sched['pairs']:.4g} pairs "
          f"over {list_eval.SMS} x {list_eval.SPLIT_WAVE_BLOCKS} block "
          f"slots); {sched['blocks']} blocks of a {sched['grid']}-block "
          "grid", flush=True)
    got = list_eval.list_eval_runs_split(*args, **kw)
    light = list_eval._launch_split(*args, slices=1, **kw)
    if not torch.equal(got, light):
        fail(f"{name}: K4 at its schedule differs in bits from r = 1")
    times = {}
    for tag, fn in (("r=1", lambda: list_eval._launch_split(
                        *args, slices=1, **kw)),
                    ("schedule",
                     lambda: list_eval.list_eval_runs_split(*args, **kw))):
        _, kern = device_profile(fn, reps=3)
        times[tag] = sum(v for k, v in kern.items()
                         if "runs_split_kernel" in k)
    pairs = sched["pairs"]
    print(f"  {name} K4 device time: r = 1 forced (before) "
          f"{times['r=1']:.3f} ms, at the schedule {times['schedule']:.3f} "
          f"ms ({pairs / times['schedule'] / 1e6:.1f} G pairs/s); bit-equal"
          f"  [{card}]", flush=True)
    return dict(sched, ms=times, by_r=by_r)


def runs_launch(args, kw, ptx: dict) -> dict:
    """K2/K3's launch on one call's tables (slices per target, targets per
    block, blocks, blocks one SM holds, waves, registers, spills), and the
    lanes it stages (counted by the kernel) against the lanes the tables
    need."""
    import torch

    from nbody_tpu_torch.ops import list_eval

    g, s, dims = args[0].shape
    p = kw.get("seg_pack", 1)
    r, per_block, blocks = list_eval.runs_launch_shape(g, s)
    per_sm = list_eval.runs_occupancy(dims, p)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    regs, spill = ptx.get((dims, p), (None, None))
    need = int(list_eval.runs_group_lanes(*args[1:], k_tile=kw["k_tile"],
                                          seg_pack=p).sum())
    return {"slices": r, "targets_per_block": per_block, "blocks": blocks,
            "blocks_per_sm": per_sm, "waves": blocks / (per_sm * sms),
            "registers": regs, "spill_bytes": spill,
            "lanes_staged": list_eval.runs_lanes_staged(*args, **kw),
            "lanes_needed": need}


def check_runs_launch(name: str, args, kw, ptx: dict) -> dict:
    """Print K2/K3's launch on one call's tables; fail unless the kernel
    stages exactly the lanes the tables need (also counted from the
    pairs)."""
    info = runs_launch(args, kw, ptx)
    per_pair = pairs_needed(args, False, kw.get("seg_pack", 1)) // (
        args[0].shape[1])
    print(f"  {name} launch: {info['slices']} slices a target, "
          f"{info['targets_per_block']} targets a block, {info['blocks']} "
          f"blocks, {info['blocks_per_sm']} blocks/SM -> "
          f"{info['waves']:.2f} waves; registers {info['registers']}, spill "
          f"bytes {info['spill_bytes']}; lanes staged {info['lanes_staged']}"
          f", needed {info['lanes_needed']} (from the pair count "
          f"{per_pair})", flush=True)
    if not info["lanes_staged"] == info["lanes_needed"] == per_pair:
        fail(f"{name} stages {info['lanes_staged']} lanes where "
             f"{info['lanes_needed']} are needed")
    return info


def runs_slice_sweep(name: str, args, kw, card: str) -> dict:
    """K2/K3 at every slice count on one call's tables (the shape
    function's pick marked): {"r=..": ms}; fail unless every count gives
    the picked shape's bits."""
    import torch

    from nbody_tpu_torch.ops import list_eval

    g, s = args[0].shape[:2]
    pick = list_eval.runs_launch_shape(g, s)[0]
    ref = list_eval.list_eval_runs(*args, **kw)
    orig, sweep = list_eval.runs_launch_shape, {}
    try:
        for r in (1, 2, 4, 8):
            per = list_eval.RUNS_THREADS // r
            list_eval.runs_launch_shape = (
                lambda g_, s_, r=r, per=per: (r, per, g_ * -(-s_ // per)))
            if not torch.equal(list_eval.list_eval_runs(*args, **kw), ref):
                fail(f"{name} at {r} slices differs in bits from the picked "
                     "shape")
            sweep[f"r={r}"] = cuda_ms(
                lambda: list_eval.list_eval_runs(*args, **kw), reps=5)
    finally:
        list_eval.runs_launch_shape = orig
    print(f"  {name} by slices per target: "
          + ", ".join(f"{k}{'*' if k == f'r={pick}' else ''} {t:.3f}"
                      for k, t in sweep.items())
          + f" ms, all bit-equal (* the launch-shape function's pick)  "
          f"[{card}]", flush=True)
    return sweep


def runs_device_ms(name: str, args, kw, card: str):
    """K2/K3's device time per launch at the picked shape, by the
    profiler: CUDA events around back-to-back calls also count the
    wrapper's host work (the group order), which can leave the card idle
    between sub-millisecond launches.  None if no device time shows."""
    from nbody_tpu_torch.ops import list_eval

    _, kern = device_profile(lambda: list_eval.list_eval_runs(*args, **kw),
                             reps=10)
    t = sum(v for k, v in kern.items() if "runs_kernel" in k)
    rest = sum(kern.values()) - t
    print(f"  {name} by the profiler: runs_kernel {t:.3f} ms a launch, the "
          f"wrapper's other kernels {rest:.3f} ms  [{card}]", flush=True)
    return t or None


def launch_info(args, mode: str, ptx: dict) -> dict:
    """K6/K7's launch on one call's targets: slices per target, targets
    per block, blocks, blocks one SM holds, waves, registers, spills."""
    import torch

    from nbody_tpu_torch.ops import list_eval

    g, s, dims = args[0].shape
    r, per_block, blocks = list_eval.list_launch_shape(g, s)
    per_sm = list_eval.list_eval_occupancy(dims, MODE_IDS[mode])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    regs, spill = ptx.get((dims, MODE_IDS[mode]), (None, None))
    return {"slices": r, "targets_per_block": per_block, "blocks": blocks,
            "blocks_per_sm": per_sm, "waves": blocks / (per_sm * sms),
            "registers": regs, "spill_bytes": spill}


def device_profile(step, reps: int = 2):
    """(wall ms, {device kernel: ms}) per call of ``step`` under
    torch.profiler; ops carry their kernels' time too, so only device
    kernels are kept."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - w0) / reps * 1e3
    kern = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            kern[e.key] = e.self_device_time_total / reps / 1e3
    return wall, kern


@contextlib.contextmanager
def plain_twins():
    """Route the main path's kernel wrappers to their plain twins."""
    from nbody_tpu_torch.ops import (allpairs, bh3d, collect_dense3,
                                     list_eval, tree, tree3d)

    names = ("list_eval_runs", "list_eval_runs_split", "list_eval_pallas",
             "list_eval_dynamic")
    orig = [allpairs.allpairs_accelerations_vs] + [
        getattr(list_eval, n) for n in names]
    allpairs.allpairs_accelerations_vs = (
        lambda t, s, m, *, target_block=None, **kw:
        allpairs.allpairs_accelerations_plain(t, s, m, **kw))
    for n in names:
        setattr(list_eval, n, getattr(list_eval, f"{n}_plain"))
    leaf = tree.leaf_sums
    tree.leaf_sums = tree3d.leaf_sums = tree.leaf_sums_plain
    dense = collect_dense3._dense_lists_kernel
    collect_dense3._dense_lists_kernel = collect_dense3._dense_lists
    gather = bh3d._gather_lists_kernel
    bh3d._gather_lists_kernel = bh3d._gather_lists
    try:
        yield
    finally:
        bh3d._gather_lists_kernel = gather
        allpairs.allpairs_accelerations_vs = orig[0]
        for n, fn in zip(names, orig[1:]):
            setattr(list_eval, n, fn)
        tree.leaf_sums = tree3d.leaf_sums = leaf
        collect_dense3._dense_lists_kernel = dense


# the short labels this script prints the program's counters under
LABELS = {"k1": "ops.allpairs.KERNEL_LAUNCHES",
          "k2": "ops.list_eval.KERNEL_LAUNCHES",
          "k3": "ops.list_eval.PACKED_LAUNCHES",
          "k4": "ops.list_eval.SPLIT_LAUNCHES",
          "k5": "ops.allpairs.POTENTIAL_LAUNCHES",
          "k6": "ops.list_eval.GRID_LAUNCHES",
          "k7": "ops.list_eval.DYNAMIC_LAUNCHES",
          "dense": "ops.collect_dense3.DENSE_PASSES",
          "escaped": "ops.collect_dense3.ESCAPED_GROUPS",
          "spills": "ops.collect_dense3.SPILL_PASSES",
          "dense_kernel": "ops.collect_dense3.DENSE_KERNEL_LAUNCHES",
          "gather_kernel": "ops.bh3d.GATHER_KERNEL_LAUNCHES",
          "leaf": "ops.tree.LEAF_SUM_LAUNCHES"}


def reset_counts():
    from nbody_tpu_torch.utils import profiling

    profiling.reset_counters()


def read_counts() -> dict:
    """The program's counters (``utils/profiling.COUNTERS``), under their
    short labels."""
    from nbody_tpu_torch.utils import profiling

    values = profiling.counter_values()
    return {label: values[name] for label, name in LABELS.items()}


def main_path_run(engine: str, n: int, dims: int, steps: int,
                  flags=()):
    """One ``run`` through the CLI (``flags`` appended) with the counters
    reset just before and read just after; returns (final positions,
    launch counts).  The counts also carry the steps retried at 4x caps
    and the peak device memory of the run."""
    import torch

    from nbody_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(["run", "--device", "cuda", "--dims", str(dims),
                       "--engine", engine, "--n-bodies", str(n),
                       "--steps", str(steps), *flags])
    counts = read_counts()
    counts["retried"] = err.getvalue().count("retrying with 4x caps")
    counts["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    text = out.getvalue()
    print(text.strip())
    if err.getvalue().strip():
        print(err.getvalue().strip())
    state = cli.last_simulation.state
    tag = f"{dims}D {engine} N={n}{' ' if flags else ''}{' '.join(flags)}"
    if rc != 0:
        fail(f"run {tag} exited {rc}")
    if "GPU total computation took" not in text or (
            "GPU parallel computation took" not in text):
        fail(f"run {tag} did not print both timing lines")
    if int(state.overflow) != 0:
        fail(f"run {tag}: {int(state.overflow)} bodies overflowed")
    if not bool(torch.isfinite(state.positions).all()):
        fail(f"run {tag}: non-finite positions")
    print(f"  {tag}: {steps} steps, overflow 0, positions finite; kernel "
          f"launches K1 {counts['k1']}, K2 {counts['k2']}, K3 "
          f"{counts['k3']}, K4 {counts['k4']}, K5 {counts['k5']}, K6 "
          f"{counts['k6']}, K7 {counts['k7']}, leaf sums {counts['leaf']}; "
          "dense collector passes "
          f"{counts['dense']}, escaped groups {counts['escaped']} (spill "
          f"passes {counts['spills']}); steps retried at 4x caps "
          f"{counts['retried']}; peak device memory "
          f"{counts['peak_gib']:.2f} GiB", flush=True)
    return state.positions.clone(), counts


def lockstep(engine: str, n: int, dims: int, steps: int, twin_steps: int,
             final, device, **over) -> None:
    """Replay a main-path run as ``run_contract`` steps it (a step whose
    caps overflow is recomputed with every cap at 4x, through the gather
    walk): every step through the kernels, the first ``twin_steps`` also
    through the twins; the replay must end at the CLI run's positions bit
    for bit.  ``over`` sets config fields the run's flags set."""
    import torch

    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.models.engines import make_accel_fn, resolved_caps
    from nbody_tpu_torch.physics import integrate
    from nbody_tpu_torch.rng import random_state

    cfg = SimConfig(n_bodies=n, n_dim=dims, n_steps=steps, engine=engine,
                    **over)
    accel = make_accel_fn(cfg, return_diagnostics=True)
    accel4 = None
    state = random_state(cfg, device=device)
    worst, d, bound, retries = 0.0, None, None, 0
    for k in range(steps):
        prev = state
        fn = accel
        acc, ovf = fn(prev.positions, prev.masses)
        if int(ovf.sum()):
            if accel4 is None:
                caps = {c: 4 * v for c, v in resolved_caps(cfg).items()}
                accel4 = make_accel_fn(
                    cfg.replace(collect3="gather", **caps),
                    return_diagnostics=True)
            fn = accel4
            acc, ovf = fn(prev.positions, prev.masses)
            retries += 1
        state = integrate(prev, acc, cfg.dt, overflow=ovf.sum())
        if k >= twin_steps:
            continue
        with plain_twins():
            acc_t, _ = fn(prev.positions, prev.masses)
        err = float((acc - acc_t).abs().max())
        scale = float(acc_t.abs().max())
        worst = max(worst, err / scale)
        if not err <= KERNEL_TOL * scale:
            fail(f"{dims}D {engine}: force pass through the kernels differs "
                 f"from the twins by {err:.3e} (max|a| {scale:.3e})")
        twin_p = integrate(prev, acc_t, cfg.dt).positions
        d = float((state.positions - twin_p).abs().max())
        pmax = float(state.positions.abs().max())
        bound = KERNEL_TOL * scale * cfg.dt ** 2 + 4 * pmax * 2.0 ** -23
        if not d <= bound:
            fail(f"{dims}D {engine}: positions after step {k} differ from "
                 f"the twins' step by {d:.3e} (bound {bound:.3e})")
    if not torch.equal(state.positions, final):
        fail(f"{dims}D {engine}: replaying the run did not reproduce the CLI "
             "run's final positions bit for bit")
    print(f"  {dims}D {engine} N={n} {over or ''}: {twin_steps} lockstep "
          "force passes "
          f"within {worst:.3e} x max|a| (bound {KERNEL_TOL:g}); positions "
          f"after step {twin_steps - 1} kernels vs twins {d:.3e} (bound "
          f"{bound:.3e}); the {steps}-step replay ({retries} steps retried "
          "at 4x caps) reproduces the CLI run bit for bit -> ok", flush=True)


def first_packed_n(device) -> int:
    """The smallest N of the 3D band [131072, 262144) whose initial
    uniform state the run-length gate sends to K3."""
    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.rng import random_state

    for n in (131072, 163840, 196608, 229376, 262143):
        st = random_state(SimConfig(n_bodies=n, n_dim=3), device=device)
        _, kw, mean_len = capture_tables(st.positions, st.masses)
        print(f"  N={n}: mean merged run length of the initial state "
              f"{mean_len:.1f} lanes -> seg_pack {kw['seg_pack']}",
              flush=True)
        if kw["seg_pack"] > 1:
            return n
    fail("the run-length gate picks K2 for every N of [131072, 262144)")



# -- phase 6: the fused run (a CUDA graph of the step), the exact BH, ---------
# -- quadtree dumps and the compare verb -------------------------------------

def cli_run(argv, tag: str):
    """One CLI call in-process, the kernels' launch counters reset just
    before and read just after; returns (stdout, stderr, the run's
    Simulation, counts).  Fails on a non-zero exit."""
    from nbody_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    counts = read_counts()
    if rc != 0:
        print(out.getvalue()[-2000:], err.getvalue()[-2000:])
        fail(f"{tag}: {' '.join(argv)} exited {rc}")
    return out.getvalue(), err.getvalue(), cli.last_simulation, counts


def digest(t) -> str:
    return digest_np(t.detach().cpu().numpy())


def digest_np(a) -> str:
    return hashlib.sha256(a.tobytes()).hexdigest()[:16]


def parallel_ms(stdout: str) -> float:
    m = re.search(r"GPU parallel computation took (\d+) microseconds", stdout)
    if not m:
        fail("a run printed no parallel timing line")
    return int(m.group(1)) / 1e3


def fused_pair(tag: str, flags, steps: int, files=(), card: str = ""):
    """``run`` and ``run --fused`` from one seed through cli.main.  The
    fused run's final positions must be bit-equal (SHA-256) to a contract
    loop's: the plain loop where no fused step overflowed (its 4x retry
    then never fires), else the loop with the retry off; every file in
    ``files`` byte-equal.  Returns (eager ms/step, fused ms/step, capture
    ms, fused launch counts, the fused Simulation)."""
    import torch

    base = ["run", "--device", "cuda", "--steps", str(steps), *flags]
    d_f = os.path.join(OUT_DIR, "fused", tag, "fused")
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out_f, err_f, sim_f, c_f = cli_run(
        base + ["--output-dir", d_f, "--fused"], f"{tag} --fused")
    # the run's own peak: above what was live before it
    c_f["peak_gib"] = (torch.cuda.max_memory_allocated() - live) / 2**30
    counts = sim_f.last_scan_overflow
    held = "the contract loop"
    loop_flags = []
    if counts.any():
        held = "the contract loop with the 4x retry off"
        loop_flags = ["--no-adaptive-caps"]
    d_e = os.path.join(OUT_DIR, "fused", tag, "eager")
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out_e, err_e, sim_e, _ = cli_run(base + ["--output-dir", d_e]
                                     + loop_flags, tag)
    peak_e = (torch.cuda.max_memory_allocated() - live) / 2**30
    fin_f, fin_e = sim_f.state.positions, sim_e.state.positions
    if not torch.equal(fin_f, fin_e):
        fail(f"{tag}: the fused run's final positions ({digest(fin_f)}) "
             f"differ from {held}'s ({digest(fin_e)})")
    for name in files:
        with open(os.path.join(d_e, name), "rb") as a, open(
                os.path.join(d_f, name), "rb") as b:
            if a.read() != b.read():
                fail(f"{tag}: {name} differs between loop and fused runs")
    route = [ln for ln in err_f.splitlines() if ln.startswith("fused:")]
    eager_ms = parallel_ms(out_e) / steps
    fused_ms = sim_f.last_scan_ms / steps
    print(f"  {tag}: {steps} steps, route {sim_f.last_scan_route}; fused "
          f"overflow per step {counts.tolist()}; final positions SHA-256 "
          f"{digest(fin_f)} = {held}'s"
          f"{'; ' + ', '.join(files) + ' byte-equal' if files else ''}; "
          f"eager {eager_ms:.3f} ms/step, fused {fused_ms:.3f} ms/step "
          f"({eager_ms / fused_ms:.2f}x), capture "
          f"{sim_f.last_capture_ms:.1f} ms; fused launches K1 {c_f['k1']}, "
          f"K2 {c_f['k2']}, K3 {c_f['k3']}, K4 {c_f['k4']}, K6 "
          f"{c_f['k6']}, K7 {c_f['k7']}, leaf sums {c_f['leaf']}; a replay "
          f"outside branches {sim_f.last_replay_launches}; branches taken "
          f"{sim_f.last_branch_counts}; peak device memory above the live "
          f"tensors: fused {c_f['peak_gib']:.2f} GiB, loop {peak_e:.2f} GiB"
          f"  [{card}]", flush=True)
    for ln in route:
        print(f"    {ln}", flush=True)
    return eager_ms, fused_ms, sim_f.last_capture_ms, c_f, sim_f


def quiet_seed(n: int, dev, steps: int = 10) -> int:
    """The first seed from 7 whose 2D grouped-BH run of ``steps`` fused
    steps overflows no cap: the fused run does not retry, so only such a
    run can be held bit for bit to the contract loop, whose 4x retry then
    never fires.  Every seed tried is printed with its counts."""
    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.models.simulation import Simulation

    for seed in range(7, 15):
        sim = Simulation(SimConfig(n_bodies=n, n_steps=steps,
                                   engine="barnes_hut", seed=seed),
                         device=dev)
        with contextlib.redirect_stderr(io.StringIO()):
            sim.run_scan()
        counts = sim.last_scan_overflow
        print(f"  N={n} seed {seed}: fused overflow per step "
              f"{counts.tolist()}", flush=True)
        if not counts.any():
            return seed
    fail(f"every seed of 7-14 overflows a cap at N={n} within {steps} "
         "steps")


def graph_profile(cfg, tag: str, dev, card: str) -> tuple:
    """The profiler over 10 replays of ``cfg``'s step as a CUDA graph
    (after 2 untimed): wall and device-busy ms/step, printed with the idle
    share and the top kernels; returns (wall, busy)."""
    from nbody_tpu_torch.models.engines import make_accel_fn
    from nbody_tpu_torch.models.simulation import StepGraph
    from nbody_tpu_torch.physics import integrate
    from nbody_tpu_torch.rng import random_state

    st = random_state(cfg, device=dev)
    accel = make_accel_fn(cfg, return_diagnostics=True)

    def step(s):
        acc, ovf = accel(s.positions, s.masses)
        return integrate(s, acc, cfg.dt, overflow=ovf.sum())

    g = StepGraph(step, st, 12)
    g.replay(2)
    wall, kern = device_profile(lambda: g.replay(1), reps=10)
    taken = g.settle()
    busy = sum(kern.values())
    print(f"  profiler, {tag} graph replays: wall {wall:.3f} ms/step, "
          f"device busy {busy:.3f} ms/step, idle share "
          f"{100 * (1 - busy / wall) if busy else float('nan'):.1f}%, "
          f"{len(kern)} kernel names; branches taken over 12 replays "
          f"{taken}  [{card}]", flush=True)
    for k, t in sorted(kern.items(), key=lambda kv: -kv[1])[:5]:
        print(f"    {t:8.3f} ms/step  {k[:90]}", flush=True)
    return wall, busy


# phase 6c's five 3D runs: (N, extra flags, what the fused run must
# show).  "no spill" holds for the uniform initial state only (JAX's census:
# 0 escaped groups at every scale): the reference's dt = 1 pulls a
# uniform cloud out of shape within a step, and later steps may spill, so
# it is checked on a 1-step fused run of the same seed
P6C_RUNS = ((131072, (), "plain (K2)"), (229376, (), "packed (K3)"),
            (262144, (), "no spill"),
            (262144, ("--init-mode", "blobs"), "spill"),
            (1 << 20, (), "K4"))


def phase6c(dev, card: str) -> dict:
    """6c: 3D BH ``run --fused`` as one CUDA graph at five sizes, its
    gates conditional nodes: each bit-equal to the loop and through the
    branch named for it; then the profiler over replays at 131,072 and
    262,144.  Returns the runs' fused launch counts."""
    from nbody_tpu_torch.config import SimConfig

    print("phase 6c: 3D BH --fused as one CUDA graph (the packing and spill "
          "gates as conditional nodes) against the loop, 10 steps",
          flush=True)
    runs = {}
    for n, extra, want in P6C_RUNS:
        tag = f"BH 3D N={n}{' ' + ' '.join(extra) if extra else ''}"
        *_, c, sim = fused_pair(
            tag, ["--engine", "barnes_hut", "--dims", "3", "--n-bodies",
                  str(n), "--seed", "7", *extra], 10, (), card)
        taken = sim.last_branch_counts
        per = sim.last_replay_launches
        print(f"    escaped groups over the fused run (warm-up step "
              f"included) {c['escaped']}, spill passes {c['spills']}",
              flush=True)
        if sim.last_scan_route != "graph":
            fail(f"{tag} --fused did not run as a graph")
        if want == "no spill":
            _, _, one, _ = cli_run(
                ["run", "--device", "cuda", "--steps", "1", "--fused",
                 "--engine", "barnes_hut", "--dims", "3", "--n-bodies",
                 str(n), "--seed", "7", "--output-dir",
                 os.path.join(OUT_DIR, "fused", tag, "one")],
                f"{tag} --fused --steps 1")
            taken = one.last_branch_counts
            print(f"    the first step alone, fused: branches taken "
                  f"{taken}", flush=True)
        ok = {"plain (K2)": taken.get("plain (K2)", 0) > 0,
              "packed (K3)": taken.get("packed (K3)", 0) > 0,
              "no spill": "spill" in taken and taken["spill"] == 0,
              "spill": taken.get("spill", 0) > 0 and c["escaped"] > 0,
              "K4": per.get(LABELS["k4"], 0) > 0}[want]
        if not ok:
            fail(f"{tag} --fused: the graph's replays did not show "
                 f"'{want}' (branches {taken}, a replay's launches {per})")
        runs[(n, extra)] = c
    for n in (131072, 262144):
        graph_profile(SimConfig(n_bodies=n, n_dim=3, engine="barnes_hut",
                                seed=7), f"BH 3D N={n:,}", dev, card)
    return runs


def phase6(dev, card: str) -> dict:
    """Phase 6; returns the fused main path's launch counts by run."""
    import numpy as np
    import torch

    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.ops import barnes_hut
    from nbody_tpu_torch.rng import random_state
    from nbody_tpu_torch.utils import native

    runs = {}
    print("phase 6a: 2D grouped BH, run against run --fused (a CUDA graph "
          "of the step) through nbody_tpu_torch.cli.main, --save-positions "
          "(and at 40,960 --save-tree-dumps: phase 6e)", flush=True)
    for n, dumps in ((40960, True), (65536, False)):
        files = ["positions.txt"] + (
            ["quadtree_init.txt", "quadtree_final.txt"] if dumps else [])
        flags = ["--engine", "barnes_hut", "--n-bodies", str(n), "--seed",
                 str(quiet_seed(n, dev)), "--save-positions"] + (
            ["--save-tree-dumps"] if dumps else [])
        *_, c, sim = fused_pair(f"BH 2D N={n}", flags, 10, files, card)
        if sim.last_scan_route != "graph" or c["k2"] <= 0:
            fail(f"BH 2D N={n} --fused did not replay K2 in a graph")
        if sim.last_scan_overflow.any():
            fail(f"BH 2D N={n} --fused overflowed")
        runs[("bh", n)] = c
    if runs:
        print("phase 6e: quadtree_init.txt and quadtree_final.txt of the "
              "40,960 runs above byte-equal between loop and fused -> ok",
              flush=True)
    # where a graph step's time goes: the profiler over replays
    graph_profile(SimConfig(n_bodies=40960, engine="barnes_hut", seed=7),
                  "BH 2D N=40,960", dev, card)

    print("phase 6b: all-pairs N=65,536 2D and 3D, and 2D BH --eval-mode "
          "grid / dynamic / --compensated at 40,960, run against run "
          "--fused", flush=True)
    for dims in (2, 3):
        *_, c, sim = fused_pair(
            f"allpairs {dims}D N=65536",
            ["--engine", "allpairs", "--n-bodies", "65536", "--dims",
             str(dims), "--seed", "7", "--save-positions"], 10,
            ["positions.txt"], card)
        if sim.last_scan_route != "graph" or c["k1"] <= 0:
            fail(f"allpairs {dims}D --fused did not replay K1 in a graph")
        runs[("allpairs", dims)] = c
    for mode, flags, want in (("grid", ["--eval-mode", "grid"], "k6"),
                              ("dynamic", ["--eval-mode", "dynamic"], "k7"),
                              ("compensated", ["--compensated"], "k6")):
        *_, c, sim = fused_pair(
            f"BH 2D N=40960 {mode}",
            ["--engine", "barnes_hut", "--n-bodies", "40960", "--seed", "7",
             *flags], 10, (), card)
        if sim.last_scan_route != "graph" or c[want] <= 0:
            fail(f"BH 2D {mode} --fused did not replay {want.upper()} in a "
                 "graph")
        runs[(mode, 2)] = c

    runs.update(phase6c(dev, card))

    print("phase 6d: --bh-mode exact, 2D N=40,960: one force pass on the "
          "card against the native f64 engine (2e-4 x max|a|, the JAX "
          "package's oracle budget, on every element where the f32 CPU run "
          "meets it; elsewhere the CPU run's error + 1e-5 x max|a|) and "
          "against its CPU run (1e-5 x max|a|, flags equal); then 10 steps "
          "eager and --fused", flush=True)
    cfg = SimConfig(n_bodies=40960, engine="barnes_hut", bh_mode="exact",
                    seed=7)
    st = random_state(cfg, device=dev)
    kw = dict(g=G, theta=cfg.theta, max_depth=cfg.resolved_max_depth,
              frontier_cap=256, return_diagnostics=True)
    acc, ovf = barnes_hut.bh_accelerations(st.positions, st.masses, **kw)
    pass_ms = cuda_ms(lambda: barnes_hut.bh_accelerations(
        st.positions, st.masses, **kw), reps=3)
    t0 = time.perf_counter()
    acc_c, ovf_c = barnes_hut.bh_accelerations(st.positions.cpu(),
                                               st.masses.cpu(), **kw)
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = native.bh_accelerations(
        st.positions.double().cpu().numpy(), st.masses.double().cpu().numpy(),
        g=G, theta=cfg.theta, max_depth=cfg.resolved_max_depth)
    native_s = time.perf_counter() - t0
    # the JAX package's oracle budget, 2e-4 x max|a| (its
    # tests/test_barnes_hut.py, at N=600), on every body where the f32
    # algorithm itself meets it: at 40,960 a body beside a near-coincident
    # neighbour can miss it in f32 (the aggregate COM's rounding), and the
    # JAX package's engine misses it there by the same amount.  There the
    # card must carry its CPU run's error, within KERNEL_TOL x max|a|.
    a = acc.double().cpu().numpy()
    a_c = acc_c.double().numpy()
    s_nat = float(np.abs(ref).max())
    err_card, err_cpu = np.abs(a - ref), np.abs(a_c - ref)
    budget = 2e-4 * s_nat
    beyond = err_cpu > budget
    ok_nat = bool(np.all(err_card <= np.where(
        beyond, err_cpu + KERNEL_TOL * s_nat, budget)))
    e_cpu = float((acc.cpu() - acc_c).abs().max())
    s_cpu = float(acc_c.abs().max())
    n_ovf = int(ovf.sum())
    print(f"  exact BH force pass: card vs native f64 max "
          f"{float(err_card.max()):.3e} = {float(err_card.max()) / s_nat:.3e}"
          f" x max|a| (budget {budget:.3e}); elements beyond the budget: "
          f"card {int((err_card > budget).sum())}, CPU run "
          f"{int(beyond.sum())} (the CPU run's worst "
          f"{float(err_cpu.max()) / s_nat:.3e} x max|a|); card vs CPU "
          f"{e_cpu:.3e} (bound {KERNEL_TOL * s_cpu:.3e}); overflowed bodies "
          f"card {n_ovf}, CPU {int(ovf_c.sum())}, flags equal "
          f"{bool(torch.equal(ovf.cpu(), ovf_c))}; eager pass "
          f"{pass_ms:.3f} ms (CUDA events), CPU run {cpu_s:.1f} s, native "
          f"f64 {native_s:.2f} s  [{card}]", flush=True)
    if not (ok_nat and e_cpu <= KERNEL_TOL * s_cpu
            and torch.equal(ovf.cpu(), ovf_c)):
        fail("the exact BH on the card disagrees with the native engine or "
             "its CPU run")
    *_, c, sim = fused_pair(
        "exact BH 2D N=40960", ["--engine", "barnes_hut", "--bh-mode",
                                "exact", "--n-bodies", "40960", "--seed",
                                "7"], 10, (), card)
    if sim.last_scan_route != "graph":
        fail("exact BH --fused did not run as a graph")

    print("phase 6f: compare --engine-a native --engine-b barnes_hut, "
          "N=40,960, 2 steps", flush=True)
    p0 = random_state(SimConfig(n_bodies=40960, seed=7), device=dev)
    # BASELINE.json: "theta=0.5 within 1e-3 relative trajectory error",
    # relative to the position scale
    tol = 1e-3 * float(p0.positions.abs().max())
    from nbody_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(["compare", "--device", "cuda", "--n-bodies", "40960",
                       "--steps", "2", "--seed", "7", "--engine-a",
                       "native", "--engine-b", "barnes_hut", "--tol",
                       f"{tol:.6g}"])
    text = out.getvalue()
    verdict = [ln for ln in text.splitlines() if "final positions" in ln]
    times = [ln for ln in text.splitlines() if "total computation" in ln]
    n_diff = text.count("Difference at index")
    print(f"  --tol {tol:.6g}: rc {rc}; {' | '.join(times)}; verdict "
          f"{verdict[0].strip() if verdict else None!r}; rows beyond tol "
          f"{n_diff}  [{card}]", flush=True)
    if rc not in (0, 1) or not verdict or len(times) != 2:
        fail("compare printed no verdict")
    return runs


# -- phase 7: the multi-device steps (nbody_tpu_torch/parallel) ----------------

# mode -> (dims, engine, N, 7b's steps, the JAX package's bound on the
# positions after its tests' 3 steps (dp2d: 2), x max|p|,
# tests/test_parallel.py; 7b takes 2 steps to keep the script's time,
# 7d and 7c take their own counts): all-pairs at the
# bench's N from random_state, the exact BH at the reference's 40,960, the
# grouped and sharded modes at BASELINE config 4's N from a Morton-sorted
# jittered grid (bounded separations keep the BH-class difference of local
# groups and window gates assertable, and ranks must hold Morton-contiguous
# slabs for the window to cover them)
P7_MODES = {
    "dp_allpairs": (2, "allpairs", 65536, 2, 5e-6),
    "ring_allpairs": (2, "allpairs", 65536, 2, 5e-6),
    "dp2d_allpairs": (2, "allpairs", 65536, 2, 5e-6),
    "dp_barnes_hut": (2, "barnes_hut", 40960, 2, 5e-6),
    "dp_barnes_hut_grouped": (2, "barnes_hut", 262144, 2, 5e-5),
    "dp_barnes_hut_sharded": (2, "barnes_hut", 262144, 2, 5e-5),
    "dp_barnes_hut_grouped3": (3, "barnes_hut", 262144, 2, 5e-5),
    "dp_barnes_hut_sharded3": (3, "barnes_hut", 262144, 2, 5e-5),
}
# BASELINE config 5's weak scaling: 262,144 bodies a rank on 4 ranks
P7_WEAK = ("dp_barnes_hut_sharded3", 1048576, 4, 2)
# jittered grids: counts per axis, at tests/test_parallel.py's spacing (a
# 48-body side in 0.2): scaled up by more cells, not by a finer grid,
# whose neighbours would pull bodies past their spacing within a step at
# dt=1 (at 512 in 0.2 the 2D grid melts into close encounters)
P7_GRIDS = {(2, 40960): (256, 160), (2, 262144): (512, 512),
            (3, 262144): (64, 64, 64), (3, 1048576): (128, 128, 64)}
P7_SPACING = 0.2 / 48
# the kernel counter(s) each mode's main path must move (the exact BH is
# eager torch: no kernel)
P7_KERNELS = {"allpairs": ("k1",), "dp_barnes_hut": (),
              "2d": ("k2",), "3d": ("k2", "k3"), "split": ("k4",)}
# a valid reorder of K1's sum (its tiles' width) in the single-device step
P7_ALT_SOURCE_BLOCK = 256
P7_TWINS = (("allpairs", "allpairs_accelerations_plain"),
            ("list_eval", "list_eval_runs_plain"),
            ("list_eval", "list_eval_runs_split_plain"),
            ("list_eval", "list_eval_pallas_plain"),
            ("list_eval", "list_eval_dynamic_plain"))


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def p7_state(mode: str, n: int, dev):
    """The phase's initial state of ``mode`` at ``n`` bodies."""
    import numpy as np
    import torch

    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.ops.tree import morton_codes, root_bounds
    from nbody_tpu_torch.ops.tree3d import morton_codes_3d, root_bounds_3d
    from nbody_tpu_torch.rng import random_state
    from nbody_tpu_torch.state import from_numpy

    dims, engine = P7_MODES[mode][:2]
    if engine == "allpairs":
        return random_state(SimConfig(n_bodies=n, n_dim=dims), device=dev)
    shape = P7_GRIDS[(dims, n)]
    rng = np.random.default_rng(3)
    idx = np.stack(np.meshgrid(*[np.arange(k) for k in shape],
                               indexing="ij"), -1).reshape(-1, dims)
    p = ((idx + rng.uniform(0.25, 0.75, idx.shape)) * P7_SPACING
         - 0.1).astype(np.float32)
    m = (10 ** rng.uniform(-1, np.log10(0.5), n)).astype(np.float32)
    v = rng.uniform(-1e-4, 1e-4, (n, dims)).astype(np.float32)
    pos = torch.from_numpy(p).to(dev)
    depth = SimConfig(n_bodies=n, n_dim=dims).resolved_max_depth
    if dims == 2:
        codes = morton_codes(pos, root_bounds(pos), depth)
    else:
        codes = morton_codes_3d(pos, root_bounds_3d(pos), depth)
    o = torch.argsort(codes, stable=True).cpu().numpy()
    return from_numpy(m[o], p[o], v[o], device=dev)


def p7_config(mode: str, n: int):
    from nbody_tpu_torch.config import SimConfig

    dims, engine = P7_MODES[mode][:2]
    return SimConfig(n_bodies=n, n_dim=dims, engine=engine,
                     bh_mode="exact" if mode == "dp_barnes_hut" else "grouped")


def engine_of(mode: str) -> str:
    return P7_MODES[mode][1]


def p7_expected(mode: str, n_eff: int) -> tuple:
    if "allpairs" in mode:
        return P7_KERNELS["allpairs"]
    if mode == "dp_barnes_hut":
        return P7_KERNELS["dp_barnes_hut"]
    if not mode.endswith("3"):
        return P7_KERNELS["2d"]
    return P7_KERNELS["split" if n_eff >= 786432 else "3d"]


def windowed_step(cfg, state):
    """One single-device step of the grouped pass with the whole cloud's
    window: what a sharded mode computes on one rank (the window gate keeps
    close cells whose leaf span reaches past the cloud's first or last
    occupied leaf from being direct, so it is not the plain grouped step;
    the JAX package alike)."""
    import torch

    from nbody_tpu_torch.ops import bh3d, bh_grouped
    from nbody_tpu_torch.physics import integrate

    p, m = state.positions, state.masses
    md = cfg.resolved_max_depth
    if cfg.n_dim == 3:
        tree = bh3d.build_octree(p, m, max_depth=md)
    else:
        tree = bh_grouped.build_quadtree(p, m, max_depth=md)
    order = torch.argsort(tree.codes, stable=True)
    ps = p[order]
    srcs = [ps[:, d].contiguous() for d in range(cfg.n_dim)]
    kw = dict(window_cells=(tree.codes.min(), tree.codes.max()),
              range_offset=torch.zeros((), dtype=torch.int32,
                                       device=p.device),
              n_sources_hint=p.shape[0], g=cfg.g, return_diagnostics=True)
    if cfg.n_dim == 3:
        acc, ovf = bh3d.grouped_eval_3d(
            p, tree, sorted_srcs=(*srcs, cfg.g * m[order]), **kw)
    else:
        acc, ovf = bh_grouped.grouped_eval(
            tree, target_positions=p, sorted_x=srcs[0], sorted_y=srcs[1],
            sorted_gm=cfg.g * m[order],
            direct_cell_max=cfg.resolved_direct_cell_max, **kw)
    return integrate(state, acc, cfg.dt, overflow=ovf.sum())


def p7_single(cfg, state, steps: int, dev):
    """``steps`` single-device steps, an overflowed step retried at 4x
    caps as the contract loop does; returns (positions, overflowed steps,
    retried steps, ms/step over the steps after the first)."""
    from nbody_tpu_torch.models.simulation import Simulation

    sim = Simulation(cfg, state=state)
    over = retried = 0
    t0 = time.perf_counter()
    for k in range(steps):
        prev = state
        state = sim.step_fn(prev)
        if int(state.overflow):
            retried += 1
            state = sim._fallback_step()(prev)
        over += bool(int(state.overflow))
        if k == 0:
            sync(dev)
            t0 = time.perf_counter()
    sync(dev)
    return (state.positions, over, retried,
            (time.perf_counter() - t0) * 1e3 / max(steps - 1, 1))


def p7_rank(mesh, mode: str, cfg, state, steps: int):
    """One thread rank of phase 7b: ``steps`` sharded steps from its slab,
    an overflowed step retried with the 4x-caps sharded step (the CLI's
    policy); returns (gathered positions, overflowed steps, retried
    steps, the collectives of the first step, ms/step over the steps
    after the first).  The mesh's axes record into one log."""
    from nbody_tpu_torch.models.engines import resolved_caps
    from nbody_tpu_torch.parallel import make_sharded_step, shard_state
    from nbody_tpu_torch.parallel.mesh import gather_state

    log = next(iter(mesh.axes.values())).log
    s = shard_state(state, mesh)
    step = make_sharded_step(cfg, mesh, mode)
    retry = None
    over = retried = n_first = 0
    t0 = time.perf_counter()
    for k in range(steps):
        prev = s
        s = step(prev)
        if k == 0:
            n_first = len(log)
        if int(s.overflow):
            if retry is None:
                caps = {c: 4 * v for c, v in resolved_caps(cfg).items()}
                retry = make_sharded_step(cfg.replace(**caps), mesh, mode)
            retried += 1
            s = retry(prev)
        over += bool(int(s.overflow))
        if k == 0:
            sync(mesh.device)
            t0 = time.perf_counter()
    sync(mesh.device)
    ms = (time.perf_counter() - t0) * 1e3 / max(steps - 1, 1)
    return (gather_state(s, mesh).positions, over, retried, log[:n_first],
            ms)


@contextlib.contextmanager
def one_rank_group(dev):
    """A process group of this process alone (NCCL on the card, gloo on
    the CPU), rendezvousing through a file; yields the backend."""
    import datetime

    import torch.distributed as dist

    os.makedirs(OUT_DIR, exist_ok=True)
    init = os.path.abspath(os.path.join(OUT_DIR, "pg7"))
    if os.path.exists(init):
        os.remove(init)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"file://{init}",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=120))
    try:
        yield backend
    finally:
        dist.destroy_process_group()


def one_rank_mesh(mode: str):
    from nbody_tpu_torch.parallel import make_mesh, make_mesh_2d

    return make_mesh_2d(1, 1) if mode == "dp2d_allpairs" else make_mesh(1)


def p7_one_rank(dev, backend: str) -> None:
    """7a: every mode on a process group of ONE rank (NCCL on the card)
    gives the bits of its single-device step."""
    from nbody_tpu_torch.models.simulation import Simulation
    from nbody_tpu_torch.parallel import make_sharded_step, shard_state

    for mode, (dims, engine, n, _, _) in P7_MODES.items():
        cfg = p7_config(mode, n)
        state = p7_state(mode, n, dev)
        mesh = one_rank_mesh(mode)
        if mesh.device != dev:
            fail(f"7a: the {backend} mesh is on {mesh.device}, not {dev}")
        step = make_sharded_step(cfg, mesh, mode)
        s = shard_state(state, mesh)
        ref = state
        single = Simulation(cfg, state=state).step_fn
        for _ in range(2):
            s = step(s)
            ref = (windowed_step(cfg, ref) if "sharded" in mode
                   else single(ref))
        got, want = digest(s.positions), digest(ref.positions)
        print(f"  7a {mode} {dims}D N={n}: 2 steps on a {backend} group "
              f"of 1 rank, sha256 {got} against the single-device "
              f"{'windowed grouped ' if 'sharded' in mode else ''}step's "
              f"{want} (overflow {int(s.overflow)} / "
              f"{int(ref.overflow)}) -> "
              f"{'ok' if got == want else 'FAIL'}", flush=True)
        if got != want:
            fail(f"7a: {mode} on one rank is not the single-device step")


# 7d: the fused run of each mode on the one-rank group, steps a run
P7D_STEPS = 10


def p7_graph(mode: str, dev, card: str) -> dict:
    """7d: ``mode``'s sharded step on the one-rank group of 7a, as the
    fused run's CUDA graph (``Simulation.run_scan`` with the step and the
    mesh: route ``graph``, the collectives captured) and stepped eagerly
    from the same slab with no retry: final positions and per-step
    overflow counts equal, both timed (CUDA synchronised wall clock),
    with the capture time, the launches a replay, the branches taken and
    the peak memory above the live tensors.  Returns the graph run's
    counts."""
    import numpy as np
    import torch

    from nbody_tpu_torch.models.simulation import Simulation
    from nbody_tpu_torch.ops import allpairs, list_eval
    from nbody_tpu_torch.parallel import make_sharded_step, shard_state

    dims, _, n, _, _ = P7_MODES[mode]
    cfg = p7_config(mode, n).replace(n_steps=P7D_STEPS)
    state = p7_state(mode, n, dev)
    mesh = one_rank_mesh(mode)
    step = make_sharded_step(cfg, mesh, mode)
    tag = f"7d {mode} {dims}D N={n}"

    def peak_above(live) -> float:
        return (torch.cuda.max_memory_allocated(dev) - live) / 2**30

    sync(dev)
    live = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    twins = []
    sim = Simulation(cfg, state=shard_state(state, mesh), step_fn=step,
                     mesh=mesh)
    reset_counts()
    with contextlib.ExitStack() as stack:
        for mod, name in P7_TWINS:
            stack.enter_context(spying(
                {"allpairs": allpairs, "list_eval": list_eval}[mod], name,
                twins))
        stack.enter_context(contextlib.redirect_stderr(io.StringIO()))
        sim.run_scan()
    counts = read_counts()
    peak_g = peak_above(live)
    route, ovf_g = sim.last_scan_route, sim.last_scan_overflow
    graph_ms, capture_ms = sim.last_scan_ms / P7D_STEPS, sim.last_capture_ms
    replay, branches = sim.last_replay_launches, sim.last_branch_counts
    fin_g = sim.state.positions
    del sim
    s = shard_state(state, mesh)
    sync(dev)
    live = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ovf = []
    t0 = time.perf_counter()
    for _ in range(P7D_STEPS):
        s = step(s)
        ovf.append(s.overflow)
    sync(dev)
    eager_ms = (time.perf_counter() - t0) * 1e3 / P7D_STEPS
    peak_e = peak_above(live)
    ovf_e = torch.stack(ovf).cpu().numpy()
    got, want = digest(fin_g), digest(s.positions)
    expect = p7_expected(mode, n)
    print(f"  {tag}: route {route}; {P7D_STEPS} steps, final positions "
          f"SHA-256 graph {got} / eager {want} -> "
          f"{'equal' if got == want else 'DIFFER'}; overflow per step "
          f"{ovf_g.tolist()} / {ovf_e.tolist()}; graph {graph_ms:.3f} "
          f"ms/step, eager {eager_ms:.3f} ms/step "
          f"({eager_ms / graph_ms:.2f}x), capture {capture_ms:.1f} ms; "
          f"a replay launches {replay} outside branches, branches taken "
          f"{branches}; the run's launches K1 {counts['k1']}, K2 "
          f"{counts['k2']}, K3 {counts['k3']}, K4 {counts['k4']}, leaf "
          f"sums {counts['leaf']} (twin calls {len(twins)}); peak device "
          f"memory above the live tensors: graph {peak_g:.2f} GiB, eager "
          f"{peak_e:.2f} GiB  [{card}]", flush=True)
    if route != "graph":
        fail(f"{tag}: the fused run took route {route!r}, not a graph")
    if got != want or not np.array_equal(ovf_g, ovf_e):
        fail(f"{tag}: the graph's run is not its eager steps'")
    if not bool(torch.isfinite(fin_g).all()):
        fail(f"{tag}: non-finite positions")
    if twins:
        fail(f"{tag}: {len(twins)} calls of the kernels' plain twins")
    if expect and not sum(counts[k] for k in expect):
        fail(f"{tag}: none of {expect} launched")
    counts.update(graph_ms=graph_ms, eager_ms=eager_ms,
                  capture_ms=capture_ms, peak_gib=peak_g,
                  eager_peak_gib=peak_e, replay=replay, branches=branches)
    return counts
def p7_threads(mode: str, n: int, n_dev: int, steps: int, tol: float, dev,
               card: str) -> dict:
    """7b: ``mode`` on ``n_dev`` thread ranks of this process on the one
    card against its single-device step; returns the run's counts."""
    import torch

    from nbody_tpu_torch.ops import allpairs, list_eval
    from nbody_tpu_torch.parallel import steps as steps_mod
    from nbody_tpu_torch.parallel.collectives import RecordingAxis
    from nbody_tpu_torch.parallel.memory import collective_inventory
    from nbody_tpu_torch.parallel.mesh import (
        Mesh, run_ranks, thread_meshes, thread_meshes_2d)

    cfg = p7_config(mode, n)
    state = p7_state(mode, n, dev)
    want, s_over, s_retried, s_ms = p7_single(cfg, state, steps, dev)
    if mode == "dp2d_allpairs":
        meshes = thread_meshes_2d(n_dev // 2, 2, dev)
        inv = collective_inventory(cfg, n_dev // 2, mode, sp=2)
    else:
        meshes = thread_meshes(n_dev, dev)
        inv = collective_inventory(cfg, n_dev, mode)
    logs = [[] for _ in meshes]
    meshes = [Mesh({k: RecordingAxis(ax, log) for k, ax in m.axes.items()},
                   m.device) for m, log in zip(meshes, logs)]
    twins, windows = [], {}
    orig_window = steps_mod._source_window

    def window_spy(ax, *a):
        out = orig_window(ax, *a)
        c_lo, c_hi = out[1]
        windows.setdefault(ax.axis_index(), int(c_lo) <= int(c_hi))
        return out

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with contextlib.ExitStack() as stack:
        for mod, name in P7_TWINS:
            stack.enter_context(spying(
                {"allpairs": allpairs, "list_eval": list_eval}[mod], name,
                twins))
        steps_mod._source_window = window_spy
        stack.callback(setattr, steps_mod, "_source_window", orig_window)
        got, over, retried, first, ms = run_ranks(
            p7_rank, meshes, mode, cfg, state, steps)[0]
    counts = read_counts()
    counts["peak_gib"] = (torch.cuda.max_memory_allocated() / 2**30
                          if dev.type == "cuda" else 0.0)
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    # the sharded modes' windows of the first step: real, or degraded (a
    # failed count match).  At D >= 4 the first and last ranks' windows
    # wrap around the ring ([D-1 | 0 | 1], [D-2 | D-1 | 0]) and never
    # match, in the JAX package alike: their bodies' close cells all
    # aggregate at max depth (PERF.md, PR 10).  The bound is then held on
    # the bodies of the ranks whose windows are real.
    degraded = sorted(r for r, ok in windows.items() if not ok)
    slab = n // n_dev
    err_real = max((float((got - want)[r * slab:(r + 1) * slab].abs().max())
                    for r in range(n_dev) if r not in degraded), default=0.0)
    # the all-pairs modes sum each target's pairs in another order than
    # the single-device step; on random_state at 65,536 bodies close
    # encounters amplify those last bits past the JAX package's bound,
    # which the single-device step itself misses under a valid reorder of
    # its sum (K1 at another source_block; PERF.md, PR 10).  The bound is
    # then held on the bodies whose single-device trajectory that reorder
    # leaves within it.
    sensitive, err_calm = None, err
    if engine_of(mode) == "allpairs" and not err <= tol * scale:
        alt = p7_single(cfg.replace(source_block=P7_ALT_SOURCE_BLOCK),
                        state, steps, dev)[0]
        moved = (alt - want).abs().amax(1) > tol * scale
        sensitive = int(moved.sum())
        if sensitive > n // 2:
            fail(f"7b {mode} D={n_dev}: {sensitive} of {n} bodies are "
                 "sensitive to a reorder of the single-device sum")
        err_calm = float((got - want)[~moved].abs().max())
    expect = p7_expected(mode, n)
    tag = f"7b {mode} {cfg.n_dim}D N={n} D={n_dev}"
    print(f"  {tag}: positions after {steps} steps within "
          f"{err / scale:.3e} x max|p| of the single-device step (bound "
          f"{tol:g}){'' if not windows else f'; windows degraded on ranks {degraded}, the other ranks within {err_real / scale:.3e}'}"
          f"{'' if sensitive is None else f'; {sensitive} bodies move by more than the bound in the single-device step under K1 at source_block {P7_ALT_SOURCE_BLOCK}, the others within {err_calm / scale:.3e}'}"
          f"; launches K1 {counts['k1']}, K2 {counts['k2']}, K3 "
          f"{counts['k3']}, K4 {counts['k4']}, K6 {counts['k6']}, K7 "
          f"{counts['k7']} (all ranks; twin calls {len(twins)}); "
          f"collectives of a step recorded {sorted(first)} against "
          f"collective_inventory {sorted(inv)}; peak device memory "
          f"{counts['peak_gib']:.2f} GiB; overflowed steps {over} (single "
          f"{s_over}), retried {retried} (single {s_retried}); "
          f"{ms:.2f} ms/step ({n_dev} ranks serialised on one card), "
          f"single device {s_ms:.2f} ms/step  [{card}]", flush=True)
    if not bool(torch.isfinite(got).all()):
        fail(f"{tag}: non-finite positions")
    if degraded and degraded != ([0, n_dev - 1] if n_dev >= 4 else []):
        fail(f"{tag}: the windows of ranks {degraded} degraded")
    held = err  # the error on the bodies the bound is held on
    if degraded:
        held = err_real
    if sensitive:
        held = err_calm
    if not held <= tol * scale:
        fail(f"{tag}: {err / scale:.3e} x max|p| from the single-device "
             f"step ({held / scale:.3e} on the bodies held), beyond the "
             f"JAX package's {tol:g}")
    if sorted(first) != sorted(inv):
        fail(f"{tag}: the collectives a step issued are not the model's")
    if twins:
        fail(f"{tag}: {len(twins)} calls of the kernels' plain twins")
    if expect and not sum(counts[k] for k in expect):
        fail(f"{tag}: none of {expect} launched")
    counts.update(ms=ms, single_ms=s_ms, rel_err=err / scale,
                  rel_err_held=held / scale, degraded=degraded,
                  sensitive=sensitive, retried=retried, overflowed=over)
    return counts


# 7c: ``run --devices D`` and ``run --devices D --fused`` per mode, from
# one seed at N=65,536, 10 steps each, through the CLI's own entry
# (``cli.main``).  The modes whose step sums no float across ranks must
# end bit-equal; the others psum floats (the leaf rows, dp2d's partial
# accelerations), which NCCL may add in another order in a graph: held
# to P7_MODES' bound, and their bits reported
P7C_N, P7C_STEPS = 65536, 10
P7C_EXACT = ("dp_allpairs", "ring_allpairs", "dp_barnes_hut_grouped",
             "dp_barnes_hut_grouped3")
P7C_TIMEOUT = 180  # seconds a run of D ranks may take
P7C_OUT = "NBODY_SMOKE_7C_OUT"  # where rank 0 saves its record


def p7c_rank(rank: int, args, mode: str) -> None:
    """``cli._run_rank`` as a 7c run's ranks run it: the CLI's rank, then
    the same Simulation's contract loop again, no outputs, from the same
    initial slab (the CLI's loop times its first step, which creates the
    NCCL communicators; this second loop times the same 10 steps warm),
    its steps' overflow counts kept (before any retry); rank 0 saves the gathered final
    positions, both runs' overflow counts, the route and the world size
    to ``$NBODY_SMOKE_7C_OUT``."""
    import numpy as np
    import torch.distributed as dist

    from nbody_tpu_torch import cli
    from nbody_tpu_torch.parallel.mesh import gather_state, shard_state

    if cli._run_rank is p7c_rank:
        fail("7c: a rank process found the CLI's rank replaced")
    cli._run_rank(rank, args, mode)
    sim = cli.last_simulation
    final = gather_state(sim.state, sim.mesh).positions.cpu().numpy()
    warm_ms, loop_ovf, again = 0.0, [], final
    if not args.fused:
        sim.config = sim.config.replace(save_positions=False,
                                        save_tree_dumps=False)
        sim.state = shard_state(cli._make_state(
            args, sim.config, sim.state.positions.device), sim.mesh)
        step = sim.step_fn

        def counted(state):
            new = step(state)
            loop_ovf.append(new.overflow)
            return new

        sim.step_fn = counted
        with contextlib.redirect_stderr(io.StringIO()):
            _, timing = sim.run_contract()
        warm_ms = timing.parallel_us / 1e3 / args.steps
        again = gather_state(sim.state, sim.mesh).positions.cpu().numpy()
    if rank == 0:
        ovf = (sim.last_scan_overflow if args.fused
               else np.asarray([int(o) for o in loop_ovf]))
        np.savez(os.environ[P7C_OUT], positions=final,
                 overflow=np.asarray(ovf), route=str(sim.last_scan_route),
                 warm_ms=warm_ms, warm_same=np.array_equal(again, final),
                 world=dist.get_world_size())


def p7c_point(argv: list, out: str) -> int:
    """``run --devices D`` through ``cli.main``, its ranks running
    :func:`p7c_rank` (``mp.spawn`` sends a function by name, so each rank
    imports this module and finds it), in a subprocess of its own
    (:func:`p7c_run`)."""
    from nbody_tpu_torch import cli

    os.environ[P7C_OUT] = out
    cli._run_rank = p7c_rank
    return cli.main(argv)


def p7c_run(argv: list, out_dir: str, tag: str) -> tuple:
    """One 7c run in a subprocess of its own session, killed with every
    rank it started after ``P7C_TIMEOUT`` s; returns (rank 0's record,
    its stdout, its stderr, wall seconds)."""
    import signal

    import numpy as np

    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "rank0.npz")
    code = ("import json, sys, chip_smoke as cs; "
            "sys.exit(cs.p7c_point(*json.loads(sys.argv[1])))")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-c", code, json.dumps([argv, out])],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=P7C_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail(f"{tag}: no end within {P7C_TIMEOUT} s (every rank killed)")
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        print(stdout[-2000:], stderr[-4000:])
        fail(f"{tag}: run --devices {argv[argv.index('--devices') + 1]} "
             f"exited {proc.returncode}")
    with np.load(out) as z:
        return {k: z[k] for k in z.files}, stdout, stderr, wall


def p7c_check(stdout: str, n: int, out_dir: str, tag: str) -> float:
    """The contract lines once, ``positions.txt`` once with every body of
    every step; returns the run's ms/step (its parallel line)."""
    totals = re.findall(r"GPU total computation took \d+ milliseconds",
                        stdout)
    if len(totals) != 1 or stdout.count("GPU parallel") != 1:
        fail(f"{tag}: the contract lines were not printed once")
    with open(os.path.join(out_dir, "positions.txt")) as f:
        rows = sum(1 for _ in f)
    if rows != (P7C_STEPS + 1) * n:
        fail(f"{tag}: positions.txt has {rows} rows, not "
             f"{(P7C_STEPS + 1) * n}")
    return parallel_ms(stdout) / P7C_STEPS


def p7c_mode(mode: str, n_dev: int, card: str) -> tuple:
    """7c of one mode: ``run --devices n_dev --fused`` and then the loop
    (with the 4x retry off where a fused step overflowed), from one seed;
    returns (loop ms/step, the warm loop's, fused ms/step)."""
    import numpy as np

    dims, _, _, _, tol = P7_MODES[mode]
    n = P7C_N
    base = ["run", "--device", "cuda", "--devices", str(n_dev), "--mode",
            mode, "--dims", str(dims), "--n-bodies", str(n), "--steps",
            str(P7C_STEPS), "--engine", engine_of(mode), "--save-positions"]
    tag = f"7c {mode} {dims}D N={n} D={n_dev}"
    root = os.path.abspath(os.path.join(OUT_DIR, f"7c_{mode}"))
    shutil.rmtree(root, ignore_errors=True)
    d_f, d_e = os.path.join(root, "fused"), os.path.join(root, "loop")
    fused, out_f, err_f, wall_f = p7c_run(
        base + ["--fused", "--output-dir", d_f], d_f, f"{tag} --fused")
    ms_f = p7c_check(out_f, n, d_f, f"{tag} --fused")
    graph_line = [ln for ln in err_f.splitlines() if ln.startswith("fused:")]
    loop_flags, held = [], "the loop"
    if fused["overflow"].any():
        loop_flags, held = ["--no-adaptive-caps"], (
            "the loop with the 4x retry off")
    loop, out_e, _, wall_e = p7c_run(
        base + loop_flags + ["--output-dir", d_e], d_e, tag)
    ms_e = p7c_check(out_e, n, d_e, tag)
    warm = float(loop["warm_ms"])
    world = int(fused["world"])
    shutil.rmtree(root, ignore_errors=True)
    got, want = fused["positions"], loop["positions"]
    same = bool(np.array_equal(got, want))
    err = float(np.abs(got - want).max()) / float(np.abs(want).max())
    print(f"  {tag}: {world} ranks over NCCL; --fused route "
          f"{fused['route']}; final positions SHA-256 {digest_np(got)} / "
          f"{held}'s {digest_np(want)} -> "
          f"{'bit-equal' if same else f'differ, {err:.3e} x max|p|'}; "
          f"fused {ms_f:.3f} ms/step, loop {ms_e:.3f} ms/step (its first "
          f"step creates the communicators), the same loop again from the "
          f"same state {warm:.3f} ms/step ({warm / ms_f:.2f}x the fused; "
          f"its final bits the loop's: {bool(loop['warm_same'])}); "
          f"overflowed bodies per step, fused "
          f"{fused['overflow'].tolist()} / loop "
          f"{loop['overflow'].tolist()} (a fused step truncates its lists "
          f"there); positions.txt {(P7C_STEPS + 1) * n} rows each; wall "
          f"{wall_f:.1f} / {wall_e:.1f} s  [{card}]", flush=True)
    for ln in graph_line:
        print(f"    rank 0: {ln}", flush=True)
    if str(fused["route"]) != "graph" or not any(
            f"on each of {world} ranks" in ln for ln in graph_line):
        fail(f"{tag}: --fused did not print the graph line of {world} ranks "
             "on rank 0")
    if not np.isfinite(got).all():
        fail(f"{tag}: non-finite positions")
    if mode in P7C_EXACT and not same:
        fail(f"{tag}: the fused run's final positions are not {held}'s "
             "bits")
    if not err <= tol:
        fail(f"{tag}: fused and loop {err:.3e} x max|p| apart, beyond "
             f"{tol:g}")
    return ms_e, warm, ms_f


def p7_cli(dev, card: str) -> dict:
    """7c: ``run --devices D`` beside ``run --devices D --fused`` per
    mode, one card a rank (D = min(cards, 4)), when the machine has two
    cards or more; returns {mode: (loop ms/step, the warm loop's, fused
    ms/step)}."""
    import torch

    count = torch.cuda.device_count() if dev.type == "cuda" else 0
    if count < 2:
        print(f"  7c: only {count} card visible: run --devices over NCCL "
              "needs two or more; not run here", flush=True)
        return {}
    torch.cuda.empty_cache()  # the ranks share card 0 with this process
    times, failed = {}, []
    for mode in P7_MODES:
        try:  # every mode runs and reports; the phase fails after
            times[mode] = p7c_mode(mode, min(count, 4), card)
        except SystemExit:
            failed.append(mode)
    if failed:
        fail(f"7c: {failed} failed (above)")
    return times


def phase7(dev, card: str) -> dict:
    """Phase 7; returns {(mode, D): counts} of the thread-rank runs and,
    keyed (f"{mode} graph", 1), of 7d's graph runs."""
    with one_rank_group(dev) as backend:
        print(f"phase 7a: each sharded mode on a process group of one rank "
              f"({backend}) against its single-device step, bit for bit "
              "(SHA-256)", flush=True)
        p7_one_rank(dev, backend)
        print("phase 7b: each sharded mode on D = 2 and 4 thread ranks of "
              "one process on this card (collectives met in the process, "
              "psum in rank order; the ranks share one stream, so ms/step "
              "is not a scaling number) against its single-device step, "
              "within the JAX package's bound (tests/test_parallel.py)",
              flush=True)
        runs, failed = {}, []
        cases = [(mode, n, n_dev, steps, tol)
                 for mode, (_, _, n, steps, tol) in P7_MODES.items()
                 for n_dev in (2, 4)]
        mode, n, n_dev, steps = P7_WEAK
        cases.append((mode, n, n_dev, steps, P7_MODES[mode][4]))
        for mode, n, n_dev, steps, tol in cases:
            key = (mode if n == P7_MODES[mode][2] else f"{mode}@{n}", n_dev)
            try:  # every case runs and reports; the phase fails after
                runs[key] = p7_threads(mode, n, n_dev, steps, tol, dev,
                                       card)
            except SystemExit:
                failed.append(key)
        if failed:
            fail(f"phase 7b: {failed} failed (above)")
        print("phase 7c: run --devices D beside run --devices D --fused "
              "over NCCL, one card a rank", flush=True)
        p7_cli(dev, card)
        print(f"phase 7d: each sharded mode's fused run on the {backend} "
              f"group of one rank (7a's): Simulation.run_scan with the "
              f"sharded step as one CUDA graph, its collectives captured, "
              f"{P7D_STEPS} replays against {P7D_STEPS} eager steps of the "
              "same step, bit for bit", flush=True)
        for mode in P7_MODES:
            runs[(f"{mode} graph", 1)] = p7_graph(mode, dev, card)
    return runs


# -- phase 8: the tooling (bench, sweep, baseline, demand, phase split) -------

# the bench line's numbers: every one present, finite and positive; its
# counts present and >= 0
P8_MS_KEYS = ("allpairs2d_loop_ms", "allpairs2d_fused_ms", "bh2d_loop_ms",
              "bh2d_fused_ms", "bh3d_loop_ms", "bh3d_fused_ms",
              "bh3d_large_loop_ms", "bh3d_large_fused_ms")
P8_POSITIVE = ("value", "vs_baseline", "n", "steps", "repeats",
               "bh3d_large_n") + P8_MS_KEYS
P8_COUNTS = ("bh2d_overflowed_bodies", "bh3d_large_retried_steps")
P8_STRINGS = ("metric", "unit", "backend", "card", "power_limit",
              "bh3d_large_route")
# the fused all-pairs step against one K1 launch at the bench's N: at
# least the kernel, at most half again (the integrator and the replay)
P8_K1_RATIO = (1.0, 1.5)
# the evaluate stage's least round (the runs wrapper's call in the pass,
# host work and kernel one after the other; the least round is the one
# the host's noise touched least) against the wrapper alone on the same
# inputs, back to back (host work hidden behind the previous kernel): at
# least the kernel, less 10% for the card's clocks moving between the two
# timings (3D 262,144, a device-bound K3, read 1.04-1.06x), at most the
# kernel plus twice the wrapper's host work (2D 65,536 read 1.44-1.72x;
# the medians 1.51-2.19x as the host slowed)
P8_EVAL_RATIO = (0.9, 3.0)


def tool_env() -> dict:
    """The environment of a tool run as a subprocess: the checkout first
    on the path, and no reference triplet (config 1 must say so)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.abspath(".")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.pop("NBODY_REFERENCE_DIR", None)
    return env


def run_tool(argv, tag: str, timeout: int = 900, rc: int = 0) -> str:
    """``python -m <argv>`` in a subprocess; returns its stdout, fails on
    an exit code other than ``rc``."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *argv], capture_output=True,
                          text=True, timeout=timeout, env=tool_env())
    print(f"  {tag}: python -m {' '.join(argv)} exited {proc.returncode} "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    if proc.returncode != rc:
        print(proc.stdout[-3000:], proc.stderr[-6000:])
        fail(f"{tag}: {' '.join(argv)} exited {proc.returncode}, not {rc}")
    return proc.stdout


def check_bench_line(line: dict, tag: str, card: str) -> None:
    missing = [k for k in P8_POSITIVE + P8_COUNTS + P8_STRINGS
               if k not in line]
    if missing:
        fail(f"{tag}: the bench line lacks {missing}")
    bad = [k for k in P8_POSITIVE
           if not (isinstance(line[k], (int, float)) and
                   math.isfinite(line[k]) and line[k] > 0)]
    bad += [k for k in P8_COUNTS
            if not (isinstance(line[k], int) and line[k] >= 0)]
    bad += [k for k in P8_STRINGS if not (isinstance(line[k], str)
                                          and line[k])]
    if bad:
        fail(f"{tag}: bench keys {bad} are not finite and positive")
    if line["backend"] != "cuda":
        fail(f"{tag}: backend {line['backend']!r}, not 'cuda'")
    if f"{line['card']}, {line['power_limit']}" != card:
        fail(f"{tag}: the bench line's card {line['card']!r}, "
             f"{line['power_limit']!r} is not phase 0's {card!r}")


def p8_bench(dev, card: str) -> dict:
    """8a: ``python -m nbody_tpu_torch bench`` as a subprocess, then the
    same measurement in-process under the launch counters and the twin
    spies, and one K1 launch at the bench's N by CUDA events."""
    from nbody_tpu_torch.bench import headline
    from nbody_tpu_torch.ops import allpairs, list_eval

    stdout = run_tool(["nbody_tpu_torch", "bench"], "8a bench")
    lines = stdout.strip().splitlines()
    try:
        line = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        fail(f"8a: bench's last stdout line is no JSON object: {lines[-1:]}")
    print(f"  8a bench line: {lines[-1]}", flush=True)
    check_bench_line(line, "8a subprocess", card)

    twins, runs_calls = [], []
    reset_counts()
    with contextlib.ExitStack() as stack:
        import importlib

        for mod, name in P7_TWINS:
            stack.enter_context(spying(importlib.import_module(
                f"nbody_tpu_torch.ops.{mod}"), name, twins))
        stack.enter_context(spying(list_eval, "list_eval_runs", runs_calls))
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            again = headline.measure(dev)
    counts = read_counts()
    check_bench_line(again, "8a in-process", card)
    # 3D runs-wrapper calls by the pass's size: the targets [G, S, 3]
    # hold the N bodies (padded to whole groups)
    n, big = again["n"], again["bh3d_large_n"]
    runs_3d = {}
    for a, kw in runs_calls:
        if a[0].shape[2] == 3:
            size = big if a[0].shape[0] * a[0].shape[1] >= big else n
            runs_3d.setdefault(size, []).append(kw.get("seg_pack", 1))
    print(f"  8a in-process: {json.dumps(again)}", flush=True)
    print(f"  8a in-process launches: K1 {counts['k1']}, K2 {counts['k2']}, "
          f"K3 {counts['k3']}, K4 {counts['k4']}, K6 {counts['k6']}, K7 "
          f"{counts['k7']}; runs-wrapper calls in 3D " + ", ".join(
              f"at N={size}: {len(v)} (seg_pack {sorted(set(v))})"
              for size, v in sorted(runs_3d.items()))
          + f"; plain twin calls {len(twins)}", flush=True)
    if not counts["k1"] or not counts["k2"]:
        fail("8a: the bench did not launch K1 and K2")
    if not runs_3d.get(n) or not runs_3d.get(big):
        fail(f"8a: the bench's 3D cases at N={n} and {big} did not both "
             f"launch K2 or K3 (calls by N: "
             f"{ {k: len(v) for k, v in runs_3d.items()} })")
    if twins:
        fail(f"8a: the bench called the kernels' plain twins {len(twins)} "
             "times")

    p, m = cloud(n, seed=8, device=dev)
    k1_ms = cuda_ms(lambda: allpairs.allpairs_accelerations(p, m, g=G),
                    reps=20)
    for tag, ln in (("subprocess", line), ("in-process", again)):
        ratio = ln["allpairs2d_fused_ms"] / k1_ms
        print(f"  8a {tag}: fused all-pairs {ln['allpairs2d_fused_ms']:.3f} "
              f"ms/step against one K1 launch at N={n} {k1_ms:.3f} ms "
              f"(CUDA events, 20 launches): {ratio:.3f}x (bound "
              f"{P8_K1_RATIO[0]}-{P8_K1_RATIO[1]}x)  [{card}]", flush=True)
        if not P8_K1_RATIO[0] <= ratio <= P8_K1_RATIO[1]:
            fail(f"8a {tag}: the fused all-pairs step is {ratio:.3f}x one "
                 "K1 launch")
    return {"line": line, "in_process": again, "k1_ms": k1_ms,
            "counts": counts}


def p8_sweeps(card: str) -> None:
    """8b: the sweep verb's strong, bodies and tiles runs; every results
    file parsed by the port's ``_parse_scaling_results``, every requested
    point present with both timing lines."""
    import torch

    from nbody_tpu_torch import cli
    from nbody_tpu_torch.bench.plots import _parse_scaling_results

    cards = torch.cuda.device_count()
    counts = [1] if cards < 2 else [d for d in (1, 2, 4) if d <= cards]
    common = ["--device", "cuda", "--steps", "10", "--repeats", "2"]
    runs = {
        "strong": (["--experiment", "strong", "--engine", "barnes_hut",
                    "--n-bodies", "40960", "--device-counts",
                    ",".join(map(str, counts))],
                   [(40960, d) for d in counts]),
        "bodies": (["--experiment", "bodies", "--engine", "barnes_hut",
                    "--body-counts", "40960,65536"],
                   [(40960, 1), (65536, 1)]),
        "tiles": (["--sweep-axis", "tiles", "--engine", "allpairs",
                   "--n-bodies", "65536"],
                  [(65536, tb) for tb in (64, 128, 256, 512)]),
    }
    for name, (flags, want) in runs.items():
        path = os.path.join(OUT_DIR, f"sweep_{name}.txt")
        if os.path.exists(path):
            os.remove(path)
        t0 = time.perf_counter()
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(["sweep", *common, *flags, "--results-file", path])
        wall = time.perf_counter() - t0
        if rc != 0:
            print(err.getvalue()[-4000:])
            fail(f"8b sweep {name} exited {rc}")
        records, _ = _parse_scaling_results(path)
        got = {}
        for n, procs, par_us, tot_ms in records:
            if par_us is None or tot_ms is None:
                fail(f"8b sweep {name}: a run without both timing lines")
            got.setdefault((n, procs), []).append(par_us / 1e3 / 10)
        label = open(path).read().strip().splitlines()[-1]
        print(f"  8b sweep {name} in {wall:.1f} s ({label}): " + "; ".join(
            f"N={n} x{procs}: " + " / ".join(f"{ms:.3f}" for ms in v)
            + " ms/step" for (n, procs), v in sorted(got.items()))
            + f"  [{card}]", flush=True)
        short = [pt for pt in want if len(got.get(pt, [])) != 2]
        if short or len(got) != len(want):
            fail(f"8b sweep {name}: points {short or sorted(got)} are not "
                 f"the requested {want}, 2 repeats each")


def p8_baseline(card: str) -> None:
    """8c: ``python -m nbody_tpu_torch.bench.baseline --configs 1,2,3,4,5``
    into build/chip_smoke/, each record held to its check."""
    out = os.path.join(OUT_DIR, "baseline_results_torch.json")
    for f in (out, out + ".tmp"):
        if os.path.exists(f):
            os.remove(f)
    # exit 1: config 1 fails without the reference's triplet
    run_tool(["nbody_tpu_torch.bench.baseline", "--configs", "1,2,3,4,5",
              "--out", out], "8c baseline", timeout=1200, rc=1)
    with open(out) as f:
        recs = {r["config"]: r for r in json.load(f)}
    for c in sorted(recs):
        print(f"  8c config {c}: {json.dumps(recs[c])}  [{card}]",
              flush=True)
    if sorted(recs) != [1, 2, 3, 4, 5]:
        fail(f"8c: records for configs {sorted(recs)}")
    if "triplet" not in recs[1].get("error", ""):
        fail("8c: config 1 is not the error record naming the missing "
             "triplet")
    for c in (2, 3, 4, 5):
        if "error" in recs[c]:
            fail(f"8c: config {c} failed: {recs[c]['error']}")
    # tests/test_allpairs.py:62, the kernel against f64
    if not recs[2]["max_rel_err_vs_dense"] <= 2e-4:
        fail(f"8c: config 2's error {recs[2]['max_rel_err_vs_dense']:.3e} "
             "is above 2e-4")
    if recs[3]["overflowed_bodies"] != 0 or not recs[3]["dump_written"]:
        fail("8c: config 3 overflowed or wrote no dump")
    for c in (4, 5):
        one = [pt for pt in recs[c]["points"] if pt["devices"] == 1]
        if len(one) != 1 or one[0]["label"] != "1 card":
            fail(f"8c: config {c} has no devices=1 point labelled one card")


def p8_demand(dev, card: str) -> None:
    """8d: the demand script on evolved states (10 steps of the engine):
    2D 40,960 and 3D 131,072, the run cap's open case."""
    from nbody_tpu_torch.ops.bh3d import run_cap_default_3d
    from nbody_tpu_torch.scripts import demand

    for n, dims in ((40960, 2), (131072, 3)):
        t0 = time.perf_counter()
        got = demand.run(n, dims, steps=10, device=dev)
        cap = 256 if dims == 2 else run_cap_default_3d(n)
        side = max(hi - lo for lo, hi in zip(got["bounds"][0::2],
                                             got["bounds"][1::2]))
        print(f"  8d demand {dims}D N={n}, 10 steps, in "
              f"{time.perf_counter() - t0:.1f} s: merged runs max/group "
              f"{got['runs']} against the engine's run cap {cap}; levels "
              f"truncated at 2x the schedule {got['truncated']}; root box "
              f"side {side:.4g} (0.24 at step 0)  [{card}]", flush=True)
        if not got["frontier"] or got["approx"] <= 0 or got["direct"] <= 0:
            fail(f"8d demand {dims}D N={n}: empty demand")


def p8_phase_split(dev, card: str) -> None:
    """8e: the phase split at 2D 65,536 and 3D 262,144: every stage's
    median positive, the evaluate stage's least round (events around the
    runs wrapper in the pass) within P8_EVAL_RATIO of the wrapper alone
    on the same inputs, and the stages' sum (its median over the rounds: the tables
    prefix plus the evaluate stage of one round) at most 1.2x the
    engine's pass alone."""
    from nbody_tpu_torch.scripts import phase_split

    for n, dims in ((65536, 2), (262144, 3)):
        out = phase_split.split(n, dims, reps=21, device=dev)
        total = out["spread"]["sum"]["median"]
        ratio = out["spread"]["evaluate"]["min"] / out["kernel_ms"]
        print(f"  8e {dims}D N={n}: median [min, max] ms over 21 rounds "
              + json.dumps({k: [round(v[q], 3) for q in ("median", "min",
                                                          "max")]
                            for k, v in out["spread"].items()})
              + f"; stages sum {total:.3f} against the pass alone "
              f"{out['pass_ms']:.3f} ms ({total / out['pass_ms']:.3f}x, "
              f"bound 1.2x); evaluate's least round {ratio:.3f}x "
              f"{out['kernel']} alone "
              f"({out['kernel_ms']:.3f} ms; bound {P8_EVAL_RATIO[0]}-"
              f"{P8_EVAL_RATIO[1]}x)  [{card}]", flush=True)
        neg = [s for s, ms in out["stages"].items() if not ms > 0]
        if neg:
            fail(f"8e {dims}D N={n}: stages {neg} are not positive")
        if not P8_EVAL_RATIO[0] <= ratio <= P8_EVAL_RATIO[1]:
            fail(f"8e {dims}D N={n}: the evaluate stage's least round is "
                 f"{ratio:.3f}x the runs wrapper alone")
        if not total <= 1.2 * out["pass_ms"]:
            fail(f"8e {dims}D N={n}: the stages sum to {total:.3f} ms, "
                 f"over 1.2x the pass ({out['pass_ms']:.3f} ms)")


def phase8(dev, card: str) -> dict:
    """Phase 8; returns 8a's bench lines, K1 time and launches."""
    os.makedirs(OUT_DIR, exist_ok=True)
    t0 = time.perf_counter()
    print("phase 8a: python -m nbody_tpu_torch bench, its JSON line, and the "
          "same measurement in-process (launches, twins, K1)", flush=True)
    bench = p8_bench(dev, card)
    print("phase 8b: sweep: strong, bodies, tiles (2 repeats of 10 steps)",
          flush=True)
    p8_sweeps(card)
    print("phase 8c: python -m nbody_tpu_torch.bench.baseline --configs "
          "1,2,3,4,5", flush=True)
    p8_baseline(card)
    print("phase 8d: scripts.demand on evolved states", flush=True)
    p8_demand(dev, card)
    print("phase 8e: scripts.phase_split", flush=True)
    p8_phase_split(dev, card)
    print(f"  phase 8 took {time.perf_counter() - t0:.1f} s", flush=True)
    return bench


# -- phase 9: the tree builds' leaf sums -------------------------------------

def leaf_inputs(positions, masses, dims: int, max_depth=None) -> tuple:
    """The (rows, lengths) the tree build of this state hands the leaf
    sums (one build, the wrapper spied)."""
    from nbody_tpu_torch.ops import tree, tree3d

    seen = []
    if dims == 2:
        with spying(tree, "leaf_sums", seen):
            tree.build_quadtree(positions, masses,
                                **({} if max_depth is None
                                   else dict(max_depth=max_depth)))
    else:
        with spying(tree3d, "leaf_sums", seen):
            tree3d.build_octree(positions, masses, max_depth=max_depth or
                                tree3d.default_max_depth3(len(masses)))
    return seen[0][0]


def leaf_bound(rows, lengths) -> tuple:
    """(bound_ms, bound_by) of the leaf sums: rows read once, the sums
    written once, the lengths read once (bytes), one add a row element
    (FP32)."""
    n, w = rows.shape
    nbytes = (n * w + lengths.shape[0] * w) * rows.element_size() + (
        lengths.shape[0] * 8)
    t_bytes, t_ops = nbytes / PEAK_BYTES, n * w / PEAK_FP32
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def leaf_check(tag: str, rows, lengths) -> tuple:
    """Phase 9's checks of ``tree.leaf_sums`` on one input; returns the
    largest gap to the twin and to ``torch.segment_reduce`` (the latter 0
    where every leaf holds at most C rows).  Bit for bit: the kernels
    against the twin and against themselves, and on leaves of at most C
    rows against segment_reduce.
    Longer leaves: the kernels and segment_reduce each against an f64
    sum, the kernels within their order's rounding bound, (C + chunks) x
    u x the sum of |rows| (u = 2^-24, f64 2^-53, plus the f64 sum's own
    for f64 rows)."""
    import torch

    from nbody_tpu_torch.ops import tree

    c = tree.LEAF_CHUNK
    got = tree.leaf_sums(rows, lengths)
    want = tree.leaf_sums_plain(rows, lengths)
    again = tree.leaf_sums(rows, lengths)
    lib = torch.segment_reduce(rows, "sum", lengths=lengths, axis=0,
                               unsafe=True)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not (torch.equal(got, want) and torch.equal(got, again)):
        fail(f"9 {tag}: leaf_sums differs from its twin (max "
             f"{float((got - want).abs().max()):.3e}) or from itself")
    short = lengths <= c
    if not torch.equal(got[short], lib[short]):
        fail(f"9 {tag}: a leaf of at most {c} rows differs from "
             "torch.segment_reduce")
    if bool(short.all()):
        return err, 0.0
    long_ = ~short
    exact = torch.segment_reduce(rows.double(), "sum", lengths=lengths,
                                 axis=0, unsafe=True)[long_]
    mags = torch.segment_reduce(rows.double().abs(), "sum", lengths=lengths,
                                axis=0, unsafe=True)[long_]
    n = lengths[long_].double()[:, None]
    u = 2.0 ** (-53 if rows.dtype == torch.float64 else -24)
    own = c + torch.ceil(n / c) + (n if rows.dtype == torch.float64 else 0)
    bound = 1.01 * own * u * mags
    k_err = (got[long_].double() - exact).abs()
    l_err = (lib[long_].double() - exact).abs()
    gap = (got[long_] - lib[long_]).abs()
    rel = float((gap / lib[long_].abs().clamp_min(1e-30)).max())
    print(f"    {int(long_.sum())} leaves past {c:,} rows: largest gap to "
          f"segment_reduce {float(gap.max()):.3e} (relative {rel:.3e}; "
          f"within rtol 1e-6: {'yes' if rel <= 1e-6 else 'no'}); against "
          f"an f64 sum, the kernels' largest error {float(k_err.max()):.3e},"
          f" segment_reduce's {float(l_err.max()):.3e}, the kernels' "
          f"bound {float(bound.min()):.3e}-{float(bound.max()):.3e}",
          flush=True)
    if not bool((k_err <= bound).all()):
        fail(f"9 {tag}: a leaf past {c} rows is off its f64 sum by more "
             "than the two-level order's rounding bound")
    return err, float(gap.max())


def edge_inputs(dev) -> dict:
    """Synthetic (rows, lengths) with leaves of C - 1, C, C + 1 and 2C + 1
    rows (C = tree.LEAF_CHUNK) among light and medium ones, 8^6 leaves of
    16 columns, in f32 and f64."""
    import numpy as np
    import torch

    from nbody_tpu_torch.ops import tree

    c = tree.LEAF_CHUNK
    rng = np.random.default_rng(21)
    lengths = rng.integers(0, 3, 8 ** 6)
    at = rng.choice(8 ** 6, 12, replace=False)
    lengths[at] = [c - 1, c, c + 1, 2 * c + 1, 33, 100, 255, 256, 257, 4000,
                   c - 1, 2 * c + 1]
    rows = rng.uniform(-0.1, 0.5, (int(lengths.sum()), 16))
    lengths = torch.tensor(lengths, dtype=torch.int64, device=dev)
    return {f"leaves of C-1, C, C+1, 2C+1 rows, {name}": (
        torch.tensor(rows, dtype=dt, device=dev), lengths)
        for name, dt in (("f32", torch.float32), ("f64", torch.float64))}


def phase9(dev, card: str) -> dict:
    """9: ``tree.leaf_sums`` (csrc/tree_sums.cu) against its twin
    (``leaf_sums_plain``, the two-level order) on seven inputs, bit for
    bit (``leaf_check``), each timed beside the twin and the library
    call; then the evolved 1M step with the leaf sums on the twin and on
    the kernels, in turns.  Returns the inputs' numbers for the summary."""
    import torch

    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.models.engines import make_accel_fn
    from nbody_tpu_torch.models.simulation import Simulation
    from nbody_tpu_torch.ops import tree, tree3d
    from nbody_tpu_torch.physics import integrate
    from nbody_tpu_torch.rng import random_state

    c = tree.LEAF_CHUNK
    print(f"phase 9: the leaf sums (csrc/tree_sums.cu) against the twin "
          f"(chunks of C = {c:,} rows), bit for bit", flush=True)
    n1m = 1 << 20
    cfg1m = SimConfig(n_bodies=n1m, n_dim=3, engine="barnes_hut", seed=7,
                      n_steps=10)
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        evolved = Simulation(cfg1m, device=dev)
        evolved.run_contract()
    inputs = {}
    for tag, cfg in (("2D N=40,960 uniform", SimConfig(n_bodies=40960)),
                     ("3D N=1,048,576 uniform", cfg1m),
                     ("3D N=262,144 blobs", SimConfig(
                         n_bodies=262144, n_dim=3, init_mode="blobs"))):
        st = random_state(cfg, device=dev)
        inputs[tag] = leaf_inputs(st.positions, st.masses, cfg.n_dim,
                                  cfg.resolved_max_depth)
    est = evolved.state
    inputs["3D N=1,048,576 after 10 contract-loop steps"] = leaf_inputs(
        est.positions, est.masses, 3, cfg1m.resolved_max_depth)
    rows = torch.rand((n1m, 16), generator=torch.Generator().manual_seed(9))
    lengths = torch.zeros(8 ** 7, dtype=torch.int64)
    lengths[12345] = n1m
    inputs["3D all 1,048,576 rows in one leaf"] = (rows.to(dev),
                                                  lengths.to(dev))
    inputs.update(edge_inputs(dev))
    out = {}
    for tag, (rows, lengths) in inputs.items():
        print(f"  {tag}: rows {tuple(rows.shape)} {str(rows.dtype)[6:]}, "
              f"{lengths.shape[0]:,} leaves, the longest "
              f"{int(lengths.max()):,} rows; {int((lengths > 32).sum())} "
              f"past the light warps' 32, {int((lengths > c).sum())} "
              f"past C", flush=True)
        err, gap = leaf_check(tag, rows, lengths)
        k_ms = cuda_ms(lambda: tree.leaf_sums(rows, lengths), reps=10)
        p_ms = cuda_ms(lambda: tree.leaf_sums_plain(rows, lengths), reps=3)
        lib_ms = cuda_ms(lambda: torch.segment_reduce(
            rows, "sum", lengths=lengths, axis=0, unsafe=True), reps=3)
        b_ms, b_by = leaf_bound(rows, lengths)
        print(f"    bit-equal to the twin and to itself; kernels "
              f"{k_ms:.4f} ms, plain twin {p_ms:.4f} ms, "
              f"torch.segment_reduce {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by})  [{card}]", flush=True)
        _, kern = device_profile(lambda: tree.leaf_sums(rows, lengths),
                                 reps=10)
        print("    profiler, device ms a call: " + ", ".join(
            f"{name[:40]} {t:.4f}" for name, t in sorted(
                kern.items(), key=lambda kv: -kv[1])), flush=True)
        out[tag] = dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                        bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                        library_gap=gap)

    accel = make_accel_fn(cfg1m, return_diagnostics=True)

    def step():
        acc, ovf = accel(est.positions, est.masses)
        return integrate(est, acc, cfg1m.dt, overflow=ovf.sum())

    leaf = tree.leaf_sums
    t = []
    try:
        for plain in (True, False, False, True):
            tree.leaf_sums = tree3d.leaf_sums = (
                tree.leaf_sums_plain if plain else leaf)
            t.append(cuda_ms(step, reps=3))
    finally:
        tree.leaf_sums = tree3d.leaf_sums = leaf
    print(f"  3D N=1,048,576 step on the evolved state: leaf sums on the "
          f"twin {t[0]:.2f} / {t[3]:.2f} ms, on the kernels "
          f"{t[1]:.2f} / {t[2]:.2f} ms (CUDA events, 3 steps each, in "
          f"turns)  [{card}]", flush=True)
    return out


def dense_walk_args(positions, masses, cfg) -> tuple:
    """The (args, kwargs) one force pass of this state hands the dense
    collector's kernel (the wrapper spied)."""
    from nbody_tpu_torch.models.engines import make_accel_fn
    from nbody_tpu_torch.ops import collect_dense3

    seen = []
    with spying(collect_dense3, "_dense_lists_kernel", seen):
        make_accel_fn(cfg, return_diagnostics=True)(positions, masses)
    return seen[0]


def dense_bound(args, kw, outs) -> tuple:
    """(bound_ms, bound_by) of one dense walk: the pyramid's levels, the
    sub-boxes and the origins read once, the outputs (every slot of the
    lists, padding included, and the flags) written once (bytes); ~15
    FP32 operations a sub-box for each cell the lists hold (an upper
    estimate of the theta tests they need: singles take none)."""
    bbox, spyr, origins, sched = args
    g, q = bbox[0].shape
    n_lv = len(sched)
    nbytes = sum(t.numel() * t.element_size()
                 for t in (*spyr.grid[:n_lv], *spyr.start[:n_lv], *bbox,
                           *origins))
    nbytes += sum(t.numel() * t.element_size() for t in outs) + 2 * g
    held = int((outs[3] > 0).sum()) + int((outs[5] > 0).sum())
    t_bytes, t_ops = nbytes / PEAK_BYTES, held * q * 15 / PEAK_FP32
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase10(dev, card: str) -> dict:
    """10: the dense 3D collector's kernel (csrc/collect_dense3.cu)
    against its twin (``collect_dense3._dense_lists``) on the walks of
    the evolved 1M state and of 262,144 blobs: every output bit for bit,
    the kernel's time (CUDA events and the profiler) beside its bound and
    the twin's; then the evolved 1M step with the walk on the twin and on
    the kernel, in turns.  Returns the inputs' numbers for the summary."""
    import torch

    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.models.engines import make_accel_fn
    from nbody_tpu_torch.models.simulation import Simulation
    from nbody_tpu_torch.ops import collect_dense3
    from nbody_tpu_torch.physics import integrate
    from nbody_tpu_torch.rng import random_state

    print("phase 10: the dense 3D collector (csrc/collect_dense3.cu) "
          "against its twin, bit for bit", flush=True)
    n1m = 1 << 20
    cfg1m = SimConfig(n_bodies=n1m, n_dim=3, engine="barnes_hut", seed=7,
                      n_steps=10)
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        evolved = Simulation(cfg1m, device=dev)
        evolved.run_contract()
    est = evolved.state
    cfg_b = SimConfig(n_bodies=262144, n_dim=3, engine="barnes_hut",
                      init_mode="blobs", seed=3)
    st_b = random_state(cfg_b, device=dev)
    inputs = {
        "3D N=1,048,576 after 10 contract-loop steps": dense_walk_args(
            est.positions, est.masses, cfg1m),
        "3D N=262,144 blobs": dense_walk_args(st_b.positions, st_b.masses,
                                              cfg_b),
    }
    out = {}
    for tag, (args, kw) in inputs.items():
        bbox, spyr, origins, sched = args
        got = collect_dense3._dense_lists_kernel(*args, **kw)
        want = collect_dense3._dense_lists(*args, **kw)
        torch.cuda.synchronize()
        flat_g = [*got[0], got[1], got[2]]
        flat_w = [*want[0], want[1], want[2]]
        for k, (a, b) in enumerate(zip(flat_g, flat_w)):
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            if a.shape != b.shape:
                fail(f"dense collector, {tag}: output {k} has shape "
                     f"{tuple(a.shape)}, the twin's {tuple(b.shape)}")
            if not torch.equal(a, b):
                fail(f"dense collector, {tag}: output {k} differs from the "
                     f"twin in {int((a != b).sum())} entries")
        g, q = bbox[0].shape
        print(f"  {tag}: G={g}, Q={q}, windows {sched}, "
              f"{sum(w ** 3 for w in sched):,} cells a group, list widths "
              f"{want[0][0].shape[1]:,} / {want[0][4].shape[1]:,}; approx "
              f"{int((want[0][3] > 0).sum()):,}, direct "
              f"{int((want[0][5] > 0).sum()):,} entries; "
              f"{int(want[2].sum())} escaped, {int(want[1].sum())} "
              "overflowed; bit-equal to the twin", flush=True)
        k_ms = cuda_ms(lambda: collect_dense3._dense_lists_kernel(
            *args, **kw), reps=10)
        p_ms = cuda_ms(lambda: collect_dense3._dense_lists(*args, **kw),
                       reps=2)
        b_ms, b_by = dense_bound(args, kw, flat_w)
        _, kern = device_profile(lambda: collect_dense3._dense_lists_kernel(
            *args, **kw), reps=10)
        dev_ms = sum(t for name, t in kern.items()
                     if "dense_collect3_kernel" in name)
        print(f"    kernel {k_ms:.4f} ms (events; device {dev_ms:.4f} ms by "
              f"the profiler), plain twin {p_ms:.2f} ms, bound {b_ms:.4f} "
              f"ms ({b_by})  [{card}]", flush=True)
        print("    profiler, device ms a call: " + ", ".join(
            f"{name[:40]} {t:.4f}" for name, t in sorted(
                kern.items(), key=lambda kv: -kv[1])), flush=True)
        out[tag] = dict(ms=k_ms, device_ms=dev_ms, plain_ms=p_ms,
                        bound_ms=b_ms, bound_by=b_by)

    accel = make_accel_fn(cfg1m, return_diagnostics=True)

    def step():
        acc, ovf = accel(est.positions, est.masses)
        return integrate(est, acc, cfg1m.dt, overflow=ovf.sum())

    kernel = collect_dense3._dense_lists_kernel
    t = []
    try:
        for plain in (True, False, False, True):
            collect_dense3._dense_lists_kernel = (
                collect_dense3._dense_lists if plain else kernel)
            t.append(cuda_ms(step, reps=3))
    finally:
        collect_dense3._dense_lists_kernel = kernel
    print(f"  3D N=1,048,576 step on the evolved state: the walk on the twin "
          f"{t[0]:.2f} / {t[3]:.2f} ms, on the kernel {t[1]:.2f} / "
          f"{t[2]:.2f} ms (CUDA events, 3 steps each, in turns)  [{card}]",
          flush=True)
    return out


def phase3c(dev, card: str) -> dict:
    """3c: K4 against its twin on the tables of a uniform 3D state at
    N=1,048,576 (the default route) and of a 2D state with
    ``split_eval=True``: the launch, the lanes staged against needed, the
    schedule and its device time against r = 1 forced, bit for bit."""
    from nbody_tpu_torch.ops import _cuda, list_eval

    err = {}
    n1m = 1 << 20
    print(f"phase 3c: K4 (quarter-split runs evaluation) vs plain twin, 3D "
          f"grouped BH N={n1m} at the resolved defaults (dense collector, "
          "split on)", flush=True)
    p1m, m1m = cloud(n1m, seed=19, device=dev, dims=3)
    a4, kw4 = capture_split(p1m, m1m)
    print(f"  tables: targets {tuple(a4[0].shape)}, approx "
          f"{tuple(a4[1].shape)}, ext {tuple(a4[2].shape)}, tiles "
          f"{tuple(a4[4].shape)}; per quarter max approx / ext lanes / "
          f"direct tiles {a4[5].max(1).values.tolist()}, k_tile "
          f"{kw4['k_tile']}", flush=True)
    err["k4_3d"] = compare(
        f"K4 3D N={n1m}, all {a4[2].shape[0]} quarters",
        list_eval.list_eval_runs_split(*a4, **kw4),
        list_eval.list_eval_runs_split_plain(*a4, **kw4))
    p2s, m2s = cloud(65536, seed=23, device=dev)
    a42, kw42 = capture_split(p2s, m2s, group_size=2048, split_eval=True)
    err["k4_2d"] = compare(
        "K4 2D N=65536 group_size 2048 split_eval=True",
        list_eval.list_eval_runs_split(*a42, **kw42),
        list_eval.list_eval_runs_split_plain(*a42, **kw42))
    ptx4 = ptxas_report(_cuda.build_log, r"runs_split_kernelILi(\d)E",
                        lambda m: int(m[1]))
    k4_info, k4_sched = {}, {}
    for dims, (a, kw) in ((3, (a4, kw4)), (2, (a42, kw42))):
        info = k4_info[dims] = k4_launch(a, kw, ptx4)
        lanes = list_eval.split_quarter_lanes(*a[1:], k_tile=kw["k_tile"])
        per_pair = pairs_needed(a, split=True) // (a[0].shape[1] // 4)
        print(f"  K4 {dims}D launch: {info['targets_per_thread']} target a "
              f"thread, {info['blocks_per_quarter']} block(s) a quarter at "
              f"r = 1, {info['blocks']} blocks ({info['sliced_quarters']} "
              f"quarters sliced; grid {info['grid']}), "
              f"{info['blocks_per_sm']} blocks/SM -> {info['waves']:.2f} "
              f"waves; registers {info['registers']}, spill bytes "
              f"{info['spill_bytes']}; lanes staged {info['lanes_staged']}"
              f", needed {info['lanes_needed']} (from the pair count "
              f"{per_pair}); lanes a quarter mean "
              f"{float(lanes.float().mean()):.1f}, max {int(lanes.max())}",
              flush=True)
        if not info["lanes_staged"] == info["lanes_needed"] == per_pair:
            fail(f"K4 {dims}D stages {info['lanes_staged']} lanes where "
                 f"{info['lanes_needed']} are needed")
        k4_sched[dims] = k4_schedule(f"K4 {dims}D", a, kw, card)
    return dict(p1m=p1m, m1m=m1m, a4=a4, kw4=kw4, err=err, info=k4_info,
                schedule=k4_sched)


def phase11(dev, card: str) -> dict:
    """11: the adaptive engine's refinement (``tree3d.refine_octree``: the
    sparse levels below the pyramid, their sums on the leaf-sums kernels)
    on an evolved 1M Plummer sphere: every output bit for bit against
    the same build on the CPU (the sums' twin), the build and the
    refinement's sums timed alone beside their bound (``leaf_bound``: the
    rows read once a level, the sums written once), and one force pass
    with its groups that walked the refinement, its leaf-sums and K4
    launches, and K4 against its plain twin on the pass's own tables
    (the adaptive caps' shapes) for the widest quarter's group and seven
    more."""
    import torch

    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.models.engines import make_accel_fn
    from nbody_tpu_torch.models.simulation import Simulation
    from nbody_tpu_torch.ops import bh3d, list_eval, tree, tree3d
    from nbody_tpu_torch.utils import profiling

    print("phase 11: the adaptive engine's refinement on an evolved 1M "
          "Plummer sphere, card against CPU, bit for bit", flush=True)
    n1m = 1 << 20
    cfg = SimConfig(n_bodies=n1m, n_dim=3, engine="barnes_hut_adaptive",
                    init_mode="plummer", seed=7, n_steps=5, g=1.0,
                    softening=0.01, dt=1.0 / 64)
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        evolved = Simulation(cfg, device=dev)
        evolved.run_contract()
    p, m = evolved.state.positions, evolved.state.masses
    md = cfg.resolved_max_depth
    dcm = bh3d.direct_cell_max_default(n1m)
    seen = []
    with spying(tree3d, "leaf_sums", seen):
        got = tree3d.build_octree_adaptive(p, m, md, dcm)
    want = tree3d.build_octree_adaptive(p.cpu(), m.cpu(), md, dcm)
    torch.cuda.synchronize()
    (t_g, r_g, o_g), (t_w, r_w, o_w) = got, want
    pairs = [("order", o_g, o_w)] + [
        (f"pyramid level {lv}", a, b)
        for lv, (a, b) in enumerate(zip(t_g.raw, t_w.raw))]
    if len(r_g.raw) != len(r_w.raw):
        fail(f"11: {len(r_g.raw)} refined levels on the card, "
             f"{len(r_w.raw)} on the CPU")
    for i in range(len(r_g.raw)):
        pairs += [(f"refined level {md + 1 + i} {what}", a[i], b[i])
                  for what, a, b in (("rows", r_g.raw, r_w.raw),
                                     ("starts", r_g.start, r_w.start),
                                     ("children", r_g.child, r_w.child))]
    for tag, a, b in pairs:
        a = a.cpu()
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if a.shape != b.shape or not torch.equal(a, b):
            fail(f"11: {tag} differs between the card and the CPU")
    counts = [r.shape[0] for r in r_g.raw]
    print(f"  depth {r_g.depth}, {r_g.n_cells:,} refined cells "
          f"{counts} below the depth-{md} pyramid (the largest leaf "
          f"{int(t_g.leaf_counts().max()):,} bodies); bit-equal to the "
          "CPU build", flush=True)
    sums = seen[1:]  # the pyramid's leaf sums come first
    sorted_codes = tree3d.morton_codes_3d(
        p, t_g.bounds, tree3d.MAX_DEPTH3_WIDE, torch.int64)[o_g]
    rows = tree3d.packed_rows_3d(p, m)[o_g]
    counts0 = tree3d.leaf_counts(t_g.codes, 8 ** md)
    cum = torch.cat([counts0.new_zeros(1), torch.cumsum(counts0, 0)])
    b_ms = sum(leaf_bound(*a)[0] for a, _ in sums)
    k_ms = sum(cuda_ms(lambda a=a: tree.leaf_sums(*a), reps=10)
               for a, _ in sums)
    r_ms = cuda_ms(lambda: tree3d.refine_octree(sorted_codes, rows, cum,
                                                md, dcm), reps=5)
    b_all = cuda_ms(lambda: tree3d.build_octree_adaptive(p, m, md, dcm),
                    reps=5)
    print(f"  the refinement's sums: {len(sums)} leaf-sums calls "
          f"{k_ms:.4f} ms, bound {b_ms:.4f} ms (bytes: {n1m:,} rows a "
          f"level read once); refine_octree {r_ms:.3f} ms; the whole "
          f"adaptive tree build {b_all:.3f} ms  [{card}]", flush=True)
    accel = make_accel_fn(cfg, return_diagnostics=True)
    reset_counts()
    split = []
    with spying(list_eval, "list_eval_runs_split", split):
        acc, ovf = accel(p, m)
    torch.cuda.synchronize()
    c = read_counts()
    launches = dict(leaf=c["leaf"], k4=c["k4"])
    want = dict(leaf=1 + len(r_g.raw), k4=1)
    entered = profiling.counter("ops.bh3d.REFINE_GROUPS")
    print(f"  a force pass: {entered} of {n1m // 2048} groups walked the "
          f"refinement, {int(ovf.sum())} bodies overflowed; launches "
          f"{launches} (want {want})", flush=True)
    if launches != want or len(split) != 1:
        fail(f"11: a force pass launched {launches} and called K4's "
             f"wrapper {len(split)} times; want {want} and one call")
    # K4 on the pass's tables against its plain twin, on the group of the
    # widest quarter (its direct ranges) and seven spread over the rest
    a4, kw4 = split[0]
    n_g = a4[0].shape[0]
    lanes = list_eval.split_quarter_lanes(*a4[1:], k_tile=kw4["k_tile"])
    widest = int(lanes.argmax()) // 4
    picked = sorted({widest, *range(0, n_g, -(-n_g // 7))})
    gi = torch.tensor(picked, device=dev)
    qi = (4 * gi[:, None] + torch.arange(4, device=dev)).reshape(-1)
    part = (a4[0][gi], a4[1][gi], a4[2][qi], a4[3], a4[4][qi],
            a4[5][:, qi].contiguous())
    k4_err = compare(
        f"K4 on the adaptive pass's tables (targets "
        f"{tuple(a4[0].shape)}, tiles {tuple(a4[4].shape)}), groups "
        f"{picked}: the widest quarter {int(lanes.max()):,} lanes "
        f"(group {widest}), mean {float(lanes.float().mean()):,.0f}",
        list_eval.list_eval_runs_split(*a4, **kw4)[gi],
        list_eval.list_eval_runs_split_plain(*part, **kw4))
    # the schedule on the pass's tables, bit for bit against r = 1 (the
    # widest quarter's group among them), and K4's time before and after
    k4_sched = k4_schedule("K4 on the adaptive pass's tables", a4, kw4,
                           card)
    f_ms = cuda_ms(lambda: accel(p, m), reps=3)
    print(f"  the force pass: {f_ms:.1f} ms [{card}]", flush=True)
    return dict(ms=k_ms, bound_ms=b_ms, refine_ms=r_ms, build_ms=b_all,
                cells=r_g.n_cells, depth=r_g.depth, k4_err=k4_err,
                k4_schedule=k4_sched, launches=launches)


def gather_outputs(res) -> list:
    """A gather walk's outputs, flat: the lists, ranges, overflow and the
    quarters dict's tensors."""
    flat = [*res[0], res[1], res[2]]
    if len(res) > 3:
        flat += [res[3]["bits"], *res[3]["com"], res[3]["mass"]]
    return flat


def gather_bound(args, outs) -> tuple:
    """(bound_ms, bound_by) of one gather walk: the 32-byte head of each
    row the lists hold read once (a floor on the rows the groups visit:
    opened and rejected cells come on top), the sub-boxes read once and
    every output slot written once (bytes); ~15 FP32 operations a
    sub-box for each cell of more than one body the lists hold."""
    bbox = args[0]
    g, q = bbox[0].shape
    lm, ranges = outs[3], outs[4]
    held = int((lm > 0).sum()) + int((ranges[..., 1] > 0).sum())
    multi = int((ranges[..., 1] > 1).sum())
    nbytes = held * 32 + 6 * g * q * 4
    nbytes += sum(t.numel() * t.element_size() for t in outs)
    t_bytes, t_ops = nbytes / PEAK_BYTES, multi * q * 15 / PEAK_FP32
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def gather_walk_args(accel, positions, masses) -> list:
    """The (args, kwargs) of every gather-walk kernel call one force pass
    of ``accel`` makes (the wrapper spied)."""
    from nbody_tpu_torch.ops import bh3d

    seen = []
    with spying(bh3d, "_gather_lists_kernel", seen):
        accel(positions, masses)
    return seen


def evolved_run(cfg, dev) -> tuple:
    """A contract-loop run of ``cfg`` on the card from counters at 0:
    (its Simulation, the launch counters after it)."""
    from nbody_tpu_torch.models.simulation import Simulation

    reset_counts()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        sim = Simulation(cfg, device=dev)
        sim.run_contract()
    return sim, read_counts()


def phase12(dev, card: str) -> dict:
    """12: the 3D gather walk's kernel (csrc/collect_gather3.cu) against
    its twin (``bh3d._gather_lists``) at the three main-path shapes: the
    1M Plummer pass (every group, across the refinement), the bh3d 1M
    spill pass (the dense collector's escaped rows) and the 4x-cap retry
    pass on the evolved uniform 1M state; every output bit for bit, the
    kernel's time (CUDA events and the profiler) beside its bound and the
    twin's, the launches of each main-path run, and the force pass with
    the walk on the twin and on the kernel, in turns."""
    import torch

    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.models.engines import make_accel_fn, resolved_caps
    from nbody_tpu_torch.ops import bh3d
    from nbody_tpu_torch.utils import profiling

    print("phase 12: the 3D gather walk (csrc/collect_gather3.cu) against "
          "its twin, bit for bit", flush=True)
    n1m = 1 << 20
    cfg_p = SimConfig(n_bodies=n1m, n_dim=3, engine="barnes_hut_adaptive",
                      init_mode="plummer", seed=7, n_steps=5, g=1.0,
                      softening=0.01, dt=1.0 / 64)
    cfg_u = SimConfig(n_bodies=n1m, n_dim=3, engine="barnes_hut", seed=7,
                      n_steps=10)
    runs = {}
    for tag, cfg in (("1M Plummer, adaptive", cfg_p),
                     ("1M uniform, barnes_hut", cfg_u)):
        sim, c = evolved_run(cfg, dev)
        retried = sim.last_retried_steps
        want = (cfg.n_steps + retried if cfg is cfg_p
                else c["spills"] + retried)
        print(f"  {tag}, {cfg.n_steps} contract-loop steps: gather-walk "
              f"kernel launches {c['gather_kernel']} (want {want}: "
              f"{c['spills']} spill passes, {retried} retried steps)",
              flush=True)
        if c["gather_kernel"] != want:
            fail(f"12: {tag}: {c['gather_kernel']} gather-walk launches, "
                 f"want {want}")
        runs[tag] = (sim.state, c, retried)
    st_p = runs["1M Plummer, adaptive"][0]
    st_u = runs["1M uniform, barnes_hut"][0]
    caps4 = {k: 4 * v for k, v in resolved_caps(cfg_u).items()}
    cfg_r = cfg_u.replace(collect3="gather", **caps4)
    passes = {
        "1M Plummer pass": (cfg_p, st_p),
        "bh3d 1M spill pass": (cfg_u, st_u),
        "4x-cap retry pass, evolved uniform 1M": (cfg_r, st_u),
    }
    out = {}
    for tag, (cfg, st) in passes.items():
        accel = make_accel_fn(cfg, return_diagnostics=True)
        seen = gather_walk_args(accel, st.positions, st.masses)
        if not seen:
            print(f"  {tag}: no gather walk on this pass (nothing "
                  "escaped)", flush=True)
            continue
        if len(seen) != 1:
            fail(f"12: {tag}: {len(seen)} gather walks in one pass")
        args, kw = seen[0]
        groups = profiling.counter("ops.bh3d.REFINE_GROUPS")
        got = gather_outputs(bh3d._gather_lists_kernel(*args, **kw))
        entered = profiling.counter("ops.bh3d.REFINE_GROUPS") - groups
        want = gather_outputs(bh3d._gather_lists(*args, **kw))
        torch.cuda.synchronize()
        for k, (a, b) in enumerate(zip(got, want)):
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            if a.shape != b.shape:
                fail(f"gather walk, {tag}: output {k} has shape "
                     f"{tuple(a.shape)}, the twin's {tuple(b.shape)}")
            if not torch.equal(a, b):
                fail(f"gather walk, {tag}: output {k} differs from the "
                     f"twin in {int((a != b).sum())} entries")
        twin = profiling.counter("ops.bh3d.REFINE_GROUPS") - groups - entered
        if twin != entered:
            fail(f"12: {tag}: the kernel counted {entered} groups entering "
                 f"the refinement, the twin {twin}")
        g, q = args[0][0].shape
        widths = bh3d.gather_widths(kw["frontier_caps"],
                                    len(kw["frontier_caps"]))
        print(f"  {tag}: G={g}, Q={q}, frontier widths {widths}, list "
              f"widths {want[0].shape[1]:,} / {want[4].shape[1]:,}; approx "
              f"{int((want[3] > 0).sum()):,}, direct "
              f"{int((want[4][..., 1] > 0).sum()):,} entries; "
              f"{entered} groups entered the refinement, "
              f"{int(want[5].sum())} overflowed; bit-equal to the twin",
              flush=True)
        k_ms = cuda_ms(lambda: bh3d._gather_lists_kernel(*args, **kw),
                       reps=10)
        p_ms = cuda_ms(lambda: bh3d._gather_lists(*args, **kw), reps=2)
        b_ms, b_by = gather_bound(args, want)
        _, kern = device_profile(lambda: bh3d._gather_lists_kernel(
            *args, **kw), reps=10)
        dev_ms = sum(t for name, t in kern.items()
                     if "gather_collect3_kernel" in name)
        print(f"    kernel {k_ms:.4f} ms (events; device {dev_ms:.4f} ms by "
              f"the profiler), plain twin {p_ms:.2f} ms, bound {b_ms:.4f} "
              f"ms ({b_by})  [{card}]", flush=True)
        print("    profiler, device ms a call: " + ", ".join(
            f"{name[:40]} {t:.4f}" for name, t in sorted(
                kern.items(), key=lambda kv: -kv[1])), flush=True)
        out[tag] = dict(ms=k_ms, device_ms=dev_ms, plain_ms=p_ms,
                        bound_ms=b_ms, bound_by=b_by)

    kernel = bh3d._gather_lists_kernel
    for tag, cfg, st in (("1M Plummer", cfg_p, st_p),
                         ("bh3d 1M", cfg_u, st_u)):
        accel = make_accel_fn(cfg, return_diagnostics=True)
        t = []
        try:
            for plain in (True, False, False, True):
                bh3d._gather_lists_kernel = (
                    bh3d._gather_lists if plain else kernel)
                t.append(cuda_ms(lambda: accel(st.positions, st.masses),
                                 reps=3))
        finally:
            bh3d._gather_lists_kernel = kernel
        print(f"  {tag} force pass on the evolved state: the walk on the "
              f"twin {t[0]:.2f} / {t[3]:.2f} ms, on the kernel {t[1]:.2f} / "
              f"{t[2]:.2f} ms (CUDA events, 3 passes each, in turns)  "
              f"[{card}]", flush=True)
    out["launches"] = {tag: r[1]["gather_kernel"] for tag, r in runs.items()}
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a GPU", file=sys.stderr)
        return 1
    try:
        import nbody_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import nbody_tpu_torch ({e}); run it "
              "from the root of a checkout", file=sys.stderr)
        return 1
    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.models.engines import make_accel_fn
    from nbody_tpu_torch.physics import integrate
    from nbody_tpu_torch.rng import random_state
    from nbody_tpu_torch.ops import (_cuda, allpairs, bh3d, bh_grouped,
                                     list_eval)
    from nbody_tpu_torch.utils.occupancy import resolve_tiles

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # -- phase 0: the card ---------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else (
        "nvidia-smi unavailable")
    kind = torch.cuda.get_device_name(0)
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    try:
        sm_clock_hz = float(clk.stdout.split()[0]) * 1e6
    except (IndexError, ValueError):
        fail(f"nvidia-smi gave no SM clock: {clk.stdout!r} {clk.stderr!r}")
    print(f"phase 0: card: {card}", flush=True)
    print(f"phase 0: max SM clock {sm_clock_hz / 1e6:.0f} MHz (the "
          "special-function units' rate in the bounds)", flush=True)
    print(f"phase 0: torch {torch.__version__} CUDA {torch.version.cuda} "
          f"device {kind}, count {torch.cuda.device_count()}", flush=True)

    # -- phase 1: build ------------------------------------------------
    t0 = time.perf_counter()
    _cuda.library()
    print(f"phase 1: built/loaded kernels in {time.perf_counter() - t0:.1f}"
          f" s (nvcc {_cuda.build_seconds:.1f} s, one per source, in "
          "parallel)", flush=True)
    for line in _cuda.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")
    only = {"--only-phase-3c": phase3c, "--only-phase-6c": phase6c,
            "--only-phase-7": phase7,
            "--only-phase-8": phase8, "--only-phase-9": phase9,
            "--only-phase-10": phase10, "--only-phase-11": phase11,
            "--only-phase-12": phase12}
    if len(sys.argv) == 2 and sys.argv[1] in only:
        # a short run of one later path alone (phases 0, 1 and it)
        only[sys.argv[1]](dev, card)
        print(f"  chip_smoke total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0

    # -- phase 2: K1 against its twin ------------------------------------
    err = {}
    ptx1 = ptxas_allpairs(_cuda.build_log)
    for dims in (2, 3):
        cases = ((65536, 0.0, False), (40000, 0.0, False))
        if dims == 2:
            cases += ((40000, 1e-3, False), (65536, 0.0, True))
        print(f"phase 2{'' if dims == 2 else 'b'}: K1 (all-pairs, {dims}D) "
              "vs plain twin", flush=True)
        for n, soft, comp in cases:
            p, m = cloud(n, seed=n + int(comp) + dims, device=dev, dims=dims)
            tb, sb = resolve_tiles(n, compensated=comp)
            kw = dict(g=G, softening=soft, source_block=sb, compensated=comp)
            got = allpairs.allpairs_accelerations_vs(p, p, m,
                                                     target_block=tb, **kw)
            want = allpairs.allpairs_accelerations_plain(p, p, m, **kw)
            torch.cuda.synchronize()
            info = k1_launch(n, n, sb, soft, comp, dims, ptx1)
            e = compare(f"{dims}D N={n} eps={soft:g} compensated={comp} "
                        f"({info['targets_per_thread']} targets a thread, "
                        f"{info['slices']} slices, {info['blocks']} blocks, "
                        f"{info['blocks_per_sm']} blocks/SM -> "
                        f"{info['waves']:.2f} waves; {info['registers']} "
                        f"registers, spill bytes {info['spill_bytes']})",
                        got, want)
            err.setdefault(f"k1_{dims}d", e)  # the main path's shape

    # -- phase 2c: K5 against its twin, and the potential energy ---------
    from nbody_tpu_torch import physics
    from nbody_tpu_torch.state import make_state

    print("phase 2c: K5 (potential) vs plain twin; bound 1e-5 x max|phi|",
          flush=True)
    ptx5 = ptxas_report(_cuda.build_log, r"potential_kernelILi(\d)E",
                        lambda m: int(m[1]))
    for dims in (2, 3):
        for n in (65536, 40000):
            p, m = cloud(n, seed=31 + n + dims, device=dev, dims=dims)
            got = allpairs.allpairs_potential(p, m, g=G)
            want = allpairs.allpairs_potential_plain(p, m, g=G)
            torch.cuda.synchronize()
            info = k5_launch(n, dims, ptx5)
            compare(f"K5 {dims}D N={n} ({info['targets_per_thread']} targets"
                    f" a thread, {info['slices']} slices, {info['blocks']} "
                    f"blocks, {info['blocks_per_sm']} blocks/SM -> "
                    f"{info['waves']:.2f} waves; {info['registers']} "
                    f"registers, spill bytes {info['spill_bytes']})",
                    got, want)
            if n == 65536:
                st = make_state(m, p, torch.zeros_like(p), device=dev)
                pe = float(physics.potential_energy_scalable(st, G))
                pe_t = float(0.5 * (m * want).sum())
                rel = abs(pe - pe_t) / abs(pe_t)
                print(f"  potential_energy_scalable {dims}D N={n} on the "
                      f"card {pe:.9e}, twin's {pe_t:.9e}: relative "
                      f"{rel:.2e} (bound 1e-05)", flush=True)
                if not rel <= 1e-5:
                    fail("potential_energy_scalable disagrees with K5's twin")

    # -- phase 3: K2 against its twin on real 2D tables -------------------
    print("phase 3: K2 (runs evaluation, 2D) vs plain twin, grouped BH "
          "N=65536 group_size 2048 k_tile 256", flush=True)
    args, kw, _ = capture_tables(*cloud(65536, seed=7, device=dev))
    tgt, approx, srct, tiles, lens = args
    print(f"  tables: targets {tuple(tgt.shape)}, approx "
          f"{tuple(approx.shape)}, sources_t {tuple(srct.shape)}, tiles "
          f"{tuple(tiles.shape)}; approx lanes max {int(lens[0].max())}, "
          f"direct tiles max {int(lens[1].max())}", flush=True)
    got = list_eval.list_eval_runs(*args, **kw)
    want = list_eval.list_eval_runs_plain(*args, **kw)
    torch.cuda.synchronize()
    err["k2_2d"] = compare("K2 2D N=65536", got, want)
    ptxr = ptxas_report(_cuda.build_log, r"runs_kernelILi(\d)ELi(\d)E",
                        lambda m: (int(m[1]), int(m[2])))
    check_runs_launch("K2 2D N=65536", args, kw, ptxr)

    # -- phase 3b: K2 (3D) and K3 on real 3D tables -----------------------
    n3 = 131072
    print(f"phase 3b: K2 (3D) and K3 (seg_pack 4) vs plain twins, 3D "
          f"grouped BH N={n3} at the resolved defaults", flush=True)
    p3, m3 = cloud(n3, seed=17, device=dev, dims=3)
    _, kw_auto, mean_len = capture_tables(p3, m3)
    gate_pick = "K3 (packed)" if kw_auto["seg_pack"] > 1 else "K2 (plain)"
    print(f"  mean merged run length {mean_len:.1f} lanes; the gate "
          f"(>= {bh_grouped.SEG_PACK_MIN_RUN_LANES:g}) picks {gate_pick}",
          flush=True)
    a3p, kw3p, _ = capture_tables(p3, m3, gate="packed")
    a3k, kw3k, _ = capture_tables(p3, m3, gate="plain")
    for name, (a, k) in (("packed", (a3p, kw3p)), ("plain", (a3k, kw3k))):
        print(f"  {name} tables: approx {tuple(a[1].shape)}, tiles "
              f"{tuple(a[3].shape)}, direct steps max {int(a[4][1].max())}, "
              f"seg_pack {k['seg_pack']}, k_tile {k['k_tile']}", flush=True)
    k3_out = list_eval.list_eval_runs(*a3p, **kw3p)
    err["k3_3d"] = compare(f"K3 3D N={n3}", k3_out,
                           list_eval.list_eval_runs_plain(*a3p, **kw3p))
    k2_out = list_eval.list_eval_runs(*a3k, **kw3k)
    err["k2_3d"] = compare(f"K2 3D N={n3}", k2_out,
                           list_eval.list_eval_runs_plain(*a3k, **kw3k))
    compare(f"K3 against K2 on the same runs, N={n3}", k3_out, k2_out)
    for name, (a, k) in (("K3", (a3p, kw3p)), ("K2", (a3k, kw3k))):
        check_runs_launch(f"{name} 3D N={n3}", a, k, ptxr)

    # -- phase 3c: K4 on real 1M tables, and in 2D -------------------------
    n1m = 1 << 20
    k4 = phase3c(dev, card)
    p1m, m1m, a4, kw4 = k4["p1m"], k4["m1m"], k4["a4"], k4["kw4"]
    err.update(k4["err"])
    k4_info = k4["info"]

    # -- phase 3d: K6, K6 compensated and K7 on real packed lists ---------
    print("phase 3d: K6, K6 compensated and K7 (padded two-section lists) "
          "vs plain twins, 2D N=40960 (group 2048) and 3D N=131072",
          flush=True)
    padded = {}  # (dims, mode) -> [(args, kwargs)] of the force pass
    shapes = {}  # (dims, mode) -> launch_info of the pass's first call
    ptx = ptxas_list_eval(_cuda.build_log)
    pads = {2: random_state(SimConfig(n_bodies=40960), device=dev),
            3: random_state(SimConfig(n_bodies=n3, n_dim=3), device=dev)}
    names = {"grid": "k6", "compensated": "k6c", "dynamic": "k7"}
    for dims, st in pads.items():
        accs = {}
        for mode, key in names.items():
            calls = capture_padded(st.positions, st.masses, mode)
            padded[(dims, mode)] = calls
            args, kw = calls[0]
            wrap = (list_eval.list_eval_dynamic if mode == "dynamic"
                    else list_eval.list_eval_pallas)
            twin = (list_eval.list_eval_dynamic_plain if mode == "dynamic"
                    else list_eval.list_eval_pallas_plain)
            err[f"{key}_{dims}d"] = compare(
                f"{key.upper()} {dims}D N={st.masses.shape[0]}, packed "
                f"{tuple(args[1].shape)}, section offset "
                f"{kw['section_offset']}, {len(calls)} call(s)",
                wrap(*args, **kw), twin(*args, **kw))
            for c, (a, k) in enumerate(calls):
                info = launch_info(a, mode, ptx)
                shapes.setdefault((dims, mode), info)
                _, need, ev, vis, _ = padded_work(a, k, mode == "dynamic")
                print(f"    call {c}: lanes evaluated (gm > 0 in visited "
                      f"tiles) {ev} of {vis} visited, needed {need}; "
                      f"slices {info['slices']}, "
                      f"{info['targets_per_block']} targets a block, "
                      f"{info['blocks']} blocks, {info['blocks_per_sm']} "
                      f"blocks/SM -> {info['waves']:.2f} waves; registers "
                      f"{info['registers']}, spill bytes "
                      f"{info['spill_bytes']}", flush=True)
                if ev != need:
                    fail(f"{key.upper()} {dims}D evaluates {ev} lanes where "
                         f"{need} are needed: padding reaches the pairs")
            if mode != "compensated":
                fn = (bh3d.bh3_accelerations_grouped if dims == 3 else
                      bh_grouped.bh_accelerations_grouped)
                accs[mode] = fn(st.positions, st.masses, g=G,
                                eval_mode=mode)
        fn = (bh3d.bh3_accelerations_grouped if dims == 3 else
              bh_grouped.bh_accelerations_grouped)
        accs["runs"] = fn(st.positions, st.masses, g=G)
        compare(f"whole {dims}D pass: K6 route against the runs route",
                accs["grid"], accs["runs"])
        compare(f"whole {dims}D pass: K7 route against the runs route",
                accs["dynamic"], accs["runs"])
        compare(f"whole {dims}D pass: K6 route against the K7 route",
                accs["grid"], accs["dynamic"])
        for a, kw in padded[(dims, "dynamic")]:
            if not torch.equal(list_eval.list_eval_pallas(*a, **kw),
                               list_eval.list_eval_dynamic(*a, **kw)):
                fail(f"K6 and K7 differ in bits on the {dims}D dynamic "
                     "route's lists")
        print(f"  K6 and K7 on the {dims}D dynamic route's lists: "
              "bit-equal -> ok", flush=True)

    # -- phase 4: the 2D main path ------------------------------------------
    print("phase 4: 2D main path through nbody_tpu_torch.cli.main",
          flush=True)
    launches = {}
    runs2 = (("barnes_hut", 40960), ("allpairs", 65536))
    finals = {}
    for engine, n in runs2:
        finals[engine], launches[(2, engine, n)] = main_path_run(
            engine, n, 2, 10)
    if launches[(2, "barnes_hut", 40960)]["k2"] <= 0 or (
            launches[(2, "allpairs", 65536)]["k1"] <= 0) or (
            launches[(2, "barnes_hut", 40960)]["leaf"] <= 0):
        fail("a kernel of the 2D main path was never launched")
    for engine, n in runs2:
        lockstep(engine, n, 2, 10, 10, finals[engine], dev)

    # -- phase 4b: the 3D main path -----------------------------------------
    print("phase 4b: 3D main path through nbody_tpu_torch.cli.main; the "
          "smallest N whose initial state the gate sends to K3:", flush=True)
    nk3 = first_packed_n(dev)
    runs3 = tuple(dict.fromkeys((
        ("barnes_hut", n3), ("barnes_hut", nk3), ("barnes_hut", 65536),
        ("allpairs", 65536))))
    finals3 = {}
    for engine, n in runs3:
        finals3[(engine, n)], launches[(3, engine, n)] = main_path_run(
            engine, n, 3, 10)
    if launches[(3, "barnes_hut", nk3)]["k3"] <= 0:
        fail(f"K3 was never launched in the 3D barnes_hut run at N={nk3}")
    if launches[(3, "barnes_hut", 65536)]["k2"] <= 0:
        fail("K2 (3D) was never launched in the 3D barnes_hut run at "
             "N=65536")
    if launches[(3, "allpairs", 65536)]["k1"] <= 0:
        fail("K1 (3D) was never launched in the 3D allpairs run")
    if any(launches[(3, e, n)]["leaf"] <= 0 for e, n in runs3
           if e == "barnes_hut"):
        fail("the leaf sums were not launched in a 3D barnes_hut run")
    for engine, n in runs3:
        lockstep(engine, n, 3, 10, 3, finals3[(engine, n)], dev)

    # -- phase 4c: the 3D default route at scale --------------------------
    print("phase 4c: 3D main path at scale: the dense collector at "
          "N=262144 (K2 or K3) and N=1048576 (K4)", flush=True)
    runs4c = ((262144, 10), (n1m, 10))
    for n, steps in runs4c:
        finals3[("barnes_hut", n)], launches[(3, "barnes_hut", n)] = (
            main_path_run("barnes_hut", n, 3, steps))
    c256, c1m = (launches[(3, "barnes_hut", n)] for n, _ in runs4c)
    if c1m["k4"] <= 0:
        fail(f"K4 was never launched in the 3D barnes_hut run at N={n1m}")
    if c256["k4"] != 0:
        fail("K4 was launched in the 3D barnes_hut run at N=262144 (the "
             "split gate is off there)")
    if c256["dense"] <= 0 or c1m["dense"] <= 0:
        fail("the dense collector was not reached in a 3D run at scale")
    if any(c["dense_kernel"] != c["dense"] for c in (c256, c1m)):
        fail("the dense collector's kernel did not run once a dense pass "
             f"({c256['dense_kernel']} / {c256['dense']} at 262144, "
             f"{c1m['dense_kernel']} / {c1m['dense']} at {n1m})")
    if c256["k2"] + c256["k3"] <= 0:
        fail("neither K2 nor K3 ran in the 3D barnes_hut run at N=262144")
    if c256["leaf"] <= 0 or c1m["leaf"] <= 0:
        fail("the leaf sums were not launched in a 3D run at scale")
    for n, steps in runs4c:
        lockstep("barnes_hut", n, 3, steps, 2, finals3[("barnes_hut", n)],
                 dev)

    # -- phase 4d: the diagnostics on the main path -------------------------
    print("phase 4d: metrics CSV (K5), checkpoints and --resume through "
          "nbody_tpu_torch.cli.main", flush=True)
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    more = {}  # launch counts of the runs of phases 4d and 4e

    def check_csv(path, rows, tag):
        import csv

        with open(path, newline="") as f:
            got = list(csv.DictReader(f))
        bad = [r["step"] for r in got if not all(
            math.isfinite(float(r[k])) for k in (
                "kinetic_energy", "potential_energy", "total_energy",
                "momentum_x", "momentum_y"))
            or not int(r["tree_nodes"]) > 1 or not int(r["tree_max_depth"])]
        if len(got) != rows or bad:
            fail(f"{tag}: metrics CSV has {len(got)} rows (want {rows}); "
                 f"rows with a non-finite value or an empty tree column: "
                 f"{bad}")
        print(f"  {tag}: {rows} rows, finite energies and momenta, tree "
              f"columns filled; total energy step 0 "
              f"{float(got[0]['total_energy']):.9e}, step {rows - 1} "
              f"{float(got[-1]['total_energy']):.9e}; tree nodes "
              f"{got[0]['tree_nodes']} -> {got[-1]['tree_nodes']}",
              flush=True)

    def check_potential(st0, fin, path, dims):
        """K5 against its twin on a metrics run's first and last states
        (its main-path inputs), and the CSV's potential energy of those
        steps against the twin's."""
        import csv

        with open(path, newline="") as f:
            rows = list(csv.DictReader(f))
        m, worst = st0.masses, 0.0
        for row, pos in ((rows[0], st0.positions), (rows[-1], fin)):
            tag = f"K5 {dims}D N={m.shape[0]} step {row['step']}"
            want = allpairs.allpairs_potential_plain(pos, m, g=G)
            worst = max(worst, compare(
                tag, allpairs.allpairs_potential(pos, m, g=G), want))
            pe_t = float(0.5 * (m * want).sum())
            rel = abs(float(row["potential_energy"]) - pe_t) / abs(pe_t)
            print(f"  {tag}: the CSV's potential energy "
                  f"{float(row['potential_energy']):.9e}, the twin's "
                  f"{pe_t:.9e}: relative {rel:.2e} (bound 1e-05)", flush=True)
            if not rel <= 1e-5:
                fail(f"{tag}: the CSV's potential energy disagrees with "
                     "K5's twin")
        err[f"k5_{dims}d"] = worst

    d = {k: os.path.join(OUT_DIR, k) for k in ("m10", "c5", "r5", "m3d")}
    fin10, more["metrics_2d"] = main_path_run(
        "barnes_hut", 40960, 2, 10,
        ["--metrics-csv", "m.csv", "--checkpoint-every", "5",
         "--output-dir", d["m10"]])
    check_csv(os.path.join(d["m10"], "m.csv"), 11, "2D N=40960 10 steps")
    if more["metrics_2d"]["k5"] != 11:
        fail(f"K5 launched {more['metrics_2d']['k5']} times in the 2D "
             "metrics run (11 recorded steps)")
    if not torch.equal(fin10, finals["barnes_hut"]):
        fail("recording metrics changed the 2D run's final positions")
    check_potential(pads[2], fin10, os.path.join(d["m10"], "m.csv"), 2)
    fin5, _ = main_path_run("barnes_hut", 40960, 2, 5,
                            ["--checkpoint-every", "5", "--output-dir",
                             d["c5"]])
    finr, _ = main_path_run(
        "barnes_hut", 40960, 2, 5,
        ["--resume", os.path.join(d["c5"], "checkpoint.npz"),
         "--output-dir", d["r5"]])
    if not torch.equal(finr, fin10):
        fail("5 steps + 5 resumed steps differ from 10 straight steps")
    print("  5 steps, checkpoint, 5 resumed steps: final positions bit-equal "
          "to the 10 straight steps (and to phase 4's run without metrics) "
          "-> ok", flush=True)
    fin3m, more["metrics_3d"] = main_path_run(
        "barnes_hut", 262144, 3, 10,
        ["--metrics-csv", "m.csv", "--output-dir", d["m3d"]])
    check_csv(os.path.join(d["m3d"], "m.csv"), 11, "3D N=262144 10 steps")
    if more["metrics_3d"]["k5"] != 11:
        fail(f"K5 launched {more['metrics_3d']['k5']} times in the 3D "
             "metrics run")
    if not torch.equal(fin3m, finals3[("barnes_hut", 262144)]):
        fail("recording metrics changed the 3D run's final positions")
    st3m = random_state(SimConfig(n_bodies=262144, n_dim=3), device=dev)
    check_potential(st3m, fin3m, os.path.join(d["m3d"], "m.csv"), 3)

    # -- phase 4e: the padded-list evaluators on the main path -------------
    print("phase 4e: --eval-mode grid / dynamic and --compensated through "
          "nbody_tpu_torch.cli.main", flush=True)
    modes4e = {"grid": (["--eval-mode", "grid"], {"eval_mode": "grid"}),
               "dynamic": (["--eval-mode", "dynamic"],
                           {"eval_mode": "dynamic"}),
               "compensated": (["--compensated"], {"compensated": True})}
    for dims, n, twin_steps in ((2, 40960, 3), (3, n3, 2)):
        for mode, (flags, over) in modes4e.items():
            fin, c = main_path_run("barnes_hut", n, dims, 10, flags)
            more[(dims, mode)] = c
            want = "k7" if mode == "dynamic" else "k6"
            if c[want] <= 0 or c["k2"] + c["k3"] + c["k4"] + c[
                    "k7" if want == "k6" else "k6"] != 0:
                fail(f"{dims}D {mode} run launched {c}: want {want.upper()} "
                     "only")
            lockstep("barnes_hut", n, dims, 10, twin_steps, fin, dev, **over)

    # -- phase 5: times on the card -------------------------------------------
    print(f"phase 5: times on {card} (CUDA events, mean of reps after a "
          "warm-up)", flush=True)
    ms = {}
    tables = {}  # the (args, kwargs) each timed runs kernel took
    runs_info = {}  # K2/K3's launch and slice sweep on those tables
    k1_info = {}  # K1's launch and slice sweep at N=65,536
    for dims, comp in ((2, False), (3, False), (2, True)):
        n = 65536
        p, m = cloud(n, seed=11 + dims, device=dev, dims=dims)
        tb, sb = resolve_tiles(n, compensated=comp)
        kw = dict(g=G, source_block=sb, compensated=comp)
        k = cuda_ms(lambda: allpairs.allpairs_accelerations_vs(
            p, p, m, target_block=tb, **kw), reps=10)
        plain = cuda_ms(lambda: allpairs.allpairs_accelerations_plain(
            p, p, m, **kw), reps=2)
        key = f"k1_{dims}d{'_compensated' if comp else ''}"
        ms[key] = (k, plain)
        name = f"K1 {dims}D N={n}{' compensated' if comp else ''}"
        print(f"  {name}: kernel {k:.3f} ms = {n * n / k / 1e6:.1f} "
              f"Gpairs/s; plain twin {plain:.3f} ms = "
              f"{n * n / plain / 1e6:.1f} Gpairs/s  [{card}]", flush=True)
        k1_info[key] = dict(
            k1_launch(n, n, sb, 0.0, comp, dims, ptx1), n_bodies=n,
            shape_ms=k1_slice_sweep(name, p, m, sb, comp, card))
    # the all-pairs step (the end-to-end all-pairs metric) and where its
    # device time goes
    for dims in (2, 3):
        cfg = SimConfig(n_bodies=65536, n_dim=dims, engine="allpairs")
        st = random_state(cfg, device=dev)
        accel = make_accel_fn(cfg, return_diagnostics=True)

        def ap_step():
            acc, ovf = accel(st.positions, st.masses)
            return integrate(st, acc, cfg.dt, overflow=ovf.sum())

        step_ms = cuda_ms(ap_step, reps=10)
        wall, kern = device_profile(ap_step, reps=10)
        busy = sum(kern.values())
        k1p = sum(t for k, t in kern.items() if "allpairs_kernel" in k)
        print(f"  all-pairs {dims}D step N=65536: {step_ms:.3f} ms/step = "
              f"{65536 ** 2 / step_ms / 1e6:.1f} Gpairs/s (CUDA events); "
              f"profiler over 10 steps: wall {wall:.3f} ms/step, device "
              f"busy {busy:.3f}, idle share "
              f"{100 * (1 - busy / wall) if busy else float('nan'):.1f}%, "
              f"K1 {k1p:.3f} ms, {len(kern)} kernel names  [{card}]",
              flush=True)

    for n in (40960, 65536):
        cfg = SimConfig(n_bodies=n, engine="barnes_hut", seed=13)
        st = random_state(cfg, device=dev)
        accel = make_accel_fn(cfg, return_diagnostics=True)

        def step():
            acc, ovf = accel(st.positions, st.masses)
            return integrate(st, acc, cfg.dt, overflow=ovf.sum())

        a, kw, _ = capture_tables(st.positions, st.masses)
        step_ms = cuda_ms(step, reps=10)
        kern = cuda_ms(lambda: list_eval.list_eval_runs(*a, **kw), reps=10)
        plain = cuda_ms(lambda: list_eval.list_eval_runs_plain(*a, **kw),
                        reps=3)
        with plain_twins():
            step_plain = cuda_ms(step, reps=3)
        print(f"  grouped BH 2D N={n}: {step_ms:.3f} ms/step (tree build "
              f"included) with K2, of which K2 {kern:.3f} ms "
              f"({100 * kern / step_ms:.1f}%); through the twin "
              f"{step_plain:.3f} ms/step, twin evaluation {plain:.3f} ms  "
              f"[{card}]", flush=True)
        if n == 40960:
            ms["k2_2d"] = (kern, plain)
            tables["k2_2d"] = (a, kw)
            runs_info["k2_2d"] = dict(
                check_runs_launch(f"K2 2D N={n}", a, kw, ptxr),
                n_bodies=n, shape_ms=runs_slice_sweep(f"K2 2D N={n}", a, kw,
                                                      card),
                device_ms=runs_device_ms(f"K2 2D N={n}", a, kw, card))

    # -- phase 5b: 3D times ----------------------------------------------------
    for n in dict.fromkeys((n3, nk3)):
        cfg3 = SimConfig(n_bodies=n, n_dim=3, engine="barnes_hut")
        st3 = random_state(cfg3, device=dev)
        accel3 = make_accel_fn(cfg3, return_diagnostics=True)

        def step3():
            acc, ovf = accel3(st3.positions, st3.masses)
            return integrate(st3, acc, cfg3.dt, overflow=ovf.sum())

        step3_ms = cuda_ms(step3, reps=5)
        a_auto, kw_auto, mean_n = capture_tables(st3.positions, st3.masses)
        pick = "K3" if kw_auto["seg_pack"] > 1 else "K2"
        pick_ms = cuda_ms(
            lambda: list_eval.list_eval_runs(*a_auto, **kw_auto), reps=10)
        print(f"  grouped BH 3D N={n}: {step3_ms:.3f} ms/step (tree build "
              f"included); mean merged run {mean_n:.1f} lanes, the gate "
              f"picks {pick}: {pick_ms:.3f} ms "
              f"({100 * pick_ms / step3_ms:.1f}% of the step)  [{card}]",
              flush=True)
        if n == n3:
            pk, kk = (a3p, kw3p), (a3k, kw3k)
        else:
            pk = capture_tables(st3.positions, st3.masses, gate="packed")[:2]
            kk = capture_tables(st3.positions, st3.masses, gate="plain")[:2]
        t = {}
        for key, (a, kw) in (("k3", pk), ("k2", kk)):
            t[key] = (cuda_ms(lambda: list_eval.list_eval_runs(*a, **kw),
                              reps=10),
                      cuda_ms(lambda: list_eval.list_eval_runs_plain(*a,
                                                                     **kw),
                              reps=2))
        print(f"  on the same merged runs (N={n}): K3 {t['k3'][0]:.3f} ms "
              f"(twin {t['k3'][1]:.3f} ms), K2 {t['k2'][0]:.3f} ms (twin "
              f"{t['k2'][1]:.3f} ms): K3/K2 = {t['k3'][0] / t['k2'][0]:.3f}"
              f"  [{card}]", flush=True)
        if n == n3:
            ms["k3_3d"], ms["k2_3d"] = t["k3"], t["k2"]
            tables["k3_3d"], tables["k2_3d"] = pk, kk
            for key, (a, kw) in (("k3_3d", pk), ("k2_3d", kk)):
                name = f"{key[:2].upper()} 3D N={n}"
                runs_info[key] = dict(
                    check_runs_launch(name, a, kw, ptxr), n_bodies=n,
                    shape_ms=runs_slice_sweep(name, a, kw, card),
                    device_ms=runs_device_ms(name, a, kw, card))
    # -- phase 5c: K4, the 3D step at scale, the gates, the profile --------
    print(f"phase 5c: K4 and the 3D default route at scale on {card}",
          flush=True)
    k4_ms = cuda_ms(lambda: list_eval.list_eval_runs_split(*a4, **kw4),
                    reps=5)
    twin_ms = cuda_ms(
        lambda: list_eval.list_eval_runs_split_plain(*a4, **kw4), reps=1)
    ms["k4_3d"] = (k4_ms, twin_ms)
    # the same force pass unsplit: K2/K3 on the group-wide direct sets
    a2u, kw2u, _ = capture_tables(p1m, m1m, split_eval=False)
    k2u_ms = cuda_ms(lambda: list_eval.list_eval_runs(*a2u, **kw2u), reps=3)
    pairs4 = pairs_needed(a4, split=True)
    pairs2 = pairs_needed(a2u, False, kw2u["seg_pack"])
    name2u = "K3" if kw2u["seg_pack"] > 1 else "K2"
    print(f"  K4 N={n1m}: {k4_ms:.3f} ms for {pairs4 / 1e9:.2f} G pairs = "
          f"{pairs4 / k4_ms / 1e6:.1f} Gpairs/s; twin {twin_ms:.3f} ms  "
          f"[{card}]", flush=True)
    print(f"  the same pass unsplit: {name2u} {k2u_ms:.3f} ms for "
          f"{pairs2 / 1e9:.2f} G pairs = {pairs2 / k2u_ms / 1e6:.1f} "
          f"Gpairs/s; split keeps {100 * pairs4 / pairs2:.1f}% of the pairs"
          f"  [{card}]", flush=True)
    for name, a in (("K4", a4), (name2u, a2u)):
        n_t, fill = direct_fill(a)
        print(f"  {name} direct tiles: {n_t}, {fill:.1f} live lanes per "
              f"tile of {kw4['k_tile']}", flush=True)

    def step_fn(n, **over):
        cfg = SimConfig(n_bodies=n, n_dim=3, engine="barnes_hut", **over)
        st = random_state(SimConfig(n_bodies=n, n_dim=3), device=dev)
        accel = make_accel_fn(cfg, return_diagnostics=True)

        def step():
            acc, ovf = accel(st.positions, st.masses)
            return integrate(st, acc, cfg.dt, overflow=ovf.sum())

        return step

    ab = (("dense vs gather collector", 262144, dict(collect3="gather")),
          ("dense vs gather collector", n1m, dict(collect3="gather")),
          ("split on vs off", n1m, dict(split_eval=False)))
    for what, n, alt in ab:
        base, other = step_fn(n), step_fn(n, **alt)
        t = [cuda_ms(f, reps=2) for f in (base, other, other, base)]
        print(f"  A/B {what}, N={n}: default {t[0]:.2f} / {t[3]:.2f} "
              f"ms/step, {alt} {t[1]:.2f} / {t[2]:.2f} ms/step (default "
              f"first and last, tree build included)  [{card}]", flush=True)
        ms[f"step_{n}"] = (t[0] + t[3]) / 2

    # where the 1M step's time goes: components by CUDA events, the
    # whole step by the profiler
    from nbody_tpu_torch.ops import bh3d, collect_dense3, tree3d

    step1m = step_fn(n1m)
    c_args = []
    e_args = []
    with spying(collect_dense3, "collect_lists_3d_dense", c_args), \
            spying(bh_grouped, "_evaluate_runs_split", e_args):
        step1m()
    parts = {
        "octree + spatial pyramid": lambda: collect_dense3.
        build_spatial_pyramid(tree3d.build_octree(
            p1m, m1m, max_depth=tree3d.default_max_depth3(n1m))),
        "dense collector": lambda: collect_dense3.collect_lists_3d_dense(
            *c_args[0][0], **c_args[0][1]),
        "split tables + K4": lambda: bh_grouped._evaluate_runs_split(
            *e_args[0][0], **e_args[0][1]),
        "K4 alone": lambda: list_eval.list_eval_runs_split(*a4, **kw4),
    }
    step_ms = cuda_ms(step1m, reps=2)
    print(f"  3D step N={n1m}: {step_ms:.2f} ms (tree build included)",
          flush=True)
    for name, fn in parts.items():
        t = cuda_ms(fn, reps=2)
        print(f"    {name}: {t:.2f} ms ({100 * t / step_ms:.1f}% of the "
              "step)", flush=True)
    wall, kern = device_profile(step1m)
    busy = sum(kern.values())
    if busy > 0:
        sorts = sum(t for k, t in kern.items() if "sort" in k.lower())
        k4p = sum(t for k, t in kern.items() if "runs_split_kernel" in k)
        print(f"  profiler, N={n1m}, 2 steps: wall {wall:.2f} ms/step, "
              f"device busy {busy:.2f} ms/step, idle share "
              f"{100 * (1 - busy / wall):.1f}%; K4 {k4p:.2f} ms "
              f"({100 * k4p / busy:.1f}% of busy), sorts {sorts:.2f} ms "
              f"({100 * sorts / busy:.1f}%)  [{card}]", flush=True)
        for k, t in sorted(kern.items(), key=lambda kv: -kv[1])[:8]:
            print(f"    {t:8.3f} ms/step  {k[:100]}", flush=True)
    else:
        print("  profiler: no device time recorded; the CUDA-event split "
              "above stands alone", flush=True)

    # -- phase 5d: K5, K6, K7 and the 1M dynamic route ----------------------
    print(f"phase 5d: K5, K6, K6 compensated and K7 on {card}", flush=True)
    work = {}  # key -> (pair family, dims, pairs, bytes)
    k5_sweep = {}  # dims -> {shape: ms}
    # K6/K7: the shares of evaluated pairs that are padding and of
    # visited lanes that are skipped
    pad_share = {}
    for dims, p, m in ((2, fin10, pads[2].masses),
                       (3, fin3m, st3m.masses)):
        n = m.shape[0]
        k = cuda_ms(lambda: allpairs.allpairs_potential(p, m, g=G), reps=10)
        plain = cuda_ms(lambda: allpairs.allpairs_potential_plain(p, m, g=G),
                        reps=1)
        ms[f"k5_{dims}d"] = (k, plain)
        work[f"k5_{dims}d"] = ("potential", dims, n * (n - 1),
                               4 * (n * (dims + 1) + n))
        print(f"  K5 {dims}D N={n} (the metrics run's last state): kernel "
              f"{k:.3f} ms = {n * n / k / 1e6:.1f} Gpairs/s; plain twin "
              f"{plain:.3f} ms  [{card}]", flush=True)
        # K5 at every shape the shape function can pick (its pick marked);
        # every shape sums in the same order, so all must give one result
        pick = allpairs.potential_launch_shape(n)[:2]
        ref = allpairs.allpairs_potential(p, m, g=G)
        orig_shape, sweep = allpairs.potential_launch_shape, {}
        tpt = allpairs.POTENTIAL_TARGETS_PER_THREAD
        try:
            for r in allpairs.POTENTIAL_SLICES:
                allpairs.potential_launch_shape = (
                    lambda n_, r=r: (tpt, r, 0))
                if not torch.equal(allpairs.allpairs_potential(p, m, g=G),
                                   ref):
                    fail(f"K5 {dims}D at {r} slices differs in bits from "
                         "the picked shape")
                sweep[f"{tpt}x{r}"] = cuda_ms(
                    lambda: allpairs.allpairs_potential(p, m, g=G), reps=5)
        finally:
            allpairs.potential_launch_shape = orig_shape
        k5_sweep[dims] = sweep
        print(f"  K5 {dims}D by (targets a thread) x (slices): "
              + ", ".join(f"{k_}{'*' if k_ == '%dx%d' % pick else ''} "
                          f"{t_:.3f}" for k_, t_ in sweep.items())
              + " ms, all bit-equal (* the launch-shape function's pick)"
              f"  [{card}]", flush=True)
    for dims, st in pads.items():
        a_r, kw_r, _ = capture_tables(st.positions, st.masses)
        k2 = cuda_ms(lambda: list_eval.list_eval_runs(*a_r, **kw_r), reps=10)
        name_r = "K3" if kw_r["seg_pack"] > 1 else "K2"
        pairs_r = pairs_needed(a_r, False, kw_r["seg_pack"])
        print(f"  {dims}D N={st.masses.shape[0]}: {name_r} (the runs route) "
              f"{k2:.3f} ms for {pairs_r / 1e9:.3f} G pairs  [{card}]",
              flush=True)
        for mode, key in names.items():
            calls = padded[(dims, mode)]
            dyn = mode == "dynamic"
            wrap = (list_eval.list_eval_dynamic if dyn
                    else list_eval.list_eval_pallas)
            twin = (list_eval.list_eval_dynamic_plain if dyn
                    else list_eval.list_eval_pallas_plain)
            k = cuda_ms(lambda: [wrap(*a, **kw) for a, kw in calls], reps=10)
            plain = cuda_ms(lambda: [twin(*a, **kw) for a, kw in calls],
                            reps=1)
            pairs = evald = visited = nbytes = 0
            for a, kw in calls:
                s_, need, ev, vis, bb = padded_work(a, kw, dyn)
                pairs, evald = pairs + need * s_, evald + ev * s_
                visited, nbytes = visited + vis * s_, nbytes + bb
            ms[f"{key}_{dims}d"] = (k, plain)
            work[f"{key}_{dims}d"] = ("bh", dims, pairs, nbytes)
            pad_share[f"{key}_{dims}d"] = (1 - pairs / evald,
                                           1 - evald / visited)
            print(f"  {key.upper()} {dims}D: kernel {k:.3f} ms for "
                  f"{pairs / 1e9:.3f} G pairs needed = "
                  f"{pairs / k / 1e6:.1f} Gpairs/s ({k / k2:.2f}x "
                  f"{name_r}, which needs {pairs_r / 1e9:.3f} G); it "
                  f"evaluates {evald / 1e9:.3f} G, "
                  f"{100 * (1 - pairs / evald):.1f}% of them padding, and "
                  f"skips {100 * (1 - evald / visited):.1f}% of the "
                  f"{visited / 1e9:.3f} G it visits; plain twin "
                  f"{plain:.3f} ms  [{card}]", flush=True)
        # K6 at every slice count on the same lists (the shape function's
        # pick marked); each result held to the twin
        calls = padded[(dims, "grid")]
        pick = list_eval.list_launch_shape(*calls[0][0][0].shape[:2])[0]
        want = [list_eval.list_eval_pallas_plain(*a, **kw) for a, kw in calls]
        orig_shape, sweep = list_eval.list_launch_shape, []
        try:
            for r in (1, 2, 4, 8):
                per = list_eval.LIST_THREADS // r
                list_eval.list_launch_shape = (
                    lambda g, s, r=r, per=per: (r, per, g * -(-s // per)))
                for (a, kw), w in zip(calls, want):
                    compare(f"K6 {dims}D at {r} slices",
                            list_eval.list_eval_pallas(*a, **kw), w)
                t_r = cuda_ms(lambda: [list_eval.list_eval_pallas(*a, **kw)
                                       for a, kw in calls], reps=5)
                sweep.append(f"r={r}{'*' if r == pick else ''} {t_r:.3f}")
        finally:
            list_eval.list_launch_shape = orig_shape
        print(f"  K6 {dims}D by slices per target: {', '.join(sweep)} ms "
              f"(* the launch-shape function's pick)  [{card}]", flush=True)
    dyn1m, base1m = step_fn(n1m, eval_mode="dynamic"), step_fn(n1m)
    t = [cuda_ms(f, reps=2) for f in (base1m, dyn1m, dyn1m, base1m)]
    peak = {}
    for name, f in (("default", base1m), ("dynamic", dyn1m)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        f()
        torch.cuda.synchronize()
        peak[name] = torch.cuda.max_memory_allocated() / 2**30
    print(f"  3D step N={n1m}: default route (dense collector, K4) "
          f"{t[0]:.2f} / {t[3]:.2f} ms, --eval-mode dynamic (K7, 64-group "
          f"chunks) {t[1]:.2f} / {t[2]:.2f} ms (default first and last); "
          f"peak device memory {peak['default']:.2f} / {peak['dynamic']:.2f}"
          f" GiB  [{card}]", flush=True)
    lists_in = []
    with spying(bh_grouped, "_padded_lists", lists_in):
        dyn1m()

    def build_lists():
        for a, kw in lists_in:
            bh_grouped._padded_lists(*a, **kw)

    build_ms = cuda_ms(build_lists, reps=2)
    wall, kern = device_profile(dyn1m)
    busy = sum(kern.values())
    if busy > 0:
        k7p = sum(t for k, t in kern.items() if "list_eval_kernel" in k)
        print(f"  profiler, N={n1m} --eval-mode dynamic, 2 steps: wall "
              f"{wall:.2f} ms/step, device busy {busy:.2f} ms/step, idle "
              f"share {100 * (1 - busy / wall):.1f}%; K7 {k7p:.2f} ms "
              f"({100 * k7p / busy:.1f}% of busy, {len(lists_in)} "
              f"launches), the rest (tree, collector, superblocks, list "
              f"building) {busy - k7p:.2f} ms; the packed lists' build "
              f"(_padded_lists x {len(lists_in)}, CUDA events) "
              f"{build_ms:.2f} ms  [{card}]", flush=True)
        for k, t in sorted(kern.items(), key=lambda kv: -kv[1])[:8]:
            print(f"    {t:8.3f} ms/step  {k[:100]}", flush=True)
    else:
        print("  profiler: no device time recorded for the dynamic step",
              flush=True)
    phase6(dev, card)
    par = phase7(dev, card)
    phase8(dev, card)
    leaf9 = phase9(dev, card)
    dense10 = phase10(dev, card)
    phase11(dev, card)
    gather12 = phase12(dev, card)
    print(f"  chip_smoke total {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # bounds of the earlier kernels, from the tables they were timed on
    for key, dims in (("k1_2d", 2), ("k1_3d", 3)):
        n = 65536
        work[key] = ("allpairs", dims, n * (n - 1), 4 * n * (2 * dims + 1))
    for key, split in (("k2_2d", False), ("k2_3d", False),
                       ("k3_3d", False), ("k4_3d", True)):
        a, kw = tables[key] if key != "k4_3d" else (a4, kw4)
        work[key] = ("bh", a[0].shape[2], pairs_needed(
            a, split, kw.get("seg_pack", 1)), runs_bytes(a))

    def entry(name, source, replaces, key, n_launch, dims, **extra):
        b_ms, b_by = bound(*work[key], sm_clock_hz)
        return {"name": name, "route": "cuda",
                "source": f"nbody_tpu_torch/csrc/{source}",
                "replaces": replaces, "dims": dims, "launches": n_launch,
                "max_abs_err": err[key], "ms": ms[key][0],
                "plain_ms": ms[key][1], "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None, **extra}

    ap, le = "nbody_tpu/ops/allpairs.py:49", "nbody_tpu/ops/list_eval.py:333"
    k4 = entry("runs_eval_k4_3d", "runs_eval.cu",
               "nbody_tpu/ops/list_eval.py:663", "k4_3d",
               launches[(3, "barnes_hut", n1m)]["k4"], 3, **k4_info[3])
    k4["max_abs_err_2d"] = err["k4_2d"]

    def par_launches(counter, modes):
        """This kernel's launches on phase 7's runs: 7b's thread ranks
        ("<mode> D=2|4") and 7d's graphs on one rank ("<mode> graph
        D=1", the warm-up step and 10 replays)."""
        return {f"{m} D={d}": c[counter] for (m, d), c in par.items()
                if m.split("@")[0].split()[0] in modes}

    ap_modes = ("dp_allpairs", "ring_allpairs", "dp2d_allpairs")
    bh2 = ("dp_barnes_hut_grouped", "dp_barnes_hut_sharded")
    bh3 = ("dp_barnes_hut_grouped3", "dp_barnes_hut_sharded3")
    k4["parallel_launches"] = {f"{m} D={d}": c["k4"]
                               for (m, d), c in par.items() if "@" in m}
    k1_2d = entry("allpairs_k1", "allpairs.cu", ap, "k1_2d",
                  launches[(2, "allpairs", 65536)]["k1"], 2,
                  **k1_info["k1_2d"])
    k1_2d["parallel_launches"] = par_launches("k1", ap_modes)
    k1_2d["compensated_ms"] = ms["k1_2d_compensated"][0]
    k1_2d["compensated_shape_ms"] = k1_info["k1_2d_compensated"]["shape_ms"]
    summary = {"kernels": [
        k1_2d,
        entry("allpairs_k1_3d", "allpairs.cu", ap, "k1_3d",
              launches[(3, "allpairs", 65536)]["k1"], 3,
              **k1_info["k1_3d"]),
        entry("runs_eval_k2", "runs_eval.cu", le, "k2_2d",
              launches[(2, "barnes_hut", 40960)]["k2"], 2,
              parallel_launches=par_launches("k2", bh2),
              **runs_info["k2_2d"]),
        entry("runs_eval_k2_3d", "runs_eval.cu", le, "k2_3d",
              sum(c["k2"] for (d_, e_, _), c in launches.items()
                  if d_ == 3 and e_ == "barnes_hut"), 3,
              parallel_launches=par_launches("k2", bh3),
              **runs_info["k2_3d"]),
        entry("runs_eval_k3_3d", "runs_eval.cu", le, "k3_3d",
              sum(c["k3"] for (d_, e_, _), c in launches.items()
                  if d_ == 3 and e_ == "barnes_hut"), 3,
              parallel_launches=par_launches("k3", bh3),
              **runs_info["k3_3d"]),
        k4,
    ]}
    pot, grid, dyn = ("nbody_tpu/ops/allpairs.py:288",
                      "nbody_tpu/ops/list_eval.py:55",
                      "nbody_tpu/ops/list_eval.py:136")
    for dims, sfx in ((2, ""), (3, "_3d")):
        n_pad = 40960 if dims == 2 else n3

        def padded_entry(name, replaces, key, mode, counter):
            pad, skipped = pad_share[f"{key}_{dims}d"]
            return entry(f"list_eval_{name}{sfx}", "list_eval.cu", replaces,
                         f"{key}_{dims}d", more[(dims, mode)][counter], dims,
                         n_bodies=n_pad, padding_share=pad,
                         skipped_share=skipped, **shapes[(dims, mode)])

        summary["kernels"] += [
            entry(f"potential_k5{sfx}", "allpairs.cu", pot, f"k5_{dims}d",
                  more[f"metrics_{dims}d"]["k5"], dims,
                  n_bodies=40960 if dims == 2 else 262144,
                  shape_ms=k5_sweep[dims],
                  **k5_launch(40960 if dims == 2 else 262144, dims, ptx5)),
            padded_entry("k6", grid, "k6", "grid", "k6"),
            padded_entry("k6_compensated", grid, "k6c", "compensated", "k6"),
            padded_entry("k7", dyn, "k7", "dynamic", "k7"),
        ]
    from nbody_tpu_torch.ops.tree import LEAF_CHUNK

    evo = leaf9["3D N=1,048,576 after 10 contract-loop steps"]
    summary["kernels"].append({
        "name": "leaf_sums", "route": "cuda",
        "source": "nbody_tpu_torch/csrc/tree_sums.cu",
        "replaces": "nbody_tpu/ops/tree3d.py:141",
        "replaces_note": "XLA's segment_sum in the JAX package (no Pallas "
                         "kernel); torch.segment_reduce in the port before",
        "dims": 3, "launches": launches[(3, "barnes_hut", n1m)]["leaf"],
        "max_abs_err": max(v["max_abs_err"] for v in leaf9.values()),
        "ms": evo["ms"], "plain_ms": evo["plain_ms"],
        "bound_ms": evo["bound_ms"], "bound_by": evo["bound_by"],
        "library_ms": evo["library_ms"],
        "n_bodies": 1 << 20, "state": "after 10 contract-loop steps",
        "inputs_ms": {k: v["ms"] for k, v in leaf9.items()},
        "inputs_library_ms": {k: v["library_ms"] for k, v in leaf9.items()},
        "inputs_bound_ms": {k: v["bound_ms"] for k, v in leaf9.items()},
        "inputs_library_gap": {
            k: v["library_gap"] for k, v in leaf9.items()},
        "order": f"two-level, chunks of {LEAF_CHUNK} rows"})
    evo = dense10["3D N=1,048,576 after 10 contract-loop steps"]
    summary["kernels"].append({
        "name": "dense_collect3", "route": "cuda",
        "source": "nbody_tpu_torch/csrc/collect_dense3.cu",
        "replaces": "nbody_tpu/ops/collect_dense3.py",
        "replaces_note": "XLA in the JAX package (no Pallas kernel); "
                         "PyTorch operators in the port before",
        "dims": 3, "launches": launches[(3, "barnes_hut", n1m)][
            "dense_kernel"],
        "max_abs_err": 0.0, "ms": evo["ms"], "plain_ms": evo["plain_ms"],
        "bound_ms": evo["bound_ms"], "bound_by": evo["bound_by"],
        "library_ms": None, "n_bodies": 1 << 20,
        "state": "after 10 contract-loop steps",
        "inputs_ms": {k: v["ms"] for k, v in dense10.items()},
        "inputs_bound_ms": {k: v["bound_ms"] for k, v in dense10.items()}})
    evo = gather12["1M Plummer pass"]
    summary["kernels"].append({
        "name": "gather_collect3", "route": "cuda",
        "source": "nbody_tpu_torch/csrc/collect_gather3.cu",
        "replaces": "nbody_tpu/ops/bh3d.py",
        "replaces_note": "XLA in the JAX package (no Pallas kernel); "
                         "PyTorch operators in the port before",
        "dims": 3, "launches": gather12["launches"],
        "max_abs_err": 0.0, "ms": evo["ms"], "plain_ms": evo["plain_ms"],
        "bound_ms": evo["bound_ms"], "bound_by": evo["bound_by"],
        "library_ms": None, "n_bodies": 1 << 20,
        "state": "a Plummer sphere after 5 contract-loop steps",
        "inputs_ms": {k: v["ms"] for k, v in gather12.items()
                      if k != "launches"},
        "inputs_bound_ms": {k: v["bound_ms"] for k, v in gather12.items()
                            if k != "launches"}})
    print(f"card: {card}")
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
