"""Vectorised analysis plots (the reference's L6 layer at scale): the
port's copy of ``nbody_tpu.bench.plots``, which imports no jax but sits
in a package that does.

The reference plotters remain the compatibility contract (our files feed
them unchanged); these are the scalable equivalents — plot_2d.py is
O(N^2) in Python lists (plot_2d.py:19-23) and cannot render the 40K-body
golden workload, so ``trajectories`` re-implements it vectorised, and
``quadtree`` renders dump files of any size.  matplotlib is imported
inside each function, so the CLI imports without it.

CLI:  python -m nbody_tpu_torch plot --positions positions.txt
      python -m nbody_tpu_torch plot --quadtree quadtree_init.txt
"""

from __future__ import annotations

import os

import numpy as np


def trajectories(positions_file: str, out_png: str | None = None,
                 max_bodies: int = 2000):
    """plot_2d.py equivalent: one polyline per body (vectorised).

    For large N only the first ``max_bodies`` bodies are drawn (the
    reference draws every body with a legend entry, which is unusable
    beyond a few dozen)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..utils.textio import read_positions_file

    data = read_positions_file(positions_file)
    bodies = data[:, 1].astype(int)
    n = bodies.max() + 1
    steps = len(data) // n
    xy = data[:, 2:4].reshape(steps, n, 2)  # rows are per-step blocks

    shown = min(n, max_bodies)
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.plot(xy[:, :shown, 0], xy[:, :shown, 1], linewidth=0.5, alpha=0.6)
    ax.scatter(xy[-1, :shown, 0], xy[-1, :shown, 1], s=4, color="red")
    ax.set_title("N-Body Problem Visualization")
    ax.set_xlabel("X Coordinate")
    ax.set_ylabel("Y Coordinate")
    ax.axhline(0, color="gray", linestyle="--", linewidth=0.5)
    ax.axvline(0, color="gray", linestyle="--", linewidth=0.5)
    ax.grid(True)
    out = out_png or "plot_2d.png"
    fig.savefig(out, dpi=150)
    plt.close(fig)
    return out


def trajectories_3d(positions_file: str, out_png: str | None = None,
                    max_bodies: int = 500):
    """Working 3D trajectory plot — the reference's plot_3d.py consumes
    the same five-column ``time body x y z`` file but is non-functional
    as committed (expects plotly, calls plt.savefig without importing
    matplotlib, plot_3d.py:1/49); this is the functional equivalent,
    vectorised and matplotlib-only.  Per-body polylines colored by body,
    final positions marked."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..utils.textio import read_positions_file

    data = read_positions_file(positions_file)
    if data.shape[1] < 5:
        raise ValueError(
            f"{positions_file} has {data.shape[1]} columns; 3D plotting "
            "needs the five-column 'time body x y z' schema (run with "
            "--dims 3 --save-positions)"
        )
    bodies = data[:, 1].astype(int)
    n = bodies.max() + 1
    steps = len(data) // n
    xyz = data[:, 2:5].reshape(steps, n, 3)

    shown = min(n, max_bodies)
    fig = plt.figure(figsize=(9, 9))
    ax = fig.add_subplot(projection="3d")
    for b in range(shown):
        ax.plot(
            xyz[:, b, 0], xyz[:, b, 1], xyz[:, b, 2],
            linewidth=0.5, alpha=0.6,
        )
    ax.scatter(
        xyz[-1, :shown, 0], xyz[-1, :shown, 1], xyz[-1, :shown, 2],
        s=4, color="red", depthshade=False,
    )
    ax.set_title("3D N-Body Problem Visualization")
    ax.set_xlabel("X Coordinate")
    ax.set_ylabel("Y Coordinate")
    ax.set_zlabel("Z Coordinate")
    out = out_png or "plot_3d.png"
    fig.savefig(out, dpi=150)
    plt.close(fig)
    return out


_MEASURED = "#2563eb"  # single measured series (ink-dark blue on white)
_IDEAL = "#6b7280"  # reference/ideal lines: neutral gray, dashed


def _parse_scaling_results(results_file: str):
    """Parse a sweep results file (the reference scripts' format, §2.11):
    config lines ``n_bodies, n_threads, n_simulations[, repetition],
    <stdout>`` followed by the two timing lines.  Thread fields may be
    products like ``1024*16`` (plot_first_scale.py:103-116).

    Returns (records, n_bodies_set) where records is a list of
    (n_bodies, procs, parallel_us, total_ms)."""
    import re

    cfg_re = re.compile(r"^\s*(\d+)\s*,\s*([\d*]+)\s*,\s*(\d+)\s*,")
    par_re = re.compile(
        r"GPU parallel computation took\s+(\d+)\s+microseconds"
    )
    tot_re = re.compile(
        r"GPU total computation took\s+(\d+)\s+milliseconds"
    )
    records = []
    cur = None  # (n_bodies, procs)
    par = tot = None

    def flush():
        nonlocal par, tot
        if cur is not None and (par is not None or tot is not None):
            records.append((cur[0], cur[1], par, tot))
        par = tot = None

    with open(results_file) as f:
        for line in f:
            m = cfg_re.match(line)
            if m:
                flush()
                procs = 1
                for part in m.group(2).split("*"):
                    procs *= int(part)
                cur = (int(m.group(1)), procs)
            m = par_re.search(line)
            if m:
                par = float(m.group(1))
            m = tot_re.search(line)
            if m:
                tot = float(m.group(1))
    flush()
    return records, sorted({r[0] for r in records})


def scaling_analysis(results_file: str, out_prefix: str | None = None,
                     metric: str = "parallel"):
    """plot_first_scale.py / plot_second_scale.py equivalent analysis.

    Strong-scaling files (one n_bodies, varying processor count) get the
    reference's three analyses (plot_first_scale.py:105-154, 160-325):
    mean runtime T(p) with the ideal T(1)/p line, speedup S(p) = T(1)/T(p)
    against the linear reference, and efficiency E(p) = S(p)/p.  Files
    with a varying n_bodies axis (weak scaling / bodies sweeps) get the
    runtime-vs-N errorbar plot (plot_second_scale.py:58-88).

    Returns the list of PNG paths written."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    records, bodies_axis = _parse_scaling_results(results_file)
    if not records:
        raise ValueError(f"no timed runs parsed from {results_file}")
    col = 2 if metric == "parallel" else 3
    unit = "µs" if metric == "parallel" else "ms"
    records = [r for r in records if r[col] is not None]
    prefix = out_prefix or os.path.splitext(results_file)[0]
    outs = []

    if len(bodies_axis) > 1:  # weak / bodies sweep
        by_n: dict[int, list[float]] = {}
        for r in records:
            by_n.setdefault(r[0], []).append(r[col])
        ns = sorted(by_n)
        mean = np.array([np.mean(by_n[n]) for n in ns])
        std = np.array([np.std(by_n[n]) for n in ns])
        fig, ax = plt.subplots(figsize=(8, 5))
        ax.errorbar(ns, mean, yerr=std, marker="o", markersize=4,
                    linewidth=1.5, capsize=3, color=_MEASURED)
        ax.set_xscale("log", base=2)
        ax.set_yscale("log")
        ax.set_xlabel("Number of bodies")
        ax.set_ylabel(f"Mean runtime ({unit}, ±σ)")
        ax.set_title(f"Runtime vs problem size ({metric} time)")
        ax.grid(True, alpha=0.3)
        out = f"{prefix}_runtime_vs_n.png"
        fig.savefig(out, dpi=150, bbox_inches="tight")
        plt.close(fig)
        return [out]

    by_p: dict[int, list[float]] = {}
    for r in records:
        by_p.setdefault(r[1], []).append(r[col])
    ps = sorted(by_p)
    mean = np.array([np.mean(by_p[p]) for p in ps])
    p_arr = np.array(ps, float)

    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot(p_arr, mean, marker="o", markersize=4, linewidth=1.5,
            color=_MEASURED, label="measured")
    if ps[0] == 1:
        ax.plot(p_arr, mean[0] / p_arr, linestyle="--", linewidth=1.2,
                color=_IDEAL, label="ideal T(1)/p")
    ax.set_xscale("log", base=2)
    ax.set_yscale("log")
    ax.set_xlabel("Processors")
    ax.set_ylabel(f"Mean runtime ({unit})")
    ax.set_title(f"Strong scaling: runtime ({metric} time)")
    ax.grid(True, alpha=0.3)
    ax.legend()
    out = f"{prefix}_runtime.png"
    fig.savefig(out, dpi=150, bbox_inches="tight")
    plt.close(fig)
    outs.append(out)

    if ps[0] != 1:
        return outs  # no T(1): speedup/efficiency undefined, like the
        #               reference (plot_first_scale.py:122-125)
    speedup = mean[0] / mean
    eff = speedup / p_arr

    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot(p_arr, speedup, marker="o", markersize=4, linewidth=1.5,
            color=_MEASURED, label="measured S(p)")
    ax.plot(p_arr, p_arr, linestyle="--", linewidth=1.2, color=_IDEAL,
            label="linear S=p")
    # the reference shades super/linear/sub-linear bands
    # (plot_first_scale.py:216-285); light tints + labels here
    ax.fill_between(p_arr, p_arr, np.maximum(speedup.max(), p_arr.max()),
                    color="#16a34a", alpha=0.06)
    ax.fill_between(p_arr, 0, p_arr, color="#dc2626", alpha=0.05)
    ax.set_xscale("log", base=2)
    ax.set_yscale("log", base=2)
    ax.set_xlabel("Processors")
    ax.set_ylabel("Speedup S(p) = T(1)/T(p)")
    ax.set_title(f"Strong scaling: speedup ({metric} time)")
    ax.grid(True, alpha=0.3)
    ax.legend()
    out = f"{prefix}_speedup.png"
    fig.savefig(out, dpi=150, bbox_inches="tight")
    plt.close(fig)
    outs.append(out)

    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot(p_arr, eff, marker="o", markersize=4, linewidth=1.5,
            color=_MEASURED, label="measured E(p)")
    ax.axhline(1.0, linestyle="--", linewidth=1.2, color=_IDEAL,
               label="ideal E=1")
    ax.set_xscale("log", base=2)
    ax.set_ylim(0, max(1.1, float(eff.max()) * 1.05))
    ax.set_xlabel("Processors")
    ax.set_ylabel("Efficiency E(p) = S(p)/p")
    ax.set_title(f"Strong scaling: efficiency ({metric} time)")
    ax.grid(True, alpha=0.3)
    ax.legend()
    out = f"{prefix}_efficiency.png"
    fig.savefig(out, dpi=150, bbox_inches="tight")
    plt.close(fig)
    outs.append(out)
    return outs


def quadtree(dump_file: str, out_png: str | None = None):
    """plot_quadtree.py equivalent using a LineCollection (fast at 350K
    nodes)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.collections import LineCollection

    import re

    occ_re = re.compile(
        r"occupantIndex=(-?\d+)\s+occupantPos=\(([-0-9.e+]+),([-0-9.e+]+)\)"
    )
    rects = []
    pts = []
    with open(dump_file) as f:
        for line in f:
            tok = line.split()
            if len(tok) < 6:
                continue
            x0, x1, y0, y1 = map(float, tok[1:5])
            rects.append([(x0, y0), (x1, y0), (x1, y1), (x0, y1), (x0, y0)])
            m = occ_re.search(line)
            if m:
                pts.append((float(m.group(2)), float(m.group(3))))
    segs = []
    for r in rects:
        segs.extend([(r[i], r[i + 1]) for i in range(4)])
    fig, ax = plt.subplots()
    ax.add_collection(
        LineCollection(segs, colors="black", alpha=0.3, linewidths=0.4)
    )
    if pts:
        p = np.asarray(pts)
        ax.scatter(p[:, 0], p[:, 1], color="red", s=2, zorder=3)
    ax.autoscale()
    ax.set_aspect("equal", "box")
    ax.set_xlabel("X")
    ax.set_ylabel("Y")
    out = out_png or dump_file.replace(".txt", "_png.png")
    fig.savefig(out, dpi=200)
    plt.close(fig)
    return out
