"""Window-size calibration for the dense (stencil) 3D collector; the port
of ``scripts/windows.py``.

Replays the grouped dual walk (``ops/bh3d._collect_lists_3d``
semantics, UNCAPPED) in NumPy and records, per level, where the reached
frontier lives in cell coordinates relative to each group's own bbox:

  * ``extent``  — max over groups of the reach bounding box side
    (cells, per axis max) entering each level,
  * ``halo_lo/hi`` — max overhang of the reach box beyond the group's
    position bbox (cells), i.e. the stencil halo a dense window needs,
  * ``lanes`` — sum over groups of reach-cell counts (the gather rows a
    capped walk pays for at that level).

These are the numbers behind ``window_schedule_3d`` in
ops/collect_dense3.py.  The tree is the port's (built on ``--device``),
and ``steps`` evolves the state with the port's 3D engine there first;
the replay itself is NumPy on the host.

Usage: python -m nbody_tpu_torch.scripts.windows [--device cpu]
           n=262144,init=uniform [spec...]
Keys: n, init (uniform|blobs), gs, theta, dcm, steps, dims.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

G_CONST = 6.67e-11
MASS_SKIP = 1e-15


def _state(n, init, steps, theta, dims, device):
    """(masses f32, positions f32) host arrays: the JAX script's draw,
    evolved ``steps`` times by the port's 3D engine on ``device``."""
    rng = np.random.default_rng(0)
    masses = 10 ** rng.uniform(-1, np.log10(0.5), n)
    if init == "blobs":
        k = n // 2
        c = rng.uniform(-0.05, 0.05, (2, dims))
        pts = np.concatenate([
            rng.normal(c[0], 0.004, (k, dims)),
            rng.normal(c[1], 0.004, (n - k, dims)),
        ])
        pos = np.clip(pts, -0.1, 0.1)
    else:
        pos = rng.uniform(-0.1, 0.1, (n, dims))
    if steps:
        if dims != 3:
            raise ValueError("steps > 0 is supported for dims=3 only")
        from ..ops.bh3d import bh3_accelerations_grouped

        p = torch.tensor(pos, dtype=torch.float32, device=device)
        m = torch.tensor(masses, dtype=torch.float32, device=device)
        for _ in range(steps):
            p = p + bh3_accelerations_grouped(p, m, g=G_CONST, theta=theta)
        pos = p.double().cpu().numpy()
    return masses.astype(np.float32), pos.astype(np.float32)


def run(n, init="uniform", gs=2048, theta=0.5, dcm=None, steps=0, dims=3,
        device="cuda"):
    device = torch.device(device)
    if dims == 3:
        from ..ops.bh3d import direct_cell_max_default
        from ..ops.tree3d import build_octree as build
        from ..ops.tree3d import default_max_depth3

        md = default_max_depth3(n)
        dcm = dcm or direct_cell_max_default(n)
    else:
        from ..ops.tree import build_quadtree as build

        md = 9
        dcm = dcm or 32

    masses, pos = _state(n, init, steps, theta, dims, device)
    tree = build(torch.tensor(pos, device=device),
                 torch.tensor(masses, device=device), max_depth=md)
    bounds = tree.bounds.cpu().numpy().astype(np.float64)
    raw = [r.cpu().numpy().astype(np.float32) for r in tree.raw]
    order = np.argsort(tree.codes.cpu().numpy(), kind="stable")
    ps = pos[order]
    g = (n + gs - 1) // gs
    q = max(4, gs // 128)
    sub = ps[: g * gs].reshape(g, q, gs // q, dims)
    blo = sub.min(axis=2)  # [G, Q, dims]
    bhi = sub.max(axis=2)
    glo, ghi = blo.min(axis=1), bhi.max(axis=1)  # [G, dims] group bbox

    lo = bounds[0::2]
    hi = bounds[1::2]
    size_l = [(hi - lo).max() / (1 << lv) for lv in range(md + 1)]
    cell = [(hi - lo) / (1 << lv) for lv in range(md + 1)]

    def coords(idx, lv):
        """De-interleave Morton cell index -> per-axis coords at level
        lv (x = bit 0 of each dims-bit group; tree/tree3d packing)."""
        cs = [np.zeros_like(idx) for _ in range(dims)]
        for k in range(lv):
            for a in range(dims):
                cs[a] |= ((idx >> (dims * k + a)) & 1) << k
        return np.stack(cs, axis=-1)

    print(f"# n={n} init={init} md={md} dcm={dcm} G={g} Q={q} steps={steps}")
    print("# lvl | reach-extent(cells) | halo_lo | halo_hi | "
          "bbox-extent | lanes(sum) | lanes(max/grp)")
    frontier = [np.zeros(1, np.int64) for _ in range(g)]
    per_group_ext = [[] for _ in range(md + 1)]
    for lv in range(md + 1):
        last = lv == md
        lanes = np.array([len(f) for f in frontier])
        ext = np.zeros(dims, np.int64)
        hlo = np.full(dims, -(10**9), np.int64)
        hhi = np.full(dims, -(10**9), np.int64)
        nxt = []
        r = raw[lv]
        for gi in range(g):
            idx = frontier[gi]
            if len(idx) == 0:
                nxt.append(idx)
                continue
            rows = r[idx]
            m = rows[:, 0]
            cnt = rows[:, 2 * dims + 1]
            safe = np.where(m > 0, m, 1.0)
            com = np.where(
                (cnt == 1.0)[:, None],
                rows[:, dims + 1: 2 * dims + 1],
                rows[:, 1: dims + 1] / safe[:, None],
            )
            d = np.maximum(
                np.maximum(
                    blo[gi][:, None, :] - com[None, :, :],
                    com[None, :, :] - bhi[gi][:, None, :],
                ),
                0.0,
            )  # [Q, F, 3]
            dmin = np.sqrt((d * d).sum(-1).min(axis=0)) + 1e-15
            ok = size_l[lv] < theta * dmin
            nonempty = (cnt > 0) & (m > MASS_SKIP)
            multi = nonempty & (cnt > 1)
            direct = multi & ~ok & (not last) & (cnt <= dcm)
            open_ = multi & ~ok & ~direct & (not last)

            c = coords(idx, lv)
            occ = c[nonempty | (cnt > 0)]
            if len(occ):
                span = occ.max(0) - occ.min(0) + 1
                ext = np.maximum(ext, span)
                per_group_ext[lv].append(int(span.max()))
                gl = np.floor((glo[gi] - lo) / cell[lv]).astype(np.int64)
                gh = np.floor((ghi[gi] - lo) / cell[lv]).astype(np.int64)
                hlo = np.maximum(hlo, gl - occ.min(0))
                hhi = np.maximum(hhi, occ.max(0) - gh)
            if last or not open_.any():
                nxt.append(np.zeros(0, np.int64))
                continue
            par = idx[open_]
            nk = 2**dims
            kids = (par[:, None] * nk + np.arange(nk)).ravel()
            kcnt = raw[lv + 1][kids, 2 * dims + 1]
            nxt.append(kids[kcnt > 0])
        frontier = nxt
        print(
            f"{lv:3d} | {ext.max():5d} | {max(hlo.max(), 0):4d} | "
            f"{max(hhi.max(), 0):4d} | "
            f"{int(np.ceil(((ghi - glo) / cell[lv]).max())):5d} | "
            f"{lanes.sum():9d} | {lanes.max():7d}"
        )
        e = np.sort(per_group_ext[lv]) if per_group_ext[lv] else np.zeros(1)
        pct = [int(np.percentile(e, p)) for p in (50, 90, 95, 99)]
        wide = {w: int((e > w).sum()) for w in (16, 20, 24, 28, 32, 40)}
        print(f"      reach-ext pct p50/90/95/99={pct}  #groups>W: {wide}")


def main(argv=None) -> int:
    from ._cli import parse

    device, specs = parse(argv, "nbody_tpu_torch.scripts.windows", __doc__,
                          default_specs=["n=262144,init=uniform"])
    for parts in specs:
        run(**{k: v if k == "init" else int(v) for k, v in parts.items()},
            device=device)
        print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
