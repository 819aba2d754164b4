"""The plain reference the benchmark holds the program to: Newtonian
gravity as a direct sum, and grouped Barnes-Hut written from its
definition.  Plain PyTorch on whatever device the tensors are on; it
imports nothing of the program and builds its trees itself.

Force law (both engines): a_i = sum_j g m_j (p_j - p_i) / (d2 (d + eps))
over the sources with d2 = |p_j - p_i|^2 > 0, eps the configuration's
softening (0 for all-pairs).

Grouped Barnes-Hut (the semantics the configuration states):

* Root box: per axis min / max of the positions, padded by 10% of the
  largest extent (1e-6 for a single point), in the positions' own
  precision.
* Leaf cell of a body: ``max_depth`` rounds of midpoint halving of the
  box, in the positions' precision, ``>=`` to the high side; the Morton
  code interleaves one bit an axis a level (x lowest).  A cell at level
  L holds the bodies whose code, shifted right by dims * (max_depth -
  L), is the cell's index.
* Cell mass and centre of mass; a cell of one body has the body's own
  position as its centre.
* Groups: the bodies sorted by code (stable), cut into ``group_size``
  runs, the last padded with copies of its last body; each group has
  ``sub_boxes`` boxes over equal slices of its run.
* A group walks the tree from the root.  For a non-empty cell (mass
  above 1e-15): d = the smallest distance from the cell's centre to a
  sub-box, plus eps; accepted iff size < theta * d, size the largest
  cell extent at the level.  One body, accepted, or a cell at max_depth:
  the cell's mass at its centre.  Otherwise a cell of at most
  ``direct_cell_max`` bodies contributes each body; a larger one opens
  to its non-empty children.
* ``quarter_split``: each quarter of a group (a quarter of its
  sub-boxes and of its bodies) takes a direct cell as its mass at its
  centre where the cell is accepted for that quarter's own sub-boxes.
"""

from __future__ import annotations

import torch

MASS_SKIP = 1e-15
PAD_FRACTION = 0.1
# pairs a chunk of the direct sum evaluates at once (memory, not bits)
CHUNK_PAIRS = 1 << 23


def pair_sum(targets: torch.Tensor, src_pos: torch.Tensor,
             src_gm: torch.Tensor, softening: float,
             dtype=torch.float64) -> torch.Tensor:
    """Accelerations [T, D] of ``targets`` due to the sources, every
    product and sum in ``dtype`` (a bfloat16 sum accumulates as
    ``torch.sum`` does).  ``src_gm`` is g times each source's mass."""
    t = targets.to(dtype)
    s = src_pos.to(dtype)
    gm = src_gm.to(dtype)
    if s.shape[0] == 0:
        return torch.zeros_like(t)
    chunk = max(1, CHUNK_PAIRS // s.shape[0])
    out = []
    for i in range(0, t.shape[0], chunk):
        disp = s[None, :, :] - t[i:i + chunk, None, :]  # [C, S, D]
        d2 = (disp * disp).sum(-1)
        ok = d2 > 0
        d2 = torch.where(ok, d2, torch.ones_like(d2))
        w = torch.where(ok, gm / (d2 * (d2.sqrt() + softening)),
                        torch.zeros_like(d2))
        out.append((w[..., None] * disp).sum(1))
    return torch.cat(out)


def root_box(positions: torch.Tensor):
    """(low [D], high [D]) of the padded root box, in the positions'
    precision."""
    lo = positions.amin(0)
    hi = positions.amax(0)
    max_dim = (hi - lo).max()
    pad = torch.where(max_dim == 0.0, torch.full_like(max_dim, 1e-6),
                      PAD_FRACTION * max_dim)
    return lo - pad, hi + pad


def morton(positions: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
           max_depth: int) -> torch.Tensor:
    """Leaf-cell Morton code [N] int64 by midpoint halving."""
    n, dims = positions.shape
    code = torch.zeros(n, dtype=torch.int64, device=positions.device)
    lows = [lo[a].expand(n) for a in range(dims)]
    highs = [hi[a].expand(n) for a in range(dims)]
    for _ in range(max_depth):
        bits = torch.zeros_like(code)
        for a in range(dims):
            mid = (lows[a] + highs[a]) * 0.5
            b = positions[:, a] >= mid
            lows[a] = torch.where(b, mid, lows[a])
            highs[a] = torch.where(b, highs[a], mid)
            bits |= b.to(torch.int64) << a
        code = (code << dims) | bits
    return code


class GroupedBH:
    """The grouped Barnes-Hut answer of one state, group by group."""

    def __init__(self, positions, masses, *, g, theta, max_depth,
                 group_size, sub_boxes, direct_cell_max, quarter_split,
                 softening):
        self.p = positions  # the state's own precision
        self.n, self.dims = positions.shape
        self.g = g
        self.theta = theta
        self.max_depth = max_depth
        self.soft = softening
        self.dcm = direct_cell_max
        self.split = quarter_split
        lo, hi = root_box(positions)
        code = morton(positions, lo, hi, max_depth)
        self.order = torch.argsort(code, stable=True)
        self.sorted_code = code[self.order]
        self.ps = positions[self.order].double()
        ms = masses[self.order].double()
        self.ms = ms
        # the largest cell extent at each level, in the box's precision
        extent = hi - lo
        self.size = [float((extent / (1 << lv)).max())
                     for lv in range(max_depth + 1)]
        # per level: each cell's count, mass and centre (dense arrays)
        self.count, self.mass, self.com = [], [], []
        for lv in range(max_depth + 1):
            ids = self.sorted_code >> (self.dims * (max_depth - lv))
            n_cells = 1 << (self.dims * lv)
            cnt = torch.bincount(ids, minlength=n_cells)
            m = torch.zeros(n_cells, dtype=torch.float64,
                            device=ms.device).index_add_(0, ids, ms)
            mx = torch.zeros((n_cells, self.dims), dtype=torch.float64,
                             device=ms.device)
            mx.index_add_(0, ids, ms[:, None] * self.ps)
            sx = torch.zeros_like(mx).index_add_(0, ids, self.ps)
            safe = torch.where(m > 0, m, torch.ones_like(m))
            com = torch.where((cnt == 1)[:, None], sx, mx / safe[:, None])
            self.count.append(cnt)
            self.mass.append(m)
            self.com.append(com)
        self.gs = min(group_size, self.n)
        self.n_groups = -(-self.n // self.gs)
        n_pad = self.n_groups * self.gs
        padded = torch.cat([self.ps, self.ps[-1:].expand(n_pad - self.n,
                                                         self.dims)])
        sub = padded.reshape(self.n_groups, sub_boxes, -1, self.dims)
        self.sub_lo = sub.amin(2)  # [G, Q, D]
        self.sub_hi = sub.amax(2)

    def _walk(self, grp: int):
        """The group's lists: approx (centres [A, D], masses [A]) and
        direct cells (levels [C], cells [C], quarter-fail bits [C],
        centres [C, D], masses [C])."""
        dev = self.ps.device
        lo, hi = self.sub_lo[grp], self.sub_hi[grp]  # [Q, D]
        q = lo.shape[0]
        cells = torch.zeros(1, dtype=torch.int64, device=dev)
        app_c, app_m = [], []
        dir_l, dir_c, dir_b, dir_x, dir_m = [], [], [], [], []
        for lv in range(self.max_depth + 1):
            cnt = self.count[lv][cells]
            m = self.mass[lv][cells]
            com = self.com[lv][cells]
            da = torch.clamp(torch.maximum(lo[None] - com[:, None],
                                           com[:, None] - hi[None]), min=0)
            d2q = (da * da).sum(-1)  # [F, Q]
            d_min = d2q.min(1).values.sqrt() + self.soft
            size = self.size[lv]
            ok = size < self.theta * d_min
            live = (cnt > 0) & (m > MASS_SKIP)
            single = live & (cnt == 1)
            multi = live & (cnt > 1)
            leaf = lv == self.max_depth
            approx = single | (multi & (ok | leaf))
            direct = multi & ~ok & (cnt <= self.dcm) & (not leaf)
            app_c.append(com[approx])
            app_m.append(m[approx])
            if self.split:
                dq = d2q.reshape(-1, 4, q // 4).min(2).values.sqrt()
                fail = size >= self.theta * (dq + self.soft)  # [F, 4]
                bits = (fail.to(torch.int64) << torch.arange(
                    4, device=dev)).sum(1)
            else:
                bits = torch.full_like(cells, 15)
            dir_l.append(torch.full_like(cells[direct], lv))
            dir_c.append(cells[direct])
            dir_b.append(bits[direct])
            dir_x.append(com[direct])
            dir_m.append(m[direct])
            if leaf:
                break
            opened = cells[multi & ~ok & ~direct]
            kids = (opened[:, None] * (1 << self.dims) + torch.arange(
                1 << self.dims, device=dev)).reshape(-1)
            cells = kids[self.count[lv + 1][kids] > 0]
        return ((torch.cat(app_c), torch.cat(app_m)),
                tuple(torch.cat(a) for a in (dir_l, dir_c, dir_b, dir_x,
                                             dir_m)))

    def _bodies(self, levels, cells):
        """Sorted-order indices of the bodies of the given cells."""
        dev = self.ps.device
        if cells.numel() == 0:
            return torch.zeros(0, dtype=torch.int64, device=dev)
        shift = self.dims * (self.max_depth - levels)
        first = cells << shift
        last = (cells + 1) << shift
        start = torch.searchsorted(self.sorted_code, first)
        stop = torch.searchsorted(self.sorted_code, last)
        counts = stop - start
        base = torch.repeat_interleave(start, counts)
        offs = torch.arange(base.shape[0], device=dev) - (
            torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts))
        return base + offs

    def accelerations(self, grp: int, dtypes=(torch.float64,)):
        """(body indices [S] in the state's order, {dtype: accelerations
        [S, D]}) of group ``grp``'s bodies, every pair evaluated in each
        of ``dtypes``."""
        (ac, am), (dl, dc, db, dx, dm) = self._walk(grp)
        s0 = grp * self.gs
        s1 = min(s0 + self.gs, self.n)
        quarters = 4 if self.split else 1
        qn = self.gs // quarters
        accs = {dt: [] for dt in dtypes}
        for k in range(quarters):
            t0, t1 = s0 + k * qn, min(s0 + (k + 1) * qn, s1)
            if t0 >= t1:
                break
            near = ((db >> k) & 1) > 0 if self.split else torch.ones_like(
                db, dtype=torch.bool)
            body = self._bodies(dl[near], dc[near])
            src = torch.cat([ac, dx[~near], self.ps[body]])
            gm = self.g * torch.cat([am, dm[~near], self.ms[body]])
            for dt in dtypes:
                accs[dt].append(pair_sum(self.ps[t0:t1], src, gm, self.soft,
                                         dt).double())
        return self.order[s0:s1], {dt: torch.cat(a) for dt, a in
                                   accs.items()}


def answers(positions, masses, config: dict, units: int,
            gen: torch.Generator, targets=None,
            dtypes=(torch.float64,)):
    """The reference's accelerations of a sample of bodies of one state:
    ``(indices [K], {dtype: accelerations [K, D]})``, each pair evaluated
    in each of ``dtypes`` over the same sample.

    ``config`` is the cell's configuration: ``g``, ``softening`` and its
    ``reference`` section, whose ``method`` is ``direct`` (``units``
    blocks of 1,024 targets drawn from ``targets``, a range of body
    indices, default all) or ``grouped_bh`` (``units`` groups drawn from
    all, every body of each)."""
    ref = config["reference"]
    g, soft = float(config["g"]), float(config["softening"])
    n = positions.shape[0]
    if ref["method"] == "direct":
        lo, hi = targets if targets is not None else (0, n)
        k = min(hi - lo, 1024 * units)
        pick = torch.randperm(hi - lo, generator=gen)[:k].sort().values
        idx = (pick + lo).to(positions.device)
        gm = g * masses.double()
        return idx, {dt: pair_sum(positions[idx], positions, gm, soft, dt)
                     .double() for dt in dtypes}
    if ref["method"] != "grouped_bh":
        raise ValueError(f"unknown reference method {ref['method']!r}")
    bh = GroupedBH(positions, masses, g=g, theta=float(config["theta"]),
                   max_depth=ref["max_depth"], group_size=ref["group_size"],
                   sub_boxes=ref["sub_boxes"],
                   direct_cell_max=ref["direct_cell_max"],
                   quarter_split=ref["quarter_split"], softening=soft)
    groups = torch.randperm(bh.n_groups, generator=gen)[:units].tolist()
    idx, acc = [], {dt: [] for dt in dtypes}
    for grp in sorted(groups):
        i, a = bh.accelerations(grp, dtypes)
        idx.append(i)
        for dt in dtypes:
            acc[dt].append(a[dt])
    return torch.cat(idx), {dt: torch.cat(a) for dt, a in acc.items()}
