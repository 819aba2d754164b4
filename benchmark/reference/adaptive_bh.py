"""Grouped Barnes-Hut as deep as a state needs, written from its
definition in plain PyTorch: the reference of the ``barnes_hut_adaptive``
engine.  It imports nothing of the program and builds its tree itself.

The rules are ``gravity.GroupedBH``'s (``gravity.py``'s docstring) at
``max_depth`` 21, the deepest level a 63-bit Morton code holds:

* root box, midpoint halving, Morton codes (one bit an axis a level, x
  lowest) and cell size as there, in the positions' own precision;
* the bodies sorted stably by their code, so each cell at each level is
  one contiguous run of them; groups of ``group_size`` of that order
  with ``sub_boxes`` boxes each;
* a non-empty cell (mass above 1e-15) is taken as its mass at its centre
  when it holds one body, passes the theta test, or lies at
  ``max_depth``; else it contributes each of its bodies when it holds at
  most ``direct_cell_max``, and opens to its non-empty children when it
  holds more; ``quarter_split`` as there.

Each level keeps only its non-empty cells (``torch.unique_consecutive``
of the sorted codes' prefixes), so depth 21 costs memory in proportion
to the bodies, not to 8^21 cells.  Sums are float64.
"""

from __future__ import annotations

import torch

from .gravity import MASS_SKIP, morton, pair_sum, root_box

MAX_DEPTH = 21


class AdaptiveBH:
    """The grouped Barnes-Hut answer of one state to ``max_depth``, group
    by group."""

    def __init__(self, positions, masses, *, g, theta, group_size,
                 sub_boxes, direct_cell_max, quarter_split, softening,
                 max_depth=MAX_DEPTH):
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
        sorted_code = code[self.order]
        self.ps = positions[self.order].double()
        self.ms = masses[self.order].double()
        extent = hi - lo
        self.size = [float((extent / (1 << lv)).max())
                     for lv in range(max_depth + 1)]
        # per level, its non-empty cells in code order: prefix, first
        # body, count, mass, centre
        self.prefix, self.first, self.count = [], [], []
        self.mass, self.com = [], []
        for lv in range(max_depth + 1):
            ids = sorted_code >> (self.dims * (max_depth - lv))
            prefix, inv, cnt = torch.unique_consecutive(
                ids, return_inverse=True, return_counts=True)
            k = prefix.shape[0]
            m = torch.zeros(k, dtype=torch.float64,
                            device=self.ms.device).index_add_(0, inv,
                                                              self.ms)
            mx = torch.zeros((k, self.dims), dtype=torch.float64,
                             device=self.ms.device)
            mx.index_add_(0, inv, self.ms[:, None] * self.ps)
            sx = torch.zeros_like(mx).index_add_(0, inv, self.ps)
            safe = torch.where(m > 0, m, torch.ones_like(m))
            self.prefix.append(prefix)
            self.first.append(torch.cumsum(cnt, 0) - cnt)
            self.count.append(cnt)
            self.mass.append(m)
            self.com.append(torch.where((cnt == 1)[:, None], sx,
                                        mx / safe[:, None]))
        self.gs = min(group_size, self.n)
        self.n_groups = -(-self.n // self.gs)
        n_pad = self.n_groups * self.gs
        padded = torch.cat([self.ps, self.ps[-1:].expand(n_pad - self.n,
                                                         self.dims)])
        sub = padded.reshape(self.n_groups, sub_boxes, -1, self.dims)
        self.sub_lo = sub.amin(2)
        self.sub_hi = sub.amax(2)

    def _children(self, lv: int, cells: torch.Tensor) -> torch.Tensor:
        """Indices at level lv + 1 of the non-empty children of cells."""
        fan = 1 << self.dims
        nxt = self.prefix[lv + 1]
        p = self.prefix[lv][cells]
        a = torch.searchsorted(nxt, p * fan)
        b = torch.searchsorted(nxt, (p + 1) * fan)
        span = b - a
        base = torch.repeat_interleave(a, span)
        offs = torch.arange(base.shape[0], device=base.device) - (
            torch.repeat_interleave(torch.cumsum(span, 0) - span, span))
        return base + offs

    def walk(self, grp: int):
        """The group's lists: approx (centres [A, D], masses [A]) and
        direct cells (first bodies [C] in the sorted order, counts [C],
        quarter-fail bits [C], centres [C, D], masses [C])."""
        dev = self.ps.device
        lo, hi = self.sub_lo[grp], self.sub_hi[grp]
        q = lo.shape[0]
        cells = torch.zeros(1, dtype=torch.int64, device=dev)
        app_c, app_m = [], []
        direct_parts = ([], [], [], [], [])
        for lv in range(self.max_depth + 1):
            cnt = self.count[lv][cells]
            m = self.mass[lv][cells]
            com = self.com[lv][cells]
            da = torch.clamp(torch.maximum(lo[None] - com[:, None],
                                           com[:, None] - hi[None]), min=0)
            d2q = (da * da).sum(-1)
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
                fail = size >= self.theta * (dq + self.soft)
                bits = (fail.to(torch.int64) << torch.arange(
                    4, device=dev)).sum(1)
            else:
                bits = torch.full_like(cells, 15)
            for part, v in zip(direct_parts, (
                    self.first[lv][cells], cnt, bits, com, m)):
                part.append(v[direct])
            opened = cells[multi & ~ok & ~direct]
            if leaf or opened.numel() == 0:
                break
            cells = self._children(lv, opened)
        return ((torch.cat(app_c), torch.cat(app_m)),
                tuple(torch.cat(p) for p in direct_parts))

    def accelerations(self, grp: int, dtypes=(torch.float64,)):
        """(body indices [S] in the state's order, {dtype: accelerations
        [S, D]}) of group ``grp``'s bodies, every pair evaluated in each
        of ``dtypes``."""
        (ac, am), (ds, dc, db, dx, dm) = self.walk(grp)
        s0 = grp * self.gs
        s1 = min(s0 + self.gs, self.n)
        quarters = 4 if self.split else 1
        qn = self.gs // quarters
        accs = {dt: [] for dt in dtypes}
        for k in range(quarters):
            t0, t1 = s0 + k * qn, min(s0 + (k + 1) * qn, s1)
            if t0 >= t1:
                break
            near = ((db >> k) & 1) > 0
            body = torch.repeat_interleave(ds[near], dc[near])
            body = body + torch.arange(body.shape[0], device=body.device) - (
                torch.repeat_interleave(torch.cumsum(dc[near], 0)
                                        - dc[near], dc[near]))
            src = torch.cat([ac, dx[~near], self.ps[body]])
            gm = self.g * torch.cat([am, dm[~near], self.ms[body]])
            for dt in dtypes:
                accs[dt].append(pair_sum(self.ps[t0:t1], src, gm, self.soft,
                                         dt).double())
        return self.order[s0:s1], {dt: torch.cat(a) for dt, a in
                                   accs.items()}


def answers(positions, masses, groups, *, g, theta, softening,
            group_size=2048, sub_boxes=16, direct_cell_max=128,
            quarter_split=True, dtypes=(torch.float64,)):
    """(indices [K], {dtype: accelerations [K, D]}) of every body of the
    given groups of one state."""
    bh = AdaptiveBH(positions, masses, g=g, theta=theta,
                    group_size=group_size, sub_boxes=sub_boxes,
                    direct_cell_max=direct_cell_max,
                    quarter_split=quarter_split, softening=softening)
    idx, acc = [], {dt: [] for dt in dtypes}
    for grp in sorted(groups):
        i, a = bh.accelerations(grp, dtypes)
        idx.append(i)
        for dt in dtypes:
            acc[dt].append(a[dt])
    return torch.cat(idx), {dt: torch.cat(a) for dt, a in acc.items()}
