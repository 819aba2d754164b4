"""NumPy float64 golden model of the reference engines (a copy of
``nbody_tpu.models.oracle``: the same NumPy code, so the same bits;
the port keeps its own copy because it imports nothing of the JAX
package).

This module is the conformance spec: a faithful behavioral model of the
reference's three engines (naive all-pairs main_approach_1.cpp, adaptive
Barnes-Hut quadtree main_approach_2.cpp / project.cu), written from the
semantics documented in SURVEY.md.  It is deliberately *not* device code — it
runs in float64 on host and is what the PyTorch/CUDA engines are tested
against (engine-vs-engine parity, the reference's own verification method:
checkEqual, project.cu:1027-1047).

Replicated semantics (with reference citations):

* Quadtree node layout: 12-field flat records — children x4, COM x/y, total
  mass, x/y min/max, particle index (project.cu:46-58).
* Build: per-body recursive insert with leaf-split-reinsert
  (QuadInsert, project.cu:358-453), depth cap at QUADTREE_MAX_DEPTH where
  co-located bodies aggregate into a mass-weighted pseudo-body
  (project.cu:358-382); occupant encoding: the first particle at a max-depth
  node is stored as ``-index - 2``, later arrivals reset it to ``-1``
  (project.cu:375-378).  The reference seeds QuadInsert with
  ``current_depth=1`` for the root (project.cu:587), so aggregation nodes
  sit at 0-based dump depth ``max_depth`` (= 9 by default).
* COM aggregation: recursive post-order ComputeMass (project.cu:473-502).
* Root bounds: min/max over bodies + 10% pad of the max dimension, 1e-6
  fallback for degenerate clouds (ComputeRootBounds, project.cu:536-573).
* Force traversal: per-body explicit stack (push children 0..3, LIFO pop),
  zero-mass skip at 1e-15, leaf-or-theta acceptance with
  ``node_size = max(dx, dy)``, softened distance ``sqrt(d2) + 1e-15``,
  self-skip including the negative encoding ``(occ + 2) == -i``
  (computeForces, project.cu:593-675).
* Integrator: a = F/m, v += a dt, p += v dt (project.cu:795-836).

Known deviation: for single-occupant max-depth nodes the reference dump
indexes ``positions[occupantIdx]`` with the *negative* encoded index
(project.cu:516-518), which is out-of-bounds/undefined behavior in C++.  We
print the encoded index but the occupant's *actual* position.
"""

from __future__ import annotations

import numpy as np

from ..config import (
    BH_SOFTENING,
    G_DEFAULT,
    MASS_SKIP_THRESHOLD,
    MAX_DEPTH_DEFAULT,
    ROOT_PAD_FRACTION,
    THETA_DEFAULT,
)

# Node field indices (project.cu:46-58).
CHILD0, CHILD1, CHILD2, CHILD3 = 0, 1, 2, 3
COM_X, COM_Y, TOTAL_MASS = 4, 5, 6
X_MIN, X_MAX, Y_MIN, Y_MAX = 7, 8, 9, 10
PARTICLE_INDEX = 11
QUADRANT_SIZE = 12


def naive_accelerations(positions, masses, g=G_DEFAULT):
    """main_approach_1.cpp:53-99 semantics in f64: factor = g*mi*mj/(d2*d),
    a = F/m (no softening; diagonal skipped)."""
    p = np.asarray(positions, dtype=np.float64)
    m = np.asarray(masses, dtype=np.float64)
    disp = p[None, :, :] - p[:, None, :]
    d2 = np.sum(disp * disp, axis=-1)
    np.fill_diagonal(d2, 1.0)
    d = np.sqrt(d2)
    factor = g * m[:, None] * m[None, :] / (d2 * d)
    np.fill_diagonal(factor, 0.0)
    forces = np.einsum("ij,ijk->ik", factor, disp)
    return forces / m[:, None]


def compute_root_bounds(positions, pad_fraction=ROOT_PAD_FRACTION):
    """ComputeRootBounds (project.cu:536-573)."""
    p = np.asarray(positions, dtype=np.float64)
    x_min, y_min = p[:, 0].min(), p[:, 1].min()
    x_max, y_max = p[:, 0].max(), p[:, 1].max()
    max_dim = max(x_max - x_min, y_max - y_min)
    pad = pad_fraction * max_dim
    if max_dim == 0.0:
        pad = 1e-6
    return (x_min - pad, x_max + pad, y_min - pad, y_max + pad)


class AdaptiveQuadtree:
    """The reference's pointer-style adaptive quadtree, in numpy records."""

    def __init__(self, max_depth: int = MAX_DEPTH_DEFAULT, max_size=None):
        # max_depth: deepest 0-based node depth (reference QUADTREE_MAX_DEPTH
        # = 10 counts the root as 1 -> 0-based 9).
        self.max_depth = max_depth
        # QUADTREE_MAX_SIZE = (4**(max_depth+1) - 1) / 3 (project.cu:62).
        self.max_size = (
            max_size
            if max_size is not None
            else (4 ** (max_depth + 1) - 1) // 3
        )
        self.nodes: list = []  # list of 12-element float64 arrays

    # -- build ------------------------------------------------------------
    def build(self, positions, masses, bounds=None):
        positions = np.asarray(positions, dtype=np.float64)
        masses = np.asarray(masses, dtype=np.float64)
        self.nodes = []
        if bounds is None:
            bounds = compute_root_bounds(positions)
        x_min, x_max, y_min, y_max = bounds
        root = np.array(
            [-1, -1, -1, -1, 0.0, 0.0, 0.0, x_min, x_max, y_min, y_max, -1],
            dtype=np.float64,
        )
        self.nodes.append(root)
        for i in range(positions.shape[0]):
            # reference seeds current_depth=1 for the root (project.cu:587)
            self._insert(i, 0, positions, masses, 1)
        self._compute_mass(0)
        return self

    @staticmethod
    def _determine_child(pos, node):
        """DetermineChild (project.cu:348-356): 0=BL, 1=BR, 2=TL, 3=TR with
        >= sending boundary points to the high side."""
        mid_x = (node[X_MIN] + node[X_MAX]) / 2
        mid_y = (node[Y_MIN] + node[Y_MAX]) / 2
        if pos[0] < mid_x and pos[1] < mid_y:
            return 0
        if pos[0] >= mid_x and pos[1] < mid_y:
            return 1
        if pos[0] < mid_x and pos[1] >= mid_y:
            return 2
        return 3

    def _insert(self, particle, node_index, positions, masses, depth):
        """QuadInsert (project.cu:358-453).  ``depth`` is the reference's
        current_depth (root call = 1); aggregation at depth >= max_depth+1."""
        if depth >= self.max_depth + 1:
            node = self.nodes[node_index]
            pos = positions[particle]
            mass = masses[particle]
            existing_mass = node[TOTAL_MASS]
            node[COM_X] = (existing_mass * node[COM_X] + mass * pos[0]) / (
                existing_mass + mass
            )
            node[COM_Y] = (existing_mass * node[COM_Y] + mass * pos[1]) / (
                existing_mass + mass
            )
            node[TOTAL_MASS] += mass
            if existing_mass == 0:
                node[PARTICLE_INDEX] = -1 * particle - 2
            else:
                node[PARTICLE_INDEX] = -1
            return

        node = self.nodes[node_index].copy()
        pos = positions[particle]
        mass = masses[particle]

        is_empty_leaf = (
            node[CHILD0] == -1
            and node[CHILD1] == -1
            and node[CHILD2] == -1
            and node[CHILD3] == -1
            and node[TOTAL_MASS] == 0.0
        )
        if is_empty_leaf:
            node[COM_X] = pos[0]
            node[COM_Y] = pos[1]
            node[TOTAL_MASS] = mass
            node[PARTICLE_INDEX] = particle
            self.nodes[node_index] = node
            return

        if node[TOTAL_MASS] > 0.0 and node[PARTICLE_INDEX] > -1:
            # Subdivide: create 4 children (BL, BR, TL, TR) then reinsert
            # the existing occupant.
            mid_x = (node[X_MIN] + node[X_MAX]) / 2.0
            mid_y = (node[Y_MIN] + node[Y_MAX]) / 2.0
            child_bounds = [
                (node[X_MIN], mid_x, node[Y_MIN], mid_y),
                (mid_x, node[X_MAX], node[Y_MIN], mid_y),
                (node[X_MIN], mid_x, mid_y, node[Y_MAX]),
                (mid_x, node[X_MAX], mid_y, node[Y_MAX]),
            ]
            for i, (cx0, cx1, cy0, cy1) in enumerate(child_bounds):
                if len(self.nodes) >= self.max_size:
                    print(
                        "Quadtree reached maximum size during subdivision."
                        f"current depth: {depth}"
                    )
                    return
                child = np.array(
                    [-1, -1, -1, -1, 0.0, 0.0, 0.0, cx0, cx1, cy0, cy1, -1],
                    dtype=np.float64,
                )
                node[CHILD0 + i] = len(self.nodes)
                self.nodes.append(child)

            existing_pos = (node[COM_X], node[COM_Y])
            existing_particle = int(node[PARTICLE_INDEX])
            node[COM_X] = 0.0
            node[COM_Y] = 0.0
            node[TOTAL_MASS] = 0.0
            node[PARTICLE_INDEX] = -1
            self.nodes[node_index] = node
            ec = self._determine_child(existing_pos, node)
            self._insert(
                existing_particle,
                int(node[CHILD0 + ec]),
                positions,
                masses,
                depth + 1,
            )

        c = self._determine_child(pos, node)
        self._insert(particle, int(node[CHILD0 + c]), positions, masses, depth + 1)

    def _compute_mass(self, node_index):
        """ComputeMass (project.cu:473-502), post-order, children 0..3."""
        node = self.nodes[node_index]
        if node[CHILD0] == -1:
            return node[TOTAL_MASS], (node[COM_X], node[COM_Y])
        total = 0.0
        cx = 0.0
        cy = 0.0
        for i in range(4):
            child = int(node[CHILD0 + i])
            if child != -1:
                m, (x, y) = self._compute_mass(child)
                total += m
                cx += m * x
                cy += m * y
        if total > 0.0:
            cx /= total
            cy /= total
        node[TOTAL_MASS] = total
        node[COM_X] = cx
        node[COM_Y] = cy
        return total, (cx, cy)

    # -- traversal ---------------------------------------------------------
    def accelerations(
        self,
        positions,
        masses,
        g=G_DEFAULT,
        theta=THETA_DEFAULT,
        softening=BH_SOFTENING,
    ):
        """computeForces (project.cu:593-675) + updateAccelerations."""
        positions = np.asarray(positions, dtype=np.float64)
        masses = np.asarray(masses, dtype=np.float64)
        n = positions.shape[0]
        acc = np.zeros((n, 2), dtype=np.float64)
        nodes = self.nodes
        for i in range(n):
            px, py = positions[i]
            fx = fy = 0.0
            stack = [0]
            while stack:
                node = nodes[stack.pop()]
                node_mass = node[TOTAL_MASS]
                if node_mass <= MASS_SKIP_THRESHOLD:
                    continue
                occupant = int(node[PARTICLE_INDEX])
                is_leaf = (
                    node[CHILD0] == -1
                    and node[CHILD1] == -1
                    and node[CHILD2] == -1
                    and node[CHILD3] == -1
                )
                dx = node[COM_X] - px
                dy = node[COM_Y] - py
                d2 = dx * dx + dy * dy
                d = np.sqrt(d2) + softening
                sx = node[X_MAX] - node[X_MIN]
                sy = node[Y_MAX] - node[Y_MIN]
                node_size = sx if sx > sy else sy
                if is_leaf or (node_size / d < theta):
                    # self-skip incl. the negative max-depth encoding
                    # (project.cu:646: occ == i || (occ + 2) == -i)
                    if is_leaf and (occupant == i or (occupant + 2) == -i):
                        continue
                    force_mag = (g * masses[i] * node_mass) / d2
                    fx += force_mag * (dx / d)
                    fy += force_mag * (dy / d)
                else:
                    for c in range(4):
                        child = int(node[CHILD0 + c])
                        if child != -1:
                            stack.append(child)
            acc[i, 0] = fx / masses[i]
            acc[i, 1] = fy / masses[i]
        return acc

    # -- dump ---------------------------------------------------------------
    def dump_lines(self, positions) -> list:
        """TraverseTreeToFile (project.cu:504-534): pre-order DFS lines."""
        from ..utils.textio import cxx_ostream as g

        positions = np.asarray(positions, dtype=np.float64)
        lines = []

        def visit(node_index, depth):
            node = self.nodes[node_index]
            line = (
                f"{depth} {g(node[X_MIN])} {g(node[X_MAX])} "
                f"{g(node[Y_MIN])} {g(node[Y_MAX])} {g(node[TOTAL_MASS])}"
            )
            occupant = int(node[PARTICLE_INDEX])
            if occupant != -1:
                # occupant >= 0: a real body; occupant <= -2: single body at
                # a max-depth node, encoded as -index-2 (project.cu:376).
                # The reference prints positions[occupant] even for the
                # negative encoding (UB); we print the actual body position.
                body = occupant if occupant >= 0 else -occupant - 2
                line += (
                    f" occupantIndex={occupant}"
                    f" occupantPos=({g(positions[body][0])},"
                    f"{g(positions[body][1])})"
                )
            elif node[TOTAL_MASS] > 0:
                line += (
                    f" occupantIndex={occupant}"
                    f" occupantPos=({g(node[COM_X])},{g(node[COM_Y])})"
                )
            lines.append(line)
            for c in range(4):
                child = int(node[CHILD0 + c])
                if child != -1:
                    visit(child, depth + 1)

        visit(0, 0)
        return lines

    def __len__(self):
        return len(self.nodes)


def bh_accelerations(
    positions,
    masses,
    g=G_DEFAULT,
    theta=THETA_DEFAULT,
    max_depth=MAX_DEPTH_DEFAULT,
):
    """Build + traverse in one call (runSimulationCpu per-step shape,
    project.cu:883-907)."""
    tree = AdaptiveQuadtree(max_depth=max_depth).build(positions, masses)
    return tree.accelerations(positions, masses, g=g, theta=theta)


def simulate(
    positions,
    velocities,
    masses,
    n_steps,
    dt=1.0,
    g=G_DEFAULT,
    engine="naive",
    theta=THETA_DEFAULT,
    max_depth=MAX_DEPTH_DEFAULT,
):
    """Reference step loop in f64: force -> a -> v -> p (semi-implicit
    Euler, project.cu:883-910).  Returns the trajectory [steps+1, N, 2]."""
    p = np.array(positions, dtype=np.float64)
    v = np.array(velocities, dtype=np.float64)
    m = np.asarray(masses, dtype=np.float64)
    traj = [p.copy()]
    for _ in range(n_steps):
        if engine == "naive":
            a = naive_accelerations(p, m, g=g)
        elif engine == "barnes_hut":
            a = bh_accelerations(p, m, g=g, theta=theta, max_depth=max_depth)
        else:
            raise ValueError(f"unknown oracle engine {engine!r}")
        v += a * dt
        p += v * dt
        traj.append(p.copy())
    return np.asarray(traj)
