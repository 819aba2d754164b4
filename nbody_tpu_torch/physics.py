"""Force laws and the semi-implicit (symplectic) Euler integrator.

The same semantics as :mod:`nbody_tpu.physics` (see its docstring for the
reference lines): the naive force has no softening, the Barnes-Hut pair
factoring softens the distance only, pairs with d2 == 0 are dropped, and
the integrator is v' = v + a*dt, p' = p + v'*dt.  All engines compute
accelerations (the target mass cancels).
"""

from __future__ import annotations

import torch

from .state import SimState
from .utils.profiling import span


def _pair_weights(d2: torch.Tensor, gm: torch.Tensor,
                  softening: float) -> torch.Tensor:
    """w = gm/d^3 (softening 0) or gm/(d2*(d+eps)), 0 where d2 == 0."""
    valid = d2 > 0.0
    safe_d2 = torch.where(valid, d2, torch.ones_like(d2))
    inv_d = torch.rsqrt(safe_d2)
    if softening:
        d = safe_d2 * inv_d
        w = gm / (safe_d2 * (d + softening))
    else:
        w = gm * inv_d * inv_d * inv_d
    return torch.where(valid, w, torch.zeros_like(w))


def pair_accelerations_dense(
    positions: torch.Tensor,
    masses: torch.Tensor,
    g: float,
    softening: float = 0.0,
) -> torch.Tensor:
    """O(N^2) accelerations with a dense [N, N] intermediate (small N and
    the test oracle); the diagonal is masked."""
    disp = positions[None, :, :] - positions[:, None, :]  # [N, N, D]
    d2 = (disp * disp).sum(-1)
    eye = torch.eye(positions.shape[0], dtype=torch.bool,
                    device=positions.device)
    d2 = torch.where(eye, torch.zeros_like(d2), d2)
    w = _pair_weights(d2, masses[None, :], softening)
    return g * torch.einsum("ij,ijk->ik", w, disp)


def pair_accelerations_chunked(
    positions: torch.Tensor,
    masses: torch.Tensor,
    g: float,
    softening: float = 0.0,
    chunk: int | None = None,
) -> torch.Tensor:
    """O(N^2) accelerations ``chunk`` targets at a time (peak memory
    chunk x N) — the precision-preserving float64 route."""
    n = positions.shape[0]
    if chunk is None:
        chunk = max(128, min(n, (1 << 24) // max(n, 1)))
    out = []
    for t0 in range(0, n, chunk):
        tblock = positions[t0:t0 + chunk]
        disp = positions[None, :, :] - tblock[:, None, :]  # [C, N, D]
        w = _pair_weights((disp * disp).sum(-1), masses[None, :], softening)
        out.append(g * torch.einsum("ij,ijk->ik", w, disp))
    return torch.cat(out, dim=0)


def integrate(
    state: SimState, accelerations: torch.Tensor, dt: float, overflow=None
) -> SimState:
    """Semi-implicit Euler (project.cu:819-836); ``overflow`` (count of
    bodies whose caps overflowed) rides in the returned state.  Span:
    ``nbody.integrate``."""
    with span("nbody.integrate"):
        new_v = state.velocities + accelerations * dt
        new_p = state.positions + new_v * dt
        if overflow is None:
            overflow = torch.zeros((), dtype=torch.int32,
                                   device=state.device)
        return SimState(
            masses=state.masses,
            positions=new_p,
            velocities=new_v,
            time=state.time + dt,
            step=state.step + 1,
            overflow=overflow.to(torch.int32),
        )


def kinetic_energy(state: SimState) -> torch.Tensor:
    v2 = (state.velocities ** 2).sum(-1)
    return 0.5 * (state.masses * v2).sum()


def potential_energy(state: SimState, g: float) -> torch.Tensor:
    """Pairwise potential (diagnostic; O(N^2), use on small N)."""
    disp = state.positions[None, :, :] - state.positions[:, None, :]
    d = torch.sqrt((disp * disp).sum(-1))
    n = state.masses.shape[0]
    mm = state.masses[None, :] * state.masses[:, None]
    eye = torch.eye(n, dtype=torch.bool, device=state.device)
    mask = ~eye & (d > 0)
    pe = torch.where(mask, -g * mm / torch.where(mask, d, torch.ones_like(d)),
                     torch.zeros_like(d))
    return 0.5 * pe.sum()


def potential_per_body_chunked(
    positions: torch.Tensor,
    masses: torch.Tensor,
    g: float,
    chunk: int | None = None,
) -> torch.Tensor:
    """phi_i = sum_{j != i} -g*m_j/d_ij, ``chunk`` targets at a time
    (peak memory chunk x N): the CPU / float64 path of
    :func:`potential_energy_scalable` and the plain twin of kernel K5."""
    n = positions.shape[0]
    if chunk is None:
        chunk = max(128, min(n, (1 << 24) // max(n, 1)))
    out = []
    for t0 in range(0, n, chunk):
        disp = positions[None, :, :] - positions[t0:t0 + chunk, None, :]
        d2 = (disp * disp).sum(-1)  # [C, N]
        valid = d2 > 0.0
        inv_d = torch.rsqrt(torch.where(valid, d2, torch.ones_like(d2)))
        phi = torch.where(valid, -g * masses[None, :] * inv_d,
                          torch.zeros_like(d2))
        out.append(phi.sum(-1))
    return torch.cat(out)


def potential_energy_scalable(state: SimState, g: float) -> torch.Tensor:
    """Pairwise potential energy at any N: the dense diagnostic up to
    4,096 bodies; a CUDA state through kernel K5
    (``ops.allpairs.allpairs_potential``), in float32 (a bfloat16 state
    is evaluated in float32); a CPU state, and a float64 state on the
    card, through the chunked path: the precision route, which keeps
    float64 and bounds memory."""
    n = state.masses.shape[0]
    if n <= 4096:
        return potential_energy(state, g)
    if state.positions.is_cuda and state.dtype != torch.float64:
        from .ops.allpairs import allpairs_potential

        masses = state.masses.float()
        phi = allpairs_potential(state.positions.float(), masses, g=g)
        return 0.5 * (masses * phi).sum()
    phi = potential_per_body_chunked(state.positions, state.masses, g)
    return 0.5 * (state.masses * phi).sum()


def total_momentum(state: SimState) -> torch.Tensor:
    return (state.masses[:, None] * state.velocities).sum(0)
