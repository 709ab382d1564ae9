"""Shared rigid-body pieces of the Go1 dynamics (port of ``physics/dynamics.py``).

Generalized coordinates, batched over a leading env dimension N:
    q  = (base_pos (N,3), base_quat (N,4) xyzw, qj (N,12))
    v  = [base lin vel (world), base ang vel (world), joint rates]  (N,18)

Only the pieces the arrow-structure solver of ``sparse.py`` uses are ported;
the dense mass-matrix path of the JAX package is left out.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import quat
from . import kinematics


def _mat3_mul(A, B):
    """(..., 3, 3) @ (..., 3, 3)."""
    return torch.matmul(A, B)


def _mat3_vec(A, v):
    """(..., 3, 3) @ (..., 3)."""
    return torch.matmul(A, v[..., None])[..., 0]


def _world_inertia(R, I_body):
    """R I R^T for per-body constant inertias."""
    return _mat3_mul(_mat3_mul(R, I_body), R.transpose(-1, -2))


class BodyState(NamedTuple):
    fk: kinematics.FK
    omega: torch.Tensor      # (N, nb, 3) world angular velocities
    u: torch.Tensor          # (N, nb, 3) world COM linear velocities


def quat_derivative(base_quat, omega_world):
    """q̇ = 0.5 * [w, 0] ⊗ q for world-frame angular velocity (xyzw)."""
    wq = torch.cat([omega_world, torch.zeros_like(omega_world[..., :1])], dim=-1)
    return 0.5 * quat.quat_mul(wq, base_quat)


def spd_inverse(M: torch.Tensor) -> torch.Tensor:
    """Explicit inverse of a small SPD matrix via unrolled Gauss-Jordan (no
    pivoting is needed for the regularized SPD blocks it inverts)."""
    n = M.shape[-1]
    eye = torch.eye(n, dtype=M.dtype, device=M.device).expand(M.shape)
    A = torch.cat([M, eye], dim=-1)
    for i in range(n):
        row = A[..., i, :] / A[..., i, i:i + 1]
        A = A - A[..., :, i:i + 1] * row[..., None, :]
        A[..., i, :] = row
    return A[..., :, n:]


def integrate(base_pos, base_quat, qj, v, qdd, dt):
    """Semi-implicit Euler: velocities first, then positions."""
    v_new = v + qdd * dt
    base_pos_new = base_pos + v_new[:, :3] * dt
    base_quat_new = quat.quat_integrate(base_quat, v_new[:, 3:6], dt)
    qj_new = qj + v_new[:, 6:] * dt
    return base_pos_new, base_quat_new, qj_new, v_new
