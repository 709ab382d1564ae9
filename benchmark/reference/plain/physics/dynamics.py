"""Rigid-body dynamics of the Go1 (port of ``physics/dynamics.py``).

Generalized coordinates, batched over a leading env dimension N:
    q  = (base_pos (N,3), base_quat (N,4) xyzw, qj (N,12))
    v  = [base lin vel (world), base ang vel (world), joint rates]  (N,18)

The dense composite formulation is what the reference's engine solves:

    M(q)   = sum_i  J_i^T  diag(I_i^w, m_i 1)  J_i            (18x18)
    bias   = sum_i  J_i^T  [ I_i^w a^vp_w,i + w_i x I_i^w w_i ;  m_i a^vp_u,i ]
    M qdd  = tau_gen + Q_ext + Q_gravity - bias

with the body Jacobians materialized, an explicit Gauss-Jordan inverse of M,
and the velocity-product accelerations (J̇ v) from one ``torch.func.jvp``
through the body-velocity map.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import quat
from . import kinematics

NV = 18  # 6 base + 12 joints


def _mat3_mul(A, B):
    """(..., 3, 3) @ (..., 3, 3)."""
    return torch.matmul(A, B)


def _mat3_vec(A, v):
    """(..., 3, 3) @ (..., 3)."""
    return torch.matmul(A, v[..., None])[..., 0]


def _world_inertia(R, I_body):
    """R I R^T for per-body constant inertias."""
    return _mat3_mul(_mat3_mul(R, I_body), R.transpose(-1, -2))


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


class BodyState(NamedTuple):
    """Body velocities with the Jacobians J that produced them."""
    fk: kinematics.FK
    J: torch.Tensor          # (N, nb, 6, NV)
    omega: torch.Tensor      # (N, nb, 3) world angular velocities
    u: torch.Tensor          # (N, nb, 3) world COM linear velocities


def _body_vel6(model, base_pos, base_quat, qj, v, com_offset=None):
    """Body spatial velocities J v, (N, nb, 6) [angular; linear]."""
    f = kinematics.fk(model, base_pos, base_quat, qj, com_offset)
    J = kinematics.jacobians(model, f, base_pos)
    return torch.einsum("nbik,nk->nbi", J, v)


def body_state(model, base_pos, base_quat, qj, v, com_offset=None) -> BodyState:
    f = kinematics.fk(model, base_pos, base_quat, qj, com_offset)
    J = kinematics.jacobians(model, f, base_pos)
    vel6 = torch.einsum("nbik,nk->nbi", J, v)
    return BodyState(fk=f, J=J, omega=vel6[..., :3], u=vel6[..., 3:])


class MassMatrix(NamedTuple):
    M: torch.Tensor        # (N, NV, NV)
    Minv: torch.Tensor     # (N, NV, NV) explicit inverse (spd_inverse)
    J: torch.Tensor        # (N, nb, 6, NV) Jacobians, base-COM shift applied
    mass: torch.Tensor     # (N, nb) with payload applied
    Iw: torch.Tensor       # (N, nb, 3, 3) world-frame inertias


def mass_matrix(model, bs: BodyState, payload) -> MassMatrix:
    """Composite mass matrix M = Jw^T Iw Jw + sum m Jv^T Jv + 1e-6 I and its
    explicit inverse.  payload (N,) is added to the base mass.  The base COM
    shift is folded into FK, so ``bs.J`` already carries the shifted arm (the
    JAX function's ``com_offset`` and ``base_pos`` arguments are unused)."""
    f, J = bs.fk, bs.J
    N = J.shape[0]
    mass = torch.cat([(model.mass[0] + payload)[:, None],
                      model.mass[1:].expand(N, -1)], dim=1)      # (N, nb)
    Iw = _world_inertia(f.R, model.inertia)                    # (N, nb, 3, 3)
    Jw, Jv = J[:, :, :3], J[:, :, 3:6]
    Mw = torch.einsum("nbir,nbij,nbjs->nrs", Jw, Iw, Jw)
    Mv = torch.einsum("nb,nbir,nbis->nrs", mass, Jv, Jv)
    M = Mw + Mv + torch.eye(NV, dtype=J.dtype, device=J.device) * 1e-6
    return MassMatrix(M=M, Minv=spd_inverse(M), J=J, mass=mass, Iw=Iw)


def refresh_mass_matrix(model, mm0: MassMatrix, bs: BodyState) -> MassMatrix:
    """The configuration-dependent pieces (J, Iw) of a later substep, with
    M and M^-1 kept from the control step's first substep."""
    return mm0._replace(J=bs.J, Iw=_world_inertia(bs.fk.R, model.inertia))


def forward_dynamics(model, base_pos, base_quat, qj, v, tau_j, f_ext, gravity,
                     bs: BodyState, mm: MassMatrix, com_offset=None) -> torch.Tensor:
    """Generalized accelerations (N, NV) = M^-1 rhs.  f_ext (N, nb, 6) world
    wrench [torque; force] at each body COM; gravity (N, 3)."""
    J, mass, Iw = mm.J, mm.mass, mm.Iw

    # velocity-product accelerations via jvp through the body-velocity map
    _, a_vp = torch.func.jvp(
        lambda bp, bq, qq: _body_vel6(model, bp, bq, qq, v, com_offset),
        (base_pos, base_quat, qj),
        (v[:, :3], quat_derivative(base_quat, v[:, 3:6]), v[:, 6:]))   # (N, nb, 6)
    alpha_vp, acc_vp = a_vp[..., :3], a_vp[..., 3:]

    omega = bs.omega
    n_bias = _mat3_vec(Iw, alpha_vp) + torch.linalg.cross(omega, _mat3_vec(Iw, omega), dim=-1)
    f_bias = mass[..., None] * acc_vp
    Jw, Jv = J[:, :, :3], J[:, :, 3:6]
    bias = torch.einsum("nbik,nbi->nk", Jw, n_bias) + torch.einsum("nbik,nbi->nk", Jv, f_bias)

    # gravity + external wrenches
    Q_grav = torch.einsum("nbik,nbi->nk", Jv, mass[..., None] * gravity[:, None, :])
    Q_ext = (torch.einsum("nbik,nbi->nk", Jw, f_ext[..., :3])
             + torch.einsum("nbik,nbi->nk", Jv, f_ext[..., 3:]))

    tau_gen = torch.cat([torch.zeros_like(tau_j[:, :6]), tau_j], dim=1)
    rhs = tau_gen + Q_grav + Q_ext - bias
    return torch.matmul(mm.Minv, rhs[..., None])[..., 0]
