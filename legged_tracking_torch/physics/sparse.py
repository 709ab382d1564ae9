"""Block-sparse articulated dynamics of the quadruped (port of ``physics/sparse.py``).

The Go1 tree is a 6-dof floating base with four independent 3-dof chains, so
the 18x18 mass matrix has arrow structure

    M = [[ A   B_0  B_1  B_2  B_3 ]       A   : 6x6   base block
         [ B_0^T  D_0             ]       B_l : 6x3   base<->leg coupling
         [ B_1^T       D_1        ]       D_l : 3x3   per-leg block
         [ ...                    ]]      (cross-leg joint coupling is ZERO)

and is solved by a Schur complement on the base: four closed-form symmetric
3x3 inverses + one unrolled 6x6 inverse.  Nothing materializes the body
Jacobians: velocities, wrench projections, the velocity-product bias (one
``torch.func.jvp`` through the sparse velocity map) and the per-sphere
apparent masses all use the closed-form leg recursions.

Every function is batched over a leading env dimension N; the small matrix
products are ``torch.matmul`` in full float32 (TF32 is off, see the package
``__init__``), where the JAX package unrolls them into component arithmetic
for the TPU's vector unit — a reassociation of the same sums.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import kinematics
from .dynamics import (BodyState, _mat3_vec, _world_inertia, quat_derivative,
                       spd_inverse)
from .model import Go1Model

def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _sym3_inv(D):
    """Closed-form inverse of symmetric (..., 3, 3) blocks (adjugate/det)."""
    a, b, c = D[..., 0, 0], D[..., 0, 1], D[..., 0, 2]
    d, e, f = D[..., 1, 1], D[..., 1, 2], D[..., 2, 2]
    A = d * f - e * e
    B = c * e - b * f
    C = b * e - c * d
    det = a * A + b * B + c * C
    inv_det = 1.0 / det
    E = b * c - a * e
    F = a * d - b * b
    Dm = a * f - c * c
    row0 = torch.stack([A, B, C], dim=-1)
    row1 = torch.stack([B, Dm, E], dim=-1)
    row2 = torch.stack([C, E, F], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2) * inv_det[..., None, None]


_skew = kinematics._skew


class LegGeom(NamedTuple):
    """Per-leg chain geometry derived from FK (all world frame)."""
    axes: torch.Tensor     # (N, 4, 3, 3)  [leg, joint-level, xyz]
    k: torch.Tensor        # (N, 4, 3, 3, 3) [leg, body, joint] a_j x (c_i - anchor_j), tril-masked
    x_legs: torch.Tensor   # (N, 4, 3, 3)  c_i - p_base per leg body
    x_base: torch.Tensor   # (N, 3)        c_0 - p_base


def leg_geometry(model: Go1Model, f: kinematics.FK) -> LegGeom:
    N = f.p.shape[0]
    axes = f.axis_w.reshape(N, 4, 3, 3)
    anchors = f.anchor_w.reshape(N, 4, 3, 3)
    coms = f.com_w[:, 1:].reshape(N, 4, 3, 3)
    d = coms[:, :, :, None, :] - anchors[:, :, None, :, :]   # (N, 4, body, joint, 3)
    k = _cross(axes[:, :, None, :, :], d) * model.leg_tril[:, :, None]
    return LegGeom(axes=axes, k=k, x_legs=coms - f.p[:, 0][:, None, None, :],
                   x_base=f.com_w[:, 0] - f.p[:, 0])


def body_velocities(model: Go1Model, f: kinematics.FK, v) -> BodyState:
    """Body angular/COM-linear world velocities via the chain recursion."""
    N = v.shape[0]
    g = leg_geometry(model, f)
    u_b, w_b, qd = v[:, :3], v[:, 3:6], v[:, 6:]
    qd_l = qd.reshape(N, 4, 3)
    aq = g.axes * qd_l[..., None]                              # (N, 4, joint, 3)
    w_legs = w_b[:, None, None, :] + torch.cumsum(aq, dim=2)   # (N, 4, body, 3)
    lin_j = torch.sum(g.k * qd_l[:, :, None, :, None], dim=3)  # (N, 4, body, 3)
    u_legs = u_b[:, None, None, :] + _cross(w_b[:, None, None, :], g.x_legs) + lin_j
    omega = torch.cat([w_b[:, None], w_legs.reshape(N, 12, 3)], dim=1)
    u0 = u_b + _cross(w_b, g.x_base)
    u = torch.cat([u0[:, None], u_legs.reshape(N, 12, 3)], dim=1)
    return BodyState(fk=f, omega=omega, u=u)


class Factorization(NamedTuple):
    """Arrow-structure mass matrix blocks + Schur factorization."""
    A: torch.Tensor        # (N, 6, 6)
    B: torch.Tensor        # (N, 4, 6, 3)
    D: torch.Tensor        # (N, 4, 3, 3)
    Dinv: torch.Tensor     # (N, 4, 3, 3)
    BD: torch.Tensor       # (N, 4, 6, 3)  B @ Dinv
    Sinv: torch.Tensor     # (N, 6, 6)     (A - sum B Dinv B^T)^-1
    P_bl: torch.Tensor     # (N, 4, 6, 3)  -Sinv @ BD         (block of M^-1)
    P_ll: torch.Tensor     # (N, 4, 3, 3)  Dinv + BD^T Sinv BD (diag block of M^-1)
    mass: torch.Tensor     # (N, nb) with payload
    Iw: torch.Tensor       # (N, nb, 3, 3)


def factorize(model: Go1Model, f: kinematics.FK, payload) -> Factorization:
    """Build the arrow blocks of M (J^T blkdiag(Iw, m) J restricted to its
    nonzero support) and the Schur factorization.  payload (N,)."""
    N = f.p.shape[0]
    g = leg_geometry(model, f)
    mass = torch.cat([(model.mass[0] + payload)[:, None],
                      model.mass[1:].expand(N, -1)], dim=1)   # (N, nb)
    Iw = _world_inertia(f.R, model.inertia)                   # (N, nb, 3, 3)
    m_l = mass[:, 1:].reshape(N, 4, 3)
    Iw_l = Iw[:, 1:].reshape(N, 4, 3, 3, 3)
    x_all = f.com_w - f.p[:, :1]                              # (N, nb, 3)
    I3 = torch.eye(3, dtype=f.p.dtype, device=f.p.device)
    tril = model.leg_tril

    # ---- A (6x6): [u; w] base rows over ALL bodies ----
    m_tot = torch.sum(mass, dim=1)
    mx = torch.sum(mass[:, :, None] * x_all, dim=1)           # sum m_i x_i
    A_uu = m_tot[:, None, None] * I3
    A_uw = -_skew(mx)
    xx = torch.sum(mass[:, :, None, None] * x_all[:, :, :, None] * x_all[:, :, None, :], dim=1)
    x2 = torch.sum(mass * torch.sum(x_all * x_all, dim=-1), dim=1)
    A_ww = torch.sum(Iw, dim=1) + x2[:, None, None] * I3 - xx
    A = torch.cat([torch.cat([A_uu, A_uw], dim=2),
                   torch.cat([-A_uw, A_ww], dim=2)], dim=1) \
        + torch.eye(6, dtype=f.p.dtype, device=f.p.device) * 1e-6

    # ---- B_l (N, 4, 6, 3) ----
    km = g.k * m_l[:, :, :, None, None]                       # (N, 4, body, joint, 3)
    B_u = torch.sum(km, dim=2).transpose(2, 3)                # (N, 4, 3, joint)
    # Iw_i a_j: (N, 4, body, joint, 3)
    Iwa_full = torch.einsum("nlbij,nltj->nlbti", Iw_l, g.axes)
    Iwa = Iwa_full * tril[:, :, None]                         # i >= j only
    xk = _cross(g.x_legs[:, :, :, None, :], km)               # m_i x_i x k_ij
    B_w = torch.sum(Iwa + xk, dim=2).transpose(2, 3)          # (N, 4, 3, joint)
    B = torch.cat([B_u, B_w], dim=2)                          # (N, 4, 6, 3)

    # ---- D_l (N, 4, 3, 3) ----
    # D[j,t] = sum_{i >= max(j,t)} a_j . Iw_i a_t + m_i k_ij . k_it
    rows = []
    for j in range(3):
        cols = []
        for t in range(3):
            lo = max(j, t)
            ang = sum(torch.sum(g.axes[:, :, j] * Iwa_full[:, :, i, t], dim=-1)
                      for i in range(lo, 3))
            lin = sum(m_l[:, :, i] * torch.sum(g.k[:, :, i, j] * g.k[:, :, i, t], dim=-1)
                      for i in range(lo, 3))
            cols.append(ang + lin)
        rows.append(torch.stack(cols, dim=-1))
    D = torch.stack(rows, dim=-2) + I3 * 1e-6                 # (N, 4, 3, 3)

    Dinv = _sym3_inv(D)
    BD = torch.matmul(B, Dinv)                                # (N, 4, 6, 3)
    S = A - torch.sum(torch.matmul(BD, B.transpose(2, 3)), dim=1)
    Sinv = spd_inverse(S)
    SBD = torch.matmul(Sinv[:, None], BD)                     # (N, 4, 6, 3)
    P_bl = -SBD
    P_ll = Dinv + torch.matmul(BD.transpose(2, 3), SBD)
    return Factorization(A=A, B=B, D=D, Dinv=Dinv, BD=BD, Sinv=Sinv,
                         P_bl=P_bl, P_ll=P_ll, mass=mass, Iw=Iw)


def solve(fac: Factorization, rhs) -> torch.Tensor:
    """M^-1 @ rhs via the Schur factorization.  rhs (N,18) -> qdd (N,18)."""
    N = rhs.shape[0]
    r_b, r_q = rhs[:, :6], rhs[:, 6:].reshape(N, 4, 3)
    t = _mat3_vec(fac.Dinv, r_q)                              # (N, 4, 3)
    r_b2 = r_b - torch.sum(torch.matmul(fac.B, t[..., None])[..., 0], dim=1)
    acc_b = torch.matmul(fac.Sinv, r_b2[..., None])[..., 0]
    qdd_l = t - torch.matmul(fac.BD.transpose(2, 3), acc_b[:, None, :, None])[..., 0]
    return torch.cat([acc_b, qdd_l.reshape(N, 12)], dim=1)


def project(model: Go1Model, g: LegGeom, n_i, f_i) -> torch.Tensor:
    """Generalized force of per-body world wrenches [n_i; f_i] at body COMs:
    Q = sum_i J_i^T [n_i; f_i] without J.  n_i, f_i (N, nb, 3) -> (N, 18)."""
    N = n_i.shape[0]
    x_all = torch.cat([g.x_base[:, None], g.x_legs.reshape(N, 12, 3)], dim=1)
    Q_u = torch.sum(f_i, dim=1)
    Q_w = torch.sum(n_i + _cross(x_all, f_i), dim=1)
    n_l = n_i[:, 1:].reshape(N, 4, 3, 3)
    f_l = f_i[:, 1:].reshape(N, 4, 3, 3)
    # Q_j = sum_{i>=j} a_j . n_i + k_ij . f_i
    ang = torch.sum(g.axes[:, :, None, :, :] * n_l[:, :, :, None, :], dim=-1)  # (N, 4, body, joint)
    lin = torch.sum(g.k * f_l[:, :, :, None, :], dim=-1)                      # (N, 4, body, joint)
    Q_q = torch.sum(ang * model.leg_tril + lin, dim=2)                       # (N, 4, joint)
    return torch.cat([Q_u, Q_w, Q_q.reshape(N, 12)], dim=1)


def velocity_jvp(model: Go1Model, base_pos, base_quat, qj, v, com_offset=None):
    """ONE fused primal+tangent pass: FK, body velocities, and the
    velocity-product accelerations (J̇v) via ``torch.func.jvp`` through the
    sparse velocity map.  The primal outputs ARE the substep's FK/velocities."""
    qdot_pos = v[:, :3]
    qdot_quat = quat_derivative(base_quat, v[:, 3:6])
    qdot_j = v[:, 6:]

    def vel_map(bp, bq, qq):
        f = kinematics.fk(model, bp, bq, qq, com_offset)
        st = body_velocities(model, f, v)
        return tuple(f) + (st.omega, st.u)

    out, tangent = torch.func.jvp(
        vel_map, (base_pos, base_quat, qj), (qdot_pos, qdot_quat, qdot_j))
    f = kinematics.FK(*out[:5])
    bs = BodyState(fk=f, omega=out[5], u=out[6])
    return bs, tangent[5], tangent[6]


def forward_dynamics(model: Go1Model, base_pos, base_quat, qj, v, tau_j, f_ext,
                     gravity, bs: BodyState, fac: Factorization,
                     com_offset=None, vp=None) -> torch.Tensor:
    """Generalized accelerations (N, 18).  f_ext (N, nb, 6) world wrench
    [torque; force] at each body COM; gravity (N, 3); ``vp`` the optional
    precomputed (alpha_vp, acc_vp) of :func:`velocity_jvp`."""
    g = leg_geometry(model, bs.fk)
    if vp is None:
        _, alpha_vp, acc_vp = velocity_jvp(model, base_pos, base_quat, qj, v, com_offset)
    else:
        alpha_vp, acc_vp = vp

    omega = bs.omega
    n_bias = _mat3_vec(fac.Iw, alpha_vp) + _cross(omega, _mat3_vec(fac.Iw, omega))
    f_bias = fac.mass[:, :, None] * acc_vp
    Q_bias = project(model, g, n_bias, f_bias)

    f_grav = fac.mass[:, :, None] * gravity[:, None, :]
    Q_grav = project(model, g, torch.zeros_like(f_grav), f_grav)
    Q_ext = project(model, g, f_ext[..., :3], f_ext[..., 3:])

    tau_gen = torch.cat([torch.zeros_like(tau_j[:, :6]), tau_j], dim=1)
    rhs = tau_gen + Q_grav + Q_ext - Q_bias
    return solve(fac, rhs)


def apparent_masses(model: Go1Model, f: kinematics.FK, fac: Factorization) -> torch.Tensor:
    """Per-sphere W = J_p M^-1 J_p^T (N, ns, 3, 3) from the block inverse."""
    N = f.p.shape[0]
    sb = model.sphere_body
    ns = sb.shape[0]
    p_s = f.p[:, sb] + _mat3_vec(f.R[:, sb], model.sphere_offset)
    r0 = p_s - f.p[:, :1]
    eye = torch.eye(3, dtype=p_s.dtype, device=p_s.device).expand(N, ns, 3, 3)
    G_b = torch.cat([eye, -_skew(r0)], dim=-1)                # (N, ns, 3, 6)

    leg_s = model.sphere_leg
    axes_s = f.axis_w.reshape(N, 4, 3, 3)[:, leg_s]           # (N, ns, joint, 3)
    anchors_s = f.anchor_w.reshape(N, 4, 3, 3)[:, leg_s]
    # per-leg columns of the sphere's ancestor joints (mask zeroes base
    # spheres and joints below the sphere's body)
    mask = model.sphere_leg_mask                              # (ns, 3)
    Gj = _cross(axes_s, p_s[:, :, None, :] - anchors_s) * mask[None, :, :, None]
    G_l = Gj.transpose(-1, -2)                                # (N, ns, 3, joint)

    G_bT = G_b.transpose(-1, -2)
    G_lT = G_l.transpose(-1, -2)
    W = torch.matmul(torch.matmul(G_b, fac.Sinv[:, None]), G_bT)
    cross_bl = torch.matmul(torch.matmul(G_b, fac.P_bl[:, leg_s]), G_lT)
    W = W + cross_bl + cross_bl.transpose(-1, -2)
    W = W + torch.matmul(torch.matmul(G_l, fac.P_ll[:, leg_s]), G_lT)
    return W
