"""Soft (penalty) contact of collision spheres vs the two-layer heightfield
(port of ``physics/contact.py``).

A compliant spring-damper normal force + impulse-capped Coulomb friction for
all 48 spheres of all envs in one batched pass.  Forces are accumulated per
*report slot* (17 = 13 bodies + 4 feet) to mirror Isaac Gym's net
``contact_forces`` tensor used by terminations and reward terms.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..terrain.heightfield import TerrainArrays, sample_window_bilinear
from .dynamics import BodyState, _mat3_vec
from .kinematics import _skew
from .model import Go1Model

# PhysX bounce_threshold_velocity (reference sim cfg :369): separations
# slower than this are treated as inelastic regardless of restitution
BOUNCE_THRESHOLD_VELOCITY = 0.5


class ContactOut(NamedTuple):
    f_ext: torch.Tensor       # (N, nb, 6) world wrench [torque; force] at body COM
    report: torch.Tensor      # (N, num_report, 3) net world contact force per slot
    sphere_pos: torch.Tensor  # (N, ns, 3) world sphere centers
    sphere_vel: torch.Tensor  # (N, ns, 3) world sphere velocities


class ContactWindow(NamedTuple):
    """The bf16 terrain window a control step samples (terrain.contact_window)."""
    table: torch.Tensor       # (T, 2, h, w) bf16 tile table
    env_tile: torch.Tensor    # (N,)
    xs: torch.Tensor          # (N,) first window row
    ys: torch.Tensor          # (N,) first window column
    PX: int
    PY: int


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def apparent_masses(model: Go1Model, bs, mm) -> torch.Tensor:
    """Per-sphere apparent inverse-mass blocks W = J_p M^-1 J_p^T (N, ns, 3, 3)
    from the dense oracle (``dynamics.body_state``, ``dynamics.mass_matrix``).
    The engine takes W from the sparse factorization
    (``sparse.apparent_masses``); this is what that is held to."""
    f = bs.fk
    N = f.p.shape[0]
    sb = model.sphere_body
    ns = sb.shape[0]
    p_s = f.p[:, sb] + _mat3_vec(f.R[:, sb], model.sphere_offset)      # (N, ns, 3)
    # point Jacobian per sphere: joint columns mask * a_k x (p_s - anchor_k),
    # base columns [I | -skew(p_s - p0)]
    r_anchor = p_s[:, :, None, :] - f.anchor_w[:, None, :, :]          # (N, ns, nd, 3)
    Jj = _cross(f.axis_w[:, None], r_anchor) * model.sphere_ancestor_mask[None, :, :, None]
    eye = torch.eye(3, dtype=p_s.dtype, device=p_s.device).expand(N, ns, 3, 3)
    Jp = torch.cat([eye, -_skew(p_s - f.p[:, :1]), Jj.transpose(2, 3)], dim=3)  # (N, ns, 3, nv)
    return torch.matmul(torch.matmul(Jp, mm.Minv[:, None]), Jp.transpose(2, 3))


def _quadform(W, v):
    """v^T W v per sphere."""
    return torch.sum(_mat3_vec(W, v) * v, dim=-1)


def contact_forces(model: Go1Model, terrain: TerrainArrays, window: ContactWindow,
                   env_terrain_origin, bs: BodyState, W, friction, restitution,
                   stiffness: float, damping: float, dt: float,
                   max_depenetration_velocity: float = 1.0) -> ContactOut:
    """Spring-damper normal + stiction-capable friction, batched over N envs.

    W (N, ns, 3, 3) apparent inverse-mass blocks; friction, restitution (N,).
    Stability at dt=5 ms comes from impulse capping with per-contact apparent
    masses m_eff = 1 / diag(J_p M^-1 J_p^T)."""
    f = bs.fk
    sb = model.sphere_body
    p_s = f.p[:, sb] + _mat3_vec(f.R[:, sb], model.sphere_offset)    # (N, ns, 3)
    r = model.sphere_radius
    rel = p_s - f.com_w[:, sb]
    v_s = bs.u[:, sb] + _cross(bs.omega[:, sb], rel)                  # (N, ns, 3)

    heights, grads = sample_window_bilinear(
        window.table, window.env_tile, window.xs, window.ys, window.PX, window.PY,
        terrain.horizontal_scale, env_terrain_origin, p_s[..., :2])   # (N,ns,2), (N,ns,2,2)
    h_ceil, h_floor = heights[..., 0], heights[..., 1]
    fric = friction[:, None]
    rest = restitution[:, None]

    def surface_force(pen, normal):
        # pen < 0 means penetrating; normal points away from the surface
        n = normal / torch.linalg.vector_norm(normal, dim=-1, keepdim=True)
        vn = torch.sum(n * v_s, dim=-1)
        active = pen < 0.0
        w_n = _quadform(W, n)
        m_eff_n = 1.0 / torch.clamp(w_n, min=1e-6)
        # spring capped at PhysX's max depenetration velocity; restitution
        # only above its bounce threshold (see the JAX module for the why)
        bouncing = vn > BOUNCE_THRESHOLD_VELOCITY
        damp = torch.minimum(damping * torch.where(bouncing, 1.0 - rest, torch.ones_like(rest)),
                             m_eff_n / dt)
        f_spring = torch.minimum(-stiffness * pen, m_eff_n * max_depenetration_velocity / dt)
        fn = torch.clamp(f_spring - damp * vn, min=0.0) * active

        vt = v_s - n * vn[..., None]
        vt_norm = torch.clamp(torch.linalg.vector_norm(vt, dim=-1), min=1e-8)
        t_dir = vt / vt_norm[..., None]
        w_t = _quadform(W, t_dir)
        m_eff_t = 1.0 / torch.clamp(w_t, min=1e-6)
        # friction: at most cancels slip velocity in one substep (stiction),
        # clamped to the Coulomb cone
        ft_mag = torch.minimum(fric * fn, m_eff_t * vt_norm / dt)
        ft = -t_dir * ft_mag[..., None]
        return n * fn[..., None] + ft

    ones = torch.ones_like(h_floor)
    # floor: surface z = h_floor, outward normal ~ (-dh/dx, -dh/dy, 1)
    pen_floor = p_s[..., 2] - r - h_floor
    n_floor = torch.stack([-grads[..., 1, 0], -grads[..., 1, 1], ones], dim=-1)
    force = surface_force(pen_floor, n_floor)

    if not terrain.is_plane:
        # ceiling SLAB z in [h_ceil, ceiling_top]: a sphere inside it is
        # pushed out of its NEAREST face (lower surface or flat top)
        pen_bot = h_ceil - (p_s[..., 2] + r)
        pen_top = (p_s[..., 2] - r) - terrain.ceiling_top
        from_below = (-pen_bot) <= (-pen_top)
        inactive = torch.full_like(pen_bot, 0.1)
        pen_bot = torch.where((pen_top < 0.0) & from_below, pen_bot, inactive)
        pen_top = torch.where((h_ceil - p_s[..., 2] - r < 0.0) & ~from_below, pen_top, inactive)
        n_ceil = torch.stack([grads[..., 0, 0], grads[..., 0, 1], -ones], dim=-1)
        force = force + surface_force(pen_bot, n_ceil)
        zeros = torch.zeros_like(pen_top)
        n_top = torch.stack([zeros, zeros, ones], dim=-1)
        force = force + surface_force(pen_top, n_top)

    # per-body wrench at COM and per-slot report: the sphere->body and
    # sphere->slot maps are static, so the sums are one-hot matmuls
    torque = _cross(p_s - f.com_w[:, sb], force)
    S_body = model.sphere_to_body                                   # (nb, ns)
    f_ext = torch.cat([torch.matmul(S_body, torque), torch.matmul(S_body, force)], dim=-1)
    report = torch.matmul(model.sphere_to_report, force)            # (nr, ns) @ (N, ns, 3)
    return ContactOut(f_ext=f_ext, report=report, sphere_pos=p_s, sphere_vel=v_s)


def joint_limit_torque(model: Go1Model, qj, qdj, stiffness: float, damping: float):
    """Penalty torques keeping joints inside their URDF limits (soft here,
    plus a position clamp at integrate)."""
    below = torch.clamp(qj - model.dof_lower, max=0.0)
    above = torch.clamp(qj - model.dof_upper, min=0.0)
    out = below + above
    tau = -stiffness * out
    tau = tau - damping * qdj * ((below < 0) & (qdj < 0))
    tau = tau - damping * qdj * ((above > 0) & (qdj > 0))
    return tau
