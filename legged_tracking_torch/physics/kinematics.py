"""Forward kinematics and world-frame Jacobians for the Go1 tree (port of
``physics/kinematics.py``).

Batched over a leading env dimension N (the JAX function is single-env and
vmapped).  The tree has exactly 3 joint levels below the floating base (hips,
thighs, calves, 4 legs each), so FK unrolls into 3 batched level updates.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import quat
from .model import Go1Model


class FK(NamedTuple):
    R: torch.Tensor         # (N, nb, 3, 3) body->world rotations
    p: torch.Tensor         # (N, nb, 3) body-frame origins (== joint anchors) in world
    com_w: torch.Tensor     # (N, nb, 3) body COMs in world
    axis_w: torch.Tensor    # (N, nd, 3) joint axes in world
    anchor_w: torch.Tensor  # (N, nd, 3) joint anchor positions in world


def fk(model: Go1Model, base_pos, base_quat, qj, base_com_offset=None) -> FK:
    """base_pos (N,3), base_quat (N,4) xyzw, qj (N,12) -> FK.

    base_com_offset (N,3): DR displacement of the base COM, folded in here."""
    N = base_pos.shape[0]
    Rb = quat.quat_to_matrix(base_quat)                       # (N,3,3)
    Rs = [Rb[:, None]]
    ps = [base_pos[:, None]]
    R_prev = Rb[:, None].expand(N, 4, 3, 3)
    p_prev = base_pos[:, None].expand(N, 4, 3)
    for level in range(3):   # model.py's LEVEL_BODIES, by their device twins
        angles = qj[:, model.level_dofs[level]]                # (N,4)
        jp = model.joint_pos[model.level_bodies[level]]        # (4,3)
        p_new = p_prev + torch.einsum("nlij,lj->nli", R_prev, jp)
        # Go1 joints are axis-aligned (hips about X, thighs/calves about Y),
        # so R_prev @ R_axis(q) is two column updates
        c = torch.cos(angles)[..., None]
        s = torch.sin(angles)[..., None]
        col0, col1, col2 = R_prev[..., 0], R_prev[..., 1], R_prev[..., 2]
        if level == 0:   # hip: rotation about local X
            R_new = torch.stack([col0, c * col1 + s * col2, -s * col1 + c * col2], dim=-1)
        else:            # thigh/calf: rotation about local Y
            R_new = torch.stack([c * col0 - s * col2, col1, s * col0 + c * col2], dim=-1)
        Rs.append(R_new)
        ps.append(p_new)
        R_prev, p_prev = R_new, p_new
    perm = model.stack_to_body
    R = torch.cat(Rs, dim=1)[:, perm]                         # (N,13,3,3)
    p = torch.cat(ps, dim=1)[:, perm]
    com = model.com.expand(N, -1, -1)
    if base_com_offset is not None:
        com = torch.cat([com[:, :1] + base_com_offset[:, None], com[:, 1:]], dim=1)
    com_w = p + torch.einsum("nbij,nbj->nbi", R, com)
    axis_w = torch.einsum("nbij,bj->nbi", R[:, 1:], model.joint_axis[1:])  # (N,12,3)
    anchor_w = p[:, 1:]
    return FK(R=R, p=p, com_w=com_w, axis_w=axis_w, anchor_w=anchor_w)


def jacobians(model: Go1Model, f: FK, base_pos) -> torch.Tensor:
    """World-frame 6D Jacobians at each body's COM, (N, nb, 6, 6+nd).

    Rows 0:3 angular, 3:6 linear; columns 0:3 base linear velocity (world),
    3:6 base angular velocity (world), 6: joint rates, so that the body
    spatial velocity [w_i; u_i] = J_i @ v.  Only the dense oracle
    (``dynamics.body_state``) builds them; the engine's sparse path never
    materializes J."""
    N = base_pos.shape[0]
    nb = model.num_bodies
    mask = model.ancestor_mask                                   # (nb, nd)
    eye = torch.eye(3, dtype=base_pos.dtype, device=base_pos.device).expand(N, nb, 3, 3)

    # angular rows: d w_i / d w_base = I, joint columns the ancestor axes
    Jw_joint = f.axis_w.transpose(1, 2)[:, None] * mask[None, :, None, :]  # (N, nb, 3, nd)

    # linear rows: d u_i / d w_base = -skew(c_i - p_base), joint columns a_j x (c_i - anchor_j)
    Jv_wbase = -_skew(f.com_w - base_pos[:, None])
    r_joint = f.com_w[:, :, None, :] - f.anchor_w[:, None, :, :]          # (N, nb, nd, 3)
    axes = f.axis_w[:, None].expand_as(r_joint)
    Jv_joint = torch.linalg.cross(axes, r_joint, dim=-1) * mask[None, :, :, None]
    J_ang = torch.cat([torch.zeros_like(eye), eye, Jw_joint], dim=3)
    J_lin = torch.cat([eye, Jv_wbase, Jv_joint.transpose(2, 3)], dim=3)
    return torch.cat([J_ang, J_lin], dim=2)


def _skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrices."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))
