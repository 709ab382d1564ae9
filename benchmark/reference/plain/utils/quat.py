"""Batched quaternion / rotation math (port of ``legged_tracking_tpu/utils/quat.py``).

Quaternion convention: ``[x, y, z, w]`` (scalar last), the Isaac Gym
convention of the reference stack.  Every function accepts ``(..., 4)``
quaternions and ``(..., 3)`` vectors and broadcasts.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-9


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def normalize(q: torch.Tensor) -> torch.Tensor:
    """Normalize the last axis to unit length."""
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=_EPS)


def quat_identity(shape=(), device="cuda") -> torch.Tensor:
    q = torch.zeros(tuple(shape) + (4,), device=device)
    q[..., 3] = 1.0
    return q


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b, both ``[x,y,z,w]``."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_apply(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by quaternion(s) q (body -> world for a body quat)."""
    xyz = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * _cross(xyz, v)
    return v + w * t + _cross(xyz, t)


def quat_rotate_inverse(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by the inverse of q (world -> body for a body quat)."""
    xyz = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * _cross(xyz, v)
    return v - w * t + _cross(xyz, t)


def quat_from_angle_axis(angle: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    """angle (...,), axis (...,3) unit -> quaternion (...,4)."""
    half = 0.5 * angle
    s = torch.sin(half)
    return torch.cat([axis * s[..., None], torch.cos(half)[..., None]], dim=-1)


def quat_from_euler_xyz(roll, pitch, yaw) -> torch.Tensor:
    """Intrinsic XYZ euler angles -> quaternion [x,y,z,w]."""
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    qx = sr * cp * cy - cr * sp * sy
    qy = cr * sp * cy + sr * cp * sy
    qz = cr * cp * sy - sr * sp * cy
    qw = cr * cp * cy + sr * sp * sy
    return torch.stack([qx, qy, qz, qw], dim=-1)


def get_euler_xyz(q: torch.Tensor):
    """Quaternion -> (roll, pitch, yaw), wrapped to [-pi, pi]."""
    qx, qy, qz, qw = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    sinr_cosp = 2.0 * (qw * qx + qy * qz)
    cosr_cosp = qw * qw - qx * qx - qy * qy + qz * qz
    roll = torch.atan2(sinr_cosp, cosr_cosp)

    sinp = 2.0 * (qw * qy - qz * qx)
    pitch = torch.where(torch.abs(sinp) >= 1.0, torch.sign(sinp) * (math.pi / 2.0),
                        torch.asin(torch.clamp(sinp, -1.0, 1.0)))

    siny_cosp = 2.0 * (qw * qz + qx * qy)
    cosy_cosp = qw * qw + qx * qx - qy * qy - qz * qz
    yaw = torch.atan2(siny_cosp, cosy_cosp)
    return roll, pitch, yaw


def quaternion_to_roll_pitch_yaw(q: torch.Tensor) -> torch.Tensor:
    """(...,4) -> (...,3) rpy in [-pi, pi] (reference math_utils.py:40-46)."""
    roll, pitch, yaw = get_euler_xyz(q)
    return wrap_to_pi(torch.stack([roll, pitch, yaw], dim=-1))


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> (...,3,3) rotation matrix (body->world)."""
    qx, qy, qz, qw = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = qx * qx, qy * qy, qz * qz
    xy, xz, yz = qx * qy, qx * qz, qy * qz
    wx, wy, wz = qw * qx, qw * qy, qw * qz
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def quat_yaw_only(q: torch.Tensor) -> torch.Tensor:
    """Zero out the x/y components and renormalize (reference quat_apply_yaw)."""
    qy = torch.cat([torch.zeros_like(q[..., :2]), q[..., 2:]], dim=-1)
    return normalize(qy)


def quat_apply_yaw(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by only the yaw component of q (math_utils.py:12-16)."""
    return quat_apply(quat_yaw_only(q), v)


def quat_apply_yaw_inverse(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by the inverse of the yaw component of q (math_utils.py:57-61)."""
    return quat_rotate_inverse(quat_yaw_only(q), v)


def quat_without_yaw(q: torch.Tensor) -> torch.Tensor:
    """Strip yaw from a quaternion via rpy (math_utils.py:48-55)."""
    rpy = quaternion_to_roll_pitch_yaw(q)
    return quat_from_euler_xyz(rpy[..., 0], rpy[..., 1], torch.zeros_like(rpy[..., 2]))


def wrap_to_pi(angles: torch.Tensor) -> torch.Tensor:
    """Wrap angles to [-pi, pi] (reference math_utils.py:20-23)."""
    a = torch.remainder(angles, 2.0 * math.pi)
    return a - 2.0 * math.pi * (a > math.pi)


def quat_integrate(q: torch.Tensor, omega_world: torch.Tensor, dt) -> torch.Tensor:
    """Integrate quaternion by world-frame angular velocity over dt.

    Uses the exponential map for exactness at large steps.
    """
    angle = torch.linalg.vector_norm(omega_world, dim=-1, keepdim=True)
    axis = omega_world / torch.clamp(angle, min=_EPS)
    dq = quat_from_angle_axis((angle * dt)[..., 0], axis)
    return normalize(quat_mul(dq, q))
