"""Offline evaluation metrics (port of ``learn/eval_metrics.py``).

Port of ``go1_gym_learn/eval_metrics/metrics.py``: velocity-tracking RMSDs,
base height, torque/power statistics, cost of transport, Froude number, and
adaptation loss, as plain functions of the port's :class:`EnvState`.

The JAX package's eval entry calls these eagerly, one operation at a time,
not under ``jit``.  So the port follows the eager arithmetic, not the
compiled one the env follows: a true division where the source divides
(the divisor a tensor, since on the card a division by a host scalar is a
multiply by its reciprocal), no fused multiply-add, and a sum over the
joints added left to right, as XLA's CPU reduction adds.  The one compiled
unit in the chain is ``jnp.linalg.norm``, a jitted function of its own: its
two squares are added as a fused multiply-add.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import quat as qt
from ..utils.math import fma

GO1_MASS = 11.309932  # kg, sum of URDF link masses


def _base_vels(state):
    blv = qt.quat_rotate_inverse(state.phys.base_quat, state.phys.v[:, :3])
    bav = qt.quat_rotate_inverse(state.phys.base_quat, state.phys.v[:, 3:6])
    return blv, bav


def _command(state, i):
    """Command ``i`` of each env.  A JAX index past the end clamps to the
    last column: the tunnel task's 2 xy commands give column 1 for 2."""
    return state.commands[:, min(i, state.commands.shape[1] - 1)]


def _sqrt(x):
    """The correctly rounded float32 square root.  torch's float32 sqrt on
    the CPU is not (its vector path misses by an ulp on some inputs); the
    float64 root rounded to float32 is."""
    return torch.sqrt(x.double()).float()


def _sum_joints(x):
    """Sum over the last axis, left to right."""
    s = x[..., 0]
    for i in range(1, x.shape[-1]):
        s = s + x[..., i]
    return s


def lin_vel_rmsd(state):
    blv, _ = _base_vels(state)
    d = blv[:, 0] - _command(state, 0)
    return _sqrt(d * d)


def ang_vel_rmsd(state):
    _, bav = _base_vels(state)
    d = bav[:, 2] - _command(state, 2)
    return _sqrt(d * d)


def lin_vel_x(state):
    return _base_vels(state)[0][:, 0]


def ang_vel_yaw(state):
    return _base_vels(state)[1][:, 2]


def base_height(state):
    return state.phys.base_pos[:, 2]


def max_torques(state):
    return torch.amax(torch.abs(state.torques), dim=1)


def power_consumption(state):
    return _sum_joints(state.torques * state.phys.v[:, 6:])


def cost_of_transport(state):
    """P / (m g v) (reference metrics.py:41-48); infinite where v is 0."""
    P = power_consumption(state)
    m = state.payload + np.float32(GO1_MASS)
    blv, _ = _base_vels(state)
    v = _sqrt(fma(blv[:, 1], blv[:, 1], blv[:, 0] * blv[:, 0]))
    return P / (m * np.float32(9.8) * v)


def froude_number(state, h: float = 0.30):
    v = lin_vel_x(state)
    return v * v / torch.full_like(v, 9.8 * h)


def adaptation_loss(ac, obs_dict):
    """Per-env mean squared error of the adaptation module's estimate
    against its target (the privileged obs, or the RMA encoder's latent)."""
    with torch.no_grad():
        pred = ac.adapt(obs_dict["obs_history"].float())
        target = ac.adaptation_target(obs_dict["privileged_obs"])
        d = pred - target
        return torch.mean(d * d, dim=1)


METRICS_FNS = {
    "lin_vel_rmsd": lin_vel_rmsd,
    "ang_vel_rmsd": ang_vel_rmsd,
    "lin_vel_x": lin_vel_x,
    "ang_vel_yaw": ang_vel_yaw,
    "base_height": base_height,
    "max_torques": max_torques,
    "power_consumption": power_consumption,
    "CoT": cost_of_transport,
    "froude_number": froude_number,
}
