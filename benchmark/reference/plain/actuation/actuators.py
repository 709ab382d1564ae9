"""Torque models: PD controller and the Go1 actuator network (port of
``actuation/actuators.py``).

Action scaling with hip reduction, a per-substep action lag buffer (DR), then
either a PD law or the learned actuator net (softsign MLP 6->32->32->1 from
``assets/actuator_nets/unitree_go1.npz``), motor-strength scaling and torque
clipping.  Everything is batched over a leading env dimension N.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

_ASSET_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "assets", "actuator_nets")


def load_actuator_net(name: str = "unitree_go1", device="cuda") -> "ActuatorNet":
    """The actuator net of ``assets/actuator_nets/<name>.npz`` as a module."""
    d = np.load(os.path.join(_ASSET_DIR, f"{name}.npz"))
    return ActuatorNet.from_arrays({k: d[k] for k in ("w0", "b0", "w1", "b1", "w2", "b2")},
                                   device=device)


class ActuatorNet(nn.Module):
    """x (..., 12, 6) = (q_err, q_err_last, q_err_last2, qd, qd_last, qd_last2)
    -> torque (..., 12): softsign MLP 6->32->32->1."""

    def __init__(self):
        super().__init__()
        self.l0 = nn.Linear(6, 32)
        self.l1 = nn.Linear(32, 32)
        self.l2 = nn.Linear(32, 1)

    @classmethod
    def from_arrays(cls, arrays, device="cuda") -> "ActuatorNet":
        """Weights (out, in) and biases as in the npz file (``x @ w.T + b``)."""
        net = cls()
        with torch.no_grad():
            for i, layer in enumerate((net.l0, net.l1, net.l2)):
                layer.weight.copy_(torch.as_tensor(np.asarray(arrays[f"w{i}"], np.float32)))
                layer.bias.copy_(torch.as_tensor(np.asarray(arrays[f"b{i}"], np.float32)))
        return net.to(device).requires_grad_(False)

    def forward(self, x):
        h = nn.functional.softsign(self.l0(x))
        h = nn.functional.softsign(self.l1(h))
        return self.l2(h)[..., 0]


def actuator_net_torque(net: ActuatorNet, x: torch.Tensor) -> torch.Tensor:
    return net(x)


class ActuatorState(NamedTuple):
    """Per-env actuator memory (folded into EnvState), batched over N."""
    lag_buffer: torch.Tensor          # (N, lag+1, 12) scaled-action delay line
    joint_pos_err_last: torch.Tensor  # (N, 12)
    joint_pos_err_last2: torch.Tensor
    joint_vel_last: torch.Tensor
    joint_vel_last2: torch.Tensor
    joint_pos_target: torch.Tensor    # (N, 12) current PD target (for rewards)


def init_actuator_state(lag_timesteps: int, num_envs: int, device="cuda") -> ActuatorState:
    z = lambda: torch.zeros(num_envs, 12, device=device)
    return ActuatorState(
        lag_buffer=torch.zeros(num_envs, lag_timesteps + 1, 12, device=device),
        joint_pos_err_last=z(), joint_pos_err_last2=z(),
        joint_vel_last=z(), joint_vel_last2=z(),
        joint_pos_target=z(),
    )


def scale_actions(actions, action_scale: float, hip_scale_reduction: float):
    """action -> scaled joint-angle offsets, hips scaled down
    (legged_robot_trajectory_tracking.py:969-970). Hip dofs are 0,3,6,9."""
    scaled = actions[..., :12] * action_scale
    hip_mask = torch.zeros(12, dtype=scaled.dtype, device=scaled.device)
    hip_mask[[0, 3, 6, 9]] = 1.0
    return scaled * (1.0 + (hip_scale_reduction - 1.0) * hip_mask)


def make_torque_fn(control_type: str, net: ActuatorNet, default_dof_pos, p_gain: float,
                   d_gain: float, torque_limits, randomize_lag: bool):
    """Per-substep torque function of engine.control_step.

    The carry is (ActuatorState, motor_strength, motor_offset, kp_factor,
    kd_factor, actions_scaled), all batched over N."""
    if control_type not in ("actuator_net", "P"):
        raise NameError(f"Unknown controller type: {control_type}")

    def torque_fn(qj, qdj, carry):
        st, motor_strength, motor_offset, kp_f, kd_f, actions_scaled = carry
        if randomize_lag:
            lag = torch.cat([st.lag_buffer[:, 1:], actions_scaled[:, None]], dim=1)
            target = lag[:, 0] + default_dof_pos
        else:
            lag = st.lag_buffer
            target = actions_scaled + default_dof_pos

        if control_type == "actuator_net":
            q_err = qj - target + motor_offset
            x = torch.stack([q_err, st.joint_pos_err_last, st.joint_pos_err_last2,
                             qdj, st.joint_vel_last, st.joint_vel_last2], dim=-1)  # (N, 12, 6)
            tau = net(x)
            st = st._replace(joint_pos_err_last2=st.joint_pos_err_last,
                             joint_pos_err_last=q_err,
                             joint_vel_last2=st.joint_vel_last,
                             joint_vel_last=qdj)
        else:
            tau = p_gain * kp_f * (target - qj + motor_offset) - d_gain * kd_f * qdj

        tau = tau * motor_strength
        tau = torch.clamp(tau, -torque_limits, torque_limits)
        st = st._replace(lag_buffer=lag, joint_pos_target=target)
        return tau, (st, motor_strength, motor_offset, kp_f, kd_f, actions_scaled)

    return torque_fn
