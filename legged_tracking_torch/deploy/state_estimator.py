"""On-robot state estimator: LCM subscriber + command mode machine (a copy
of ``legged_tracking_tpu/deploy/state_estimator.py``).

Port of ``go1_gym_deploy/utils/cheetah_state_estimator.py`` (StateEstimator,
:51-397): subscribes leg data / IMU / RC topics, maintains joint state with
the SDK->sim leg remap ``joint_idxs``, smoothed body angular velocity, gravity
vector, contact states, and the RC-stick command mode machine (get_command,
:152-280).  Camera decoding is provided as raw-buffer hooks.

The SLAM hook (get_xy_yaw) returns zeros exactly like the reference (:148-150,
flagged unimplemented in its README:33-36).
"""

from __future__ import annotations

import time

import numpy as np

from .lcm_types import (camera_message_lcmt, camera_message_rect_wide,
                        leg_control_data_lcmt, rc_command_lcmt, state_estimator_lcmt)


def _rpy_to_R(rpy):
    r, p, y = rpy
    cr, sr, cp, sp, cy, sy = np.cos(r), np.sin(r), np.cos(p), np.sin(p), np.cos(y), np.sin(y)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return Rz @ Ry @ Rx


class StateEstimator:
    # SDK leg order FR,FL,RR,RL <-> sim order remap (reference :55)
    joint_idxs = [3, 4, 5, 0, 1, 2, 9, 10, 11, 6, 7, 8]
    contact_idxs = [1, 0, 3, 2]

    def __init__(self, lc, use_cameras: bool = False):
        self.lc = lc
        self.joint_pos = np.zeros(12)
        self.joint_vel = np.zeros(12)
        self.tau_est = np.zeros(12)
        self.world_lin_vel = np.zeros(3)
        self.world_ang_vel = np.zeros(3)
        self.euler = np.zeros(3)
        self.R = np.eye(3)
        self.contact_state = np.ones(4)
        self.body_lin_vel = np.zeros(3)
        self.body_ang_vel = np.zeros(3)
        self.smoothing_length = 12
        self.smoothing_ratio = 0.2
        self.deuler_history = np.zeros((self.smoothing_length, 3))
        self.dt_history = np.ones((self.smoothing_length, 1)) * 1e-3
        self.euler_prev = np.zeros(3)
        self.timuprev = time.time()
        self.buf_idx = 0
        self.body_loc = np.zeros(3)
        self.body_quat = np.array([0.0, 0.0, 0.0, 1.0])
        self.received_first_legdata = False

        # RC state
        self.mode = 0
        self.ctrlmode_left = 0
        self.ctrlmode_right = 0
        self.left_stick = [0.0, 0.0]
        self.right_stick = [0.0, 0.0]
        for sw in ("left_upper", "left_lower_left", "left_lower_right",
                   "right_upper", "right_lower_left", "right_lower_right"):
            setattr(self, f"{sw}_switch", 0)
            setattr(self, f"{sw}_switch_pressed", 0)
        self.cmd_freq, self.cmd_phase = 3.0, 0.5
        self.cmd_offset, self.cmd_bound, self.cmd_duration = 0.0, 0.0, 0.5

        lc.subscribe("state_estimator_data", self._imu_cb)
        lc.subscribe("leg_control_data", self._legdata_cb)
        lc.subscribe("rc_command", self._rc_command_cb)
        # 5-camera pipeline (reference :113-119): raw fisheye frames on
        # camera{1..5}, rectified crops on rect_image_{name}
        self.camera_names = ["front", "bottom", "left", "right", "rear"]
        for name in self.camera_names:
            setattr(self, f"camera_image_{name}", None)
        if use_cameras:
            for cam_id in [1, 2, 3, 4, 5]:
                lc.subscribe(f"camera{cam_id}", self._camera_cb)
            for name in self.camera_names:
                lc.subscribe(f"rect_image_{name}", self._rect_camera_cb)

    # ---------------------------------------------------------------- reads
    def get_dof_pos(self):
        return self.joint_pos[self.joint_idxs]

    def get_dof_vel(self):
        return self.joint_vel[self.joint_idxs]

    def get_body_linear_vel(self):
        self.body_lin_vel = self.R.T @ self.world_lin_vel
        return self.body_lin_vel

    def get_body_angular_vel(self):
        inst = np.mean(self.deuler_history / self.dt_history, axis=0)
        self.body_ang_vel = (self.smoothing_ratio * inst
                             + (1 - self.smoothing_ratio) * self.body_ang_vel)
        return self.body_ang_vel

    def get_gravity_vector(self):
        return self.R.T @ np.array([0.0, 0.0, -1.0])

    def get_contact_state(self):
        return self.contact_state[self.contact_idxs]

    def get_rpy(self):
        return self.euler

    def get_yaw(self):
        return np.asarray([self.euler[2]])

    def get_xy_yaw(self):
        # ----------- SLAM hook (unimplemented, as in the reference) --------
        return np.array([0.0, 0.0]), 0.0

    # -------------------------------------------------------------- command
    def get_command(self):
        """RC sticks -> 15-dim walk-these-ways command (reference :152-280)."""
        modes_left = ["body_height", "lat_vel", "stance_width"]
        modes_right = ["step_frequency", "footswing_height", "body_pitch"]
        if self.left_upper_switch_pressed:
            self.ctrlmode_left = (self.ctrlmode_left + 1) % 3
            self.left_upper_switch_pressed = 0
        if self.right_upper_switch_pressed:
            self.ctrlmode_right = (self.ctrlmode_right + 1) % 3
            self.right_upper_switch_pressed = 0
        mode_left = modes_left[self.ctrlmode_left]
        mode_right = modes_right[self.ctrlmode_right]

        cmd_x = 1.0 * self.left_stick[1]
        cmd_yaw = -1.0 * self.right_stick[0]
        cmd_y, cmd_height, cmd_freq = 0.0, 0.0, 3.0
        cmd_footswing, cmd_stance_width, cmd_stance_length = 0.08, 0.33, 0.40
        cmd_ori_pitch = cmd_ori_roll = 0.0
        if mode_left == "body_height":
            cmd_height = 0.3 * self.left_stick[0]
        elif mode_left == "lat_vel":
            cmd_y = 0.6 * self.left_stick[0]
        elif mode_left == "stance_width":
            cmd_stance_width = 0.275 + 0.175 * self.left_stick[0]
        if mode_right == "step_frequency":
            cmd_freq = (1 + self.right_stick[1]) / 2 * 2.0 + 2.0
        elif mode_right == "footswing_height":
            cmd_footswing = max(0, self.right_stick[1]) * 0.32 + 0.03
        elif mode_right == "body_pitch":
            cmd_ori_pitch = -0.4 * self.right_stick[1]

        # gait selection by RC mode buttons (trot/pronk/pace/bound)
        gaits = {0: (0.5, 0.0, 0.0), 1: (0.0, 0.0, 0.0),
                 2: (0.0, 0.5, 0.0), 3: (0.0, 0.0, 0.5)}
        self.cmd_phase, self.cmd_offset, self.cmd_bound = gaits.get(
            self.mode % 4, (0.5, 0.0, 0.0))

        return np.array([cmd_x, cmd_y, cmd_yaw, cmd_height, cmd_freq,
                         self.cmd_phase, self.cmd_offset, self.cmd_bound,
                         self.cmd_duration, cmd_footswing, cmd_ori_pitch,
                         cmd_ori_roll, cmd_stance_width, cmd_stance_length, 0.0])

    # ------------------------------------------------------------ callbacks
    def _legdata_cb(self, channel, data):
        msg = leg_control_data_lcmt.decode(data)
        if not self.received_first_legdata:
            self.received_first_legdata = True
        self.joint_pos = np.array(msg.q)
        self.joint_vel = np.array(msg.qd)
        self.tau_est = np.array(msg.tau_est)

    def _imu_cb(self, channel, data):
        msg = state_estimator_lcmt.decode(data)
        self.euler = np.array(msg.rpy)
        self.R = _rpy_to_R(self.euler)
        self.contact_state = 1.0 * (np.array(msg.contact_estimate) > 200)
        now = time.time()
        self.deuler_history[self.buf_idx] = self.euler - self.euler_prev
        self.dt_history[self.buf_idx] = max(now - self.timuprev, 1e-4)
        self.buf_idx = (self.buf_idx + 1) % self.smoothing_length
        self.timuprev = now
        self.euler_prev = self.euler.copy()
        self.world_ang_vel = np.array(msg.omegaWorld)

    def _rc_command_cb(self, channel, data):
        msg = rc_command_lcmt.decode(data)
        for sw in ("left_upper", "left_lower_left", "left_lower_right",
                   "right_upper", "right_lower_left", "right_lower_right"):
            new = getattr(msg, f"{sw}_switch")
            if getattr(self, f"{sw}_switch") == 0 and new == 1:
                setattr(self, f"{sw}_switch_pressed", 1)
            setattr(self, f"{sw}_switch", new)
        self.mode = msg.mode
        self.left_stick = list(msg.left_stick)
        self.right_stick = list(msg.right_stick)

    def _camera_cb(self, channel, data):
        """Raw fisheye decode (reference _camera_cb, :322-346): 3x200x464
        uint8 -> (200, 464, 3) HWC image, slot keyed by the channel digit."""
        msg = camera_message_lcmt.decode(data)
        img = np.frombuffer(msg.data, dtype=np.uint8)
        img = img.reshape((3, 200, 464)).transpose(1, 2, 0)
        cam_id = int(channel[-1])
        if 1 <= cam_id <= 5:
            setattr(self, f"camera_image_{self.camera_names[cam_id - 1]}", img)
        else:
            print("Image received from camera with unknown ID#!")

    def _rect_camera_cb(self, channel, data):
        """Rectified-wide decode (reference _rect_camera_cb, :348-377):
        3x100x116 uint8, flipped on the first two axes -> (100, 116, 3)."""
        msg = camera_message_rect_wide.decode(data)
        img = np.frombuffer(msg.data, dtype=np.uint8)
        img = np.flip(np.flip(img.reshape((3, 100, 116)), axis=0),
                      axis=1).transpose(1, 2, 0)
        cam_name = channel.split("_")[-1]
        setattr(self, f"camera_image_{cam_name}", img)

    def spin(self):
        self.lc.spin()

    def close(self):
        self.lc.close()
