"""LCM message types for the Go1 deployment stack (a copy of
``legged_tracking_tpu/deploy/lcm_types.py``: the same bytes and fingerprints).

Declarative equivalents of the generated bindings in
``go1_gym_deploy/lcm_types/*.lcm`` — field names/types/order match the
schemas exactly so fingerprints agree with lcm-gen output.
"""

from __future__ import annotations

import struct

from .lcm_lite import LCMType


class pd_tau_targets_lcmt(LCMType):
    """pd_tau_targets_lcmt.lcm — joint PD targets published by the policy."""
    MEMBERS = [
        ("q_des", "double", (12,)),
        ("qd_des", "double", (12,)),
        ("tau_ff", "double", (12,)),
        ("kp", "double", (12,)),
        ("kd", "double", (12,)),
        ("timestamp_us", "int64_t", ()),
        ("id", "int64_t", ()),
        ("robot_id", "int64_t", ()),
        ("se_contactState", "double", (4,)),
    ]


class leg_control_data_lcmt(LCMType):
    """leg_control_data_lcmt.lcm — joint state from the robot bridge."""
    MEMBERS = [
        ("q", "float", (12,)),
        ("qd", "float", (12,)),
        ("p", "float", (12,)),
        ("v", "float", (12,)),
        ("tau_est", "float", (12,)),
        ("timestamp_us", "int64_t", ()),
        ("id", "int64_t", ()),
        ("robot_id", "int64_t", ()),
    ]


class state_estimator_lcmt(LCMType):
    """state_estimator_lcmt.lcm — IMU/odometry state."""
    MEMBERS = [
        ("p", "float", (3,)),
        ("vWorld", "float", (3,)),
        ("vBody", "float", (3,)),
        ("rpy", "float", (3,)),
        ("omegaBody", "float", (3,)),
        ("omegaWorld", "float", (3,)),
        ("quat", "float", (4,)),
        ("contact_estimate", "float", (4,)),
        ("aBody", "float", (3,)),
        ("aWorld", "float", (3,)),
        ("timestamp_us", "int64_t", ()),
        ("id", "int64_t", ()),
        ("robot_id", "int64_t", ()),
    ]


class rc_command_lcmt(LCMType):
    """rc_command_lcmt.lcm — remote-controller state."""
    MEMBERS = [
        ("mode", "int16_t", ()),
        ("left_stick", "float", (2,)),
        ("right_stick", "float", (2,)),
        ("knobs", "float", (2,)),
        ("left_upper_switch", "int16_t", ()),
        ("left_lower_left_switch", "int16_t", ()),
        ("left_lower_right_switch", "int16_t", ()),
        ("right_upper_switch", "int16_t", ()),
        ("right_lower_left_switch", "int16_t", ()),
        ("right_lower_right_switch", "int16_t", ()),
    ]


class _RawBlobLCMType:
    """Fixed-size raw byte-blob message (the reference's camera bindings are
    hand-edited lcm-gen output writing ``data`` bytes verbatim with a frozen
    fingerprint, go1_gym_deploy/lcm_types/camera_message_*.py)."""

    SIZE = 0
    BASE_HASH = 0

    def __init__(self, data: bytes = b""):
        self.data = data

    @classmethod
    def _fingerprint(cls) -> int:
        h = cls.BASE_HASH & 0xFFFFFFFFFFFFFFFF
        return (((h << 1) & 0xFFFFFFFFFFFFFFFF) + (h >> 63)) & 0xFFFFFFFFFFFFFFFF

    def encode(self) -> bytes:
        return struct.pack(">Q", self._fingerprint()) + bytes(self.data[: self.SIZE])

    @classmethod
    def decode(cls, data: bytes):
        (fp,) = struct.unpack_from(">Q", data, 0)
        if fp != cls._fingerprint():
            raise ValueError(f"{cls.__name__}: fingerprint mismatch")
        return cls(data=data[8: 8 + cls.SIZE])


class camera_message_lcmt(_RawBlobLCMType):
    """Raw fisheye frame: 3x200x464 uint8 (camera_message_lcmt.py:29,43)."""
    SIZE = 278400
    BASE_HASH = 0x1610A8A9F4D174B7


class camera_message_rect_wide(_RawBlobLCMType):
    """Rectified wide frame: 3x100x116 uint8 (camera_message_rect_wide.py:20,38)."""
    SIZE = 34800
    BASE_HASH = 0xC3E9F058530B2A8B
