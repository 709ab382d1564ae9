"""Gait clocks and von-Mises desired contact states (port of ``tasks/gaits.py``).

Batched ``_step_contact_targets`` (reference
legged_robot_velocity_tracking.py:844-920): per-foot phase variables driven by
the commanded frequency/phase/offset/bound, duration-warped so stance occupies
[0, 0.5) and swing [0.5, 1), sinusoidal clock inputs, and smoothed desired
contact probabilities via a Normal(0, kappa) CDF.

Foot order everywhere is the URDF traversal order FR, FL, RR, RL.

The arithmetic follows what XLA compiles for the JAX package, so that the
phases are bitwise the jitted JAX ones: ``g + dt * f`` is one fused
multiply-add, and the division by the constant ``kappa * sqrt(2)`` is a
multiply by its float32 reciprocal.  ``sin`` and ``erf`` are each library's
own polynomial, so the clocks and the desired contact states agree with
JAX's to about 1e-6 (``tests/test_torch_velocity.py``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..utils.math import fma


class GaitState(NamedTuple):
    gait_indices: torch.Tensor            # (N,)
    foot_indices: torch.Tensor            # (N, 4) UNwarped phases (reward-facing)
    clock_inputs: torch.Tensor            # (N, 4)
    doubletime_clock_inputs: torch.Tensor  # (N, 4)
    halftime_clock_inputs: torch.Tensor   # (N, 4)
    desired_contact_states: torch.Tensor  # (N, 4)


def _normal_cdf(x, kappa):
    inv = float(np.float32(1.0) / (np.float32(kappa) * np.float32(math.sqrt(2.0))))
    return 0.5 * (1.0 + torch.erf(x * inv))


def step_contact_targets(gait_indices, commands, dt, kappa, pacing_offset=False) -> GaitState:
    """Advance gait clocks one control step."""
    frequencies = commands[:, 4]
    phases = commands[:, 5]
    offsets = commands[:, 6]
    bounds = commands[:, 7]
    durations = commands[:, 8]
    gait_indices = torch.remainder(fma(np.float32(dt), frequencies, gait_indices), 1.0)

    g = gait_indices
    if pacing_offset:
        raw = torch.stack([g + phases + offsets + bounds, g + bounds, g + offsets,
                           g + phases], dim=1)
    else:
        raw = torch.stack([g + phases + offsets + bounds, g + offsets, g + bounds,
                           g + phases], dim=1)
    foot_indices = torch.remainder(raw, 1.0)

    # duration-warp: stance -> [0, 0.5), swing -> [0.5, 1).  The reference
    # stores the UNwarped phase on the env (feet_clearance / raibert read
    # it) but computes clocks and desired contacts from the WARPED phase
    d = durations[:, None]
    stance = foot_indices < d
    warped = torch.where(stance, foot_indices * (0.5 / d),
                         fma(foot_indices - d, 0.5 / (1.0 - d), 0.5))

    two_pi = float(np.float32(2.0) * np.float32(np.pi))
    four_pi = float(np.float32(4.0) * np.float32(np.pi))
    clock = torch.sin(two_pi * warped)
    clock2 = torch.sin(four_pi * warped)
    clock_half = torch.sin(float(np.float32(np.pi)) * warped)

    cdf = lambda x: _normal_cdf(x, kappa)
    fi = warped
    desired = cdf(fi) * (1 - cdf(fi - 0.5)) + cdf(fi - 1.0) * (1 - cdf(fi - 1.5))
    return GaitState(gait_indices=gait_indices, foot_indices=foot_indices,
                     clock_inputs=clock, doubletime_clock_inputs=clock2,
                     halftime_clock_inputs=clock_half, desired_contact_states=desired)
