"""On-robot velocity-policy (walk-these-ways) deployment entry point
(counterpart of ``scripts/deploy_policy.py``).

    python -m legged_tracking_torch.deploy_policy --logdir D [--device cpu]

Loads ``parameters.pkl`` and ``policy.npz`` of a velocity-tracking run of
either package (``train_velocity_tracking``) and drives the robot from the
RC sticks through the 15-dim gait-clock command path of
``deploy/lcm_agent.py``.  The stick->command state machine (gait selection,
frequency, body height, stance width, footswing) lives in
``deploy/state_estimator.py:get_command``, the reference's
RCControllerProfile mapping (go1_gym_deploy/utils/command_profile.py:238-330).

The policy runs on the card (the Jetson's GPU on the robot) unless
``--device cpu`` is given; the rest of the stack is numpy on the host.  The
bus is ``LCM_DEFAULT_URL`` when it is set (``deploy/lcm_lite.py``); start the
C++ bridge (``deploy/bridge/``) on the same bus.  The runner waits for the
RC's R2 switch before it calibrates.
"""

from __future__ import annotations

import argparse


def build_runner(logdir: str, se, max_vel: float = 1.0, max_yaw_vel: float = 1.0,
                 device="cuda"):
    """The entry's DeploymentRunner over the spinning StateEstimator ``se``
    (``deployment_runner.wire``)."""
    from .deploy.command_profiles import RCControllerProfile
    from .deploy.deployment_runner import wire

    # reference deploy_policy.py:33 uses y_scale=0.6 fixed
    return wire(logdir, se, lambda dt: RCControllerProfile(
        dt, se, x_scale=max_vel, y_scale=0.6, yaw_scale=max_yaw_vel), device)


def load_and_run_policy(logdir: str, max_vel: float = 1.0, max_yaw_vel: float = 1.0,
                        max_steps: int = 10_000_000, device="cuda"):
    from .deploy.lcm_lite import LCMLite
    from .deploy.state_estimator import StateEstimator

    se = StateEstimator(LCMLite())
    se.spin()
    try:
        build_runner(logdir, se, max_vel, max_yaw_vel, device).run(max_steps=max_steps)
    finally:
        se.close()


def parse_args(argv=None):
    """The flags of ``scripts/deploy_policy.py``, and ``--device``."""
    p = argparse.ArgumentParser()
    p.add_argument("--logdir", required=True)
    p.add_argument("--max_vel", type=float, default=1.0)
    p.add_argument("--max_yaw_vel", type=float, default=1.0)
    p.add_argument("--max_steps", type=int, default=10_000_000)
    p.add_argument("--device", default="cuda",
                   help="torch device of the policy (default cuda; cpu to stay off the card)")
    return p.parse_args(argv)


if __name__ == "__main__":
    args = parse_args()
    load_and_run_policy(args.logdir, args.max_vel, args.max_yaw_vel, args.max_steps,
                        args.device)
