"""On-robot trajectory-policy deployment entry point (counterpart of
``scripts/deploy_traj_policy.py``).

    python -m legged_tracking_torch.deploy_traj_policy --logdir D \
        [--profile front_goal|random_trajectory|rc] [--device cpu]

Loads ``parameters.pkl`` and ``policy.npz`` of a training run of either
package and wires StateEstimator + LCMAgent + command profile +
DeploymentRunner over the LCM bus shared with the C++ bridge
(``deploy/bridge/go1_bridge.cpp``).  The policy runs on the card (the
Jetson's GPU on the robot) unless ``--device cpu`` is given; the rest of
the stack is numpy on the host.  The bus is ``LCM_DEFAULT_URL`` when it is
set.  The runner waits for the RC's R2 switch before it calibrates.
"""

from __future__ import annotations

import argparse

def build_runner(logdir: str, se, profile_name: str = "random_trajectory", device="cuda"):
    """The entry's DeploymentRunner over the spinning StateEstimator ``se``
    (``deployment_runner.wire``), with the named command profile."""
    from .deploy.command_profiles import (DummyFrontGoalProfile, RandomTrajectoryProfile,
                                          RCControllerProfile)
    from .deploy.deployment_runner import wire

    profiles = {
        "front_goal": lambda dt: DummyFrontGoalProfile(dt),
        "random_trajectory": lambda dt: RandomTrajectoryProfile(dt, se),
        "rc": lambda dt: RCControllerProfile(dt, se),
    }
    return wire(logdir, se, profiles[profile_name], device)


def load_and_run_policy(logdir: str, profile_name: str = "random_trajectory",
                        max_steps: int = 10_000_000, device="cuda"):
    from .deploy.lcm_lite import LCMLite
    from .deploy.state_estimator import StateEstimator

    se = StateEstimator(LCMLite())
    se.spin()
    try:
        build_runner(logdir, se, profile_name, device).run(max_steps=max_steps)
    finally:
        se.close()


def parse_args(argv=None):
    """The flags of ``scripts/deploy_traj_policy.py``, and ``--device``."""
    p = argparse.ArgumentParser()
    p.add_argument("--logdir", required=True)
    p.add_argument("--profile", default="random_trajectory", choices=["front_goal", "random_trajectory", "rc"])
    p.add_argument("--max_steps", type=int, default=10_000_000)
    p.add_argument("--device", default="cuda",
                   help="torch device of the policy (default cuda; cpu to stay off the card)")
    return p.parse_args(argv)


if __name__ == "__main__":
    args = parse_args()
    load_and_run_policy(args.logdir, args.profile, args.max_steps, args.device)
