"""Deployment orchestration: calibration, control loop, safety, logging (a
copy of ``legged_tracking_tpu/deploy/deployment_runner.py``).

Port of ``go1_gym_deploy/utils/deployment_runner.py`` (:11-226): slow
interpolation to the nominal pose gated on the RC R2 button, the policy
control loop, roll/pitch>1.6 emergency recovery, and button-triggered logging.

``wire`` builds the objects of the two deploy entries (``deploy_policy``,
``deploy_traj_policy``) from a run's directory.
"""

from __future__ import annotations

import os
import pickle
import time

import numpy as np

from ..io.checkpoint import load_pickle
from .lcm_agent import LCMAgent
from .policy_runtime import PolicyRuntime


class DeploymentRunner:
    def __init__(self, se=None, log_root: str | None = None):
        self.agents = {}
        self.policy = None
        self.command_profile = None
        self.se = se
        self.log_root = log_root
        self.log = []

    def add_control_agent(self, agent, name):
        self.control_agent_name = name
        self.agents[name] = agent

    def add_policy(self, policy):
        self.policy = policy

    def add_command_profile(self, profile):
        self.command_profile = profile

    def calibrate(self, wait: bool = True, low: bool = False):
        """Interpolate joints slowly to the nominal pose (reference :65-122);
        gated on the R2 button when an RC is present."""
        agent = self.agents[self.control_agent_name]
        se = self.se
        if wait and se is not None:
            while getattr(se, "right_lower_right_switch", 1) == 0:
                time.sleep(0.05)
        target = agent.default_dof_pos.copy()
        if low:
            target = np.array([0.0, 1.4, -2.5] * 4)
        q0 = se.get_dof_pos() if se is not None else np.zeros(12)
        steps = 100
        for i in range(steps):
            frac = (i + 1) / steps
            q_des = q0 * (1 - frac) + target * frac
            action = (q_des - agent.default_dof_pos) / agent.cfg.control.action_scale
            action = action.copy()
            action[[0, 3, 6, 9]] /= agent.cfg.control.hip_scale_reduction
            agent.publish_action(action.reshape(1, -1))
            time.sleep(agent.dt)
        return target

    def run(self, num_log_steps: int = 10_000_000, max_steps: int = 10_000_000):
        agent = self.agents[self.control_agent_name]
        self.calibrate(wait=self.se is not None)
        obs = agent.get_obs()
        obs_history = np.tile(obs, (1, agent.cfg.env.num_observation_history))
        for step in range(max_steps):
            action = self.policy(obs_history)
            obs = agent.step(action)
            obs_history = np.concatenate(
                [obs_history[:, obs.shape[1]:], obs], axis=1)
            self.log.append({"t": time.time(), "obs": obs, "action": np.asarray(action)})
            if len(self.log) > num_log_steps:
                self.log.pop(0)
            # emergency recovery on extreme roll/pitch (reference :163-166)
            if self.se is not None:
                rpy = self.se.get_rpy()
                if abs(rpy[0]) > 1.6 or abs(rpy[1]) > 1.6:
                    self.calibrate(wait=False, low=True)
                    obs = agent.get_obs()
                    obs_history = np.tile(obs, (1, agent.cfg.env.num_observation_history))
        if self.log_root:
            with open(f"{self.log_root}/deploy_log.pkl", "wb") as f:
                pickle.dump(self.log, f)


def wire(logdir: str, se, make_profile, device="cuda"):
    """A DeploymentRunner over the spinning StateEstimator ``se``: the run's
    ``parameters.pkl`` (either package's, read without JAX), the command
    profile ``make_profile(dt)``, an ``LCMAgent`` publishing on ``se``'s
    bus and the ``PolicyRuntime`` of the run's ``policy.npz`` on ``device``.
    The runner waits for the RC's R2 switch before it calibrates, and
    watches roll and pitch, through ``runner.se``."""
    cfg = load_pickle(os.path.join(logdir, "parameters.pkl"))
    profile = make_profile(cfg.control.decimation * cfg.sim.dt)
    runner = DeploymentRunner(se=se, log_root=logdir)
    runner.add_control_agent(LCMAgent(cfg, se, profile, se.lc), "hardware")
    runner.add_policy(PolicyRuntime(os.path.join(logdir, "policy.npz"), device=device))
    runner.add_command_profile(profile)
    return runner
