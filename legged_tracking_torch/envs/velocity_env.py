"""Walk-these-ways velocity-tracking environment (MoB, 15-dim commands),
port of ``envs/velocity_env.py``.

The reference velocity env (``go1_gym/envs/base/legged_robot_velocity_tracking
.py``): gait clocks and von Mises desired contact states (:844-920), a 15-dim
command space resampled from a RewardThresholdCurriculum every
``resampling_time`` (:728-845), the CoRL reward container, legged_gym
terrain tiles, and command-conditioned observations (70 dims in the shipped
config: gravity 3 + commands 15 + q/qd/actions 36 + two prev actions 12 +
clock 4).

The command curriculum runs on the device (``tasks/curriculum.py``): its
tables are built once here, and a step's curriculum update, category and bin
draws never wait for the host.  Every random number comes from
:meth:`LeggedEnv.draw` under the JAX env's key derivation: the reset's
resample hangs from the state key folded with 50 (tag ``("rng", 50)``), a
step's two resamples from the step key folded with 42 and 43; within one,
40 is the category draw and 41, split in two, the bin and the value in it.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tracing
from ..actuation import actuators
from ..config import Cfg
from ..physics.engine import PhysState
from ..rewards.containers import RewardCtx, slots
from ..tasks.curriculum import DeviceCurriculum
from ..tasks.gaits import GaitState, step_contact_targets
from ..terrain.heightfield import TerrainArrays, plane_terrain, sample_height_nearest
from ..terrain.legged_gym_terrains import build_velocity_terrain
from ..utils import quat as qt
from ..utils.math import norm as _norm
from . import observations as obs_lib
from .legged_env import LeggedEnv, StepOut, _sel
from .state import EnvState

# curriculum-tracked reward terms, fixed order (reference :746-748)
TRACK_KEYS = ["tracking_lin_vel", "tracking_ang_vel",
              "tracking_contacts_shaped_force", "tracking_contacts_shaped_vel"]
# per-dim neighbourhood for curriculum expansion (reference :753-755)
LOCAL_RANGE = np.array([0.55, 0.55, 0.55, 0.55, 0.35, 0.25, 0.25, 0.25, 0.25,
                        1.0, 1.0, 1.0, 1.0, 1.0, 1.0])


class VelocityTrackingEnv(LeggedEnv):
    def __init__(self, cfg: Cfg, terrain: TerrainArrays | None = None,
                 seed: int | None = None, device="cuda", shard=None):
        cfg.env.command_type = "velocity"
        cfg.rewards.reward_container_name = getattr(
            cfg.rewards, "reward_container_name", "CoRLRewards") or "CoRLRewards"
        seed_ = cfg.seed if seed is None else seed
        if terrain is None:
            if cfg.terrain.mesh_type == "plane":
                terrain = plane_terrain(cfg.env.num_envs, device=device)
            else:
                terrain = build_velocity_terrain(cfg.terrain, cfg.env.num_envs, seed_,
                                                 device=device)
        super().__init__(cfg, terrain=terrain, seed=seed_, device=device, shard=shard)
        dev = self.device

        c = cfg.commands
        self.category_names = (["pronk", "trot", "pace", "bound"]
                               if c.gaitwise_curricula else ["nominal"])
        key_ranges = [
            (c.limit_vel_x[0], c.limit_vel_x[1], c.num_bins_vel_x),
            (c.limit_vel_y[0], c.limit_vel_y[1], c.num_bins_vel_y),
            (c.limit_vel_yaw[0], c.limit_vel_yaw[1], c.num_bins_vel_yaw),
            (c.limit_body_height[0], c.limit_body_height[1], c.num_bins_body_height),
            (c.limit_gait_frequency[0], c.limit_gait_frequency[1], c.num_bins_gait_frequency),
            (c.limit_gait_phase[0], c.limit_gait_phase[1], c.num_bins_gait_phase),
            (c.limit_gait_offset[0], c.limit_gait_offset[1], c.num_bins_gait_offset),
            (c.limit_gait_bound[0], c.limit_gait_bound[1], c.num_bins_gait_bound),
            (c.limit_gait_duration[0], c.limit_gait_duration[1], c.num_bins_gait_duration),
            (c.limit_footswing_height[0], c.limit_footswing_height[1],
             c.num_bins_footswing_height),
            (c.limit_body_pitch[0], c.limit_body_pitch[1], c.num_bins_body_pitch),
            (c.limit_body_roll[0], c.limit_body_roll[1], c.num_bins_body_roll),
            (c.limit_stance_width[0], c.limit_stance_width[1], c.num_bins_stance_width),
            (c.limit_stance_length[0], c.limit_stance_length[1], c.num_bins_stance_length),
            (c.limit_aux_reward_coef[0], c.limit_aux_reward_coef[1],
             c.num_bins_aux_reward_coef),
        ][: c.num_commands]
        init_low = np.array([
            c.lin_vel_x[0], c.lin_vel_y[0], c.ang_vel_yaw[0], c.body_height_cmd[0],
            c.gait_frequency_cmd_range[0], c.gait_phase_cmd_range[0],
            c.gait_offset_cmd_range[0], c.gait_bound_cmd_range[0],
            c.gait_duration_cmd_range[0], c.footswing_height_range[0],
            c.body_pitch_range[0], c.body_roll_range[0], c.stance_width_range[0],
            c.stance_length_range[0], c.aux_reward_coef_range[0]])[: c.num_commands]
        init_high = np.array([
            c.lin_vel_x[1], c.lin_vel_y[1], c.ang_vel_yaw[1], c.body_height_cmd[1],
            c.gait_frequency_cmd_range[1], c.gait_phase_cmd_range[1],
            c.gait_offset_cmd_range[1], c.gait_bound_cmd_range[1],
            c.gait_duration_cmd_range[1], c.footswing_height_range[1],
            c.body_pitch_range[1], c.body_roll_range[1], c.stance_width_range[1],
            c.stance_length_range[1], c.aux_reward_coef_range[1]])[: c.num_commands]
        self.curriculum = DeviceCurriculum(
            key_ranges, init_low, init_high, LOCAL_RANGE[: c.num_commands],
            len(self.category_names), device=dev)

        os_ = cfg.obs_scales
        self.commands_scale = torch.as_tensor(np.asarray([
            os_.lin_vel, os_.lin_vel, os_.ang_vel, os_.body_height_cmd,
            os_.gait_freq_cmd, os_.gait_phase_cmd, os_.gait_phase_cmd,
            os_.gait_phase_cmd, os_.gait_phase_cmd, os_.footswing_height_cmd,
            os_.body_pitch_cmd, os_.body_roll_cmd, os_.stance_width_cmd,
            os_.stance_length_cmd, os_.aux_reward_cmd][: c.num_commands], np.float32),
            device=dev)

        # curriculum success thresholds: threshold * scale (x dt)
        th = cfg.curriculum_thresholds
        scale = dict(zip(self.reward_names, self.reward_scales))
        self._track_idx = [self.reward_names.index(k) if k in self.reward_names else -1
                           for k in TRACK_KEYS]
        self._track_thresh = np.array([
            getattr(th, k) * scale.get(k, 0.0) for k in TRACK_KEYS], dtype=np.float32)
        self._resample_interval = max(int(c.resampling_time / self.dt), 1)
        # the JAX package's command_sums / ep_used (an int constant)
        # compiles to a multiply by its float32 reciprocal
        ep_used = min(int(cfg.env.max_episode_length), self._resample_interval)
        self._inv_ep_used = float(np.float32(1.0) / np.float32(ep_used))

        # built once: slices of consecutive report slots and collision
        # spheres (views, no index list from the host), and the step's
        # constant vectors on the device
        self._feet = slots(self.feet_slots)
        self._term = slots(self.termination_slots)
        self._foot_spheres = slots(self.model.foot_sphere_idx)
        self._g0 = torch.tensor([0.0, 0.0, -9.8], device=dev)
        self._x_axis = torch.tensor([1.0, 0.0, 0.0], device=dev)
        self._span = torch.tensor([cfg.terrain.terrain_length, cfg.terrain.terrain_width],
                                  dtype=torch.float32, device=dev)

    # ----------------------------------------------------- command sampling
    def draw_bins(self, tag, weights, categories):
        """One curriculum bin per env, drawn from its category's row of
        ``weights`` (the JAX package's ``jax.random.categorical``): one
        uniform per env from :meth:`draw`, then the inverse CDF."""
        u = self.draw(tag, (self.num_envs,), 0.0, 1.0)
        return self.curriculum.bins_from_uniform(weights, categories, u)

    def _gaitwise_transform(self, commands, categories):
        """Category-conditioned phase/offset/bound shaping (reference :783-844)."""
        c = self.cfg.commands
        if c.num_commands <= 5:
            return commands
        ph, of, bo = commands[:, 5], commands[:, 6], commands[:, 7]
        if c.gaitwise_curricula:
            # pronk / trot / pace / bound
            z = torch.zeros_like(ph)
            idx = categories.long()[:, None]
            pick = lambda cols: torch.gather(torch.stack(cols, dim=1), 1, idx)[:, 0]
            ph = pick([torch.remainder(ph / 2 - 0.25, 1.0), ph / 2 + 0.25, z, z])
            of = pick([torch.remainder(of / 2 - 0.25, 1.0), z, of / 2 + 0.25, z])
            bo = pick([torch.remainder(bo / 2 - 0.25, 1.0), z, z, bo / 2 + 0.25])
        if c.binary_phases:
            ph = torch.remainder(torch.round(2 * ph) / 2.0, 1.0)
            of = torch.remainder(torch.round(2 * of) / 2.0, 1.0)
            bo = torch.remainder(torch.round(2 * bo) / 2.0, 1.0)
        return torch.cat([commands[:, :5], torch.stack([ph, of, bo], dim=1), commands[:, 8:]],
                         dim=1)

    @tracing.spanned("env.curriculum")
    def _resample_commands(self, tag, state_weights, command_sums, ep_len,
                           old_cats, old_bins, old_commands, mask):
        """Batched _resample_commands (reference :728-845): the curriculum
        update from the resampled envs' tracking sums, then fresh draws."""
        N = mask.shape[0]
        # 1. curriculum update from the envs being resampled
        ok = torch.ones_like(mask)
        for i, idx in enumerate(self._track_idx):
            if idx >= 0:
                ok = ok & (command_sums[:, i] * self._inv_ep_used > float(self._track_thresh[i]))
        if all(i < 0 for i in self._track_idx):
            ok = torch.zeros_like(mask)
        weights = self.curriculum.update(state_weights, old_cats, old_bins, ok & mask,
                                         reduce=self._rank_sum)

        # 2. new categories, bins and values
        cat = self.draw(tag + (40,), (N,), 0, len(self.category_names), integer=True)
        bins = self.draw_bins(tag + (41, ("split", 2, 0)), weights, cat)
        u = self.draw(tag + (41, ("split", 2, 1)), (N, self.cfg.commands.num_commands),
                      -0.5, 0.5)
        new_cmds = self._gaitwise_transform(self.curriculum.values(bins, u), cat)
        # zero small xy commands (reference :841-842)
        keep = _norm(new_cmds[:, :2]) > 0.2
        new_cmds = torch.cat([new_cmds[:, :2] * keep[:, None], new_cmds[:, 2:]], dim=1)

        m1 = mask[:, None]
        commands = torch.where(m1, new_cmds, old_commands)
        bins = torch.where(mask, bins, old_bins)
        cats = torch.where(mask, cat, old_cats)
        command_sums = torch.where(m1, 0.0, command_sums)
        return weights, commands, bins, cats, command_sums

    # -------------------------------------------------------------- observe
    def _obs(self, phys, gravity_vec, commands, actions, last_actions, episode_length,
             foot_z, gait_indices, clock_inputs):
        """The obs vector and (base_lin_vel, base_ang_vel) of a state."""
        cfg = self.cfg
        N = self.num_envs
        g_unit = gravity_vec / _norm(gravity_vec)
        proj_grav = qt.quat_rotate_inverse(phys.base_quat, g_unit.expand(N, 3))
        blv = qt.quat_rotate_inverse(phys.base_quat, phys.v[:, :3])
        bav = qt.quat_rotate_inverse(phys.base_quat, phys.v[:, 3:6])
        scalars = obs_lib.scalar_obs(
            cfg, projected_gravity=proj_grav, commands=commands * self.commands_scale,
            dof_pos=phys.qj, default_dof_pos=self.default_dof_pos, dof_vel=phys.v[:, 6:],
            actions=actions, episode_length=episode_length)
        obs = obs_lib.assemble_obs(
            cfg, scalars, None, base_lin_vel=blv, base_ang_vel=bav,
            base_quat=phys.base_quat, last_actions=last_actions, foot_contact_z=foot_z,
            gait_indices=gait_indices, clock_inputs=clock_inputs)
        return obs, blv

    @tracing.spanned("env.observe")
    def observe(self, state: EnvState):
        cfg = self.cfg
        phys = state.phys
        obs, blv = self._obs(phys, state.gravity_vec, state.commands, state.actions,
                             state.last_actions, state.episode_length,
                             state.contact_forces[:, self._feet, 2], state.gait_indices,
                             state.clock_inputs)
        clip = cfg.normalization.clip_observations
        obs = torch.clamp(obs, -clip, clip)
        priv = obs_lib.privileged_obs(
            cfg, friction=state.friction, restitution=state.restitution,
            payload=state.payload, com_displacement=state.com_displacement,
            motor_strength=state.motor_strength, motor_offset=state.motor_offset,
            kp_factor=state.kp_factor, kd_factor=state.kd_factor,
            base_z=phys.base_pos[:, 2], base_lin_vel=blv, gravity_vec=state.gravity_vec)
        obs_history = torch.cat([state.obs_history[:, self.num_obs:],
                                 obs.to(state.obs_history.dtype)], dim=-1)
        return {"obs": obs, "privileged_obs": priv, "obs_history": obs_history}

    # ---------------------------------------------------------------- reset
    def reset_fn(self, randomize_ep_len: bool = False) -> EnvState:
        state = super().reset_fn(randomize_ep_len)
        N = self.num_envs
        dev = self.device
        zi = lambda: torch.zeros(N, dtype=torch.int32, device=dev)
        z = lambda *shape: torch.zeros(shape, device=dev)
        weights, commands, bins, cats, sums = self._resample_commands(
            ("rng", 50), self.curriculum.init_weights, z(N, len(TRACK_KEYS)),
            state.episode_length, zi(), zi(), z(N, self.cfg.commands.num_commands),
            torch.ones(N, dtype=torch.bool, device=dev))
        return state._replace(
            commands=commands,
            gait_indices=z(N), clock_inputs=z(N, 4), desired_contact_states=z(N, 4),
            foot_phase=z(N, 4), foot_positions=z(N, 4, 3), foot_velocities=z(N, 4, 3),
            env_command_bins=bins, env_command_categories=cats,
            curriculum_weights=weights, command_sums=sums,
        )

    # ----------------------------------------------------------------- step
    @tracing.spanned("env.step")
    def step_fn(self, state: EnvState, actions: torch.Tensor):
        cfg = self.cfg
        dr = cfg.domain_rand
        N = self.num_envs
        dev = self.device
        terrain = self.terrain

        actions = torch.clamp(actions, -cfg.normalization.clip_actions,
                              cfg.normalization.clip_actions)
        actions_scaled = actuators.scale_actions(
            actions, cfg.control.action_scale, cfg.control.hip_scale_reduction)
        prev_foot_velocities = state.foot_velocities

        # ---- physics: decimated control step ----
        phys, carry, aux = self._physics(state, actions_scaled)
        act_state = carry[0]
        torques = aux.torques
        contact_forces = aux.contact_report
        raw_contact_forces = contact_forces
        if cfg.sim.contact_report_ema > 0.0:
            # smooth the reported force texture only (SimCfg.contact_report_ema)
            b = cfg.sim.contact_report_ema
            contact_forces = (1.0 - b) * contact_forces + b * state.contact_forces
        foot_positions = aux.sphere_pos[:, self._foot_spheres, :]
        foot_velocities = aux.sphere_vel[:, self._foot_spheres, :]

        ep_len = state.episode_length + 1
        common = state.common_step + 1
        base_pos, base_quat = phys.base_pos, phys.base_quat
        base_lin_vel = qt.quat_rotate_inverse(base_quat, phys.v[:, :3])
        base_ang_vel = qt.quat_rotate_inverse(base_quat, phys.v[:, 3:6])
        g_unit = state.gravity_vec / _norm(state.gravity_vec)
        projected_gravity = qt.quat_rotate_inverse(base_quat, g_unit.expand(N, 3))

        # ---- callback: command resampling + gait clocks (:686-727,844) ----
        resample_mask = (ep_len % self._resample_interval) == 0
        weights, commands, bins, cats, command_sums = self._resample_commands(
            ("step", 42), state.curriculum_weights, state.command_sums, ep_len,
            state.env_command_categories, state.env_command_bins, state.commands,
            resample_mask)
        if cfg.commands.heading_command:
            fwd = qt.quat_apply(base_quat, self._x_axis.expand(N, 3))
            heading = torch.atan2(fwd[:, 1], fwd[:, 0])
            yaw_cmd = torch.clamp(0.5 * qt.wrap_to_pi(commands[:, 3] - heading), -1.0, 1.0)
            commands = torch.cat([commands[:, :2], yaw_cmd[:, None], commands[:, 3:]], dim=1)
        if cfg.env.observe_gait_commands:
            gait = step_contact_targets(state.gait_indices, commands, self.dt,
                                        cfg.rewards.kappa_gait_probs, cfg.commands.pacing_offset)
        else:
            gait = GaitState(state.gait_indices, state.foot_phase, state.clock_inputs,
                             state.clock_inputs, state.clock_inputs,
                             state.desired_contact_states)

        # push + interval DR + gravity events (as in the tunnel env)
        if dr.push_robots:
            push_mask = (ep_len % int(dr.push_interval)) == 0
            v_push = self.draw(("step", 20), (N, 2), -dr.max_push_vel_xy, dr.max_push_vel_xy)
            v_xy = torch.where(push_mask[:, None], v_push, phys.v[:, :2])
            phys = phys._replace(v=torch.cat([v_xy, phys.v[:, 2:]], dim=1))
        ms, mo, kp, kd = state.motor_strength, state.motor_offset, state.kp_factor, state.kd_factor
        fric, rest, payload, com = (state.friction, state.restitution, state.payload,
                                    state.com_displacement)
        dr_mask = (ep_len % int(dr.rand_interval)) == 0
        nms, nmo, nkp, nkd = self._sample_dof_props(("step", 21), (ms, mo, kp, kd))
        ms, mo, kp, kd = (_sel(nms, ms, dr_mask), _sel(nmo, mo, dr_mask),
                          _sel(nkp, kp, dr_mask), _sel(nkd, kd, dr_mask))
        if dr.randomize_rigids_after_start:
            nfr, nre, npl, nco = self._sample_rigid_props(("step", 22), (fric, rest, payload, com))
            fric, rest, payload, com = (_sel(nfr, fric, dr_mask), _sel(nre, rest, dr_mask),
                                        _sel(npl, payload, dr_mask), _sel(nco, com, dr_mask))
        gravity_vec = state.gravity_vec
        if dr.randomize_gravity:
            newg = self.draw(("global", "gravity"), (3,), *dr.gravity_range) + self._g0
            reroll = (common % int(dr.gravity_rand_interval)) == 0
            gravity_vec = torch.where(reroll, newg, gravity_vec)
            zero_evt = ((common - int(dr.gravity_rand_duration))
                        % int(dr.gravity_rand_interval)) == 0
            gravity_vec = torch.where(zero_evt, self._g0, gravity_vec)

        # teleport at tile edges (reference _teleport_robots, :1046-1072),
        # re-expressed as a within-tile wrap
        if cfg.terrain.teleport_robots and not terrain.is_plane:
            th = cfg.terrain.teleport_thresh
            span = self._span
            local = base_pos[:, :2] - terrain.env_terrain_origin[:, :2]
            shift = (torch.where(local < th, span - 2 * th, 0.0)
                     + torch.where(local > span - th, -(span - 2 * th), 0.0))
            base_pos = torch.cat([base_pos[:, :2] + shift, base_pos[:, 2:]], dim=1)
            phys = phys._replace(base_pos=base_pos)

        # feet bookkeeping
        contact = contact_forces[:, self._feet, 2] > 1.0
        contact_filt = contact | state.last_contacts
        first_contact = (state.feet_air_time > 0.0) & contact_filt
        feet_air_time = state.feet_air_time + self.dt
        feet_air_time_post = feet_air_time * ~contact_filt

        # ---- termination (velocity check_termination, :262-272) ----
        if self.termination_slots:
            term_contact = torch.any(_norm(contact_forces[:, self._term, :]) > 1.0, dim=-1)
        else:
            term_contact = torch.zeros(N, dtype=torch.bool, device=dev)
        time_out = ep_len > int(cfg.env.max_episode_length)
        done = term_contact | time_out
        if cfg.rewards.use_terminal_body_height:
            if cfg.terrain.measure_heights and not terrain.is_plane:
                pts = self.height_points[None, :, :] + base_pos[:, None, :2]
                floor_h = sample_height_nearest(
                    terrain, terrain.env_tile, terrain.env_terrain_origin, pts)[..., 1]
                rel_h = base_pos[:, 2] - torch.mean(floor_h, dim=-1)
            else:
                rel_h = base_pos[:, 2]
            done = done | (rel_h < cfg.rewards.terminal_body_height)
        if getattr(cfg.rewards, "use_terminal_roll_pitch", False):
            rpy = qt.quaternion_to_roll_pitch_yaw(base_quat)
            done = done | (torch.amax(torch.abs(rpy[:, :2]), dim=-1)
                           > cfg.rewards.terminal_body_ori)

        # ---- rewards ----
        with tracing.span("env.rewards"):
            z3 = torch.zeros(N, 3, device=dev)
            zb = torch.zeros(N, dtype=torch.bool, device=dev)
            ctx = RewardCtx(
                dt=self.dt, max_episode_length=float(cfg.env.max_episode_length),
                base_pos=base_pos, base_lin_vel=base_lin_vel, base_ang_vel=base_ang_vel,
                projected_gravity=projected_gravity, dof_pos=phys.qj, dof_vel=phys.v[:, 6:],
                last_dof_vel=state.last_dof_vel, default_dof_pos=self.default_dof_pos,
                dof_pos_soft_limits=self.dof_pos_soft_limits, torques=torques,
                actions=actions, last_actions=state.last_actions,
                contact_forces=contact_forces, penalised_slots=self.penalised_slots,
                feet_slots=self.feet_slots,
                relative_linear=z3, relative_rotation=z3, local_relative_linear=z3,
                reached_buf=zb, plan_buf=zb, replan=zb, episode_length_buf=ep_len, reset_buf=done,
                feet_air_time=feet_air_time, feet_first_contact=first_contact,
                commands=commands, desired_contact_states=gait.desired_contact_states,
                foot_positions=foot_positions, foot_velocities=foot_velocities,
                prev_foot_velocities=prev_foot_velocities, foot_phase=gait.foot_indices,
                joint_pos_target=act_state.joint_pos_target,
                last_joint_pos_target=state.last_joint_pos_target,
                last_last_joint_pos_target=state.last_last_joint_pos_target,
                last_last_actions=state.last_last_actions, gravity_unit=g_unit,
                feet_contact_filt=contact_filt, base_quat=base_quat)
            terms = torch.stack([fn(ctx, cfg) for fn in self.reward_fns], dim=-1)
            rews = terms * self._reward_scales_t
            term_sign = self._rank_sum(torch.sum(rews, dim=0)) >= 0.0
            rew_pos = torch.sum(rews * term_sign, dim=-1)
            rew_neg = torch.sum(rews * ~term_sign, dim=-1)
            rew = torch.sum(rews, dim=-1)
            if cfg.rewards.only_positive_rewards:
                rew = torch.clamp(rew, min=0.0)
            elif cfg.rewards.only_positive_rewards_ji22_style:
                # / sigma_rew_neg compiles to a multiply by its float32 reciprocal
                inv = float(np.float32(1.0) / np.float32(cfg.rewards.sigma_rew_neg))
                rew = rew_pos * torch.exp(rew_neg * inv)
            # termination reward after clipping; "total" excludes it
            # (compute_reward, legged_robot_trajectory_tracking.py:348-353)
            term_cols = []
            if self.termination_scale:
                term_rew = self.termination_scale * (done & ~time_out).float()
                term_cols = [term_rew[:, None]]
            episode_sums = state.episode_sums + torch.cat(
                [rews] + term_cols + [rew[:, None], rew_pos[:, None], rew_neg[:, None]], dim=-1)
            if self.termination_scale:
                rew = rew + term_rew

        # command_sums for the curriculum (reference compute_reward :297-301:
        # the contact-shaped terms accumulate scale + rew)
        cs = []
        for i, idx in enumerate(self._track_idx):
            if idx < 0:
                cs.append(torch.zeros(N, device=dev))
            elif TRACK_KEYS[i].startswith("tracking_contacts"):
                cs.append(float(self.reward_scales[idx]) + rews[:, idx])
            else:
                cs.append(rews[:, idx])
        command_sums = command_sums + torch.stack(cs, dim=-1)

        info = {
            "time_outs": time_out & done,
            "done": done,
            "episode_sums": episode_sums,
            "episode_length": ep_len,
            "reached": zb,
            "goal_distance": torch.zeros(N, device=dev),
        }

        # ---- auto-reset ----
        with tracing.span("env.reset"):
            rphys, ract, _ = self._reset_values(("step", 23), state.target_dist)
            rms, rmo, rkp, rkd = self._sample_dof_props(("step", 24), (ms, mo, kp, kd))
            d1 = done[:, None]
            phys = PhysState(*(_sel(a, b, done) for a, b in zip(rphys, phys)))
            act_state = type(act_state)(*(_sel(a, b, done) for a, b in zip(ract, act_state)))
            ms, mo, kp, kd = (_sel(rms, ms, done), _sel(rmo, mo, done),
                              _sel(rkp, kp, done), _sel(rkd, kd, done))
            if dr.randomize_rigids_after_start:
                rfr, rre, rpl, rco = self._sample_rigid_props(("step", 25),
                                                              (fric, rest, payload, com))
                fric, rest, payload, com = (_sel(rfr, fric, done), _sel(rre, rest, done),
                                            _sel(rpl, payload, done), _sel(rco, com, done))

            # commands resample for reset envs (reset_idx -> _resample_commands)
            weights, commands, bins, cats, command_sums = self._resample_commands(
                ("step", 43), weights, command_sums, ep_len, cats, bins, commands, done)
            gait_indices = torch.where(done, 0.0, gait.gait_indices)

            ep_len_post = torch.where(done, 0, ep_len)
            episode_sums = torch.where(d1, 0.0, episode_sums)
            feet_air_time_post = torch.where(d1, 0.0, feet_air_time_post)
            last_contacts = torch.where(d1, False, contact)

        # ---- observations from the post-reset state ----
        with tracing.span("env.observe"):
            obs, blv_o = self._obs(phys, gravity_vec, commands, actions, state.last_actions,
                                   ep_len_post, contact_forces[:, self._feet, 2], gait_indices,
                                   gait.clock_inputs)
            if cfg.noise.add_noise:
                noise = self.draw(("step", 26), (N, self.num_obs), -1.0, 1.0)
                obs = obs + noise * self.noise_vec
            clip = cfg.normalization.clip_observations
            obs = torch.clamp(obs, -clip, clip)
            priv = obs_lib.privileged_obs(
                cfg, friction=fric, restitution=rest, payload=payload,
                com_displacement=com, motor_strength=ms, motor_offset=mo,
                kp_factor=kp, kd_factor=kd, base_z=phys.base_pos[:, 2],
                base_lin_vel=blv_o, gravity_vec=gravity_vec)
            priv = torch.clamp(priv, -clip, clip)
            obs_history = torch.cat([state.obs_history[:, self.num_obs:],
                                     obs.to(state.obs_history.dtype)], dim=-1)

        new_state = state._replace(
            phys=phys, act=act_state,
            friction=fric, restitution=rest, payload=payload, com_displacement=com,
            motor_strength=ms, motor_offset=mo, kp_factor=kp, kd_factor=kd,
            gravity_vec=gravity_vec,
            episode_length=ep_len_post, common_step=common,
            commands=commands,
            actions=actions, last_actions=torch.where(d1, 0.0, actions),
            last_last_actions=torch.where(d1, 0.0, state.last_actions),
            last_dof_vel=phys.v[:, 6:],
            last_joint_pos_target=act_state.joint_pos_target,
            last_last_joint_pos_target=torch.where(d1, 0.0, state.last_joint_pos_target),
            feet_air_time=feet_air_time_post, last_contacts=last_contacts,
            # the EMA restarts from the raw report across episode boundaries
            # (no-op at the default contact_report_ema=0)
            contact_forces=(_sel(raw_contact_forces, contact_forces, done)
                            if cfg.sim.contact_report_ema > 0.0 else contact_forces),
            torques=torques,
            obs_history=obs_history,
            episode_sums=episode_sums,
            gait_indices=gait_indices, clock_inputs=gait.clock_inputs,
            desired_contact_states=gait.desired_contact_states,
            foot_phase=gait.foot_indices,
            foot_positions=foot_positions, foot_velocities=foot_velocities,
            env_command_bins=bins, env_command_categories=cats,
            curriculum_weights=weights, command_sums=command_sums,
        )
        return new_state, StepOut(obs=obs, privileged_obs=priv, obs_history=obs_history,
                                  rew=rew, done=done, info=info)


VelocityTrackingEasyEnv = VelocityTrackingEnv
