"""The Go1 trajectory-tracking environment, batched over N envs on one device
(port of ``envs/legged_env.py``).

Order of operations mirrors the reference ``post_physics_step``
(legged_robot_trajectory_tracking.py:114-169): physics -> derive base
quantities -> callback (heights, target pose, commands, push, DR, waypoint
switching) -> termination -> rewards -> auto-reset -> observations.  The
auto-reset is branchless (``torch.where`` over every state field), so a step
never waits for the device.

The height scan goes through kernel B1 (``terrain/scan.py``) on the card and
through its plain version on the CPU.  Every random number comes from
:meth:`LeggedEnv.draw`, which names each draw by the tag the JAX env folds
into its key, so a test can substitute the JAX package's values.

With ``commands.sampling_based_planning`` the batched local planner
(``_plan_local_targets``) scores every candidate pose of every env at every
step and keeps the planned target where ``do_plan`` holds.  It reads the
scan stored in ``EnvState.measured_heights`` by the previous step, so a step
pays one scan.

With a ``shard`` (:class:`..parallel.Shard`) the env holds rank r's n = N / W
envs of a data-parallel run: the terrain and every per-env constant are built
at the global width N and the rank keeps its rows, ``draw`` draws at the
global width and keeps the rank's rows, and the step's reductions over the
env axis (the reward terms' batch-sign split, the velocity curriculum's
bump) are all-reduced.  So the rank's envs step as their rows of the 1-rank
run of N envs do.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import tracing
from ..actuation import actuators
from ..config import Cfg
from ..parallel import Shard, all_reduce_sum
from ..physics import model as go1_model
from ..physics.engine import PhysParams, PhysState
from ..physics.graph import PhysicsStep
from ..rewards.containers import RewardCtx, get_container
from ..terrain.heightfield import TerrainArrays, bf16_table, to_cells
from ..terrain.scan import scan_heights
from ..terrain.tunnel import build_terrain
from ..utils import quat as qt
from ..utils.planner import ROBOT_SIZE
from . import observations as obs_lib
from .state import EnvState
from .trajectories import TRAJ_FUNCTIONS


class StepOut(NamedTuple):
    obs: torch.Tensor
    privileged_obs: torch.Tensor
    obs_history: torch.Tensor
    rew: torch.Tensor
    done: torch.Tensor
    info: dict


def _sel(new, old, mask):
    """Per-env select of a batched field: new where mask[n], else old."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.ndim - 1)), new, old)


class LeggedEnv:
    """Static env build: holds config/model/terrain, exposes ``reset_fn`` /
    ``step_fn`` / ``observe`` on explicit states plus a stateful API."""

    # the most bytes one chunk of the planner's candidate scores may hold
    PLAN_CHUNK_BYTES = 2 ** 31

    def __init__(self, cfg: Cfg, terrain: TerrainArrays | None = None,
                 seed: int | None = None, device="cuda", shard: Shard | None = None):
        cfg.parse()
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = go1_model.make_go1_model(self.device)
        seed = cfg.seed if seed is None else seed
        self.num_envs = self.num_envs_global = cfg.env.num_envs
        self.shard = None
        self.terrain = (terrain if terrain is not None
                        else build_terrain(cfg, self.num_envs, seed, device=self.device))
        self.tile_table = bf16_table(self.terrain)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.num_actions = cfg.env.num_actions
        self.dt = cfg.dt
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=self.device)

        dof_names = go1_model.DOF_NAMES
        self.default_dof_pos = t([cfg.init_state.default_joint_angles[n] for n in dof_names])
        # soft dof limits (reference _process_dof_props, :692-706)
        lo, hi = np.asarray(self.model.dof_lower.cpu()), np.asarray(self.model.dof_upper.cpu())
        m, r = (lo + hi) / 2, hi - lo
        soft = cfg.rewards.soft_dof_pos_limit
        self.dof_pos_soft_limits = t(np.stack([m - 0.5 * r * soft, m + 0.5 * r * soft], axis=1))

        # contact report slots (reference _create_envs index lookups, :1647-1664)
        self.penalised_slots = tuple(go1_model.report_slots_for(cfg.asset.penalize_contacts_on))
        self.termination_slots = tuple(
            go1_model.report_slots_for(cfg.asset.terminate_after_contacts_on))
        self.feet_slots = tuple(go1_model.FOOT_REPORT_SLOTS)

        # observation sizes
        self.num_obs = obs_lib.num_obs(cfg)
        self.num_scalar_obs = obs_lib.num_scalar_obs(cfg)
        self.num_privileged_obs = obs_lib.num_privileged_obs(cfg)
        self.num_obs_history = cfg.env.num_observation_history * self.num_obs
        cfg.env.num_observations = self.num_obs
        cfg.env.num_scalar_observations = self.num_scalar_obs
        cfg.env.num_privileged_obs = self.num_privileged_obs
        self.noise_vec = t(obs_lib.noise_scale_vec(cfg))
        if self.noise_vec.shape[0] != self.num_obs:
            raise ValueError(f"noise vector {self.noise_vec.shape[0]} != obs {self.num_obs}")

        # height scan points (reference _init_height_points, :1902-1916)
        gx, gy = np.meshgrid(np.asarray(cfg.terrain.measured_points_x),
                             np.asarray(cfg.terrain.measured_points_y), indexing="ij")
        self.height_grid_shape = gx.shape
        self.height_points = t(np.stack([gx.ravel(), gy.ravel()], axis=-1))  # (P, 2)

        # reward wiring (reference _prepare_reward_function, :1368-1397)
        container = get_container(cfg.rewards.reward_container_name)
        scales = {k: v for k, v in cfg.reward_scales.items() if v != 0.0}
        self.reward_names = [k for k in scales if k in container]
        missing = [k for k in scales if k not in container and k != "termination"]
        if missing:
            print(f"Warning: rewards {missing} have nonzero scale but no term in "
                  f"{cfg.rewards.reward_container_name}")
        self.reward_fns = [container[k] for k in self.reward_names]
        self.reward_scales = np.asarray([scales[k] * self.dt for k in self.reward_names],
                                        dtype=np.float32)
        self._reward_scales_t = t(self.reward_scales)
        self._exp_lin_idx = (self.reward_names.index("exploration_lin")
                             if "exploration_lin" in self.reward_names else -1)
        self._exp_yaw_idx = (self.reward_names.index("exploration_yaw")
                             if "exploration_yaw" in self.reward_names else -1)
        # termination reward: applied AFTER the positive clipping and excluded
        # from the "total" sum (reference compute_reward, :348-353)
        self.termination_scale = float(scales.get("termination", 0.0)) * self.dt
        self.metric_names = (self.reward_names
                             + (["termination"] if self.termination_scale else [])
                             + ["total", "total_pos", "total_neg"])

        # actuator model
        self.actuator_net = actuators.load_actuator_net(device=self.device)
        self._torque_fn = actuators.make_torque_fn(
            cfg.control.control_type, self.actuator_net, self.default_dof_pos,
            cfg.control.stiffness, cfg.control.damping,
            self.model.dof_effort, cfg.domain_rand.randomize_lag_timesteps)
        self.physics_step = PhysicsStep(
            self.model, self._torque_fn, cfg.sim.patch_x, cfg.sim.patch_y, cfg.sim.dt,
            cfg.control.decimation, cfg.sim.contact_stiffness, cfg.sim.contact_damping,
            cfg.sim.joint_limit_stiffness, cfg.sim.joint_limit_damping)
        self._traj_fn = TRAJ_FUNCTIONS[cfg.commands.traj_function]
        self._init_planner()
        self.state: EnvState | None = None
        if shard is not None:
            self.set_shard(shard)

    def set_shard(self, shard: Shard):
        """Keep rank ``shard.rank``'s envs of the ``num_envs_global`` built:
        its rows of the terrain's per-env arrays, and from here on its rows
        of every draw.  Call before the first reset."""
        if self.shard is not None or self.state is not None:
            raise RuntimeError("set_shard: the env is already sharded or stepped")
        if shard.num_envs_global != self.num_envs_global:
            raise ValueError(f"a shard of {shard.num_envs_global} envs for an env of "
                             f"{self.num_envs_global}")
        t = self.terrain
        self.terrain = t._replace(env_tile=shard.shard_rows(t.env_tile),
                                  env_origin=shard.shard_rows(t.env_origin),
                                  env_terrain_origin=shard.shard_rows(t.env_terrain_origin))
        self.num_envs = shard.num_envs
        self.shard = shard

    def env_ids(self) -> torch.Tensor:
        """(n,) global ids of the envs this env holds."""
        if self.shard is not None:
            return self.shard.global_ids(self.device)
        return torch.arange(self.num_envs, device=self.device)

    def _rank_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ranks of a data-parallel run (itself on
        one)."""
        if self.shard is None or self.shard.world == 1:
            return x
        return all_reduce_sum([x])[0]

    def _init_planner(self):
        """Candidate poses and their quadform weights (reference :142-172).

        quad(p) = f(p)·w_c with f = [x², y², z², xy, x, y, z, 1] is the
        squared scaled distance of scan point p from candidate c in the
        candidate's frame; the effective yaw is the quaternion's yaw (the
        ±15° roll/pitch shift it ~2° from the euler yaw), as in the direct
        form.  The weights are (8, C), C = 1,575 candidates."""
        cfg, dev = self.cfg, self.device
        cp = np.asarray(cfg.commands.candidate_target_poses, dtype=np.float64)
        self._candidate_poses = torch.as_tensor(cp, dtype=torch.float32, device=dev)
        self._robot_size = torch.as_tensor(ROBOT_SIZE, dtype=torch.float32, device=dev)
        c32 = torch.as_tensor(cp, dtype=torch.float32)
        qc = qt.quat_from_euler_xyz(c32[:, 3], c32[:, 4], c32[:, 5]).numpy().astype(np.float64)
        ye = 2.0 * np.arctan2(qc[:, 2], qc[:, 3])        # quat is (x,y,z,w)
        ca, sa = np.cos(ye), np.sin(ye)
        sx, sy, sz = (float(v) for v in np.asarray(ROBOT_SIZE, np.float32))
        a = ca ** 2 / sx ** 2 + sa ** 2 / sy ** 2
        c_ = sa ** 2 / sx ** 2 + ca ** 2 / sy ** 2
        b = ca * sa * (1.0 / sx ** 2 - 1.0 / sy ** 2)
        cx, cy, cz = cp[:, 0], cp[:, 1], cp[:, 2]
        w = np.stack([
            a, c_, np.full_like(a, 1.0 / sz ** 2), 2.0 * b,
            -2.0 * (a * cx + b * cy), -2.0 * (b * cx + c_ * cy),
            -2.0 * cz / sz ** 2,
            a * cx ** 2 + c_ * cy ** 2 + 2.0 * b * cx * cy + cz ** 2 / sz ** 2,
        ])                                               # (8, C)
        self._cand_quad_w = torch.as_tensor(w, dtype=torch.float32, device=dev)
        # candidates per chunk: the JAX package's 45 was sized for the TPU's
        # HBM; here a chunk's (N, 2P, chunk) float32 scores stay within
        # PLAN_CHUNK_BYTES (7 chunks of 225 at 4096 envs x 462 points), since
        # the host pays for every launch of the host-bound rollout
        C = cp.shape[0]
        two_p = 2 * self.height_points.shape[0]
        per_cand = self.num_envs * two_p * 4
        fit = max(1, self.PLAN_CHUNK_BYTES // per_cand)
        self._plan_chunk = max(c for c in range(1, C + 1) if C % c == 0 and c <= fit)

    # ------------------------------------------------------------------ rng
    def draw(self, tag: tuple, shape: tuple, lo, hi, integer: bool = False) -> torch.Tensor:
        """Every random number of the env: uniform in [lo, hi) (integers with
        ``integer``) of ``shape``, from the env's generator.

        ``tag`` names the draw after the JAX env's key derivation: its first
        element is the key ("reset": the per-env reset keys, "step": the
        per-env step key, "global": the global key), the rest are the
        ``fold_in`` tags applied to it.

        Every draw but a ``"global"`` one has a leading env axis.  Under a
        shard it is drawn at the global width, from the generator every
        rank seeds alike, and the rank keeps its rows; a global draw stays
        whole, the same on every rank."""
        sh = self.shard
        rows = sh is not None and tag[0] != "global"
        if rows:
            if shape[0] != self.num_envs:
                raise ValueError(f"draw {tag}: leading axis {shape[0]} is not the "
                                 f"{self.num_envs} envs of the shard")
            shape = (sh.num_envs_global,) + tuple(shape[1:])
        if integer:
            x = torch.randint(int(lo), int(hi), shape, generator=self.generator,
                              device=self.device, dtype=torch.int32)
        else:
            x = lo + (hi - lo) * torch.rand(shape, generator=self.generator,
                                            device=self.device)
        return sh.shard_rows(x) if rows else x

    # ------------------------------------------------------------ reset core
    def _sample_dof_props(self, tag, state_vals):
        """(Re-)roll motor DR (reference _randomize_dof_props, :744-764)."""
        dr = self.cfg.domain_rand
        ms, mo, kp, kd = state_vals
        N = self.num_envs

        def u_scalar(k, lo, hi):
            return self.draw(tag + (k,), (N,), lo, hi)[:, None].expand(N, 12)

        if dr.randomize_motor_strength:
            ms = u_scalar(1, *dr.motor_strength_range)
        if dr.randomize_motor_offset:
            mo = self.draw(tag + (2,), (N, 12), *dr.motor_offset_range)
        if dr.randomize_Kp_factor:
            kp = u_scalar(3, *dr.Kp_factor_range)
        if dr.randomize_Kd_factor:
            kd = u_scalar(4, *dr.Kd_factor_range)
        return ms, mo, kp, kd

    def _sample_rigid_props(self, tag, state_vals):
        """(Re-)roll rigid-body DR (reference _randomize_rigid_body_props, :710-732)."""
        dr = self.cfg.domain_rand
        fric, rest, payload, com = state_vals
        N = self.num_envs
        if dr.randomize_friction:
            fric = self.draw(tag + (5,), (N,), *dr.friction_range)
        if dr.randomize_restitution:
            rest = self.draw(tag + (6,), (N,), *dr.restitution_range)
        if dr.randomize_base_mass:
            payload = self.draw(tag + (7,), (N,), *dr.added_mass_range)
        if dr.randomize_com_displacement:
            com = self.draw(tag + (8,), (N, 3), *dr.com_displacement_range)
        return fric, rest, payload, com

    def _reset_values(self, tag, target_dist):
        """Fresh per-env states (reference _reset_dofs/_reset_root_states/
        _resample_trajectory, :998-1072,949-955)."""
        cfg = self.cfg
        N = self.num_envs
        dev = self.device
        qj = self.default_dof_pos * self.draw(tag + (10,), (N, 12), 0.5, 1.5)

        init_pos = torch.tensor(cfg.init_state.pos, dtype=torch.float32, device=dev)
        t = cfg.terrain
        off = torch.stack([
            self.draw(tag + (11,), (N,), -t.x_init_range, t.x_init_range) + t.x_init_offset,
            self.draw(tag + (11, 1), (N,), -t.y_init_range, t.y_init_range) + t.y_init_offset,
            torch.zeros(N, device=dev)], dim=-1)
        base_pos = self.terrain.env_origin + init_pos + off
        if not self.terrain.is_plane:
            # spawn on TOP of the local floor (the JAX env explains why)
            tiles = self.terrain.tiles
            th, tw = tiles.shape[2], tiles.shape[3]
            rel = to_cells(base_pos[:, :2] - self.terrain.env_terrain_origin[:, :2],
                         self.terrain.horizontal_scale)
            xp = torch.clamp(rel[:, 0].to(torch.int32), 0, th - 1).long()
            yp = torch.clamp(rel[:, 1].to(torch.int32), 0, tw - 1).long()
            floor_h = tiles[self.terrain.env_tile.long(), 1, xp, yp]
            base_pos = torch.cat([base_pos[:, :2], (base_pos[:, 2] + floor_h)[:, None]], dim=1)

        yaw = self.draw(tag + (12,), (N,), -t.yaw_init_range, t.yaw_init_range)
        z_axis = torch.tensor([0.0, 0.0, 1.0], device=dev).expand(N, 3)
        base_quat = qt.quat_from_angle_axis(yaw, z_axis)

        v6 = self.draw(tag + (13,), (N, 6), -0.5, 0.5)
        v = torch.cat([v6, torch.zeros(N, 12, device=dev)], dim=-1)
        phys = PhysState(base_pos=base_pos, base_quat=base_quat, qj=qj, v=v)

        # rehearsal mixing (cl_dist_mix, config.py): a LEADING slice of train
        # envs samples its goal distance uniformly in [cl_start, target_dist]
        ct = cfg.curriculum_thresholds
        dist_i = target_dist.expand(N)
        if ct.cl_fix_target and ct.cl_dist_mix > 0.0:
            n_train = self.num_envs_global - int(getattr(cfg.env, "num_eval_envs", 0))
            n_mix = int(round(ct.cl_dist_mix * n_train))
            u = self.draw(tag + (15,), (N,), 0.0, 1.0)
            mixed = ct.cl_start_target_dist + u * torch.clamp(
                dist_i - ct.cl_start_target_dist, min=0.0)
            dist_i = torch.where(self.env_ids() < n_mix, mixed, dist_i)
        with tracing.span("env.trajectory") as span:
            span.add("envs", N)
            span.add("waypoints", cfg.commands.traj_length)
            traj = self._traj_fn(lambda *a, **k: self.draw(*a, **k), tag + (14,), base_pos, cfg,
                                 self.terrain, dist_i[:, None])

        act = actuators.init_actuator_state(cfg.domain_rand.lag_timesteps, N, device=dev)
        return phys, act, traj

    def reset_fn(self, randomize_ep_len: bool = False) -> EnvState:
        """Full reset of all envs (auto-resets happen inside step_fn)."""
        cfg = self.cfg
        N = self.num_envs
        dev = self.device
        f = lambda v, shape=(N,): torch.full(shape, v, dtype=torch.float32, device=dev)
        z = lambda *shape: torch.zeros(shape, device=dev)

        fric, rest, payload, com = self._sample_rigid_props(
            ("reset",), (f(cfg.terrain.static_friction), f(cfg.domain_rand.restitution),
                         z(N), z(N, 3)))
        ms, mo, kp, kd = self._sample_dof_props(
            ("reset",), (f(1.0, (N, 12)), z(N, 12), f(1.0, (N, 12)), f(1.0, (N, 12))))

        target_dist = torch.tensor(
            cfg.curriculum_thresholds.cl_start_target_dist
            if cfg.curriculum_thresholds.cl_fix_target else cfg.commands.x_mean,
            dtype=torch.float32, device=dev)
        phys, act, traj = self._reset_values(("reset",), target_dist)

        ep_len = (self.draw(("reset", "ep_len"), (N,), 0, int(cfg.env.max_episode_length),
                            integer=True)
                  if randomize_ep_len else torch.zeros(N, dtype=torch.int32, device=dev))

        K = len(self.metric_names)
        C = 2 if cfg.env.command_type in ("xy", "xy_norm") else 6
        zi = lambda: torch.zeros(N, dtype=torch.int32, device=dev)
        zb = lambda *shape: torch.zeros(shape, dtype=torch.bool, device=dev)
        scale = lambda i: torch.tensor(self.reward_scales[i] if i >= 0 else 0.0,
                                       dtype=torch.float32, device=dev)
        if cfg.commands.sampling_based_planning:
            # the planner's first step reads this scan (reference :400-403)
            mh = self._get_heights(phys.base_pos, qt.quaternion_to_roll_pitch_yaw(phys.base_quat))
        else:
            mh = None
        return EnvState(
            phys=phys, act=act,
            friction=fric, restitution=rest, payload=payload, com_displacement=com,
            motor_strength=ms, motor_offset=mo, kp_factor=kp, kd_factor=kd,
            gravity_vec=torch.tensor(cfg.sim.gravity, dtype=torch.float32, device=dev),
            episode_length=ep_len, common_step=torch.zeros((), dtype=torch.int32, device=dev),
            trajectories=traj, curr_pose_index=zi(),
            reached=zb(N), plan_buf=torch.ones(N, dtype=torch.bool, device=dev),
            replan=zb(N), plan_length=zi(),
            local_target_poses=traj[:, 0, :], collision_count=zi(),
            commands=z(N, C),
            relative_linear=z(N, 3), relative_rotation=z(N, 3),
            local_relative_linear=z(N, 3), local_relative_rotation=z(N, 3),
            actions=z(N, 12), last_actions=z(N, 12), last_last_actions=z(N, 12),
            last_dof_vel=z(N, 12), last_joint_pos_target=z(N, 12),
            last_last_joint_pos_target=z(N, 12),
            feet_air_time=z(N, 4), last_contacts=zb(N, 4),
            contact_forces=z(N, self.model.num_report_bodies, 3),
            torques=z(N, 12),
            obs_history=torch.zeros(N, self.num_obs_history, dtype=torch.bfloat16, device=dev),
            exploration_lin_scale=scale(self._exp_lin_idx),
            exploration_yaw_scale=scale(self._exp_yaw_idx),
            target_dist=target_dist,
            episode_sums=z(N, K),
            measured_heights=mh,
        )

    # ------------------------------------------------------------ step core
    @tracing.spanned("env.scan")
    def _get_heights(self, base_pos, base_rpy):
        """Two-layer height scan (reference _get_heights, :1918-1965): the
        scan grid is axis-aligned around the base, shifted by the camera
        offset under camera_zero.  Kernel B1 on the card."""
        N = base_pos.shape[0]
        nx, ny = self.height_grid_shape
        if self.terrain.is_plane:
            return torch.stack([torch.ones(N, nx, ny, device=self.device),
                                torch.zeros(N, nx, ny, device=self.device)], dim=1)
        zeros = torch.zeros(N, device=self.device)
        cam = (torch.stack([0.12 * torch.cos(base_rpy[:, 1]), zeros], dim=-1)
               if self.cfg.env.camera_zero else torch.zeros(N, 2, device=self.device))
        frames = torch.stack([base_pos[:, :2], cam, self.terrain.env_terrain_origin[:, :2]],
                             dim=1).contiguous()
        h = scan_heights(self.tile_table, self.terrain.env_tile, frames, self.height_points,
                         self.terrain.horizontal_scale)
        return h.reshape(N, 2, nx, ny)

    @staticmethod
    def _select_waypoint(trajectories, idx):
        return trajectories[torch.arange(trajectories.shape[0], device=idx.device), idx.long()]

    def _relative_pose(self, target, base_pos, base_quat, base_rpy):
        """(reference _compute_relative_target_pose, :922-932)."""
        rel_lin = qt.quat_apply_yaw_inverse(base_quat, target[:, :3] - base_pos)
        rel_rot = qt.wrap_to_pi(target[:, 3:] - base_rpy)
        return rel_lin, rel_rot

    def _commands(self, target, rel_lin, rel_rot):
        ct = self.cfg.env.command_type
        if ct == "xy":
            return rel_lin[:, :2]
        if ct == "xy_norm":
            n = torch.linalg.vector_norm(rel_lin[:, :2], dim=-1, keepdim=True)
            return torch.where(n > 1.0, rel_lin[:, :2] / n, rel_lin[:, :2])
        if ct == "6dof":
            return torch.cat([rel_lin[:, :2], target[:, 2:5], rel_rot[:, 2:]], dim=-1)
        raise ValueError(ct)

    @tracing.spanned("env.plan")
    def _plan_local_targets(self, state, target, rel_lin, base_pos, base_quat, base_rpy,
                            measured_heights, ep_len):
        """Batched sampling-based local planner (reference _plan_target_pose,
        :850-920, a per-env loop there; a masked argmin here, JAX :480-550).

        Every env scores every candidate at every step; ``do_plan`` selects
        which envs take the result.  A candidate is valid when every scan
        point (both layers) lies outside its robot ellipsoid; the valid
        candidate nearest the goal wins (z does not enter the metric, so
        the first of equal candidates wins, as in the JAX package)."""
        cfg = self.cfg
        N = base_pos.shape[0]
        norm = lambda x: torch.sqrt(torch.sum(x * x, dim=-1))    # XLA's sum of squares
        plan_length = state.plan_length + 1
        close = norm(rel_lin[:, :2]) < 1.0
        ep_start = ep_len == 1
        if cfg.commands.plan_interval > 0:
            replan = (plan_length % cfg.commands.plan_interval) == 0
            do_plan = ep_start | (replan & state.plan_buf)
        else:
            replan = torch.ones_like(ep_start)
            do_plan = ep_start | state.plan_buf
        plan_length = torch.where(do_plan, 0, plan_length)

        cands = self._candidate_poses                        # (C, 6)
        goal_xy = target[:, :2] - base_pos[:, :2]
        sort_metric = (norm(cands[None, :, :2] - goal_xy[:, None, :])
                       + norm(cands[None, :, 3:]) * 0.1)     # (N, C)
        valid = self.candidates_valid(self.scan_points(measured_heights))
        best = torch.argmin(sort_metric + 1e6 * (~valid), dim=-1)
        any_valid = torch.any(valid, dim=-1)
        chosen = cands[best]                                 # (N, 6)
        # to world frame (:904-906)
        world_xy = qt.quat_apply_yaw(base_quat, chosen[:, :3])[:, :2] + base_pos[:, :2]
        world_rot = qt.wrap_to_pi(chosen[:, 3:] + base_rpy)
        planned = torch.cat([world_xy, chosen[:, 2:3], world_rot], dim=-1)
        planned = torch.where((any_valid & ~close)[:, None], planned, target)
        local = torch.where(do_plan[:, None], planned, state.local_target_poses)
        return local, plan_length, replan

    def scan_points(self, measured_heights):
        """(N, 2, nx, ny) scan -> (N, 2P, 3) points in the base frame: the
        grid with the ceiling layer's z, then with the floor layer's."""
        N = measured_heights.shape[0]
        P = self.height_points.shape[0]
        xy = self.height_points[None].expand(N, P, 2)
        return torch.cat([torch.cat([xy, measured_heights[:, i].reshape(N, P, 1)], dim=-1)
                          for i in (0, 1)], dim=1)

    def candidates_valid(self, pts, quadform: bool | None = None):
        """(N, 2P, 3) points -> (N, C) bool: every point outside candidate
        c's ellipsoid.  ``quadform`` (default ``commands.planner_quadform``)
        scores q = f(p)·w_c, one float32 product per chunk of candidates;
        otherwise the direct form rotates and scales every difference, the
        quadform's plain version (the reference's ``quat_apply_yaw_inverse``
        and norm, component by component)."""
        if quadform is None:
            quadform = self.cfg.commands.planner_quadform
        C = self._candidate_poses.shape[0]
        chunks = []
        if quadform:
            x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
            F = torch.stack([x * x, y * y, z * z, x * y, x, y, z, torch.ones_like(x)], dim=-1)
            for i in range(0, C, self._plan_chunk):
                q = torch.matmul(F, self._cand_quad_w[:, i:i + self._plan_chunk])  # (N, 2P, c)
                # all(q > 1) over the points, as one reduction
                chunks.append(torch.amin(q, dim=1) > 1.0)
        else:
            cands = self._candidate_poses
            # the yaw-only quaternions (0, 0, qz, qw) of the candidates
            cq = qt.quat_yaw_only(qt.quat_from_euler_xyz(cands[:, 3], cands[:, 4], cands[:, 5]))
            px, py, pz = (pts[:, None, :, i] for i in range(3))            # (N, 1, 2P)
            sx, sy, sz = self._robot_size
            # about eight (N, c, 2P) temporaries live at once
            step = max(1, self._plan_chunk // 8)
            for i in range(0, C, step):
                qz, qw = cq[i:i + step, 2, None], cq[i:i + step, 3, None]  # (c, 1)
                cl = cands[i:i + step]
                dx, dy, dz = (p - cl[:, j, None] for j, p in enumerate((px, py, pz)))
                # quat_rotate_inverse(q, d) = d - w t + xyz × t with
                # t = 2 xyz × d, written out for xyz = (0, 0, qz)
                tx, ty = 2.0 * -(qz * dy), 2.0 * (qz * dx)
                rx = (dx - qw * tx) - qz * ty
                ry = (dy - qw * ty) + qz * tx
                r2 = torch.square(rx / sx) + torch.square(ry / sy) + torch.square(dz / sz)
                chunks.append(torch.all(torch.sqrt(r2) > 1.0, dim=-1))
        return torch.cat(chunks, dim=1)

    def _physics_inputs(self, state: EnvState, actions_scaled: torch.Tensor):
        """``(PhysState, PhysParams, carry)`` of the control step from
        ``state``, with ``actions_scaled`` as the PD targets' offsets."""
        params = PhysParams(
            friction=state.friction, restitution=state.restitution,
            gravity=state.gravity_vec.expand(self.num_envs, 3),
            payload=state.payload, com_offset=state.com_displacement)
        carry = (state.act, state.motor_strength, state.motor_offset,
                 state.kp_factor, state.kd_factor, actions_scaled)
        return state.phys, params, carry

    def _physics(self, state: EnvState, actions_scaled: torch.Tensor):
        """The decimated control step of every env: ``(PhysState, carry,
        StepAux)`` of ``engine.control_step``, as one CUDA graph replay on
        the card (``physics/graph.py``)."""
        return self.physics_step(self.terrain, self.tile_table,
                                 *self._physics_inputs(state, actions_scaled))

    @tracing.spanned("env.step")
    def step_fn(self, state: EnvState, actions: torch.Tensor):
        cfg = self.cfg
        dr = cfg.domain_rand
        N = self.num_envs
        dev = self.device
        norm = lambda x: torch.linalg.vector_norm(x, dim=-1)

        actions = torch.clamp(actions, -cfg.normalization.clip_actions,
                              cfg.normalization.clip_actions)
        actions_scaled = actuators.scale_actions(
            actions, cfg.control.action_scale, cfg.control.hip_scale_reduction)

        # ---- physics: decimated control step (reference step, :64-98) ----
        phys, carry, aux = self._physics(state, actions_scaled)
        act_state = carry[0]
        torques = aux.torques
        contact_forces = aux.contact_report                       # (N, 17, 3)
        raw_contact_forces = contact_forces
        if cfg.sim.contact_report_ema > 0.0:
            b = cfg.sim.contact_report_ema
            contact_forces = (1.0 - b) * contact_forces + b * state.contact_forces

        # ---- post-physics derivations (:126-136) ----
        ep_len = state.episode_length + 1
        common = state.common_step + 1
        base_pos, base_quat = phys.base_pos, phys.base_quat
        base_lin_vel = qt.quat_rotate_inverse(base_quat, phys.v[:, :3])
        base_ang_vel = qt.quat_rotate_inverse(base_quat, phys.v[:, 3:6])
        g_unit = state.gravity_vec / norm(state.gravity_vec)
        projected_gravity = qt.quat_rotate_inverse(base_quat, g_unit.expand(N, 3))
        base_rpy = qt.quaternion_to_roll_pitch_yaw(base_quat)

        # ---- callback (:774-848) ----
        planning = cfg.commands.sampling_based_planning
        idx = state.curr_pose_index
        target = self._select_waypoint(state.trajectories, idx)
        rel_lin, rel_rot = self._relative_pose(target, base_pos, base_quat, base_rpy)
        if planning:
            # the scan stored by the previous step, at this step's
            # pre-physics pose; planner_rescan scans again (the A/B knob)
            measured_heights = (self._get_heights(base_pos, base_rpy)
                                if cfg.commands.planner_rescan else state.measured_heights)
            local_target, plan_length, replan = self._plan_local_targets(
                state, target, rel_lin, base_pos, base_quat, base_rpy, measured_heights,
                ep_len)
            local_rel_lin, local_rel_rot = self._relative_pose(
                local_target, base_pos, base_quat, base_rpy)
        else:
            local_target, plan_length, replan = target, state.plan_length, state.replan
            local_rel_lin, local_rel_rot = rel_lin, rel_rot
        commands = self._commands(local_target, local_rel_lin, local_rel_rot)

        # push robots (:1074-1084) — affects the next physics step only
        if dr.push_robots:
            push_mask = (ep_len % int(dr.push_interval)) == 0
            v_push = self.draw(("step", 20), (N, 2), -dr.max_push_vel_xy, dr.max_push_vel_xy)
            v_xy = torch.where(push_mask[:, None], v_push, phys.v[:, :2])
            phys = phys._replace(v=torch.cat([v_xy, phys.v[:, 2:]], dim=1))

        # interval DR re-rolls (:821-833)
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

        # gravity impulse DR (:826-830, _randomize_gravity :645-660)
        gravity_vec = state.gravity_vec
        if dr.randomize_gravity:
            g0 = torch.tensor([0.0, 0.0, -9.8], device=dev)
            newg = self.draw(("global", "gravity"), (3,), *dr.gravity_range) + g0
            reroll = (common % int(dr.gravity_rand_interval)) == 0
            gravity_vec = torch.where(reroll, newg, gravity_vec)
            zero_evt = ((common - int(dr.gravity_rand_duration))
                        % int(dr.gravity_rand_interval)) == 0
            gravity_vec = torch.where(zero_evt, g0, gravity_vec)

        # waypoint switching (:836-848)
        if cfg.commands.switch_upon_reach:
            switched = norm(rel_lin[:, :2]) < cfg.commands.switch_dist
        else:
            switched = (ep_len % max(int(cfg.commands.switch_interval), 1)) == 0
        idx2 = torch.clamp(idx + switched.to(torch.int32), 0, cfg.commands.traj_length - 1)
        reached = switched & (idx2 == cfg.commands.traj_length - 1)
        plan_buf = ((norm(local_rel_lin[:, :2]) < cfg.commands.switch_dist)
                    & (torch.abs(local_rel_rot[:, 2]) < cfg.commands.switch_yaw))
        pen_f = contact_forces[:, list(self.penalised_slots), :]
        collision_count = state.collision_count + torch.sum(
            norm(pen_f) > 0.1, dim=-1).to(torch.int32)

        # feet air time bookkeeping (trajectory_tracking_reward.py:115-126)
        contact = contact_forces[:, list(self.feet_slots), 2] > 1.0
        contact_filt = contact | state.last_contacts
        first_contact = (state.feet_air_time > 0.0) & contact_filt
        feet_air_time = state.feet_air_time + self.dt
        feet_air_time_post = feet_air_time * ~contact_filt

        # ---- termination (:198-216) ----
        if self.termination_slots:
            term_contact = torch.any(
                norm(contact_forces[:, list(self.termination_slots), :]) > 1.0, dim=-1)
        else:
            term_contact = torch.zeros(N, dtype=torch.bool, device=dev)
        time_out = ep_len > int(cfg.env.max_episode_length)
        done = term_contact | time_out
        if cfg.rewards.use_terminal_body_height:
            done = done | (base_pos[:, 2] < cfg.rewards.terminal_body_height)
        if cfg.env.terminate_end_of_trajectory:
            done = done | (reached & (ep_len > cfg.rewards.T_reach))
        if cfg.env.use_terminal_body_rotation:
            done = done | (projected_gravity[:, 2] > 0.0)

        # ---- rewards (:320-355) ----
        with tracing.span("env.rewards"):
            ctx = RewardCtx(
                dt=self.dt, max_episode_length=float(cfg.env.max_episode_length),
                base_pos=base_pos, base_lin_vel=base_lin_vel, base_ang_vel=base_ang_vel,
                projected_gravity=projected_gravity, dof_pos=phys.qj, dof_vel=phys.v[:, 6:],
                last_dof_vel=state.last_dof_vel, default_dof_pos=self.default_dof_pos,
                dof_pos_soft_limits=self.dof_pos_soft_limits, torques=torques,
                actions=actions, last_actions=state.last_actions,
                contact_forces=contact_forces, penalised_slots=self.penalised_slots,
                feet_slots=self.feet_slots, relative_linear=rel_lin,
                relative_rotation=rel_rot, local_relative_linear=local_rel_lin,
                reached_buf=reached, plan_buf=plan_buf, replan=replan,
                episode_length_buf=ep_len, reset_buf=done,
                feet_air_time=feet_air_time, feet_first_contact=first_contact)
            terms = torch.stack([fn(ctx, cfg) for fn in self.reward_fns], dim=-1)  # (N, K)
            scale_vec = self._reward_scales_t
            if self._exp_lin_idx >= 0 or self._exp_yaw_idx >= 0:
                scale_vec = scale_vec.clone()
                if self._exp_lin_idx >= 0:
                    scale_vec[self._exp_lin_idx] = state.exploration_lin_scale
                if self._exp_yaw_idx >= 0:
                    scale_vec[self._exp_yaw_idx] = state.exploration_yaw_scale
            rews = terms * scale_vec
            # batch-sign split (reference compute_reward, :328-335)
            term_sign = self._rank_sum(torch.sum(rews, dim=0)) >= 0.0
            rew_pos = torch.sum(rews * term_sign, dim=-1)
            rew_neg = torch.sum(rews * ~term_sign, dim=-1)
            rew = torch.sum(rews, dim=-1)
            if cfg.rewards.only_positive_rewards:
                rew = torch.clamp(rew, min=0.0)
            elif cfg.rewards.only_positive_rewards_ji22_style:
                rew = rew_pos * torch.exp(rew_neg / cfg.rewards.sigma_rew_neg)
            # termination reward after clipping; "total" excludes it (:348-353)
            term_cols = []
            if self.termination_scale:
                term_rew = self.termination_scale * (done & ~time_out).float()
                term_cols = [term_rew[:, None]]
            episode_sums = state.episode_sums + torch.cat(
                [rews] + term_cols + [rew[:, None], rew_pos[:, None], rew_neg[:, None]], dim=-1)
            if self.termination_scale:
                rew = rew + term_rew

        # exploration-scale decay (update_curriculum, :171-183)
        exp_lin, exp_yaw = state.exploration_lin_scale, state.exploration_yaw_scale
        if np.isfinite(cfg.rewards.exploration_steps):
            decay_on = (common > cfg.rewards.exploration_steps).float()
            if self._exp_lin_idx >= 0:
                d = float(self.reward_scales[self._exp_lin_idx]) / cfg.rewards.exploration_steps
                exp_lin = torch.clamp(exp_lin - d * decay_on, min=0.0)
            if self._exp_yaw_idx >= 0:
                d = float(self.reward_scales[self._exp_yaw_idx]) / cfg.rewards.exploration_steps
                exp_yaw = torch.clamp(exp_yaw - d * decay_on, min=0.0)

        # ---- episodic metrics snapshot before reset zeroing ----
        info = {
            "time_outs": time_out & done,
            "done": done,
            "episode_sums": episode_sums,
            "episode_length": ep_len,
            "reached": reached,
            "goal_distance": norm(rel_lin),
        }

        # ---- branchless auto-reset (reset_idx, :218-296) ----
        with tracing.span("env.reset"):
            rphys, ract, rtraj = self._reset_values(("step", 23), state.target_dist)
            rms, rmo, rkp, rkd = self._sample_dof_props(("step", 24), (ms, mo, kp, kd))
            d1 = done[:, None]
            phys = PhysState(*(_sel(a, b, done) for a, b in zip(rphys, phys)))
            act_state = type(act_state)(*(_sel(a, b, done) for a, b in zip(ract, act_state)))
            trajectories = _sel(rtraj, state.trajectories, done)
            ms, mo, kp, kd = (_sel(rms, ms, done), _sel(rmo, mo, done),
                              _sel(rkp, kp, done), _sel(rkd, kd, done))
            if dr.randomize_rigids_after_start:
                rfr, rre, rpl, rco = self._sample_rigid_props(("step", 25),
                                                              (fric, rest, payload, com))
                fric, rest, payload, com = (_sel(rfr, fric, done), _sel(rre, rest, done),
                                            _sel(rpl, payload, done), _sel(rco, com, done))

            idx2 = torch.where(done, 0, idx2)
            ep_len_post = torch.where(done, 0, ep_len)
            episode_sums = torch.where(d1, 0.0, episode_sums)
            feet_air_time_post = torch.where(d1, 0.0, feet_air_time_post)
            last_contacts = torch.where(d1, False, contact)
            collision_count = torch.where(done, 0, collision_count)
            plan_buf = torch.where(done, True, plan_buf)
            local_rel_lin = torch.where(d1, 0.0, local_rel_lin)
            local_rel_rot = torch.where(d1, 0.0, local_rel_rot)

        # ---- observations from the post-reset state (:357-469) ----
        with tracing.span("env.observe"):
            base_pos_o, base_quat_o = phys.base_pos, phys.base_quat
            base_rpy_o = qt.quaternion_to_roll_pitch_yaw(base_quat_o)
            base_lin_vel_o = qt.quat_rotate_inverse(base_quat_o, phys.v[:, :3])
            base_ang_vel_o = qt.quat_rotate_inverse(base_quat_o, phys.v[:, 3:6])
            proj_grav_o = qt.quat_rotate_inverse(
                base_quat_o, (gravity_vec / norm(gravity_vec)).expand(N, 3))
            target_o = self._select_waypoint(trajectories, idx2)
            rel_lin_o, rel_rot_o = self._relative_pose(target_o, base_pos_o, base_quat_o,
                                                       base_rpy_o)
            commands_o = torch.where(d1, self._commands(target_o, rel_lin_o, rel_rot_o), commands)
            local_target = torch.where(d1, target_o, local_target)
            mh_o = self._get_heights(base_pos_o, base_rpy_o)

            foot_z = contact_forces[:, list(self.feet_slots), 2]
            heights = obs_lib.height_obs(cfg, mh_o, base_pos_o[:, 2], base_rpy_o[:, 1])
            scalars = obs_lib.scalar_obs(
                cfg, projected_gravity=proj_grav_o, commands=commands_o,
                dof_pos=phys.qj, default_dof_pos=self.default_dof_pos,
                dof_vel=phys.v[:, 6:], actions=actions, episode_length=ep_len_post)
            obs = obs_lib.assemble_obs(
                cfg, scalars, heights, base_lin_vel=base_lin_vel_o,
                base_ang_vel=base_ang_vel_o, base_quat=base_quat_o,
                last_actions=state.last_actions, foot_contact_z=foot_z)
            if cfg.noise.add_noise:
                noise = self.draw(("step", 26), (N, self.num_obs), -1.0, 1.0)
                obs = obs + noise * self.noise_vec
            obs = torch.clamp(obs, -cfg.normalization.clip_observations,
                              cfg.normalization.clip_observations)

            priv = obs_lib.privileged_obs(
                cfg, friction=fric, restitution=rest, payload=payload,
                com_displacement=com, motor_strength=ms, motor_offset=mo,
                kp_factor=kp, kd_factor=kd, base_z=base_pos_o[:, 2],
                base_lin_vel=base_lin_vel_o, gravity_vec=gravity_vec)
            priv = torch.clamp(priv, -cfg.normalization.clip_observations,
                               cfg.normalization.clip_observations)

            obs_history = torch.cat([state.obs_history[:, self.num_obs:],
                                     obs.to(state.obs_history.dtype)], dim=-1)

        # ---- action memory updates (:148-153; reset zeroing :246-248) ----
        new_state = EnvState(
            phys=phys, act=act_state,
            friction=fric, restitution=rest, payload=payload, com_displacement=com,
            motor_strength=ms, motor_offset=mo, kp_factor=kp, kd_factor=kd,
            gravity_vec=gravity_vec,
            episode_length=ep_len_post, common_step=common,
            trajectories=trajectories, curr_pose_index=idx2,
            reached=reached, plan_buf=plan_buf, replan=replan, plan_length=plan_length,
            local_target_poses=local_target, collision_count=collision_count,
            commands=commands_o,
            relative_linear=rel_lin_o, relative_rotation=rel_rot_o,
            local_relative_linear=local_rel_lin, local_relative_rotation=local_rel_rot,
            actions=actions,
            last_actions=torch.where(d1, 0.0, actions),
            last_last_actions=torch.where(d1, 0.0, state.last_actions),
            last_dof_vel=phys.v[:, 6:],
            last_joint_pos_target=act_state.joint_pos_target,
            last_last_joint_pos_target=torch.where(d1, 0.0, state.last_joint_pos_target),
            feet_air_time=feet_air_time_post, last_contacts=last_contacts,
            # the stored EMA restarts from the raw report across episode
            # boundaries (no-op at the default contact_report_ema=0)
            contact_forces=(_sel(raw_contact_forces, contact_forces, done)
                            if cfg.sim.contact_report_ema > 0.0 else contact_forces),
            torques=torques,
            obs_history=obs_history,
            exploration_lin_scale=exp_lin, exploration_yaw_scale=exp_yaw,
            target_dist=state.target_dist,
            episode_sums=episode_sums,
            measured_heights=mh_o if planning else None,
        )
        return new_state, StepOut(obs=obs, privileged_obs=priv, obs_history=obs_history,
                                  rew=rew, done=done, info=info)

    @tracing.spanned("env.observe")
    def observe(self, state: EnvState):
        """Assemble {obs, privileged_obs, obs_history} from a state without
        stepping (reference get_observations / HistoryWrapper.reset)."""
        cfg = self.cfg
        N = self.num_envs
        phys = state.phys
        norm = lambda x: torch.linalg.vector_norm(x, dim=-1)
        base_rpy = qt.quaternion_to_roll_pitch_yaw(phys.base_quat)
        g_unit = state.gravity_vec / norm(state.gravity_vec)
        proj_grav = qt.quat_rotate_inverse(phys.base_quat, g_unit.expand(N, 3))
        blv = qt.quat_rotate_inverse(phys.base_quat, phys.v[:, :3])
        bav = qt.quat_rotate_inverse(phys.base_quat, phys.v[:, 3:6])
        target = self._select_waypoint(state.trajectories, state.curr_pose_index)
        rel_lin, rel_rot = self._relative_pose(target, phys.base_pos, phys.base_quat, base_rpy)
        commands = self._commands(target, rel_lin, rel_rot)
        mh = self._get_heights(phys.base_pos, base_rpy)
        heights = obs_lib.height_obs(cfg, mh, phys.base_pos[:, 2], base_rpy[:, 1])
        foot_z = state.contact_forces[:, list(self.feet_slots), 2]
        scalars = obs_lib.scalar_obs(
            cfg, projected_gravity=proj_grav, commands=commands, dof_pos=phys.qj,
            default_dof_pos=self.default_dof_pos, dof_vel=phys.v[:, 6:],
            actions=state.actions, episode_length=state.episode_length)
        obs = obs_lib.assemble_obs(cfg, scalars, heights, base_lin_vel=blv,
                                   base_ang_vel=bav, base_quat=phys.base_quat,
                                   last_actions=state.last_actions, foot_contact_z=foot_z)
        obs = torch.clamp(obs, -cfg.normalization.clip_observations,
                          cfg.normalization.clip_observations)
        priv = obs_lib.privileged_obs(
            cfg, friction=state.friction, restitution=state.restitution,
            payload=state.payload, com_displacement=state.com_displacement,
            motor_strength=state.motor_strength, motor_offset=state.motor_offset,
            kp_factor=state.kp_factor, kd_factor=state.kd_factor,
            base_z=phys.base_pos[:, 2], base_lin_vel=blv, gravity_vec=state.gravity_vec)
        obs_history = torch.cat([state.obs_history[:, self.num_obs:],
                                 obs.to(state.obs_history.dtype)], dim=-1)
        return {"obs": obs, "privileged_obs": priv, "obs_history": obs_history}

    # --------------------------------------------------------- host wrappers
    def reset(self, randomize_ep_len: bool = True):
        self.state = self.reset_fn(randomize_ep_len)
        return self.observe(self.state)

    def step(self, actions):
        """Stateful gym-style step (reference TrajectoryTrackingEnv.step)."""
        self.state, out = self.step_fn(self.state, actions)
        obs_dict = {"obs": out.obs, "privileged_obs": out.privileged_obs,
                    "obs_history": out.obs_history}
        return obs_dict, out.rew, out.done, out.info

