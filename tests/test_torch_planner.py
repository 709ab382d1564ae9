"""The port's sampling-based local planner against the JAX package's on the
CPU: ``_plan_local_targets`` on fed states and scans, the quadform against
the direct form, a 4-env planner env of the goal recipe stepped under the
JAX env's draws, and the tunnel traversability check."""

from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_support import J_TRAIN, JaxDraws, bench_cfg, install_jax_draws, to_numpy

from legged_tracking_torch import convert
from legged_tracking_torch import train as t_train
from legged_tracking_torch.config import Cfg as TCfg
from legged_tracking_torch.config import config_go1 as t_config_go1
from legged_tracking_torch.envs import LeggedEnv as TEnv
from legged_tracking_torch.terrain.tunnel import build_terrain as t_build_terrain
from legged_tracking_torch.utils import planner as t_planner
from legged_tracking_torch.utils import quat as tqt
from legged_tracking_tpu.config import Cfg, config_go1
from legged_tracking_tpu.envs import LeggedEnv as JEnv
from legged_tracking_tpu.rewards.containers import TRAJECTORY_TRACKING_REWARDS
from legged_tracking_tpu.terrain.tunnel import build_terrain as j_build_terrain
from legged_tracking_tpu.utils import planner as j_planner
from legged_tracking_tpu.utils import quat as jqt

N = 4
# the fields of EnvState that _plan_local_targets reads
PlanState = namedtuple("PlanState", "plan_length plan_buf local_target_poses")


def planner_cfg(cfg_cls, go1, apply_goal_recipe, num_envs=N):
    """The bench's single_path tiles with the goal recipe (its train entry's
    ``_apply_goal_recipe``: TrajectoryTrackingRewards, valid_goal targets,
    the recipe's DR and P control) and the planner on, replanning every 2
    steps; every TrajectoryTrackingRewards term scaled, so each reaches the
    reward; 3-step episodes so that the auto-reset runs.  One configuration
    for the planner and the goal recipe's env keeps this file to one
    compile of the JAX ``step_fn``."""
    cfg = bench_cfg(cfg_cls, go1, num_envs=num_envs)
    apply_goal_recipe(cfg)
    cfg.env.episode_length_s = 0.06
    cfg.commands.sampling_based_planning = True
    cfg.commands.plan_interval = 2
    for i, name in enumerate(sorted(TRAJECTORY_TRACKING_REWARDS)):
        if not dict(cfg.reward_scales.items()).get(name):
            cfg.reward_scales.set(name, 0.01 * (i % 3 + 1))
    return cfg


@pytest.fixture(scope="module")
def envs():
    jenv = JEnv(planner_cfg(Cfg, config_go1, J_TRAIN._apply_goal_recipe), seed=3)
    tenv = TEnv(planner_cfg(TCfg, t_config_go1, t_train._apply_goal_recipe), seed=3,
                device="cpu")
    return jenv, tenv


def fed_inputs(env, n, seed):
    """Planner inputs for n envs: random poses, goals and plan state, and
    scans of a floor with a wall strip across y at a random height per
    env (some envs fully blocked), under a 0.8 m ceiling."""
    rng = np.random.RandomState(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    nx, ny = env.height_grid_shape
    pts = np.asarray(env.height_points).reshape(nx, ny, 2)
    wall_y = rng.uniform(-0.5, 0.5, (n, 1, 1))
    wall_h = rng.choice([0.0, 0.2, 0.3, 0.45], (n, 1, 1))
    floor = np.where(np.abs(pts[None, :, :, 1] - wall_y) < 0.15, wall_h, 0.0)
    floor[: n // 8] = 0.3                       # every candidate blocked
    ceiling = 0.8 - 0.4 * (rng.uniform(size=(n, nx, ny)) < 0.03)
    mh = f32(np.stack([ceiling, floor + 0.02 * rng.uniform(size=floor.shape)], axis=1))
    yaw = rng.uniform(-np.pi, np.pi, n)
    base_quat = f32(np.stack([np.zeros(n), np.zeros(n), np.sin(yaw / 2), np.cos(yaw / 2)], -1))
    base_pos = f32(np.concatenate([rng.uniform(-2, 2, (n, 2)), np.full((n, 1), 0.3)], -1))
    base_rpy = f32(np.stack([np.zeros(n), np.zeros(n), yaw], -1))
    target = f32(np.concatenate([base_pos[:, :2] + rng.uniform(-3, 3, (n, 2)),
                                 rng.uniform(-0.5, 0.5, (n, 4))], -1))
    target[: n // 6, :2] = base_pos[: n // 6, :2] + 0.5      # close: keep the goal
    state = PlanState(plan_length=rng.randint(0, 5, n).astype(np.int32),
                      plan_buf=rng.uniform(size=n) < 0.5,
                      local_target_poses=f32(rng.uniform(-1, 1, (n, 6))))
    ep_len = rng.randint(1, 4, n).astype(np.int32)
    return state, target, base_pos, base_quat, base_rpy, mh, ep_len


def test_plan_local_targets_matches_jax(envs):
    """On 64 fed inputs the port picks the jitted JAX planner's candidate in
    every env: local targets within 1e-6 (the world transform's float32
    arithmetic), plan_length and replan equal."""
    jenv, tenv = envs
    n = 64
    state, target, base_pos, base_quat, base_rpy, mh, ep_len = fed_inputs(jenv, n, seed=0)
    rel_lin = np.array(jqt.quat_apply_yaw_inverse(jnp.asarray(base_quat),
                                                    jnp.asarray(target[:, :3] - base_pos)))

    def jplan(state, *a):
        return jenv._plan_local_targets(state, *a)
    j_args = (PlanState(*map(jnp.asarray, state)),) + tuple(
        jnp.asarray(x) for x in (target, rel_lin, base_pos, base_quat, base_rpy, mh, ep_len))
    jl, jpl, jrp = (np.asarray(x) for x in jax.jit(jplan)(*j_args))
    t_args = (PlanState(*map(torch.as_tensor, state)),) + tuple(
        torch.as_tensor(x) for x in (target, rel_lin, base_pos, base_quat, base_rpy, mh, ep_len))
    tl, tpl, trp = (x.numpy() for x in tenv._plan_local_targets(*t_args))

    differing = int(np.sum(np.abs(tl - jl).max(axis=1) > 1e-4))
    assert differing == 0, differing
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tpl, jpl)
    np.testing.assert_array_equal(trp, jrp)
    # the inputs exercise both outcomes: envs that plan to a candidate, envs
    # that keep the goal (blocked or close) and envs that keep their target
    valid = tenv.candidates_valid(tenv.scan_points(torch.as_tensor(mh)))
    any_valid = valid.any(dim=1).numpy()
    assert any_valid.any() and not any_valid.all()
    assert 0 < int(valid.sum()) < valid.numel()


def test_quadform_matches_direct(envs):
    """The port's quadform weights agree with the JAX package's to 1e-5
    relative (both take the candidates' yaw from a float32 quaternion, whose
    sin and cos differ by an ulp between XLA and torch, and the constant
    term cancels; 2.7e-6 read), and
    its quadform validity equals its direct form's on fed scans: zero
    mismatches in 64 x 1,575 candidates."""
    jenv, tenv = envs
    np.testing.assert_allclose(tenv._cand_quad_w.numpy(), np.asarray(jenv._cand_quad_w),
                               rtol=1e-5, atol=0)
    np.testing.assert_array_equal(tenv._candidate_poses.numpy(),
                                  np.asarray(jenv._candidate_poses))
    *_, mh, _ = fed_inputs(jenv, 64, seed=1)
    pts = tenv.scan_points(torch.as_tensor(mh))
    quad = tenv.candidates_valid(pts, quadform=True)
    direct = tenv.candidates_valid(pts, quadform=False)
    assert int((quad != direct).sum()) == 0
    assert 0 < int(quad.sum()) < quad.numel()


def test_planner_env_steps_match_jax(envs):
    """4 step_fns of the 4-env planner env from the JAX reset state, under
    the JAX env's draws: the reset's valid_goal targets and stored scan
    bitwise; at every step dones, plan state, replan and the targets
    exact, the stored scan bitwise, local targets within 1e-5 m, obs 5e-5,
    base positions 1e-6, rewards 1e-6 and the episodic sums 1e-5 (the
    limits of the no-planner env's parity, tests/test_torch_env.py); after
    them the stored scan equals a fresh scan at the stored pose."""
    jenv, tenv = envs
    assert tenv.reward_names == jenv.reward_names
    assert set(TRAJECTORY_TRACKING_REWARDS) <= set(tenv.reward_names)
    key = jax.random.key(5)
    jstate = jenv._reset_jit(key, True)
    assert jstate.measured_heights is not None
    install_jax_draws(tenv, JaxDraws(key, N))
    try:
        tstate = tenv.reset_fn(True)
        np.testing.assert_array_equal(tstate.measured_heights.numpy(),
                                      np.asarray(jstate.measured_heights))
        np.testing.assert_array_equal(tstate.trajectories.numpy(),
                                      np.asarray(jstate.trajectories))
        tstate = convert.env_state_from_numpy(to_numpy(jstate), device="cpu")
        js = jstate
        step_j = jax.jit(jenv.step_fn)
        n_done = 0
        for i in range(4):
            a = 0.3 * np.sin(0.1 * i + np.arange(N * 12, dtype=np.float32)).reshape(N, 12)
            js, oj = step_j(js, jnp.asarray(a))
            tstate, ot = tenv.step_fn(tstate, torch.as_tensor(a))
            msg = f"step {i}"
            np.testing.assert_array_equal(ot.done.numpy(), np.asarray(oj.done), err_msg=msg)
            n_done += int(np.asarray(oj.done).sum())
            for k in ("plan_length", "plan_buf", "replan", "trajectories"):
                np.testing.assert_array_equal(getattr(tstate, k).numpy(),
                                              np.asarray(getattr(js, k)), err_msg=f"{msg} {k}")
            np.testing.assert_allclose(tstate.local_target_poses.numpy(),
                                       np.asarray(js.local_target_poses), rtol=0, atol=1e-5,
                                       err_msg=msg)
            np.testing.assert_allclose(ot.obs.numpy(), np.asarray(oj.obs), rtol=0, atol=5e-5,
                                       err_msg=msg)
            np.testing.assert_allclose(tstate.phys.base_pos.numpy(),
                                       np.asarray(js.phys.base_pos), rtol=0, atol=1e-6,
                                       err_msg=msg)
            np.testing.assert_allclose(ot.rew.numpy(), np.asarray(oj.rew), rtol=0, atol=1e-6,
                                       err_msg=msg)
            np.testing.assert_allclose(ot.info["episode_sums"].numpy(),
                                       np.asarray(oj.info["episode_sums"]), rtol=0, atol=1e-5,
                                       err_msg=msg)
            np.testing.assert_array_equal(tstate.measured_heights.numpy(),
                                          np.asarray(js.measured_heights), err_msg=msg)
        assert n_done > 0
    finally:
        del tenv.draw, tenv.step_fn
    rpy = tqt.quaternion_to_roll_pitch_yaw(tstate.phys.base_quat)
    fresh = tenv._get_heights(tstate.phys.base_pos, rpy)
    assert torch.equal(tstate.measured_heights, fresh)
    assert bool(np.asarray(js.replan).any() or np.asarray(js.plan_length).any())


def test_valid_checking_matches_jax():
    """valid_checking on fed elevation maps, and a valid_tunnel_only build of
    2x2 single_path tiles: the port's copy agrees with the JAX package's."""
    rng = np.random.RandomState(0)
    hs = 0.05
    for k in range(6):
        top = np.full((72, 20), 0.8) - rng.uniform(0, 0.6, (72, 20)) * (rng.uniform(size=(72, 20))
                                                                        < 0.1 * k)
        bottom = rng.uniform(0, 0.3, (72, 20)) * (rng.uniform(size=(72, 20)) < 0.1 * k)
        emap = np.stack([top, bottom])
        start = np.array([-1.35, 0, 0.27, 0, 0, 0, 1.0])
        goal = np.array([1.35, 0, 0.27, 0, 0, 0, 1.0])
        args = (emap, start, goal, 4.0, 2.0, 0.5, hs)
        assert t_planner.valid_checking(*args) == j_planner.valid_checking(*args), k
    for cls, go1, build, kw in ((TCfg, t_config_go1, t_build_terrain, {"device": "cpu"}),
                                (Cfg, config_go1, j_build_terrain, {})):
        cfg = bench_cfg(cls, go1)
        cfg.terrain.valid_tunnel_only = True
        cfg.terrain.p_flat = 0.0
        built = build(cfg, N, 3, **kw)
        if cls is TCfg:
            ours = built.tiles.numpy()
        else:
            theirs = np.asarray(built.tiles)
    np.testing.assert_array_equal(ours, theirs)
