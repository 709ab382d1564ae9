"""The goal recipe of the port against the JAX package on the CPU: the
trajectory functions, the TrajectoryTrackingRewards terms, and the train
entries' configurations against ``scripts/train.py`` and
``scripts/train_hierarchy.py``.  The recipe's env is stepped against the JAX
one, with the planner on, in tests/test_torch_planner.py."""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_env import JaxDraws

from legged_tracking_torch import convert
from legged_tracking_torch import train as t_train
from legged_tracking_torch import train_hierarchy as t_train_hierarchy
from legged_tracking_torch.envs import trajectories as t_traj
from legged_tracking_torch.rewards import containers as t_rew
from legged_tracking_tpu.envs import trajectories as j_traj
from legged_tracking_tpu.rewards import containers as j_rew
from legged_tracking_tpu.terrain.tunnel import build_terrain as j_build_terrain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4


def script(name):
    """``scripts/<name>.py`` of the JAX package, as a module."""
    spec = importlib.util.spec_from_file_location(f"scripts_{name}",
                                                  os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J_TRAIN, J_HIERARCHY = script("train"), script("train_hierarchy")
GOAL_FLAGS = ["--strategy", "goal", "--terrain", "random_pyramid", "--terrain_rows", "2",
              "--terrain_cols", "2"]


def goal_cfgs(num_envs=N, flags=()):
    """The goal recipe's configuration from each package's train entry."""
    argv = GOAL_FLAGS + ["--num_envs", str(num_envs), *flags]
    return J_TRAIN.build_cfg(J_TRAIN.parse_args(argv)), t_train.build_cfg(t_train.parse_args(argv))


def cfg_tree(obj):
    """A configuration as nested dicts and lists of plain values."""
    if dataclasses.is_dataclass(obj):
        return {k: cfg_tree(v) for k, v in vars(obj).items()}
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (list, tuple)):
        return [cfg_tree(x) for x in obj]
    return obj


# ------------------------------------------------------------ trajectories
def test_linspace_matches_jnp_linspace():
    """valid_goal's tie-breaking tent is built from two linspaces of
    constants: the port's float32 linspace equals jnp.linspace of constants
    under jit (what the JAX env computes) bitwise, at the widths the
    terrains have; an eager jnp.linspace, and torch.linspace, differ from
    it in the last ulp somewhere."""
    eager_differs = torch_differs = False
    for w in (2, 11, 20, 32, 40, 61, 100):
        for a, b in ((-0.01, 0.01), (0.01, -0.01)):
            ours = t_traj.linspace_f32(a, b, w).numpy()
            np.testing.assert_array_equal(ours, np.asarray(jax.jit(
                lambda: jnp.linspace(a, b, w))()))
            eager_differs |= not np.array_equal(ours, np.asarray(jnp.linspace(a, b, w)))
            torch_differs |= not np.array_equal(ours, torch.linspace(a, b, w).numpy())
    assert eager_differs and torch_differs


@pytest.fixture(scope="module")
def goal_terrain():
    """2x2 random_pyramid tiles of the goal recipe (100x32 cells), the JAX
    package's build, and its numpy leaves."""
    jcfg, _ = goal_cfgs(num_envs=8)
    terrain = j_build_terrain(jcfg, 8, 3)
    leaves = {k: (np.asarray(v) if hasattr(v, "shape") else v)
              for k, v in terrain._asdict().items()}
    return terrain, leaves


@pytest.mark.parametrize("name", ["random_goal", "valid_goal", "valid_goal_grid_aligned",
                                  "random_target"])
def test_trajectory_functions_match_jax(goal_terrain, name):
    """Each trajectory function on the JAX env's per-env keys (the port
    reads the same uniforms through JaxDraws, under the reset key's tag 14)
    against the jitted JAX function: bitwise.  The grid-aligned case puts
    every goal x on a cell boundary, where x / hs and x * (1 / hs) pick
    different cells."""
    jterrain, leaves = goal_terrain
    n = 8
    flags = ["--random_target"] if name == "random_target" else []
    jcfg, tcfg = goal_cfgs(num_envs=n, flags=flags)
    fn = name.replace("_grid_aligned", "")
    for cfg in (jcfg, tcfg):
        cfg.commands.traj_function = fn
        if name == "random_target":
            cfg.commands.traj_length = 10
            cfg.commands.num_interpolation = 2
        if name == "random_goal":
            cfg.commands.y_range = 0.6
    rng = np.random.RandomState(4)
    origin = leaves["env_terrain_origin"]
    base = (origin + np.array([0.4, 0.8, 0.3]) + rng.uniform(-0.3, 0.3, (n, 3))).astype(np.float32)
    dist = rng.uniform(0.6, 3.8, n).astype(np.float32)
    if name == "valid_goal_grid_aligned":
        for cfg in (jcfg, tcfg):
            cfg.commands.x_range = 0.0
        hs = leaves["horizontal_scale"]
        base[:, 0] = origin[:, 0] + hs * rng.randint(10, 40, n)
        dist = (hs * rng.randint(12, 40, n)).astype(np.float32)

    key = jax.random.key(7)
    draws = JaxDraws(key, n)
    keys = JaxDraws._fold(draws.reset_keys, 14)
    jf = jax.jit(jax.vmap(lambda k, bp, tile, to, d: getattr(j_traj, fn)(
        k, bp, jcfg, jterrain, tile, to, d)))
    want = np.asarray(jf(keys, jnp.asarray(base), jterrain.env_tile,
                         jterrain.env_terrain_origin, jnp.asarray(dist)))
    tterrain = convert.terrain_from_numpy(leaves, device="cpu")
    got = t_traj.TRAJ_FUNCTIONS[fn](draws, ("reset", 14), torch.as_tensor(base), tcfg,
                                    tterrain, torch.as_tensor(dist)[:, None]).numpy()
    assert got.shape == want.shape == (n, tcfg.commands.traj_length, 6)
    np.testing.assert_array_equal(got, want)
    if fn == "valid_goal":
        assert len(np.unique(got[:, 0, 1])) > 1          # goals at several openings


# ------------------------------------------------------------------ rewards
def reward_ctx(mod, cfg, seed=0, n=16):
    """One random RewardCtx, as numpy values fed to ``mod``'s tensor type."""
    rng = np.random.RandomState(seed)
    r = lambda *s: rng.normal(size=s).astype(np.float32)
    b = lambda *s: rng.uniform(size=s) < 0.5
    vals = dict(
        base_pos=r(n, 3), base_lin_vel=0.3 * r(n, 3), base_ang_vel=r(n, 3),
        projected_gravity=r(n, 3), dof_pos=r(n, 12), dof_vel=r(n, 12), last_dof_vel=r(n, 12),
        default_dof_pos=r(12), dof_pos_soft_limits=np.sort(r(12, 2), axis=1),
        torques=10 * r(n, 12), actions=r(n, 12), last_actions=r(n, 12),
        contact_forces=r(n, 17, 3), relative_linear=r(n, 3), relative_rotation=r(n, 3),
        local_relative_linear=r(n, 3), reached_buf=b(n), plan_buf=b(n), replan=b(n),
        episode_length_buf=rng.randint(0, 400, n).astype(np.int32), reset_buf=b(n),
        feet_air_time=rng.uniform(0, 1, (n, 4)).astype(np.float32),
        feet_first_contact=b(n, 4))
    vals["base_lin_vel"][: n // 4] *= 0.05          # below the small-velocity threshold
    vals["relative_linear"][: n // 4] *= 0.1        # within reach
    tensor = jnp.asarray if mod is j_rew else torch.as_tensor
    return mod.RewardCtx(dt=cfg.dt, max_episode_length=float(cfg.env.max_episode_length),
                         penalised_slots=(1, 2, 5, 9), feet_slots=(3, 7, 11, 15),
                         **{k: tensor(v) for k, v in vals.items()})


@pytest.mark.parametrize("term", sorted(j_rew.TRAJECTORY_TRACKING_REWARDS))
def test_trajectory_tracking_rewards_match_jax(term):
    """Every TrajectoryTrackingRewards term on one random context against
    the jitted JAX term: float32 elementwise work and short sums, so within
    1e-6 relative (1e-6 absolute near zero)."""
    jcfg, tcfg = goal_cfgs()
    for cfg in (jcfg, tcfg):
        cfg.parse()
    assert sorted(t_rew.TRAJECTORY_TRACKING_REWARDS) == sorted(j_rew.TRAJECTORY_TRACKING_REWARDS)
    assert t_rew.get_container("TrajectoryTrackingRewards") is t_rew.TRAJECTORY_TRACKING_REWARDS
    want = np.asarray(jax.jit(lambda c: j_rew.TRAJECTORY_TRACKING_REWARDS[term](c, jcfg))(
        reward_ctx(j_rew, jcfg)))
    got = t_rew.TRAJECTORY_TRACKING_REWARDS[term](reward_ctx(t_rew, tcfg), tcfg).numpy()
    assert got.shape == want.shape == (16,)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ configuration
@pytest.mark.parametrize("flags", [
    ["--strategy", "goal", "--terrain", "random_pyramid"],
    ["--strategy", "goal", "--terrain", "random_pyramid", "--num_envs", "64",
     "--max_noise_std", "1.0", "--cl_goal_target_dist", "3.8", "--cl_downstep", "0.5",
     "--cl_dist_mix", "0.1", "--cl_probe", "0", "--cl_restore_best", "0"],
    ["--strategy", "pms", "--terrain", "multi_path", "--tunnel_width", "1.5", "--old_ppo"],
    ["--random_target", "--old_ppo"],
    ["--strategy", "e2e", "--terrain", "single_path", "--cnn", "--gru"],
    ["--strategy", "e2e", "--old_ppo", "--dr_profile", "large"],
    ["--strategy", "goal", "--terrain", "random_pyramid", "--dr_profile", "regular"],
], ids=["goal", "goal_stage_a", "pms_multi_path", "random_target", "e2e_cnn_gru",
        "e2e_dr_large", "goal_dr_regular"])
def test_train_build_cfg_matches_scripts(flags):
    """train.build_cfg gives the configuration scripts/train.py builds from
    the same flags, field by field, and leaves the same defaults in the
    parsed flags (4096 envs and the std ceiling for --strategy goal)."""
    jargs, targs = J_TRAIN.parse_args(flags), t_train.parse_args(flags)
    jcfg, tcfg = J_TRAIN.build_cfg(jargs), t_train.build_cfg(targs)
    assert cfg_tree(tcfg) == cfg_tree(jcfg)
    for k in ("num_envs", "max_noise_std", "entropy_coef", "cnn", "gru",
              "critic_detach_encoder"):
        assert getattr(targs, k) == getattr(jargs, k), k


@pytest.mark.parametrize("flags", [[], ["--plan_interval", "2", "--num_envs", "8",
                                        "--difficulty_level", "0", "--no_curriculum"]],
                         ids=["defaults", "small"])
def test_train_hierarchy_build_cfg_matches_scripts(flags):
    """train_hierarchy.build_cfg gives scripts/train_hierarchy.py's
    configuration (its argparse defaults are the port's parse_args
    defaults)."""
    args = t_train_hierarchy.parse_args(flags)
    assert cfg_tree(t_train_hierarchy.build_cfg(args)) == cfg_tree(J_HIERARCHY.build_cfg(args))
    assert args.num_envs == (4000 if not flags else 8)
