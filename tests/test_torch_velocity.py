"""The port's velocity-tracking (walk-these-ways) path against the JAX
package on the CPU: the legged_gym terrain, the curriculum's tables, update
and sampling, the gait clocks, the 24 CoRL reward terms, the env's reset,
observe and steps under the JAX env's draws, the train entry's
configuration, and the curriculum weights of a checkpoint crossing between
the two Runners.

The env is ``scripts/train_velocity_tracking.py``'s configuration cut to 4
envs on 2 x 2 trimesh tiles of 5 m at 0.10 m (50 x 50 cells), with
resamples every 2 steps and 3-step episodes, so that the curriculum update,
the command resample and the auto-reset all run within 4 steps; the JAX env
runs its env-major physics (``lane_engine=False``), jitted.
"""

import importlib.util
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_env import JaxDraws, assert_state_close, to_numpy
from test_torch_goal import cfg_tree

from legged_tracking_torch import convert
from legged_tracking_torch import train_velocity_tracking as t_tv
from legged_tracking_torch.envs.velocity_env import VelocityTrackingEnv as TEnv
from legged_tracking_torch.learn.runner import Runner as TRunner
from legged_tracking_torch.learn.runner import RunnerArgs as TRunnerArgs
from legged_tracking_torch.rewards import containers as t_rew
from legged_tracking_torch.tasks import curriculum as t_cur
from legged_tracking_torch.tasks import gaits as t_gaits
from legged_tracking_torch.terrain import heightfield as t_hf
from legged_tracking_torch.terrain import legged_gym_terrains as t_lgt
from legged_tracking_tpu.envs.velocity_env import VelocityTrackingEnv as JEnv
from legged_tracking_tpu.learn import ppo as j_ppo
from legged_tracking_tpu.learn.runner import Runner as JRunner
from legged_tracking_tpu.learn.runner import RunnerArgs as JRunnerArgs
from legged_tracking_tpu.rewards import containers as j_rew
from legged_tracking_tpu.tasks import corl_rewards as j_corl
from legged_tracking_tpu.tasks import curriculum as j_cur
from legged_tracking_tpu.tasks import gaits as j_gaits
from legged_tracking_tpu.terrain import heightfield as j_hf
from legged_tracking_tpu.terrain import legged_gym_terrains as j_lgt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4


def _script():
    spec = importlib.util.spec_from_file_location(
        "scripts_train_velocity_tracking",
        os.path.join(ROOT, "scripts", "train_velocity_tracking.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J_TV = _script()
SMALL = ["--num_envs", str(N), "--terrain_rows", "2", "--terrain_cols", "2"]


def velocity_cfgs(flags=SMALL, resampling_time=0.04, episode_s=0.06):
    """The script's configuration from each package's entry, with commands
    resampled every ``resampling_time`` s (2 steps), episodes of
    ``episode_s`` (3 steps), lower curriculum thresholds, and the JAX env's
    env-major physics."""
    out = []
    for mod in (J_TV, t_tv):
        cfg = mod.build_cfg(mod.parse_args(flags))
        cfg.commands.resampling_time = resampling_time
        cfg.env.episode_length_s = episode_s
        cfg.sim.lane_engine = False
        # the curriculum starts from its centre bin alone, and its success
        # thresholds are an eighth of the defaults, so that some envs clear
        # them within 2 steps and the weights around them move
        cfg.commands.lin_vel_x = cfg.commands.ang_vel_yaw = [-0.3, 0.3]
        for k in ("tracking_lin_vel", "tracking_ang_vel", "tracking_contacts_shaped_force",
                  "tracking_contacts_shaped_vel"):
            setattr(cfg.curriculum_thresholds, k, getattr(cfg.curriculum_thresholds, k) / 8)
        out.append(cfg)
    return out


class VelocityDraws(JaxDraws):
    """``JaxDraws`` for the velocity env: integer draws (the gait category),
    draws under the state key (``("rng", ...)``, the reset's resample), and
    :meth:`bins`, the JAX curriculum's categorical, in place of the env's
    ``draw_bins``."""

    def _keys(self, ns, path):
        keys = {"reset": self.reset_keys, "step": self.kstep, "rng": self.rng}[ns]
        for t in path:
            if isinstance(t, tuple):
                _, n, i = t
                keys = jax.vmap(lambda k: jax.random.split(k, n)[i])(keys)
            else:
                keys = self._fold(keys, t)
        return keys

    def __call__(self, tag, shape, lo, hi, integer=False):
        ns, path = tag[0], tag[1:]
        if ns == "rng" or (integer and path != ("ep_len",)):
            keys = self._keys(ns, path)
            if integer:
                v = jax.vmap(lambda k: jax.random.randint(k, shape[1:], lo, hi))(keys)
                return torch.as_tensor(np.array(v, np.int32))
            v = jax.vmap(lambda k: jax.random.uniform(k, shape[1:], minval=lo, maxval=hi))(keys)
            return torch.as_tensor(np.array(v))
        return super().__call__(tag, shape, lo, hi, integer)

    def bins(self, tag, weights, categories):
        keys = self._keys(tag[0], tag[1:])
        return torch.as_tensor(np.asarray(
            _categorical(keys, jnp.asarray(weights.numpy()), jnp.asarray(categories.numpy())),
            np.int32))


@jax.jit
def _categorical(keys, weights, categories):
    """DeviceCurriculum.sample's bin draw (tasks/curriculum.py:214-219)."""
    logits = jnp.log(jnp.maximum(weights[categories], 1e-12))
    return jax.vmap(jax.random.categorical)(keys, logits)


def install(env, draws):
    """Route env's draws to ``draws`` and advance its keys after each step."""
    env.draw, env.draw_bins = draws, draws.bins
    step_fn = env.step_fn

    def stepped(state, actions):
        out = step_fn(state, actions)
        draws.advance()
        return out

    env.step_fn = stepped
    return env


def uninstall(env):
    for name in ("draw", "draw_bins", "step_fn"):
        env.__dict__.pop(name, None)


@pytest.fixture(scope="module")
def envs():
    """One JAX velocity env (reset, observe and step jitted once) and its
    port twin, and the JAX reset state with randomized episode lengths."""
    jcfg, tcfg = velocity_cfgs()
    jenv = JEnv(jcfg, seed=3)
    tenv = TEnv(tcfg, seed=3, device="cpu")
    key = jax.random.key(5)
    jstate = jenv._reset_jit(key, True)
    return jenv, tenv, key, jstate


# ----------------------------------------------------------------- terrain
ALL_KINDS = [0.1] * 10


@pytest.mark.parametrize("mesh,proportions,curriculum", [
    ("plane", None, False), ("trimesh", None, False),
    ("trimesh", ALL_KINDS, False), ("trimesh", ALL_KINDS, True)],
    ids=["plane", "trimesh_script", "trimesh_every_kind", "trimesh_curriculum"])
def test_velocity_terrain_bitwise(mesh, proportions, curriculum):
    """The env's world, bitwise: the plane's dummy tiles and spawn grid, and
    build_velocity_terrain's tiles, spawn origins (z the float32 tile max)
    and tile assignment for the same seed.  The script's proportions take
    the random-uniform branch with a zero-width range (one height, 0); the
    spread proportions reach every tile kind (slopes, rough slopes,
    stairs up and down, obstacles, stepping stones, rough ground, the
    half-flat rough tile) on 6 x 6 tiles, with and without the curriculum's
    row/column choice."""
    flags = ["--num_envs", "40", "--terrain", mesh, "--terrain_rows", "6",
             "--terrain_cols", "6"]
    jcfg, tcfg = velocity_cfgs(flags)
    for cfg in (jcfg, tcfg):
        if proportions is not None:
            cfg.terrain.terrain_proportions = proportions
            cfg.terrain.terrain_noise_magnitude = 0.05
        cfg.terrain.curriculum = curriculum
    if mesh == "plane":
        jt, tt = j_hf.plane_terrain(40), t_hf.plane_terrain(40, device="cpu")
    else:
        jt = j_lgt.build_velocity_terrain(jcfg.terrain, 40, seed=7)
        tt = t_lgt.build_velocity_terrain(tcfg.terrain, 40, seed=7, device="cpu")
        assert tt.tiles.shape == (36, 2, 50, 50)
        assert float(tt.tiles[:, 1].abs().max()) > (0.0 if proportions else -1.0)
    for name, v in convert.terrain_to_numpy(tt).items():
        want = getattr(jt, name)
        np.testing.assert_array_equal(v, np.asarray(want), err_msg=name)


def near_midpoint_triples(n, seed):
    """float32 (a, b, c) whose exact a * b + c lies a hair off a float32
    midpoint next to c: a * b = (half the gap from c to its neighbour) *
    (1 +- u^3), u = 2^-k for k in 10..16, as (1 +- u)(1 -+ u + u^2).  The
    float64 sum rounds onto the midpoint, where a cast to float32 breaks the
    tie to even, which for about a third of them is the wrong side."""
    rng = np.random.RandomState(seed)
    u = np.ldexp(1.0, -rng.randint(10, 17, n))
    s = rng.choice([-1.0, 1.0], n)
    c = (rng.uniform(0.01, 100.0, n) * rng.choice([-1.0, 1.0], n)).astype(np.float32)
    up = rng.rand(n) < 0.5
    nb = np.where(up, np.nextafter(c, np.float32(np.inf)), np.nextafter(c, np.float32(-np.inf)))
    half = (nb.astype(np.float64) - c) / 2
    e = np.floor(np.log2(np.abs(half))).astype(int)
    ea = e // 2 + rng.randint(-3, 4, n)
    a = np.ldexp(1.0 + s * u, ea).astype(np.float32)
    b = (np.sign(half) * np.ldexp(1.0 - s * u + u * u, e - ea)).astype(np.float32)
    return a, b, c


def test_fma_rounds_once_as_jitted_jax():
    """utils.math.fma equals the jitted JAX ``a * b + c`` (one fused
    multiply-add, rounded once) bitwise: on ROADMAP §C's triple, which a
    float64 sum cast to float32 misses by one ulp, and on 100,000 crafted
    near-midpoint triples, about a third of which that cast misses."""
    from legged_tracking_torch.utils.math import fma

    a, b, c = near_midpoint_triples(100_000, 0)
    a = np.concatenate([[6.618818133574678e-07], a]).astype(np.float32)
    b = np.concatenate([[0.04502665251493454], b]).astype(np.float32)
    c = np.concatenate([[0.5886133909225464], c]).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    double_rounded = (a.astype(np.float64) * b + c).astype(np.float32)
    assert double_rounded[0] != want[0] and (double_rounded != want).mean() > 0.2
    got = fma(*map(torch.as_tensor, (a, b, c))).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] == np.float32(0.5886134505271912)


def test_sample_height_nearest_matches_jax():
    """sample_height_nearest on the 50 x 50-cell tiles at random points and
    at points on cell boundaries (where the compiled division by the cell
    size decides the cell), against the jitted JAX sampler: bitwise."""
    jcfg, tcfg = velocity_cfgs(["--num_envs", "8", "--terrain_rows", "2", "--terrain_cols", "2"])
    for cfg in (jcfg, tcfg):
        cfg.terrain.terrain_proportions = ALL_KINDS
    jt = j_lgt.build_velocity_terrain(jcfg.terrain, 8, seed=1)
    tt = t_lgt.build_velocity_terrain(tcfg.terrain, 8, seed=1, device="cpu")
    rng = np.random.RandomState(0)
    origin = np.asarray(jt.env_terrain_origin)[:, None, :2]
    pts = np.concatenate([origin + rng.uniform(-0.5, 5.5, (8, 30, 2)),
                          origin + rng.randint(0, 50, (8, 30, 2)) * np.float32(0.1)],
                         axis=1).astype(np.float32)
    want = jax.jit(lambda p: j_hf.sample_height_nearest(jt, jt.env_tile, jt.env_terrain_origin,
                                                        p))(jnp.asarray(pts))
    got = t_hf.sample_height_nearest(tt, tt.env_tile, tt.env_terrain_origin, torch.as_tensor(pts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -------------------------------------------------------------- curriculum
def test_curriculum_tables_bitwise(envs):
    """The envs' curricula: _make_grid's bin centres and sizes, the
    neighbour table and the initial weights of the script's 441-bin, 4-gait
    curriculum, bitwise."""
    jc, tc = envs[0].curriculum, envs[1].curriculum
    assert tc.num_bins == 441
    np.testing.assert_array_equal(tc.grid.numpy(), np.asarray(jc.const.grid))
    np.testing.assert_array_equal(tc.bin_sizes.numpy(), np.asarray(jc.const.bin_sizes))
    np.testing.assert_array_equal(tc.neighbour.numpy(), np.asarray(jc.const.neighbour))
    np.testing.assert_array_equal(tc.init_weights.numpy(), np.asarray(jc.init_weights))
    for ranges in ([(-1, 1, 5), (-1, 1, 3)], [(0.0, 1.0, 7), (-0.3, 0.9, 4), (2.0, 4.0, 1)]):
        for got, want in zip(t_cur._make_grid(ranges), j_cur._make_grid(ranges)):
            np.testing.assert_array_equal(got, want)


def test_curriculum_update_bitwise(envs):
    """DeviceCurriculum.update against the jitted JAX update, bitwise: 64
    envs, many of them in the same few bins and categories (overlapping
    neighbourhoods add up before the clip), from weights that are multiples
    of 0.2, a bumped run, and random weights."""
    jc, tc = envs[0].curriculum, envs[1].curriculum
    rng = np.random.RandomState(0)
    n = 64
    upd = jax.jit(jc.update)
    for w0 in (np.array(jc.init_weights),
               (rng.randint(0, 6, (4, 441)) * np.float32(0.2)).astype(np.float32),
               rng.uniform(0, 1, (4, 441)).astype(np.float32)):
        cats = rng.randint(0, 4, n).astype(np.int32)
        bins = rng.choice([0, 1, 220, 221, 240, 440], n).astype(np.int32)
        success = rng.uniform(size=n) < 0.6
        want = upd(jnp.asarray(w0), jnp.asarray(cats), jnp.asarray(bins), jnp.asarray(success))
        got = tc.update(torch.as_tensor(w0), torch.as_tensor(cats), torch.as_tensor(bins),
                        torch.as_tensor(success))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert float(np.abs(np.asarray(want) - w0).max()) > 0


def test_curriculum_sample_fed_bins_and_uniforms(envs):
    """DeviceCurriculum.sample's draws fed to the port: the JAX categorical's
    bins and uniforms give the JAX commands bitwise (the cell value is one
    fused multiply-add).  The port's own inverse CDF, fed a uniform inside
    a bin's share, returns that bin; over 200k uniforms every bin's share
    is its weight's within 5 standard errors, and no bin of weight 0 is
    drawn."""
    jc, tc = envs[0].curriculum, envs[1].curriculum
    rng = np.random.RandomState(1)
    n = 256
    w = (rng.randint(0, 6, (4, 441)) * np.float32(0.2)).astype(np.float32)
    w[:, :200] = 0.0
    cats = rng.randint(0, 4, n).astype(np.int32)
    keys = jax.random.split(jax.random.key(3), n)
    cmds, bins = jax.jit(jc.sample)(keys, jnp.asarray(w), jnp.asarray(cats))
    k2 = jax.vmap(lambda k: jax.random.split(k)[1])(keys)
    u = jax.vmap(lambda k: jax.random.uniform(k, (15,), minval=-0.5, maxval=0.5))(k2)
    got = tc.values(torch.as_tensor(np.asarray(bins)), torch.as_tensor(np.asarray(u)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(cmds))

    # the inverse CDF: a uniform at the middle of the JAX bin's share
    p = np.maximum(w[cats].astype(np.float64), 1e-12)
    cdf = np.cumsum(p, axis=1)
    b = np.asarray(bins)
    lo = np.where(b > 0, cdf[np.arange(n), np.maximum(b - 1, 0)], 0.0)
    mid = ((lo + cdf[np.arange(n), b]) / 2 / cdf[:, -1]).astype(np.float32)
    mine = tc.bins_from_uniform(torch.as_tensor(w), torch.as_tensor(cats), torch.as_tensor(mid))
    np.testing.assert_array_equal(mine.numpy(), b)

    m = 200_000
    cat1 = torch.ones(m, dtype=torch.int32)
    drawn = tc.bins_from_uniform(torch.as_tensor(w), cat1,
                                 torch.rand(m, generator=torch.Generator().manual_seed(0)))
    share = np.bincount(drawn.numpy(), minlength=441) / m
    want = w[1] / w[1].sum()
    z = np.abs(share - want) / np.sqrt(want * (1 - want) / m + 1e-30)
    assert z.max() < 5.0, z.max()            # each bin within 5 standard errors
    assert share[w[1] == 0].sum() == 0


# ------------------------------------------------------------------- gaits
def test_step_contact_targets_matches_jax():
    """Gait clocks from the jitted JAX step_contact_targets: the gait and
    foot phases bitwise (``g + dt * f`` is one fused multiply-add, the wrap
    a remainder), including phases at and just below 0 and 1 and sums that
    wrap exactly; the clocks (``sin``) and the desired contact states
    (``erf``, each library's own float32 polynomial) within 1e-6 (read
    6.0e-8 and 2.4e-7)."""
    rng = np.random.RandomState(0)
    n = 64
    below1 = np.nextafter(np.float32(1), np.float32(0))
    g = rng.uniform(0, 1, n).astype(np.float32)
    g[:6] = [0.0, below1, 0.96, 1 - 0.06, np.float32(0.5), np.nextafter(np.float32(0), 1)]
    cmd = np.zeros((n, 15), np.float32)
    cmd[:, 4] = rng.uniform(2, 4, n)
    cmd[:, 5:8] = rng.choice([0.0, 0.25, 0.5, 0.75, below1], (n, 3))
    cmd[:, 8] = rng.choice([0.5, 0.3, 0.7], n)
    cmd[:6, 4] = [2.0, 3.0, 2.0, 3.0, 2.0, 4.0]
    for pacing in (False, True):
        want = jax.jit(lambda g, c: j_gaits.step_contact_targets(g, c, 0.02, 0.07, pacing))(
            jnp.asarray(g), jnp.asarray(cmd))
        got = t_gaits.step_contact_targets(torch.as_tensor(g), torch.as_tensor(cmd), 0.02, 0.07,
                                           pacing)
        for name in ("gait_indices", "foot_indices"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)), err_msg=name)
        for name in ("clock_inputs", "doubletime_clock_inputs", "halftime_clock_inputs",
                     "desired_contact_states"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(want, name)), rtol=0, atol=1e-6,
                                       err_msg=name)
        fi = got.foot_indices.numpy()
        assert (fi >= 0).all() and (fi < 1).all()


# ----------------------------------------------------------------- rewards
def corl_ctx(mod, cfg, seed=0, n=16):
    """One seeded RewardCtx with the velocity task's fields."""
    rng = np.random.RandomState(seed)
    r = lambda *s: rng.normal(size=s).astype(np.float32)
    b = lambda *s: rng.uniform(size=s) < 0.5
    cmd = r(n, 15)
    cmd[:, 4] = rng.uniform(2, 4, n)
    cmd[:, 9] = rng.uniform(0.03, 0.35, n)
    cmd[:, 12] = rng.uniform(0.1, 0.45, n)
    cmd[:, 13] = rng.uniform(0.35, 0.45, n)
    q = r(n, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    act = r(n, 12)
    act[: n // 4] = 0.0                          # the first step of an episode
    g = np.array([0.3, -0.2, -9.8], np.float32)
    vals = dict(
        base_pos=r(n, 3), base_lin_vel=r(n, 3), base_ang_vel=r(n, 3),
        projected_gravity=r(n, 3), dof_pos=r(n, 12), dof_vel=r(n, 12), last_dof_vel=r(n, 12),
        default_dof_pos=r(12), dof_pos_soft_limits=np.sort(r(12, 2), axis=1),
        torques=10 * r(n, 12), actions=r(n, 12), last_actions=act,
        contact_forces=60 * r(n, 17, 3), relative_linear=r(n, 3), relative_rotation=r(n, 3),
        local_relative_linear=r(n, 3), reached_buf=b(n), plan_buf=b(n), replan=b(n),
        episode_length_buf=rng.randint(0, 400, n).astype(np.int32), reset_buf=b(n),
        feet_air_time=rng.uniform(0, 1, (n, 4)).astype(np.float32), feet_first_contact=b(n, 4),
        commands=cmd, desired_contact_states=rng.uniform(0, 1, (n, 4)).astype(np.float32),
        foot_positions=0.05 * r(n, 4, 3), foot_velocities=r(n, 4, 3),
        prev_foot_velocities=r(n, 4, 3), foot_phase=rng.uniform(0, 1, (n, 4)).astype(np.float32),
        joint_pos_target=r(n, 12), last_joint_pos_target=r(n, 12),
        last_last_joint_pos_target=r(n, 12), last_last_actions=act[::-1].copy(),
        gravity_unit=g / np.linalg.norm(g), feet_contact_filt=b(n, 4), base_quat=q)
    tensor = jnp.asarray if mod is j_rew else torch.as_tensor
    return mod.RewardCtx(dt=cfg.dt, max_episode_length=float(cfg.env.max_episode_length),
                         penalised_slots=(1, 2, 5, 9), feet_slots=(13, 14, 15, 16),
                         **{k: tensor(v) for k, v in vals.items()})


@pytest.mark.parametrize("term", sorted(j_corl.CORL_REWARDS))
def test_corl_rewards_match_jax(term):
    """Each CoRL term on one seeded context against the jitted JAX term,
    through the containers' registry: float32 elementwise work, short sums,
    and exp, sin and cos that are each library's own, so within 2e-6 of
    the term's scale (read up to 1.9e-7)."""
    jcfg, tcfg = velocity_cfgs()
    jcfg.parse()
    tcfg.parse()
    jfn = j_rew.get_container("CoRLRewards")[term]
    tfn = t_rew.get_container("CoRLRewards")[term]
    want = np.asarray(jax.jit(lambda ctx: jfn(ctx, jcfg))(corl_ctx(j_rew, jcfg)))
    got = tfn(corl_ctx(t_rew, tcfg), tcfg).numpy()
    assert got.shape == want.shape == (16,)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * max(1.0, np.abs(want).max()))


# --------------------------------------------------------------------- env
EXACT = ("env_command_bins", "env_command_categories", "curriculum_weights", "commands",
         "episode_length", "gait_indices", "foot_phase")


def test_velocity_reset_matches(envs):
    """reset_fn under the JAX env's draws rebuilds the JAX reset state: the
    curriculum weights, bins, categories and commands bitwise; the rest as
    tests/test_torch_env.py holds the tunnel env's (atol 1e-6)."""
    jenv, tenv, key, jstate = envs
    assert (tenv.num_obs, tenv.num_privileged_obs, tenv.num_obs_history) == (70, 2, 2100)
    tenv.draw, tenv.draw_bins = (d := VelocityDraws(key, N)), d.bins
    try:
        tstate = tenv.reset_fn(True)
    finally:
        uninstall(tenv)
    assert_state_close(tstate, jstate, atol=1e-6, exact=EXACT)


def test_velocity_observe_matches(envs):
    """observe from the converted JAX reset state (atol 1e-5, as for the
    tunnel env)."""
    jenv, tenv, key, jstate = envs
    ref = jenv._observe_jit(jstate)
    out = tenv.observe(convert.env_state_from_numpy(to_numpy(jstate), device="cpu"))
    for k in ("obs", "privileged_obs", "obs_history"):
        np.testing.assert_allclose(out[k].float().numpy(), np.asarray(ref[k], np.float32),
                                   rtol=0, atol=1e-5, err_msg=k)


def test_velocity_step_fn_matches_four_steps(envs):
    """4 step_fns from the JAX reset state under the JAX env's draws, with a
    curriculum update and command resample every 2 steps and 3-step
    episodes, where some envs clear the curriculum's thresholds and bump
    its weights.  Bitwise: dones, episode lengths, time-outs, commands,
    curriculum weights, bins, categories and the gait and foot phases.
    Within the tunnel env's limits (tests/test_torch_env.py): base
    positions 1e-6, velocities 5e-4, obs 5e-5, privileged obs 1e-6; the
    rewards, whose ji22 shaping multiplies by exp(rew_neg / 0.02), within
    1e-6 (read 3.7e-9 of up to 0.005).  Read besides: base positions 0,
    velocities 1.2e-4, obs 6.2e-6, privileged obs 0, desired contact states
    1.2e-7, clocks 6.0e-8, the curriculum's tracking sums 5.8e-7."""
    jenv, tenv, key, jstate = envs
    install(tenv, VelocityDraws(key, N))
    try:
        tstate = convert.env_state_from_numpy(to_numpy(jstate), device="cpu")
        js = jstate
        step_j = jax.jit(jenv.step_fn)
        n_done = n_resampled = 0
        for i in range(4):
            a = 0.3 * np.sin(0.1 * i + np.arange(N * 12, dtype=np.float32)).reshape(N, 12)
            ep = np.asarray(js.episode_length) + 1
            js, oj = step_j(js, jnp.asarray(a))
            tstate, ot = tenv.step_fn(tstate, torch.as_tensor(a))
            msg = f"step {i}"
            np.testing.assert_array_equal(ot.done.numpy(), np.asarray(oj.done), err_msg=msg)
            n_done += int(np.asarray(oj.done).sum())
            n_resampled += int((ep % tenv._resample_interval == 0).sum())
            for k in ("episode_length", "time_outs"):
                np.testing.assert_array_equal(ot.info[k].numpy(), np.asarray(oj.info[k]),
                                              err_msg=f"{msg} {k}")
            for k in EXACT:
                np.testing.assert_array_equal(getattr(tstate, k).numpy(),
                                              np.asarray(getattr(js, k)), err_msg=f"{msg} {k}")
            for k, x, y, tol in (("base_pos", tstate.phys.base_pos, js.phys.base_pos, 1e-6),
                                 ("v", tstate.phys.v, js.phys.v, 5e-4),
                                 ("obs", ot.obs, oj.obs, 5e-5),
                                 ("privileged_obs", ot.privileged_obs, oj.privileged_obs, 1e-6),
                                 ("rew", ot.rew, oj.rew, 1e-6)):
                np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0, atol=tol,
                                           err_msg=f"{msg} {k}")
        assert n_done > 0 and n_resampled > 0          # the auto-reset and resample ran
        # some envs cleared the thresholds: the weights around them moved
        assert float(np.abs(np.asarray(js.curriculum_weights)
                            - np.asarray(jstate.curriculum_weights)).max()) > 0
        assert_state_close(tstate, js, atol=5e-2, exact=EXACT)
    finally:
        uninstall(tenv)


# ------------------------------------------------------------------- entry
@pytest.mark.parametrize("flags", [
    [], ["--num_envs", "64", "--terrain", "plane", "--pd_control", "--num_history", "5",
         "--sigma_rew_neg", "0.05", "--contact_ema", "0.3"],
    ["--only_positive", "--terrain_rows", "4", "--terrain_cols", "3", "--seed", "2"]],
    ids=["defaults", "plane_pd", "only_positive"])
def test_velocity_build_cfg_matches_scripts(flags):
    """train_velocity_tracking.build_cfg gives the configuration of
    scripts/train_velocity_tracking.py for the same flags, field by field;
    the flags the two parsers share have the same defaults."""
    jargs, targs = J_TV.parse_args(flags), t_tv.parse_args(flags)
    assert cfg_tree(t_tv.build_cfg(targs)) == cfg_tree(J_TV.build_cfg(jargs))
    shared = set(vars(jargs)) - {"cpu"}
    assert shared == set(vars(targs)) - {"device"}
    assert {k: getattr(targs, k) for k in shared} == {k: getattr(jargs, k) for k in shared}


def test_velocity_checkpoint_curriculum_crosses_runners(tmp_path):
    """The curriculum weights of a velocity checkpoint go both ways between
    the two packages' Runners, bitwise: the port's save is what the JAX
    Runner's load takes up, and a JAX save is what the port's Runner
    resumes with, into its env state."""
    _, tcfg = velocity_cfgs(["--num_envs", "8", "--terrain", "plane"])
    tenv = TEnv(tcfg, device="cpu")
    runner = TRunner(tenv, runner_args=TRunnerArgs(num_steps_per_env=4), seed=0)
    w = (np.random.RandomState(0).randint(0, 6, (4, 441)) * np.float32(0.2)).astype(np.float32)
    runner.env_state = runner.env_state._replace(curriculum_weights=torch.as_tensor(w))
    runner.save(str(tmp_path / "port.pkl"))

    # the JAX Runner's load and save (its env's reset plays no part)
    jcfg = J_TV.build_cfg(J_TV.parse_args(["--num_envs", "8", "--terrain", "plane"]))
    jenv = object.__new__(JEnv)
    jenv.num_obs, jenv.num_privileged_obs, jenv.num_actions = (tenv.num_obs,
                                                              tenv.num_privileged_obs, 12)
    jenv.num_obs_history, jenv.num_envs, jenv.cfg = tenv.num_obs_history, 8, jcfg
    jr = object.__new__(JRunner)
    jr.runner_args = JRunnerArgs()
    jalg = j_ppo.PPO(jenv)
    jr.train_state = jalg.init(jax.random.key(0))
    jr.load(str(tmp_path / "port.pkl"))
    np.testing.assert_array_equal(jr._pending_curriculum, w)
    w2 = np.clip(w + np.float32(0.2), 0, 1)
    jr.env_state = type("S", (), {"curriculum_weights": jnp.asarray(w2),
                                  "target_dist": jnp.asarray(0.0)})()
    jr.save(str(tmp_path / "jax.pkl"))
    with open(tmp_path / "jax.pkl", "rb") as f:
        np.testing.assert_array_equal(pickle.load(f)["curriculum_weights"], w2)
    resumed = TRunner(TEnv(velocity_cfgs(["--num_envs", "8", "--terrain", "plane"])[1],
                           device="cpu"),
                      runner_args=TRunnerArgs(num_steps_per_env=4,
                                              resume=str(tmp_path / "jax.pkl")), seed=0)
    np.testing.assert_array_equal(resumed.env_state.curriculum_weights.numpy(), w2)


def test_train_velocity_entry_on_cpu(tmp_path):
    """``python -m legged_tracking_torch.train_velocity_tracking --device
    cpu`` trains 2 iterations of 8 envs on the plane and writes
    metrics.jsonl with the curriculum records, a checkpoint with the
    curriculum weights, and policy.npz."""
    import json
    logdir = tmp_path / "run"
    cmd = [sys.executable, "-m", "legged_tracking_torch.train_velocity_tracking",
           "--device", "cpu", "--num_envs", "8", "--terrain", "plane", "--iterations", "2",
           "--num_steps_per_env", "8", "--logdir", str(logdir)]
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr[-3000:]
    recs = [json.loads(line) for line in open(logdir / "metrics.jsonl")]
    assert [r["it"] for r in recs] == [0, 1]
    for key in ("value_loss", "rew_tracking_lin_vel", "rew_total", "curriculum_unlocked_frac",
                "curriculum_weight_mean", "curriculum_unlocked_frac_trot"):
        assert np.isfinite(recs[-1][key]), key
    with open(logdir / "ac_weights_last.pkl", "rb") as f:
        ckpt = pickle.load(f)
    assert ckpt["curriculum_weights"].shape == (4, 441) and ckpt["iteration"] == 2
    assert "params/actor_body/Dense_0/kernel" in np.load(logdir / "policy.npz")
