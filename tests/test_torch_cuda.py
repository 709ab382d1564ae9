"""The port on the card: kernel B1 against its plain version (at the bench
grid, and across the env and point counts where its blocking and staging
change), and an env step on the card (kernels) against the same step on
the CPU (plain versions), the physics step's graph replay against its eager
block, the deploy runtime and the actuator-net fit on the card against
the CPU.  Every test here needs an NVIDIA card and skips
without one, but for the one which holds that the deploy runtime refuses
``cuda`` where there is no card; the data-parallel tests across cards need
four and skip with fewer.

This file imports neither JAX nor the JAX package, so that it also runs
where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q
"""

import numpy as np
import pytest
import torch

from legged_tracking_torch.config import Cfg, config_go1
from legged_tracking_torch.envs import LeggedEnv
from legged_tracking_torch.terrain import heightfield as hf
from legged_tracking_torch.terrain import scan
from legged_tracking_torch.terrain.tunnel import build_terrain


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def tunnel_cfg(num_envs, tiles):
    cfg = config_go1(Cfg())
    cfg.env.num_envs = num_envs
    t = cfg.terrain
    t.mesh_type, t.terrain_type = "trimesh", "single_path"
    t.num_rows = t.num_cols = tiles
    t.terrain_length, t.terrain_width = 4.0, 2.0
    t.terrain_ratio_x, t.terrain_ratio_y = 0.9, 0.5
    t.ceiling_height, t.start_loc = 0.8, 0.32
    t.measure_front_half = True
    t.measured_points_x = np.linspace(-1, 1, 21)
    t.measured_points_y = np.linspace(-0.5, 0.5, 11)
    cfg.env.command_type = "xy"
    cfg.env.episode_length_s = 0.06        # 3-step episodes: auto-resets run
    cfg.control.control_type = "actuator_net"
    cfg.commands.traj_function = "fixed_target"
    cfg.commands.traj_length = 1
    return cfg


@pytest.mark.cuda
def test_scan_kernel_matches_plain_on_card(cuda_device):
    """Kernel B1 == its plain version on the card, bitwise (atol 0), with
    bases on the tiles, on cell boundaries and 10 m off the tiles."""
    n = 3 * 256
    tt = build_terrain(tunnel_cfg(n, 8), n, seed=1, device=cuda_device)
    table = hf.bf16_table(tt)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    base = tt.env_origin[:, :2].clone()
    base[:256] += torch.rand(256, 2, generator=g, device=cuda_device) - 0.5
    base[512:] += 10.0
    pitch = torch.rand(n, generator=g, device=cuda_device) - 0.5
    pitch[256:512] = 0.0
    cam = torch.stack([0.12 * torch.cos(pitch), torch.zeros_like(pitch)], -1)
    frames = torch.stack([base, cam, tt.env_terrain_origin[:, :2]], 1).contiguous()
    gx, gy = np.meshgrid(np.linspace(-1, 1, 21), np.linspace(-0.5, 0.5, 11), indexing="ij")
    grid = torch.as_tensor(np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32),
                           device=cuda_device)
    args = (table, tt.env_tile, frames, grid, tt.horizontal_scale)
    before = scan.scan_heights.launches
    out = scan.scan_heights(*args)
    torch.cuda.synchronize()
    assert scan.scan_heights.launches == before + 1
    assert torch.equal(out, scan.scan_heights_reference(*args))
    cpu_args = [a.cpu() if torch.is_tensor(a) else a for a in args]
    assert torch.equal(out.cpu(), scan.scan_heights_reference(*cpu_args))
    with pytest.raises(ValueError):
        scan.scan_heights(table.float(), *args[1:])      # the kernel takes bf16 only


# scan grids of P points, each spaced 0.1 m so that spawn bases put every
# point on a cell boundary; 33x41 = 1353 points stage 86.6 KB at 8 envs a
# block, past the 48 KB a block gets without opting in
SWEEP_GRIDS = {1: ([0.0], [0.0]),
               33: (np.linspace(-0.1, 0.1, 3), np.linspace(-0.5, 0.5, 11)),
               231: (np.linspace(-1, 1, 21), np.linspace(-0.5, 0.5, 11)),
               1353: (np.linspace(-1.6, 1.6, 33), np.linspace(-2, 2, 41))}
SWEEP_ENVS = 4099


@pytest.fixture(scope="module")
def sweep_world():
    """A world of 8x8 tiles with room for SWEEP_ENVS envs (build_terrain
    takes a multiple of the 64 tiles' count)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA (a CUDA kernel has no CPU mode)")
    dev = torch.device("cuda")
    n = -(-SWEEP_ENVS // 64) * 64
    tt = build_terrain(tunnel_cfg(n, 8), n, seed=2, device=dev)
    return tt, hf.bf16_table(tt)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["on_tile", "grid_aligned", "off_tile"])
@pytest.mark.parametrize("P", sorted(SWEEP_GRIDS))
@pytest.mark.parametrize("N", [1, 7, 8, 9, SWEEP_ENVS])
def test_scan_kernel_blocking_bitwise(sweep_world, N, P, case):
    """Kernel B1 == its plain version, bitwise, for env counts that fill
    blocks of E envs or leave a tail block (odd N included), and grids from
    one point to one whose staging needs more than 48 KB of shared memory;
    bases on the tiles, at the spawn points (cell boundaries) and 10 m off
    the tiles."""
    tt, table = sweep_world
    dev = table.device
    rng = np.random.RandomState(N * 10_000 + P)
    base = tt.env_origin[:N, :2].cpu().numpy()
    pitch = np.zeros(N, np.float32)
    if case != "grid_aligned":
        base = base + rng.uniform(-0.5, 0.5, (N, 2)) + (10.0 if case == "off_tile" else 0.0)
        pitch = rng.uniform(-0.5, 0.5, N)
    cam = np.stack([0.12 * np.cos(pitch), np.zeros(N)], -1)
    frames = torch.as_tensor(
        np.stack([base, cam, tt.env_terrain_origin[:N, :2].cpu().numpy()], 1)
        .astype(np.float32), device=dev)
    gx, gy = np.meshgrid(*SWEEP_GRIDS[P], indexing="ij")
    grid = torch.as_tensor(np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32),
                           device=dev)
    args = (table, tt.env_tile[:N].contiguous(), frames, grid, tt.horizontal_scale)
    before = scan.scan_heights.launches
    out = scan.scan_heights(*args)
    torch.cuda.synchronize()
    assert scan.scan_heights.launches == before + 1
    assert torch.equal(out, scan.scan_heights_reference(*args))
    cpu_args = [a.cpu() if torch.is_tensor(a) else a for a in args]
    assert torch.equal(out.cpu(), scan.scan_heights_reference(*cpu_args))


@pytest.mark.cuda
def test_env_steps_on_card_match_cpu(cuda_device):
    """Five steps of 8 envs, with auto-resets, from the same draws: the card
    (kernel B1, cuBLAS products) against the CPU (plain versions).  The
    float32 sums run in another order; the limits are those of the
    reference phase of chip_smoke.py, 5 to 20 times the errors read on an
    H100; dones are exact."""
    n = 8
    cpu = LeggedEnv(tunnel_cfg(n, 2), seed=3, device="cpu")
    card = LeggedEnv(tunnel_cfg(n, 2), seed=3, device=cuda_device)
    draws = []
    cpu_draw = cpu.draw

    def record(tag, shape, lo, hi, integer=False):
        draws.append(cpu_draw(tag, shape, lo, hi, integer))
        return draws[-1]

    cpu.draw = record
    replay = iter(draws)
    card.draw = lambda tag, shape, lo, hi, integer=False: next(replay).to(cuda_device)
    s_cpu = cpu.reset_fn(True)
    obs_cpu = cpu.observe(s_cpu)["obs"]
    outs = []
    acts = [0.3 * torch.sin(0.1 * i + torch.arange(n * 12, dtype=torch.float32)).reshape(n, 12)
            for i in range(5)]
    for a in acts:
        s_cpu, o = cpu.step_fn(s_cpu, a)
        outs.append((s_cpu.phys.base_pos, o))
    s = card.reset_fn(True)
    launches = scan.scan_heights.launches
    # the same reset state; elementwise float32 only
    torch.testing.assert_close(card.observe(s)["obs"].cpu(), obs_cpu, rtol=0, atol=1e-6)
    for a, (bp, o_cpu) in zip(acts, outs):
        s, o = card.step_fn(s, a.to(cuda_device))
        assert torch.equal(o.done.cpu(), o_cpu.done)
        torch.testing.assert_close(s.phys.base_pos.cpu(), bp, rtol=0, atol=1e-5)
        torch.testing.assert_close(o.obs.cpu(), o_cpu.obs, rtol=0, atol=5e-4)
        torch.testing.assert_close(o.rew.cpu(), o_cpu.rew, rtol=0, atol=1e-6)
    assert scan.scan_heights.launches == launches + 1 + len(acts)


def random_trajectory(alg, T, seed):
    """A trajectory of random observations through ``alg``'s policy (on the
    CPU): its means, stds, sampled actions, log-probs and values, random
    rewards and dones."""
    from legged_tracking_torch.learn.actor_critic import normal_log_prob
    from legged_tracking_torch.learn.ppo import Transition

    env = alg.env
    N = env.num_envs
    g = torch.Generator().manual_seed(seed)
    obs = torch.randn(T, N, env.num_obs, generator=g)
    priv = torch.randn(T, N, env.num_privileged_obs, generator=g)
    hist = torch.randn(T, N, env.num_obs_history, generator=g).to(torch.bfloat16)
    with torch.no_grad():
        mean, std = alg.ac.action_dist(obs, priv, hist.float())
        std = std.expand_as(mean)
        actions = mean + std * torch.randn(mean.shape, generator=g)
        traj = Transition(obs=obs, privileged_obs=priv, obs_history=hist, actions=actions,
                          rewards=torch.randn(T, N, generator=g),
                          dones=torch.rand(T, N, generator=g) < 0.2,
                          values=alg.ac.evaluate(obs, priv, hist.float()),
                          log_prob=normal_log_prob(mean, std, actions), mu=mean, sigma=std)
    return traj, torch.randn(N, generator=g), torch.randperm(T * N, generator=g)


@pytest.mark.cuda
def test_update_on_card_matches_cpu(cuda_device):
    """One ``update`` (5 epochs x 4 minibatches) of a random 8-step,
    16-env trajectory on the card (cuBLAS, the foreach Adam) against the
    same update on the CPU, from the same parameters and permutation: the
    learning rate bitwise; on an H100 the rms parameter error of each leaf
    read 4.9e-4 of the distance it moved, the Adam moments 4.0e-4 of each
    leaf's largest value, the losses 5.5e-6; the limits are about 10 times
    that."""
    from legged_tracking_torch.learn.ppo import PPO, Transition

    algs = {}
    for d in ("cpu", cuda_device):
        torch.manual_seed(0)
        algs[d] = PPO(LeggedEnv(tunnel_cfg(16, 2), seed=3, device=d))
    traj, last_values, perm = random_trajectory(algs["cpu"], 8, seed=1)
    out = {}
    for d, alg in algs.items():
        ts = alg.init()
        start = {k: v.detach().cpu().clone() for k, v in ts.params.items()}
        tr = Transition(*(x.to(d) for x in traj))
        returns, adv = alg.compute_gae(tr, last_values.to(d))
        out[d] = alg.update(ts, tr, returns, adv, perm=perm)
    (ts_c, m_c), (ts_g, m_g) = out["cpu"], out[cuda_device]
    errs = {
        "params_leaf_rms_rel": max(float(((ts_g.params[k].detach().cpu() - v.detach()).square()
                                          .mean() / (v.detach() - start[k]).square().mean())
                                         .sqrt()) for k, v in ts_c.params.items()),
        "opt_state": max(float((ts_g.opt_state.mu[k].cpu() - v).abs().max() / v.abs().max())
                         for k, v in ts_c.opt_state.mu.items()),
        "losses": max(abs(float(m_g[k]) - float(m_c[k])) / max(abs(float(m_c[k])), 1.0)
                      for k in ("value_loss", "surrogate_loss", "adaptation_loss",
                                "adaptation_test_loss", "kl_mean"))}
    assert float(ts_g.learning_rate) == float(ts_c.learning_rate)
    tol = {"params_leaf_rms_rel": 5e-3, "opt_state": 4e-3, "losses": 5e-5}
    assert all(errs[k] <= tol[k] for k in tol), errs


@pytest.mark.cuda
def test_train_iteration_on_card_is_finite(cuda_device):
    """A whole train_iteration of 64 envs on the card: finite metrics,
    parameters that moved, and kernel B1 launched once per rollout step."""
    from legged_tracking_torch.learn.ppo import PPO

    env = LeggedEnv(tunnel_cfg(64, 8), seed=3, device=cuda_device)
    alg = PPO(env, seed=0)
    ts = alg.init()
    start = {k: v.detach().clone() for k, v in ts.params.items()}
    state = env.reset_fn(True)
    obs = env.observe(state)
    before = scan.scan_heights.launches
    ts, state, obs, metrics = alg.train_iteration(ts, state, obs)
    torch.cuda.synchronize()
    assert scan.scan_heights.launches == before + alg.args.num_steps_per_env
    for k, v in metrics.items():
        assert v.device.type == "cuda" and bool(torch.isfinite(v.float()).all()), k
    assert all(not torch.equal(v, start[k]) for k, v in ts.params.items())
    assert all(bool(torch.isfinite(v).all()) for v in obs.values())


@pytest.mark.cuda
def test_windowed_train_iterations_on_card_match_stored(cuda_device):
    """Two train iterations of 64 envs on the card (3-step episodes; the
    first started by observe, the second by a step), histories windowed and
    stored, from one seed: parameters, Adam states, learning rate and
    metrics bitwise; B1 once per rollout step either way."""
    from legged_tracking_torch.learn.ppo import PPO, PPOArgs

    runs = []
    for windowed in (False, True):
        env = LeggedEnv(tunnel_cfg(64, 8), seed=3, device=cuda_device)
        torch.manual_seed(0)
        alg = PPO(env, args=PPOArgs(windowed_history=windowed), seed=0)
        assert alg._window_history == windowed
        ts = alg.init()
        state = env.reset_fn(True)
        obs = env.observe(state)
        before = scan.scan_heights.launches
        metrics = []
        for _ in range(2):
            ts, state, obs, m = alg.train_iteration(ts, state, obs)
            metrics.append(m)
        torch.cuda.synchronize()
        assert scan.scan_heights.launches == before + 2 * alg.args.num_steps_per_env
        runs.append((ts, metrics))
    (a, ma), (b, mb) = runs
    for x, y in ((a.params, b.params), (a.opt_state.mu, b.opt_state.mu),
                 (a.opt_state.nu, b.opt_state.nu), (a.adapt_opt_state.mu, b.adapt_opt_state.mu),
                 (a.adapt_opt_state.nu, b.adapt_opt_state.nu)):
        for k in x:
            assert torch.equal(x[k], y[k]), k
    assert torch.equal(a.learning_rate, b.learning_rate)
    for m1, m2 in zip(ma, mb):
        assert int(m1["num_episodes"]) > 0
        for k in m1:
            assert torch.equal(m1[k], m2[k]), k


def goal_cfg(num_envs, tiles=2):
    """The published goal recipe (stage A of ``tools/goal_recipe.sh``):
    random_pyramid tiles of 100x32 cells, the default policy's obs."""
    from legged_tracking_torch import train
    return train.build_cfg(train.parse_args([
        "--strategy", "goal", "--terrain", "random_pyramid", "--num_envs", str(num_envs),
        "--max_noise_std", "1.0", "--cl_goal_target_dist", "3.8", "--cl_downstep", "0.5",
        "--terrain_rows", str(tiles), "--terrain_cols", str(tiles)]))


def hierarchy_cfg(num_envs, tiles=2, plan_interval=100):
    """``train_hierarchy``'s configuration: the planner on, random_pyramid
    tiles of 100x32 cells."""
    from legged_tracking_torch import train_hierarchy
    return train_hierarchy.build_cfg(train_hierarchy.parse_args([
        "--num_envs", str(num_envs), "--terrain_rows", str(tiles), "--terrain_cols", str(tiles),
        "--plan_interval", str(plan_interval)]))


@pytest.mark.cuda
@pytest.mark.parametrize("path,num_envs", [("goal", 4096), ("hierarchy", 4000)])
def test_scan_kernel_bitwise_on_new_paths(cuda_device, path, num_envs):
    """Kernel B1 == its plain version, bitwise, at the shapes the goal and
    planner paths give it: random_pyramid tiles of 100x32 cells, and 4000
    envs (500 blocks of 8 where the bench's 4096 launch 512; the tail
    blocks of odd counts are the sweep's); bases on the tiles, at the spawn
    points and off the tiles."""
    cfg = (goal_cfg if path == "goal" else hierarchy_cfg)(num_envs, tiles=4)
    tt = build_terrain(cfg, num_envs, seed=1, device=cuda_device)
    table = hf.bf16_table(tt)
    assert tuple(table.shape[2:]) == (100, 32)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    third = num_envs // 3
    base = tt.env_origin[:, :2].clone()
    base[:third] += torch.rand(third, 2, generator=g, device=cuda_device) - 0.5
    base[2 * third:] += 10.0
    pitch = torch.rand(num_envs, generator=g, device=cuda_device) - 0.5
    pitch[third:2 * third] = 0.0
    cam = torch.stack([0.12 * torch.cos(pitch), torch.zeros_like(pitch)], -1)
    frames = torch.stack([base, cam, tt.env_terrain_origin[:, :2]], 1).contiguous()
    gx, gy = np.meshgrid(cfg.terrain.measured_points_x, cfg.terrain.measured_points_y,
                         indexing="ij")
    grid = torch.as_tensor(np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32),
                           device=cuda_device)
    args = (table, tt.env_tile, frames, grid, tt.horizontal_scale)
    out = scan.scan_heights(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, scan.scan_heights_reference(*args))
    cpu_args = [a.cpu() if torch.is_tensor(a) else a for a in args]
    assert torch.equal(out.cpu(), scan.scan_heights_reference(*cpu_args))


@pytest.mark.cuda
def test_planner_quadform_matches_direct_on_card(cuda_device):
    """The planner's quadform validity (one float32 cuBLAS product per
    chunk of candidates) equals its direct form on the card, and the card's
    quadform equals the CPU's, on 256 envs of the hierarchy configuration
    moved into the obstacle window and turned: zero mismatches in 256 x
    1,575 candidates."""
    from legged_tracking_torch.utils import quat as qt

    n = 256
    env = LeggedEnv(hierarchy_cfg(n), seed=3, device=cuda_device)
    state = env.reset_fn(True)
    g = torch.Generator(device=cuda_device).manual_seed(2)
    base_pos = state.phys.base_pos + torch.cat(
        [torch.rand(n, 1, generator=g, device=cuda_device) * 2.5,
         torch.rand(n, 1, generator=g, device=cuda_device) * 0.6 - 0.3,
         torch.zeros(n, 1, device=cuda_device)], dim=1)
    yaw = torch.rand(n, generator=g, device=cuda_device) * 1.6 - 0.8
    quat = qt.quat_from_angle_axis(yaw, torch.tensor([0.0, 0.0, 1.0], device=cuda_device)
                                   .expand(n, 3))
    pts = env.scan_points(env._get_heights(base_pos, qt.quaternion_to_roll_pitch_yaw(quat)))
    quad = env.candidates_valid(pts, quadform=True)
    direct = env.candidates_valid(pts, quadform=False)
    assert int((quad != direct).sum()) == 0
    assert 0 < int(quad.sum()) < quad.numel()
    cpu_env = LeggedEnv(hierarchy_cfg(n), seed=3, device="cpu")
    assert torch.equal(cpu_env.candidates_valid(pts.cpu(), quadform=True), quad.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("use_cnn,use_gru", [(False, False), (True, False), (False, True),
                                             (True, True)],
                         ids=["mlp", "conv", "mlp_gru", "conv_gru"])
def test_cnn_policy_on_card_matches_cpu(cuda_device, use_cnn, use_gru):
    """The four ActorCriticCNN variants on the card (cuDNN convolutions,
    TF32 off) against the same weights on the CPU, on a 3-frame history of
    the goal recipe's obs: atol 1e-5 on O(1) outputs, as the CPU against
    the flax module (tests/test_torch_policy_cnn.py)."""
    from legged_tracking_torch.learn.actor_critic_cnn import ACCnnArgs, ActorCriticCNN

    num_obs, num_priv = 261, 6
    torch.manual_seed(0)
    cpu = ActorCriticCNN(num_obs, num_priv, 3 * num_obs, 12, args=ACCnnArgs(
        use_cnn=use_cnn, use_gru=use_gru, height_map_shape=(2, 10, 11), max_noise_std=1.0))
    card = ActorCriticCNN(num_obs, num_priv, 3 * num_obs, 12, args=cpu.args).to(cuda_device)
    card.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(1)
    o, p, h = (torch.randn(64, n, generator=g) for n in (num_obs, num_priv, 3 * num_obs))
    with torch.no_grad():
        want = (*cpu.action_dist(o, p, h), cpu.evaluate(o, p, h), cpu.adapt(h))
        got = (*card.action_dist(*(x.to(cuda_device) for x in (o, p, h))),
               card.evaluate(*(x.to(cuda_device) for x in (o, p, h))),
               card.adapt(h.to(cuda_device)))
    for name, a, b in zip(("mean", "std", "value", "adapt"), got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-5, msg=name)


@pytest.mark.cuda
def test_goal_train_iteration_on_card_is_finite(cuda_device):
    """A whole train_iteration of 64 envs of the goal recipe on the card,
    with its default policy (ActorCriticCNN, MLP encoder): finite metrics,
    parameters that moved, and kernel B1 launched once per rollout step."""
    from legged_tracking_torch import train
    from legged_tracking_torch.learn.ppo import PPO

    args = train.parse_args(["--strategy", "goal", "--terrain", "random_pyramid",
                             "--num_envs", "64", "--terrain_rows", "4", "--terrain_cols", "4"])
    cfg = train.build_cfg(args)
    env = LeggedEnv(cfg, seed=3, device=cuda_device)
    alg = PPO(env, ac=train.make_policy(args, cfg, env), seed=0)
    assert type(alg.ac).__name__ == "ActorCriticCNN"
    ts = alg.init()
    start = {k: v.detach().clone() for k, v in ts.params.items()}
    state = env.reset_fn(True)
    obs = env.observe(state)
    before = scan.scan_heights.launches
    ts, state, obs, metrics = alg.train_iteration(ts, state, obs)
    torch.cuda.synchronize()
    assert scan.scan_heights.launches == before + alg.args.num_steps_per_env
    for k, v in metrics.items():
        assert v.device.type == "cuda" and bool(torch.isfinite(v.float()).all()), k
    assert all(not torch.equal(v, start[k]) for k, v in ts.params.items())
    assert all(bool(torch.isfinite(v).all()) for v in obs.values())


def velocity_cfg(num_envs, tiles=2):
    """scripts/train_velocity_tracking.py's configuration at ``num_envs``
    envs on tiles x tiles trimesh tiles of 50 x 50 cells, with commands
    resampled every 2 steps and 5-step episodes."""
    from legged_tracking_torch import train_velocity_tracking

    cfg = train_velocity_tracking.build_cfg(train_velocity_tracking.parse_args(
        ["--num_envs", str(num_envs), "--terrain_rows", str(tiles),
         "--terrain_cols", str(tiles)]))
    cfg.commands.resampling_time = 0.04
    cfg.env.episode_length_s = 0.1
    return cfg


def velocity_env(num_envs, device, tiles=2):
    """The velocity env of :func:`velocity_cfg`."""
    from legged_tracking_torch.envs.velocity_env import VelocityTrackingEnv

    return VelocityTrackingEnv(velocity_cfg(num_envs, tiles), seed=3, device=device)


@pytest.mark.cuda
def test_velocity_train_iteration_on_card_is_finite(cuda_device):
    """A whole train_iteration of 64 envs of the velocity env on the card
    (curriculum resamples and auto-resets inside it), with the CSE policy:
    finite metrics, parameters that moved, the curriculum's state on the
    card, and kernel B1 never launched (the path observes no heights)."""
    from legged_tracking_torch.learn.ppo import PPO

    env = velocity_env(64, cuda_device)
    alg = PPO(env, seed=0)
    ts = alg.init()
    start = {k: v.detach().clone() for k, v in ts.params.items()}
    before = scan.scan_heights.launches
    state = env.reset_fn(True)
    ts, state, obs, metrics = alg.train_iteration(ts, state, env.observe(state))
    torch.cuda.synchronize()
    assert scan.scan_heights.launches == before
    for k, v in metrics.items():
        assert v.device.type == "cuda" and bool(torch.isfinite(v.float()).all()), k
    assert int(metrics["num_episodes"]) > 0
    assert all(not torch.equal(v, start[k]) for k, v in ts.params.items())
    for k in ("curriculum_weights", "env_command_bins", "env_command_categories", "commands"):
        assert getattr(state, k).device.type == "cuda", k
    w = state.curriculum_weights
    assert w.shape == (4, 441) and bool(((w >= 0) & (w <= 1)).all())
    assert all(bool(torch.isfinite(v.float()).all()) for v in obs.values())


@pytest.mark.cuda
def test_rma_update_on_card_matches_cpu(cuda_device):
    """One ``update`` of the RMA policy (5 epochs x 4 minibatches) on a
    random 8-step, 16-env trajectory of the velocity env's dimensions, on
    the card against the CPU from the same parameters and permutation: the
    learning rate bitwise, and the limits of
    test_update_on_card_matches_cpu."""
    from legged_tracking_torch.learn.actor_critic_rma import ActorCriticRMA
    from legged_tracking_torch.learn.ppo import PPO, Transition

    algs = {}
    for d in ("cpu", cuda_device):
        env = velocity_env(16, d)
        torch.manual_seed(0)
        algs[d] = PPO(env, ac=ActorCriticRMA(env.num_obs, env.num_privileged_obs,
                                             env.num_obs_history, env.num_actions))
    traj, last_values, perm = random_trajectory(algs["cpu"], 8, seed=1)
    out = {}
    for d, alg in algs.items():
        ts = alg.init()
        start = {k: v.detach().cpu().clone() for k, v in ts.params.items()}
        tr = Transition(*(x.to(d) for x in traj))
        returns, adv = alg.compute_gae(tr, last_values.to(d))
        out[d] = alg.update(ts, tr, returns, adv, perm=perm)
    (ts_c, m_c), (ts_g, m_g) = out["cpu"], out[cuda_device]
    errs = {
        "params_leaf_rms_rel": max(float(((ts_g.params[k].detach().cpu() - v.detach()).square()
                                          .mean() / (v.detach() - start[k]).square().mean())
                                         .sqrt()) for k, v in ts_c.params.items()),
        "opt_state": max(float((ts_g.opt_state.mu[k].cpu() - v).abs().max()
                               / v.abs().max().clamp(min=1e-30))
                         for k, v in ts_c.opt_state.mu.items()),
        "losses": max(abs(float(m_g[k]) - float(m_c[k])) / max(abs(float(m_c[k])), 1.0)
                      for k in ("value_loss", "surrogate_loss", "adaptation_loss",
                                "adaptation_test_loss", "kl_mean"))}
    assert float(ts_g.learning_rate) == float(ts_c.learning_rate)
    tol = {"params_leaf_rms_rel": 5e-3, "opt_state": 4e-3, "losses": 5e-5}
    assert all(errs[k] <= tol[k] for k in tol), errs


def port_run(logdir, cfg):
    """A run as the port's Runner writes it, on the CPU: parameters.pkl and
    a checkpoint of the CSE policy's initial weights."""
    from legged_tracking_torch.learn.runner import Runner
    runner = Runner(LeggedEnv(cfg, seed=3, device="cpu"), logdir=str(logdir), seed=0)
    runner.save(str(logdir / "ac_weights_last.pkl"))
    return str(logdir)


# the eval-reference phase's limits in chip_smoke.py, of max(|value|, 1),
# 15 to 20 times the readings on an H100
EVAL_ROLLOUT_TOL = {"lin_vel_rmsd": 1e-5, "ang_vel_rmsd": 2e-4, "lin_vel_x": 3e-5,
                    "ang_vel_yaw": 3e-4, "base_height": 6e-7, "max_torques": 5e-4,
                    "power_consumption": 4e-3, "CoT": 4e-3, "froude_number": 6e-6,
                    "adaptation_loss": 7e-5, "base_pos": 1e-6}


@pytest.mark.cuda
def test_eval_rollout_metrics_on_card_match_cpu(cuda_device, tmp_path):
    """eval.rollout_metrics of 8 envs (DR and noise off, 3-step episodes),
    5 steps from one reset state with the same draws, on the card against
    the CPU: every env's nine metrics and adaptation loss, and the frames'
    base positions, within the limits of chip_smoke.py's eval-reference
    phase; the metrics of the CPU's final state computed on the card
    bitwise (the adaptation loss, a cuBLAS product, within 3e-7)."""
    from legged_tracking_torch import eval as ev

    logdir = port_run(tmp_path, tunnel_cfg(8, 2))
    out, draws = {}, []
    for d in ("cpu", cuda_device):
        env = ev.load_env(logdir, 8, device=d)
        if d == "cpu":
            cpu_draw = env.draw

            def record(tag, shape, lo, hi, integer=False):
                draws.append(cpu_draw(tag, shape, lo, hi, integer))
                return draws[-1]
            env.draw = record
        else:
            replay = iter(draws)
            env.draw = lambda tag, shape, lo, hi, integer=False: next(replay).to(cuda_device)
        alg, policy = ev.load_policy(env, logdir)
        _, frames = ev.rollout_metrics(env, alg, policy, 5, state=env.reset_fn(False))
        out[d] = (env, alg, {k: v.cpu() for k, v in ev.per_env_metrics(env, alg).items()},
                  frames)
    (env_c, _, per_cpu, fr_cpu), (env_g, alg_g, per_card, fr_card) = out["cpu"], out[cuda_device]
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max().clamp(min=1.0))
    errs = {k: rel(per_card[k], v) for k, v in per_cpu.items()}
    errs["base_pos"] = max(float(abs(a["base_pos"] - b["base_pos"]).max())
                           for a, b in zip(fr_card, fr_cpu))
    assert len(errs) == len(EVAL_ROLLOUT_TOL)
    assert all(errs[k] <= EVAL_ROLLOUT_TOL[k] for k in errs), errs
    move = lambda x: (x.to(cuda_device) if torch.is_tensor(x) else
                      type(x)(*map(move, x)) if hasattr(x, "_fields") else x)
    env_g.state = move(env_c.state)
    same = ev.per_env_metrics(env_g, alg_g)
    for k, v in per_cpu.items():
        if k == "adaptation_loss":
            assert rel(same[k].cpu(), v) <= 3e-7
        else:
            assert torch.equal(same[k].cpu(), v), k


@pytest.mark.cuda
def test_eval_reached_on_card(cuda_device, tmp_path):
    """eval_reached at 64 envs for 20 steps on the card: the counts read
    once at the end are sane and B1 ran once at observe and once a step."""
    from legged_tracking_torch import eval_reached

    env, policy = eval_reached.load(port_run(tmp_path, tunnel_cfg(8, 2)), 64,
                                    device=cuda_device)
    before = scan.scan_heights.launches
    rec = eval_reached.evaluate(env, policy, steps=20)
    assert scan.scan_heights.launches == before + 1 + 20
    assert rec["episodes"] > 0            # 3-step episodes end within 20 steps
    assert 0.0 <= rec["reached"] <= 1.0 and np.isfinite(rec["mean_ep_len"])


@pytest.mark.cuda
def test_scan_kernel_bitwise_on_a_shard(cuda_device):
    """Kernel B1 == its plain version, bitwise, on one rank's shard of the
    bench: rank 1 of 2 of 4096 envs holds 2048, whose ``env_tile`` rows are
    the second half of the whole env's."""
    import chip_smoke
    from legged_tracking_torch.parallel import Shard

    cfg = tunnel_cfg(4096, 32)
    whole = build_terrain(cfg, 4096, seed=1, device=cuda_device)
    env = LeggedEnv(cfg, terrain=whole, device=cuda_device, shard=Shard(1, 2, 4096))
    assert torch.equal(env.terrain.env_tile, whole.env_tile[2048:])
    args = chip_smoke.scan_args(env.terrain, env.tile_table, cfg, cuda_device)
    assert args[2].shape[0] == 2048
    out = scan.scan_heights(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, scan.scan_heights_reference(*args))


@pytest.mark.cuda
def test_data_parallel_on_card_matches_one_rank(cuda_device):
    """chip_smoke.py's dp-reference phase: the 8-env configuration of
    tests/test_distributed.py run by two gloo ranks that share card 0 and by
    one rank, within 1e-5 on the rollout and atol 2e-4 / rtol 2e-3 on the
    parameters after two Runner.learn iterations (the phase raises past
    them), the two ranks' parameters equal."""
    import chip_smoke

    chip_smoke.phase_dp_reference(torch.device("cuda", 0), "card test")


@pytest.fixture
def four_cards(cuda_device):
    count = torch.cuda.device_count()
    if count < 4:
        pytest.skip(f"needs 4 NVIDIA cards (data parallelism across cards over NCCL); torch "
                    f"sees {count}")
    return 4


@pytest.mark.cuda
def test_scan_kernel_bitwise_on_every_card(four_cards):
    """chip_smoke.py's kernels-per-card phase: kernel B1 == its plain
    version, bitwise, at the bench shapes on each of four cards (the inputs
    made on card 0 and copied), its output on the card of its inputs."""
    import chip_smoke

    row = chip_smoke.phase_kernels_per_card([f"card {k}" for k in range(four_cards)])
    assert row["max_abs_err"] == 0.0
    assert [c["card_index"] for c in row["per_card"]] == list(range(four_cards))


@pytest.mark.cuda
def test_data_parallel_across_four_cards_matches_one_rank(four_cards):
    """chip_smoke.py's dp-reference-nccl phase: the 8-env configuration of
    tests/test_distributed.py run by four NCCL ranks, one a card, and by one
    rank on card 0, within 1e-5 on the rollout and atol 2e-4 / rtol 2e-3 on
    the parameters after two Runner.learn iterations (the phase raises past
    them, or where a rank's backend is not NCCL), the ranks' parameters
    equal."""
    import chip_smoke

    chip_smoke.phase_dp_reference(torch.device("cuda", 0), "card test", ranks=four_cards,
                                  backend="nccl", device="cuda", phase="dp_reference_nccl")


def cse_export(path, n_obs, n_hist, seed=0):
    """A random CSE policy's ``policy.npz`` (the velocity run's shapes with
    n_obs 70, n_hist 2100)."""
    from legged_tracking_torch.io.checkpoint import export_policy_npz
    from legged_tracking_torch.learn.actor_critic import ActorCriticCSE

    torch.manual_seed(seed)
    export_policy_npz(path, ActorCriticCSE(n_obs, 2, n_hist, 12).state_dict())
    return path


@pytest.mark.cuda
def test_policy_runtime_on_card_matches_cpu(cuda_device, tmp_path):
    """The deploy runtime on the card against the same export on the CPU,
    within chip_smoke.py's DEPLOY_RUNTIME_TOL: 300 histories at once and
    one at a time, as the control loop calls it; numpy in and out."""
    import chip_smoke
    from legged_tracking_torch.deploy.policy_runtime import PolicyRuntime

    path = cse_export(str(tmp_path / "policy.npz"), 70, 2100)
    card, cpu = PolicyRuntime(path, device=cuda_device), PolicyRuntime(path, device="cpu")
    assert next(card.parameters()).is_cuda
    x = np.random.RandomState(0).randn(300, 2100).astype(np.float32)
    y = card(x)
    assert isinstance(y, np.ndarray) and y.shape == (300, 12)
    ref = cpu(x)
    assert np.abs(y - ref).max() <= chip_smoke.DEPLOY_RUNTIME_TOL
    rows = np.concatenate([card(x[i:i + 1]) for i in range(0, 300, 30)])
    assert np.abs(rows - ref[::30]).max() <= chip_smoke.DEPLOY_RUNTIME_TOL


@pytest.mark.cuda
def test_actuator_fit_on_card_matches_cpu(cuda_device):
    """One epoch of the actuator-net fit (16 minibatches of 4096) on the card
    and on the CPU from the same initial weights, within chip_smoke.py's
    ACTUATOR_FIT_TOL; the card's losses finite."""
    import chip_smoke
    from legged_tracking_torch import train_actuator_net as tam

    rng = np.random.RandomState(0)
    X = rng.randn(17 * 4096, 6).astype(np.float32)
    Y = (np.tanh(X[:, :1] * 3.0 - X[:, 3:4]) * 20.0).astype(np.float32)
    w = tam.init_weights(0)
    card = tam.fit(X, Y, epochs=1, device=cuda_device, weights=w)
    cpu = tam.fit(X, Y, epochs=1, device="cpu", weights=w)
    assert card.minibatches == 16 and np.isfinite(card.losses).all()
    for k in w:
        assert np.abs(card.weights[k] - cpu.weights[k]).max() <= chip_smoke.ACTUATOR_FIT_TOL, k


def test_policy_runtime_on_cuda_without_a_card_raises(tmp_path):
    """Where torch sees no card, ``PolicyRuntime(device="cuda")`` raises; it
    does not run on the CPU.  (The inverse of this file's other tests: it
    runs where there is no card, so it carries no ``cuda`` marker.)"""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA card")
    from legged_tracking_torch.deploy.policy_runtime import PolicyRuntime

    path = cse_export(str(tmp_path / "policy.npz"), 70, 2100)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PolicyRuntime(path, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PolicyRuntime(path)


@pytest.mark.cuda
def test_physics_oracle_on_card(cuda_device):
    """chip_smoke.py's physics-oracle phase at 512 envs: the sparse engine
    within the JAX package's bars of the dense oracle on the card, the
    dense oracle on the card within its limits of the CPU, the physical
    anchors (free fall, M positive definite with the total mass, energy,
    drop-and-stand at the Go1's weight for P and the actuator net, friction
    anisotropy), the calibration anchors (feet-only stance, the thigh step,
    the ji22 gate's shares) and the flat sampler (against the contact
    sampler, and card against CPU)."""
    import chip_smoke
    row = chip_smoke.physics_oracle(cuda_device, 512)
    assert not row["bad"], row


@pytest.mark.cuda
def test_flat_sampler_and_stance_on_card(cuda_device):
    """At 512 envs on the card (the bench's tiles, 16 x 16 of them at this
    width): the contact sampler within the worst case of its bf16 stages of
    the flat float32 sampler on the bf16-quantized tiles (on the CPU the
    errors read 4.9e-3 and 5.2e-2, one gradient past the JAX package's 5e-2
    bar, as its own patch path is), both samplers on the card within their
    limits of the CPU, and feet-only contact at calm P stance after 200
    steps (tests/test_calibration.py's bounds)."""
    import chip_smoke
    from legged_tracking_torch.physics.model import make_go1_model

    n = 512
    terrain = chip_smoke.bench_terrain(n, cuda_device)
    fw = chip_smoke.flat_vs_window(terrain)
    bound = chip_smoke.bf16_stage_bounds(fw["run"][0].tiles, terrain.horizontal_scale)
    for k in chip_smoke.FLAT_BARS:
        assert fw[k] <= bound[k], (k, fw[k], bound[k])
    cc = chip_smoke.samplers_card_vs_cpu(*fw["run"], chip_smoke.FLAT_CPU_ENVS)
    for sampler, errs in cc.items():
        for k, limit in chip_smoke.FLAT_CARD_TOL.items():
            assert errs[k] <= limit, (sampler, k, errs[k])
    s, report, _ = chip_smoke.drop_and_stand(make_go1_model(cuda_device), n, cuda_device, "P",
                                             1.0, steps=200)
    readings = chip_smoke.feet_only(s, report)
    _, failed = chip_smoke.calibration_checks(readings)
    assert failed == [], readings


def physics_env(task, control_type, num_envs, device):
    """The tunnel env on a single_path heightfield of 2 x 2 tiles, or the
    velocity env on its 2 x 2 trimesh tiles, with ``control_type``."""
    from legged_tracking_torch.envs.velocity_env import VelocityTrackingEnv

    cfg = tunnel_cfg(num_envs, 2) if task == "tunnel" else velocity_cfg(num_envs)
    cfg.control.control_type = control_type
    env_class = LeggedEnv if task == "tunnel" else VelocityTrackingEnv
    return env_class(cfg, seed=3, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("control_type", ["actuator_net", "P"])
@pytest.mark.parametrize("task", ["tunnel", "velocity"])
def test_physics_graph_replay_equals_eager(cuda_device, task, control_type):
    """The env's physics step (``physics/graph.py``) at 16 envs for 8 steps
    with auto-resets, on a tunnel heightfield and on the velocity env's
    trimesh tiles, for both control types: each graph replay equals the
    eager block on the same inputs bitwise; one capture serves every step;
    step t's outputs are unchanged by step t+1's replay; a terrain of 8
    envs (as ``set_shard`` leaves it) captures anew and a return to 16 once
    more, each bitwise."""
    from torch.utils._pytree import tree_leaves as leaves

    from legged_tracking_torch.actuation import actuators

    n = 16
    env = physics_env(task, control_type, n, cuda_device)
    cfg, step = env.cfg, env.physics_step
    state = env.reset_fn(True)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    kept = None
    for _ in range(8):
        actions = torch.randn(n, env.num_actions, generator=g, device=cuda_device)
        scaled = actuators.scale_actions(actions, cfg.control.action_scale,
                                         cfg.control.hip_scale_reduction)
        inputs = env._physics_inputs(state, scaled)
        got = step(env.terrain, env.tile_table, *inputs)
        want = step.eager(env.terrain, env.tile_table, *inputs)
        assert len(leaves(got)) == 19
        assert all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(want)))
        if kept is not None:
            assert all(torch.equal(a, b) for a, b in zip(leaves(kept[0]), kept[1]))
        kept = (got, [t.clone() for t in leaves(got)])
        state, _ = env.step_fn(state, actions)
    assert step.captures == 1

    half = lambda x: type(x)(*(half(v) for v in x)) if hasattr(x, "_fields") else (
        tuple(half(v) for v in x) if isinstance(x, tuple) else x[:n // 2])
    t = env.terrain
    terrain = t._replace(env_tile=t.env_tile[:n // 2], env_origin=t.env_origin[:n // 2],
                         env_terrain_origin=t.env_terrain_origin[:n // 2])
    for terr, ins, captures in ((terrain, half(inputs), 2), (t, inputs, 3)):
        got = step(terr, env.tile_table, *ins)
        want = step.eager(terr, env.tile_table, *ins)
        assert step.captures == captures
        assert all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(want)))


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["tunnel", "velocity"])
def test_physics_step_makes_no_sync(cuda_device, task):
    """One eager physics block (contact window and ``control_step``) and
    one graph replay with its copies, at 16 envs after a warm-up, under
    ``torch.cuda.set_sync_debug_mode("error")``: nothing raises."""
    n = 16
    env = physics_env(task, "actuator_net", n, cuda_device)
    inputs = env._physics_inputs(env.reset_fn(True), torch.zeros(n, 12, device=cuda_device))
    env.physics_step(env.terrain, env.tile_table, *inputs)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        env.physics_step.eager(env.terrain, env.tile_table, *inputs)
        env.physics_step(env.terrain, env.tile_table, *inputs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert env.physics_step.captures == 1


@pytest.mark.cuda
def test_physics_graph_on_a_card_that_is_not_current(four_cards):
    """Two envs of one process on two cards: card 0's physics step captures
    first, then the last card's is captured and replayed while card 0 is
    the current device (as a rank that never set its card would run it);
    the last card's replays equal its eager block bitwise, on that card."""
    from torch.utils._pytree import tree_leaves

    first = physics_env("tunnel", "actuator_net", 16, torch.device("cuda", 0))
    first.physics_step(first.terrain, first.tile_table,
                       *first._physics_inputs(first.reset_fn(True),
                                              torch.zeros(16, 12, device="cuda:0")))
    assert first.physics_step.captures == 1
    card = torch.device("cuda", four_cards - 1)
    with torch.cuda.device(card):
        env = physics_env("tunnel", "actuator_net", 16, card)
        state = env.reset_fn(True)
        g = torch.Generator(device=card).manual_seed(5)
        scaled = 0.25 * torch.randn(16, env.num_actions, generator=g, device=card)
        inputs = env._physics_inputs(state, scaled)
        want = tree_leaves(env.physics_step.eager(env.terrain, env.tile_table, *inputs))
    with torch.cuda.device(0):
        for _ in range(2):
            got = tree_leaves(env.physics_step(env.terrain, env.tile_table, *inputs))
            assert all(a.device == card and torch.equal(a, b) for a, b in zip(got, want))
    assert env.physics_step.captures == 1
