"""Smoke run of the PyTorch/CUDA port (``legged_tracking_torch``) on one card.

    python3 chip_smoke.py [--profile DIR]

Phases, each printing one JSON line:

1. build: compiles every CUDA kernel of the port with nvcc (one process
   per source, all at once) and prints the build seconds and ptxas report.
2. kernels: holds each kernel against its plain PyTorch version on the card
   at the shapes the main path gives it (the bench terrain, 4096 envs, the
   231-point scan grid; bases on the tiles, on cell boundaries and 10 m off
   the tiles), atol 0, and times both with CUDA events, beside two floors
   (the least kernel, ``torch.cuda._sleep(1)``, and a ``fill_`` of the
   output) and the kernel at half and twice its chosen envs per block.
3. reference: steps a small env on the CPU (plain versions) and on the card
   (kernels) from the same state with the same random draws and holds the
   card's observations, rewards and base positions to the CPU's, within
   limits of 5 to 20 times the float32-reordering errors read on an H100.
4. rollout: the acting half of the main path.  The bench configuration
   (``bench.py:build``) at 4096 envs with the default CSE actor-critic:
   reset, observe, then two 24-step ``PPO.rollout``s, the second timed.
   Checks that obs, rewards and values are finite and of the expected
   shapes, and that every kernel was launched on this path (the scan: once
   per step, once at observe).
5. update-reference: one ``train_iteration`` (rollout, GAE, 5 x 4
   minibatches) of 8 envs on the card and on the CPU from the same state,
   parameters, env draws, action noise and permutation; the card's
   parameters, Adam moments, learning rate and losses are held to the
   CPU's within limits of 5 to 20 times the errors read on an H100.
6. train: the main path.  The bench configuration at 4096 envs trained by
   the port's ``Runner.learn`` for 4 iterations into a temporary logdir.
   Checks finite metrics, parameters that moved, the scan launched 24
   times an iteration and once at the Runner's observe, metrics.jsonl, a
   checkpoint that loads back and policy.npz; prints train env-steps/s
   over the iterations after the first (host clock, each iteration between
   two synchronizes), their rollout/update split (CUDA events, no barrier
   inside an iteration) and the peak memory.

Then the kernel table as one JSON line, the card's name and power limit as
``nvidia-smi`` prints them, and last ``{"ok": true, "device": ...}``.  The
script exits non-zero, without that last line, when CUDA is missing, when
the port is not beside it, or when any phase fails.  It imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# the bench's width (bench.py:build): envs stepped in parallel on the card
NUM_ENVS = 4096

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and float32
# operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def emit(obj):
    print(json.dumps(obj), flush=True)


def bench_cfg(num_envs: int, tiles: int = 32):
    """The configuration of ``bench.py:build`` (tunnel tracking, single_path
    terrain of tiles x tiles tiles, actuator net, xy commands, fixed_target
    goal, 21x11 scan); the bench has 32x32 tiles."""
    import numpy as np

    from legged_tracking_torch.config import Cfg, config_go1
    cfg = config_go1(Cfg())
    cfg.env.num_envs = num_envs
    t = cfg.terrain
    t.mesh_type, t.terrain_type = "trimesh", "single_path"
    t.num_rows, t.num_cols = tiles, tiles
    t.terrain_length, t.terrain_width = 4.0, 2.0
    t.terrain_ratio_x, t.terrain_ratio_y = 0.9, 0.5
    t.ceiling_height, t.start_loc = 0.8, 0.32
    t.measure_front_half = True
    t.measured_points_x = np.linspace(-1, 1, 21)
    t.measured_points_y = np.linspace(-0.5, 0.5, 11)
    cfg.env.episode_length_s = 10.0
    cfg.env.command_type = "xy"
    cfg.control.control_type = "actuator_net"
    cfg.asset.penalize_contacts_on = ["thigh", "calf", "base"]
    cfg.asset.terminate_after_contacts_on = []
    cfg.rewards.terminal_body_height = 0.0
    cfg.reward_scales.set("exploration_lin", 1.0)
    cfg.reward_scales.set("exploration_yaw", 0.4)
    cfg.commands.traj_function = "fixed_target"
    cfg.commands.traj_length = 1
    cfg.commands.switch_dist = 0.3
    cfg.commands.base_x = 2.6
    return cfg


def cuda_ms(fn, iters: int = 100, reps: int = 7) -> tuple[float, float]:
    """(device ms, call ms) of one call of ``fn``, medians over ``reps``.

    Call ms: ``iters`` calls timed on the host clock to the synchronize,
    which is what a caller that waits for the host pays.  Device ms: the
    mean over ``iters`` back-to-back calls between two CUDA events, with a
    device-side sleep queued first that outlasts the host's queueing, so
    the host's own time per call stays out of the reading.  The device
    queues about a thousand launches; past that the host waits for it, so
    ``iters`` times the launches of one call stays below that."""
    import torch

    def event():
        return torch.cuda.Event(enable_timing=True)

    for _ in range(3):
        fn()
    a, b = event(), event()
    a.record()
    torch.cuda._sleep(10_000_000)
    b.record()
    b.synchronize()
    ms_per_cycle = a.elapsed_time(b) / 10_000_000
    dev, call = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        call.append((time.perf_counter() - t0) * 1e3 / iters)

        # a host stall while queueing (the machine's cores are shared) can
        # outlast the sleep; such a run is repeated with a longer sleep
        for attempt in range(4):
            slept, start, end = event(), event(), event()
            slept.record()
            torch.cuda._sleep(int(3 * 4 ** attempt * call[-1] * iters / ms_per_cycle))
            start.record()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            queued = time.perf_counter() - t0
            end.record()
            end.synchronize()
            if queued * 1e3 < slept.elapsed_time(start):
                break
        else:
            raise RuntimeError(f"the host took {queued * 1e3:.3f} ms to queue {iters} calls, "
                               f"longer than the device slept "
                               f"({slept.elapsed_time(start):.3f} ms)")
        dev.append(start.elapsed_time(end) / iters)
    return sorted(dev)[reps // 2], sorted(call)[reps // 2]


def phase_build(card_line: str):
    from legged_tracking_torch.utils.cuda_build import KERNELS
    t0 = time.perf_counter()
    KERNELS.build(["scan_heights"], force=True)
    seconds = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines() if "ptxas" in ln]
             for name, log in KERNELS.build_logs.items()}
    emit({"phase": "build", "ok": True, "card": card_line, "seconds": seconds, "ptxas": ptxas})


def phase_kernels(dev, card_line: str):
    """Kernel B1 against its plain version at the main path's shapes."""
    import torch

    from legged_tracking_torch.terrain import heightfield as hf
    from legged_tracking_torch.terrain import scan
    from legged_tracking_torch.terrain.tunnel import build_terrain

    n_envs = NUM_ENVS
    cfg = bench_cfg(n_envs)
    terrain = build_terrain(cfg, n_envs, cfg.seed, device=dev)
    table = hf.bf16_table(terrain)
    g = torch.Generator(device=dev).manual_seed(0)
    # thirds: random bases on the tiles, spawn bases (every scan point on a
    # cell boundary), and bases 10 m past the tiles (every point clamps)
    base = terrain.env_origin[:, :2].clone()
    third = n_envs // 3
    base[:third] += torch.rand(third, 2, generator=g, device=dev) - 0.5
    base[2 * third:] += 10.0
    pitch = torch.rand(n_envs, generator=g, device=dev) - 0.5
    pitch[third:2 * third] = 0.0
    cam = torch.stack([0.12 * torch.cos(pitch), torch.zeros_like(pitch)], -1)
    frames = torch.stack([base, cam, terrain.env_terrain_origin[:, :2]], 1).contiguous()
    nx, ny = len(cfg.terrain.measured_points_x), len(cfg.terrain.measured_points_y)
    gx = torch.as_tensor(cfg.terrain.measured_points_x, dtype=torch.float32)
    gy = torch.as_tensor(cfg.terrain.measured_points_y, dtype=torch.float32)
    grid = torch.stack(torch.meshgrid(gx, gy, indexing="ij"), -1).reshape(nx * ny, 2).to(dev)
    hs = terrain.horizontal_scale
    args = (table, terrain.env_tile, frames, grid, hs)

    out = scan.scan_heights(*args)
    torch.cuda.synchronize()
    ref = scan.scan_heights_reference(*args)
    ref_cpu = scan.scan_heights_reference(*(a.cpu() if torch.is_tensor(a) else a for a in args))
    err = float((out - ref).abs().max())
    err_cpu = float((out.cpu() - ref_cpu).abs().max())
    if err != 0.0 or err_cpu != 0.0:
        raise AssertionError(f"scan_heights: kernel vs plain max abs err {err} on the card, "
                             f"{err_cpu} vs the CPU")
    ms, call_ms = cuda_ms(lambda: scan.scan_heights(*args))
    plain_ms, plain_call_ms = cuda_ms(lambda: scan.scan_heights_reference(*args), iters=20)
    # floors, timed alike: the least kernel the card runs, and one PyTorch
    # fill of a tensor of the output's size (writing the output alone)
    launch_floor_ms, _ = cuda_ms(lambda: torch.cuda._sleep(1))
    write_floor_ms, _ = cuda_ms(lambda: out.fill_(0.0))

    # the chosen launch shape beside envs per block halved and doubled,
    # each held bitwise to the plain version
    N, P = frames.shape[0], grid.shape[0]
    chosen = scan.launch_shape(N, P, torch.cuda.get_device_properties(dev).multi_processor_count)
    shapes = []
    for E in sorted({max(2, chosen[0] // 2 // 2 * 2), chosen[0], 2 * chosen[0]}):
        shape = (E, -(-N // E), scan.staging_bytes(E, P))
        if not torch.equal(scan._launch(*args, shape), ref):
            raise AssertionError(f"scan_heights: launch shape {shape} disagrees with plain")
        shapes.append({"E": E, "blocks": shape[1], "smem": shape[2],
                       "ms": cuda_ms(lambda: scan._launch(*args, shape))[0]})

    # least work: each input read once, the output written once; of the
    # table, the cells this run's points touch (both layers)
    L = table.shape[1]
    touched = int(torch.unique(scan.scan_cells(*args)).numel())
    nbytes = (N * 2 * P * 4 + N * 3 * 2 * 4 + N * 4 + P * 2 * 4 + touched * L * 2)
    ops = N * P * 2 * 4          # per axis: two adds, a subtract, a multiply
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    row = {"name": "scan_heights", "route": "cuda",
           "source": "legged_tracking_torch/csrc/scan_heights.cu",
           "replaces": "legged_tracking_tpu/terrain/pallas_scan.py:97",
           "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": None}
    emit({"phase": "kernels", "ok": True, "card": card_line, "kernel": "scan_heights",
          "shape": {"N": N, "P": P, "table": list(table.shape)}, "max_abs_err": err,
          "max_abs_err_vs_cpu": err_cpu, "ms": ms, "plain_ms": plain_ms,
          "call_ms": call_ms, "plain_call_ms": plain_call_ms,
          "bytes": nbytes, "table_cells_touched": touched, "ops": ops,
          "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
          "bound_share": row["bound_ms"] / ms, "launch_floor_ms": launch_floor_ms,
          "write_floor_ms": write_floor_ms,
          "launch_shape": dict(zip(("E", "blocks", "smem"), chosen)),
          "launch_shapes": shapes, "library_ms": None})
    return [row]


class DrawLog:
    """Records an env's random draws in order, to replay them elsewhere."""

    def __init__(self, env):
        self.draw, self.log = env.draw, []

    def __call__(self, tag, shape, lo, hi, integer=False):
        v = self.draw(tag, shape, lo, hi, integer)
        self.log.append((tag, v))
        return v

    def replay(self, device):
        it = iter(self.log)

        def draw(tag, shape, lo, hi, integer=False):
            rtag, v = next(it)
            if rtag != tag:
                raise AssertionError(f"draw order differs: {tag} != {rtag}")
            return v.to(device)
        return draw


def phase_reference(dev, card_line: str):
    """The card (kernels) against the CPU (plain versions), 8 envs, 5 steps."""
    import torch

    from legged_tracking_torch.envs import LeggedEnv
    from legged_tracking_torch.learn.actor_critic import ActorCriticCSE

    n, steps = 8, 5
    cpu, card_env = (LeggedEnv(bench_cfg(n, tiles=2), seed=3, device=d) for d in ("cpu", dev))
    log = DrawLog(cpu)
    cpu.draw = log
    s_cpu = cpu.reset_fn(True)
    o_cpu = cpu.observe(s_cpu)
    acts = [0.3 * torch.sin(0.1 * i + torch.arange(n * 12, dtype=torch.float32)).reshape(n, 12)
            for i in range(steps)]
    outs_cpu = []
    for a in acts:
        s_cpu, out = cpu.step_fn(s_cpu, a)
        outs_cpu.append((s_cpu.phys.base_pos, out))

    card_env.draw = log.replay(dev)
    s = card_env.reset_fn(True)
    o = card_env.observe(s)
    errs = {"reset_obs": float((o["obs"].cpu() - o_cpu["obs"]).abs().max())}
    torch.manual_seed(0)
    ac = ActorCriticCSE(cpu.num_obs, cpu.num_privileged_obs, cpu.num_obs_history, 12)
    with torch.no_grad():
        h = o_cpu["obs_history"].float()
        mean_cpu = ac.action_dist(o_cpu["obs"], o_cpu["privileged_obs"], h)[0]
        ac = ac.to(dev)
        mean = ac.action_dist(o["obs"], o["privileged_obs"], o["obs_history"].float())[0]
    errs["policy_mean"] = float((mean.cpu() - mean_cpu).abs().max())
    worst = {"base_pos": 0.0, "obs": 0.0, "rew": 0.0}
    for a, (bp_cpu, out_cpu) in zip(acts, outs_cpu):
        s, out = card_env.step_fn(s, a.to(dev))
        if not torch.equal(out.done.cpu(), out_cpu.done):
            raise AssertionError("done flags differ between the card and the CPU")
        for k, x, y in (("base_pos", s.phys.base_pos, bp_cpu), ("obs", out.obs, out_cpu.obs),
                        ("rew", out.rew, out_cpu.rew)):
            worst[k] = max(worst[k], float((x.cpu() - y).abs().max()))
    errs.update(worst)
    # the same float32 sums in another order (cuBLAS products, reductions);
    # the scan itself is exact.  On an H100 the errors read 0 (reset obs),
    # 6.0e-8 (policy mean), 4.8e-7 (base_pos), 5.7e-5 (obs) and 1.8e-7
    # (rew, of rewards up to |rew_max|); each limit is 5 to 20 times that
    tol = {"reset_obs": 1e-6, "policy_mean": 1e-6, "base_pos": 1e-5, "obs": 5e-4,
           "rew": 1e-6}
    bad = {k: v for k, v in errs.items() if not v <= tol[k]}
    rew_max = max(float(out_cpu.rew.abs().max()) for _, out_cpu in outs_cpu)
    emit({"phase": "reference", "ok": not bad, "card": card_line, "envs": n, "steps": steps,
          "max_abs_err": errs, "tolerance": tol, "rew_max": rew_max})
    if bad:
        raise AssertionError(f"card vs CPU beyond tolerance: {bad}")


def phase_rollout(dev, card_line: str, profile_dir: str | None):
    import torch

    from legged_tracking_torch.envs import LeggedEnv
    from legged_tracking_torch.learn.ppo import PPO
    from legged_tracking_torch.terrain import scan

    n_envs = NUM_ENVS
    cfg = bench_cfg(n_envs)
    t0 = time.perf_counter()
    env = LeggedEnv(cfg, device=dev)
    alg = PPO(env, seed=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    T = alg.args.num_steps_per_env

    scan.scan_heights.launches = 0
    state = env.reset_fn(True)
    obs = env.observe(state)
    per_rollout, seconds = [], None
    for i in range(2):
        before = scan.scan_heights.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, obs, traj, metrics, _ = alg.rollout(state, obs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        per_rollout.append(scan.scan_heights.launches - before)
    launches = scan.scan_heights.launches
    if per_rollout != [T, T] or launches != 2 * T + 1:
        raise AssertionError(f"scan_heights launches {per_rollout} per rollout, {launches} "
                             f"in all; expected {T} per rollout and one at observe")

    n_obs, n_priv, n_hist = env.num_obs, env.num_privileged_obs, env.num_obs_history
    shapes = {"obs": (T, n_envs, n_obs), "privileged_obs": (T, n_envs, n_priv),
              "obs_history": (T, n_envs, n_hist), "actions": (T, n_envs, 12),
              "rewards": (T, n_envs), "values": (T, n_envs), "dones": (T, n_envs)}
    for name, shape in shapes.items():
        x = getattr(traj, name)
        if tuple(x.shape) != shape:
            raise AssertionError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
        if x.is_floating_point() and not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{name}: non-finite values")
    if not all(bool(torch.isfinite(v).all()) for v in obs.values()):
        raise AssertionError("last observations: non-finite values")

    if profile_dir:
        profile(lambda: alg.rollout(state, obs), "rollout", profile_dir, card_line)

    emit({"phase": "rollout", "ok": True, "card": card_line, "envs": n_envs, "steps": T,
          "setup_s": setup_s, "rollout_s": seconds,
          "env_steps_per_s": n_envs * T / seconds,
          "scan_heights_launches": launches, "per_rollout": per_rollout,
          "mean_reward": float(traj.rewards.mean()), "done_frac": float(traj.dones.float().mean()),
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    return {"scan_heights": launches}


def phase_update_reference(dev, card_line: str):
    """One train_iteration of 8 envs on the card against the CPU: the same
    reset state and env draws, parameters, action noise and permutation."""
    import torch

    from legged_tracking_torch.envs import LeggedEnv
    from legged_tracking_torch.learn.ppo import PPO, PPOArgs

    n, T = 8, 8
    g = torch.Generator().manual_seed(1)
    noise = torch.randn(T, n, 12, generator=g)
    perm = torch.randperm(T * n, generator=g)
    log, outs = None, {}
    for d in ("cpu", dev):
        env = LeggedEnv(bench_cfg(n, tiles=2), seed=3, device=d)
        if log is None:
            log = env.draw = DrawLog(env)
        else:
            env.draw = log.replay(dev)
        torch.manual_seed(0)                    # the same initial weights on both
        alg = PPO(env, args=PPOArgs(num_steps_per_env=T), seed=0)
        state = env.reset_fn(True)
        ts = alg.init()
        start = {k: v.detach().cpu().clone() for k, v in ts.params.items()}
        ts, _, _, metrics = alg.train_iteration(ts, state, env.observe(state),
                                                action_noise=noise.to(d), perm=perm)
        outs[d] = (ts, metrics)
    (ts_c, m_c), (ts_g, m_g) = outs["cpu"], outs[dev]

    def rms_rel(a, b, keys):
        """rms difference of the leaves ``keys`` over the rms distance they
        moved from the start."""
        d = sum(float((a[k].detach().cpu() - b[k].detach()).square().sum()) for k in keys)
        m = sum(float((b[k].detach() - start[k]).square().sum()) for k in keys)
        return (d / m) ** 0.5

    leaf = {k: rms_rel(ts_g.params, ts_c.params, [k]) for k in ts_c.params}
    worst = max(leaf, key=leaf.get)

    def rel(a, b):
        """Largest abs difference of a leaf over the leaf's largest value."""
        return max(float((a[k].cpu() - b[k]).abs().max() / b[k].abs().max().clamp(min=1e-30))
                   for k in b)

    losses = ("value_loss", "surrogate_loss", "adaptation_loss", "adaptation_test_loss",
              "kl_mean")
    errs = {"params_rms_rel": rms_rel(ts_g.params, ts_c.params, list(ts_c.params)),
            "params_leaf_rms_rel": leaf[worst],
            "opt_state": rel(ts_g.opt_state.mu, ts_c.opt_state.mu),
            "adapt_opt_state": rel(ts_g.adapt_opt_state.mu, ts_c.adapt_opt_state.mu),
            "learning_rate": abs(float(ts_g.learning_rate) / float(ts_c.learning_rate) - 1),
            "losses": max(abs(float(m_g[k]) - float(m_c[k])) / max(abs(float(m_c[k])), 1.0)
                          for k in losses)}
    # the same float32 sums in another order (cuBLAS products, reductions),
    # in the 8 steps of physics and in the update, where Adam's division by
    # sqrt(nu) + 1e-8 lets a few elements with near-zero gradients step
    # apart.  On an H100 the errors read: parameters 2.0e-3 of the rms
    # distance they moved (2.6e-2 for the worst leaf, the adaptation
    # module's first bias), Adam moments 5.7e-3 and 6.5e-3 of each leaf's
    # largest value, losses 5.6e-5, the learning rate bitwise (the same
    # branch at every minibatch); each limit is 5 to 10 times that
    tol = {"params_rms_rel": 1e-2, "params_leaf_rms_rel": 0.13, "opt_state": 3e-2,
           "adapt_opt_state": 4e-2, "learning_rate": 0.0, "losses": 5e-4}
    bad = {k: v for k, v in errs.items() if not v <= tol[k]}
    emit({"phase": "update_reference", "ok": not bad, "card": card_line, "envs": n,
          "steps": T, "max_err": errs, "tolerance": tol, "worst_leaf": worst,
          "leaf_rms_rel": leaf,
          "learning_rate": float(ts_c.learning_rate),
          "losses_cpu": {k: float(m_c[k]) for k in losses}})
    if bad:
        raise AssertionError(f"train_iteration, card vs CPU beyond tolerance: {bad}")


def update_flop(ac, samples: int) -> float:
    """Matrix-product operations of a PPO update over ``samples`` sample
    passes, from the layer shapes: each layer's forward, its weight
    gradient and, where its input needs one, its input gradient.  The
    actor's input holds the latent, so all its layers take an input
    gradient; the critic's and the adaptation module's first layers read
    the history only.  The adaptation module runs twice a minibatch (in the
    policy, and in its own substep)."""
    macs = lambda mlp: sum(l.in_features * l.out_features for l in mlp.layers)
    first = lambda mlp: mlp.layers[0].in_features * mlp.layers[0].out_features
    a, c, d = ac.actor_body, ac.critic_body, ac.adaptation_module
    per_sample = 3 * macs(a) + (3 * macs(c) - first(c)) + 2 * (3 * macs(d) - first(d))
    return 2.0 * per_sample * samples


def phase_train(dev, card_line: str, profile_dir: str | None):
    """The main path: the bench configuration trained by Runner.learn."""
    import tempfile

    import numpy as np
    import torch

    from legged_tracking_torch.envs import LeggedEnv
    from legged_tracking_torch.learn.runner import Runner, RunnerArgs
    from legged_tracking_torch.terrain import scan

    n_envs, iters = NUM_ENVS, 4
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as logdir:
        t0 = time.perf_counter()
        env = LeggedEnv(bench_cfg(n_envs), device=dev)
        scan.scan_heights.launches = 0
        runner = Runner(env, runner_args=RunnerArgs(log_freq=1, save_interval=2),
                        logdir=logdir, seed=0)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        at_observe = scan.scan_heights.launches
        alg = runner.alg
        T = alg.args.num_steps_per_env
        start = {k: v.detach().clone() for k, v in runner.train_state.params.items()}

        # each iteration on the host clock between two synchronizes (Runner.learn
        # reads its metrics back every iteration at log_freq 1, so the loop
        # has that barrier anyway); its halves from CUDA events, which add none
        timed, launches = [], []
        spans = {"rollout": [], "update": []}

        def clocked(fn):
            def run(*args, **kwargs):
                torch.cuda.synchronize()
                before = scan.scan_heights.launches
                t = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                timed.append(time.perf_counter() - t)
                launches.append(scan.scan_heights.launches - before)
                return out
            return run

        def evented(name, fn):
            def run(*args, **kwargs):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                out = fn(*args, **kwargs)
                end.record()
                spans[name].append((start, end))
                return out
            return run

        alg.train_iteration = clocked(alg.train_iteration)
        alg.rollout = evented("rollout", alg.rollout)
        alg.update = evented("update", alg.update)
        history = runner.learn(iters, verbose=False)
        total = scan.scan_heights.launches
        if at_observe != 1 or launches != [T] * iters or total != 1 + T * iters:
            raise AssertionError(f"scan_heights launches: {at_observe} at observe, {launches} "
                                 f"per iteration, {total} in all; expected 1, {T} each")
        bad = [(r["it"], k) for r in history for k, v in r.items()
               if isinstance(v, float) and not np.isfinite(v)]
        if len(history) != iters or bad:
            raise AssertionError(f"metrics: {len(history)} records, non-finite {bad}")
        moved = {k: float((v.detach() - start[k]).abs().max())
                 for k, v in runner.train_state.params.items()}
        if not all(m > 0 for m in moved.values()):
            raise AssertionError(f"parameters that did not move: "
                                 f"{[k for k, m in moved.items() if m == 0]}")
        with open(os.path.join(logdir, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        if [r["it"] for r in records] != list(range(iters)):
            raise AssertionError(f"metrics.jsonl holds iterations {[r['it'] for r in records]}")
        policy = np.load(os.path.join(logdir, "policy.npz"))
        if "params/actor_body/Dense_0/kernel" not in policy:
            raise AssertionError(f"policy.npz keys: {sorted(policy)[:5]}")
        now = {k: v.detach().clone() for k, v in runner.train_state.params.items()}
        runner.load(os.path.join(logdir, "ac_weights_last.pkl"))
        if not all(torch.equal(now[k], v) for k, v in runner.train_state.params.items()):
            raise AssertionError("ac_weights_last.pkl does not load back the parameters")
        files = sorted(os.listdir(logdir))

    torch.cuda.synchronize()
    split = {k: [a.elapsed_time(b) / 1e3 for a, b in v] for k, v in spans.items()}
    # the first iteration carries one-time work (allocator growth, cuBLAS
    # heuristics); the rate is over the rest
    it_s, roll_s, upd_s = (float(np.mean(v[1:])) for v in (timed, split["rollout"],
                                                            split["update"]))
    flop = update_flop(alg.ac, n_envs * T * alg.args.num_learning_epochs)
    last = history[-1]
    emit({"phase": "train", "ok": True, "card": card_line, "envs": n_envs, "steps": T,
          "iterations": iters, "minibatches": alg.args.num_learning_epochs
          * alg.args.num_mini_batches, "setup_s": setup_s,
          "train_env_steps_per_s": n_envs * T / it_s, "iteration_s": it_s,
          "rollout_s": roll_s, "update_s": upd_s, "iteration_s_all": timed,
          "rollout_s_all": split["rollout"], "update_s_all": split["update"],
          "update_matmul_flop": flop, "update_flop_per_s": flop / upd_s,
          "update_bound_s": flop / F32_OPS_PER_S,
          "scan_heights_launches": total, "per_iteration": launches,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "logdir_files": files,
          "last": {k: last[k] for k in ("value_loss", "surrogate_loss", "adaptation_loss",
                                        "kl_mean", "learning_rate", "mean_reward_per_step")}})
    if profile_dir:
        state, obs = runner.env_state, runner.obs_dict
        profile(lambda: alg.train_iteration(runner.train_state, state, obs), "train_iteration",
                profile_dir, card_line)
        _, last_obs, traj, _, _ = alg.rollout(state, obs)
        returns, adv = alg.compute_gae(traj, alg._last_values(last_obs, None))
        profile(lambda: alg.update(runner.train_state, traj, returns, adv), "update",
                profile_dir, card_line)
    return {"scan_heights": total}


def profile(fn, label: str, out_dir: str, card_line: str):
    """``fn`` once more under torch.profiler: device busy time by kernel and
    the device's idle share of its wall time."""
    import torch
    from torch.profiler import ProfilerActivity
    os.makedirs(out_dir, exist_ok=True)
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    attr = "device_time_total" if hasattr(ka[0], "device_time_total") else "cuda_time_total"
    rows = sorted(((e.key, getattr(e, attr), e.count) for e in ka
                   if getattr(e, "device_type", None) is not None
                   and str(e.device_type).endswith("CUDA")), key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    runtime = {e.key: {"count": e.count, "cpu_ms": e.cpu_time_total / 1e3} for e in ka
               if e.key.startswith("cuda") and e.count}
    with open(os.path.join(out_dir, f"{label}_kernels.txt"), "w") as f:
        f.write(ka.table(sort_by=attr, row_limit=60))
    emit({"phase": "profile", "of": label, "card": card_line, "wall_s": wall,
          "device_busy_s": busy_us / 1e6, "device_idle_share": 1.0 - busy_us / 1e6 / wall,
          "kernel_launches": sum(r[2] for r in rows), "runtime_calls": runtime,
          "top": [{"name": k[:80], "ms": t / 1e3, "count": c} for k, t, c in rows[:15]]})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also profile one rollout and one train iteration and write the "
                         "kernel tables to DIR")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import legged_tracking_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card_line = card()

    phase_build(card_line)
    rows = phase_kernels(dev, card_line)
    phase_reference(dev, card_line)
    by_path = {"rollout": phase_rollout(dev, card_line, args.profile)}
    phase_update_reference(dev, card_line)
    by_path["train"] = phase_train(dev, card_line, args.profile)
    for row in rows:
        row["launches_by_path"] = {path: n[row["name"]] for path, n in by_path.items()}
        row["launches"] = by_path["train"][row["name"]]
        if not all(row["launches_by_path"].values()):
            raise AssertionError(f"{row['name']} was not launched on every path: "
                                 f"{row['launches_by_path']}")
    emit({"kernels": rows, "card": card_line})
    print(card_line)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
