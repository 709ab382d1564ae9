"""Throughput benchmark of the port: env-steps/s of whole PPO train
iterations of the bench configuration (counterpart of the repo's
``bench.py``, which measures the JAX package).

    python -m legged_tracking_torch.bench                  # on the card
    BENCH_NUM_ENVS=4 BENCH_ITERS=1 BENCH_ITERS_PER_CALL=1 \\
        python -m legged_tracking_torch.bench --device cpu

Builds the bench configuration (:func:`build`, read from the same
``BENCH_*`` variables as the JAX build), runs 2 warm-up calls and then
``BENCH_ITERS`` (10) timed calls, each of ``BENCH_ITERS_PER_CALL`` (5)
back-to-back ``PPO.train_iteration``s (the JAX bench's ``lax.scan`` of K
iterations), with the device synchronized before each clock read.  Prints
the card's name and power limit and kernel B1's launches on one line, then,
as the last line, the JAX line's four keys: ``metric``, ``value`` (envs x
24 steps x iterations over the seconds), ``unit`` and ``vs_baseline``.

It runs on the card unless ``--device cpu`` is given; on ``cuda`` with no
card it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

# the reference's best logged training rate, Isaac Gym at 4000 envs on one
# GPU (BASELINE.md:14): the JAX bench's baseline, kept so both lines compare
BASELINE_ENV_STEPS_PER_S = 1093.8

# the JAX package's layout knobs (BENCH_* variable -> SimCfg field): the
# build stores them as the JAX build does, and the port's physics reads none
# of them (config.py, SimCfg)
LAYOUT_KNOBS = {"BENCH_FUSED": "fused_sampling", "BENCH_GRANULE": "granule_gather",
                "BENCH_LAYER": "layer_gather", "BENCH_INTERLEAVED": "interleaved_gather",
                "BENCH_PALLAS_SCAN": "pallas_scan"}


def bench_cfg(num_envs: int, tiles: int | None = None):
    """The configuration of ``bench.py:build`` (tunnel tracking, single_path
    terrain of tiles x tiles tiles, actuator net, xy commands, fixed_target
    goal, 21x11 scan).  By default the tiles are the most, up to the
    bench's 32 x 32, that the envs fill evenly: 32 at 1,024 envs and any
    multiple of them, 2 at 4 envs."""
    import numpy as np

    from .config import Cfg, config_go1
    from .terrain.tunnel import even_tile_grid
    if tiles is None:
        tiles = even_tile_grid(num_envs, 32)
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


def _flag(name: str, default: bool) -> bool:
    return os.environ.get(name, "1" if default else "0") == "1"


def bench_config(num_envs=None, lane_engine=None, tiles=None):
    """(cfg, PPOArgs) of the bench, with every ``BENCH_*`` variable the JAX
    build reads applied as it applies them, at the same defaults.  The
    terrain has ``tiles`` x ``tiles`` tiles (by default :func:`bench_cfg`'s:
    the bench's 32 wherever the JAX build can run)."""
    from .learn.ppo import PPOArgs

    if num_envs is None:
        num_envs = int(os.environ.get("BENCH_NUM_ENVS", 4096))
    cfg = bench_cfg(num_envs, tiles)
    sim = cfg.sim
    sim.lane_engine = _flag("BENCH_LANE", True) if lane_engine is None else lane_engine
    for var, field in LAYOUT_KNOBS.items():
        setattr(sim, field, _flag(var, getattr(sim, field)))
    # the contact window in cells, which the port's sampler reads
    sim.patch_y = int(os.environ.get("BENCH_PATCH_Y", sim.patch_y))
    sim.patch_x = int(os.environ.get("BENCH_PATCH_X", sim.patch_x))
    # the local planner of the pms strategy; BENCH_PMS_RESCAN restores the
    # reference's second height scan a step, BENCH_PMS_DIRECT the direct
    # candidate scoring in place of the quadform product
    if _flag("BENCH_PMS", False):
        cfg.commands.sampling_based_planning = True
        cfg.commands.planner_rescan = _flag("BENCH_PMS_RESCAN", False)
        cfg.commands.planner_quadform = not _flag("BENCH_PMS_DIRECT", False)
    args = PPOArgs(cheap_shuffle=_flag("BENCH_SHUFFLE", False),
                   windowed_history=_flag("BENCH_WINDOW", False))
    return cfg, args


def build(num_envs=None, lane_engine=None, tiles=None, device="cuda"):
    """The bench on ``device``: (env, alg, train_state, env_state, obs_dict),
    as ``bench.py:build`` returns them.  The policy's weights are drawn from
    seed 0, the env's draws from the configuration's seed; the env state is
    a reset with randomized episode lengths, observed once (B1's first
    launch).  Raises for ``cuda`` where torch sees no card."""
    import torch

    from .envs import LeggedEnv
    from .learn.ppo import PPO
    from .parallel import entry_device

    dev = entry_device(device)
    cfg, args = bench_config(num_envs, lane_engine, tiles)
    env = LeggedEnv(cfg, device=dev)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        alg = PPO(env, args=args, seed=0)
    ts = alg.init()
    env_state = env.reset_fn(True)
    obs = env.observe(env_state)
    return env, alg, ts, env_state, obs


def device_line(dev) -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them, or
    ``cpu``."""
    import torch

    dev = torch.device(dev)
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", str(index)],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def synchronize(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from .terrain import scan

    num_envs = int(os.environ.get("BENCH_NUM_ENVS", 4096))
    iters = int(os.environ.get("BENCH_ITERS", 10))
    K = int(os.environ.get("BENCH_ITERS_PER_CALL", 5))
    scan.scan_heights.launches = 0
    env, alg, ts, env_state, obs = build(num_envs, device=args.device)
    dev = env.device

    def run_k(ts, env_state, obs):
        for _ in range(K):
            ts, env_state, obs, m = alg.train_iteration(ts, env_state, obs)
        return ts, env_state, obs, m["value_loss"]

    # 2 warm-up calls: the first grows the allocator and picks the cuBLAS
    # kernels, the second runs at the steady state the timed calls see
    for _ in range(2):
        ts, env_state, obs, vl = run_k(ts, env_state, obs)
    synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        ts, env_state, obs, vl = run_k(ts, env_state, obs)
    synchronize(dev)
    dt = time.perf_counter() - t0
    if not bool(vl.isfinite()):
        raise RuntimeError(f"bench: value loss {float(vl)} after {iters} calls")

    fps = iters * K * num_envs * alg.args.num_steps_per_env / dt
    print(json.dumps({"card": device_line(dev), "envs": num_envs, "iters": iters,
                      "iters_per_call": K, "seconds": dt,
                      "scan_heights_launches": scan.scan_heights.launches}))
    print(json.dumps({
        "metric": "train_env_steps_per_s",
        "value": round(fps, 1),
        "unit": "env-steps/s",
        "vs_baseline": round(fps / BASELINE_ENV_STEPS_PER_S, 2),
    }))


if __name__ == "__main__":
    main()
