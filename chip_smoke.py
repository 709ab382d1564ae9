"""Smoke run of the PyTorch/CUDA port (``legged_tracking_torch``) on one card,
or across K cards of one host with ``--cards K``.

    python3 chip_smoke.py [--profile DIR]
    python3 chip_smoke.py --cards 4

Phases of the one-card run, each printing one JSON line:

1. build: compiles every CUDA kernel of the port with nvcc (one process
   per source, all at once) and prints the build seconds and ptxas report.
2. kernels: holds each kernel against its plain PyTorch version on the card
   at the shapes the main path gives it (the bench terrain, 4096 envs, the
   231-point scan grid; bases on the tiles, on cell boundaries and 10 m off
   the tiles), atol 0, and times both with CUDA events, beside two floors
   (the least kernel, ``torch.cuda._sleep(1)``, and a ``fill_`` of the
   output) and the kernel at half and twice its chosen envs per block.
   conv-wgrad: kernel W1, the height encoder's conv weight gradients, at
   the conv + GRU cell's shapes and the full scan's, against its float64
   plain version (1e-5 of the largest |dW|), bitwise from launch to
   launch, timed beside its bound, the plain version and cuDNN's
   ``conv2d_weight`` (``library_ms``), the call the port no longer makes,
   under its heuristic and under its search (``cudnn.benchmark``,
   ``library_search_ms``).
3. reference: steps a small env on the CPU (plain versions) and on the card
   (kernels) from the same state with the same random draws and holds the
   card's observations, rewards and base positions to the CPU's, within
   limits of 5 to 20 times the float32-reordering errors read on an H100.
4. physics-oracle: the engine's physics at the bench's 4096 envs against
   the dense rigid-body oracle (``dynamics.body_state``, ``mass_matrix``,
   ``forward_dynamics``, ``contact.apparent_masses``: an 18x18 composite
   mass matrix with an explicit inverse), on random states, payloads,
   base-COM offsets, torques and wrenches from a numpy seed: the sparse
   path's body velocities, mass blocks, solve, accelerations and apparent
   masses within the JAX package's bars of the dense ones
   (``tests/test_sparse_dynamics.py``); the dense oracle on the card within
   limits of 5 to 20 times its H100 errors of the same code on the CPU
   (64 envs); and the anchors of ``tests/test_physics.py``: free fall,
   M symmetric positive definite with the total mass 11.309932 kg, energy
   drift under 1 % over 100 passive dense substeps, drop-and-stand on the
   plane for 150 control steps under P and the actuator net (heights, |v|,
   the feet carrying 111 N within 2 %), and, in the P run, half the envs
   at friction 1.5 and half at 0.0 copied at step 100 and pushed sideways
   at 0.5 m/s; the anchors of ``tests/test_calibration.py`` on every env:
   feet-only contact on the P run's unpushed envs (non-foot slots under
   1 N, each foot 0.14-0.36 of m g, 0.24-0.30 m), the zero-gravity thigh
   step (90 % within 15 steps, peak under 1.6, settled within 0.05) and
   the ji22 gate of a velocity env on the plane (its shares of envs past
   the gate's bounds within those of the JAX package's draws); and the
   contact sampler against the flat float32 sampler
   (``heightfield.sample_height_bilinear``) on the bench's bf16 table, 16
   points an env within 0.5 m of its origin, against the JAX package's
   bars and within the worst case of its bf16 stages, both samplers on
   the card against the CPU (256 envs).  Prints every error beside its
   limit and its seconds.
5. rollout: the acting half of the main path.  The bench configuration
   (``bench.py:build``) at 4096 envs with the default CSE actor-critic:
   reset, observe, then two 24-step ``PPO.rollout``s, the second timed.
   Checks that obs, rewards and values are finite and of the expected
   shapes, and that every kernel was launched on this path (the scan: once
   per step, once at observe).
6. update-reference: one ``train_iteration`` (rollout, GAE, 5 x 4
   minibatches) of 8 envs on the card and on the CPU from the same state,
   parameters, env draws, action noise and permutation; the card's
   parameters, Adam moments, learning rate and losses are held to the
   CPU's within limits of 5 to 20 times the errors read on an H100.
7. cnn-update-reference: the same for the goal configuration with
   ``ActorCriticCNN`` (conv encoder and GRU), and W1 launched twice for
   each encoder backward of the update (three a minibatch).
8. velocity-reference: the same for the velocity env (8 envs, curriculum
   resamples every 2 steps, 5-step episodes) with the CSE policy; the
   curriculum's weights, bins and categories and the commands bitwise.
9. rma-update-reference: the same with ``ActorCriticRMA``.
10. planner: the local planner at 4096 envs x 462 scan points x 1,575
   candidates: the quadform's validity against the direct form's (zero
   mismatches), the device time of one ``_plan_local_targets`` (CUDA
   events) beside its byte reckoning, and its peak memory.
11. planner-reference: 8 envs of the hierarchy configuration, replanning
   every 2 steps, stepped 5 times on the card and on the CPU from one
   state with the same draws: the same choices, and obs, rewards, base
   positions and local targets within limits of 5 to 20 times the
   readings on an H100.
12. train: the main path.  The bench configuration at 4096 envs trained by
   the port's ``Runner.learn`` for 4 iterations into a temporary logdir,
   which the eval phases read (as the next three phases' runs).
   Checks finite metrics, parameters that moved, the scan launched 24
   times an iteration and once at the Runner's observe, metrics.jsonl, a
   checkpoint that loads back and policy.npz; prints train env-steps/s
   over the iterations after the first (host clock, each iteration between
   two synchronizes), their rollout/update split (CUDA events, no barrier
   inside an iteration) and the peak memory.
13. train-goal: the goal path, stage A of ``tools/goal_recipe.sh`` at 4096
   envs with its default policy (``ActorCriticCNN``, MLP encoder), held
   as the train phase is, after B1 is held bitwise at its 100x32 tiles.
14. train-hierarchy: the planner path, ``train_hierarchy``'s defaults (4000
   envs, the planner replanning every 100 steps), held the same way, with
   the planner's share of the rollout; B1 launches twice while the Runner
   starts (the scan ``reset_fn`` stores for the planner, and observe).
15. train-velocity: the velocity path, ``scripts/train_velocity_tracking
   .py``'s defaults (4000 envs, 30x30 tiles of 50x50 cells, the 441-bin
   command curriculum over 4 gaits, the CSE policy), held the same way; it
   observes no heights, so B1 is launched 0 times.
16. eval-reference: ``eval.rollout_metrics`` of the bench run's checkpoint,
   8 envs with DR and noise off, 5 steps on the card and on the CPU from
   one reset state with the same draws; every env's nine metrics and
   adaptation loss, and the frames' base positions, then the metrics of
   the CPU's final state computed on the card, within limits of 5 to 20
   times the readings on an H100.
17. eval: the eval entries on the four runs at their own widths, depths cut
   to 100 steps (printed): ``eval``'s rollout and metrics (16 envs) on each
   run, ``eval_reached`` (1,024 envs) on the goal run and
   ``play_hierarchical`` (1 env, the planner every 100 steps) on the
   hierarchy run; each prints its metrics, env-steps/s and B1's launches,
   held to the count the code gives (one a step, one at each observe, one
   at a reset that stores the planner's scan; none on the velocity run),
   and B1 is held bitwise at each tunnel env's width first.  No rendering.
18. deploy: the deploy stack with its policy on the card.  The port's C++
   bridge (``deploy/bridge``) is built with cmake and started as a
   subprocess on a bus of the phase's own (``LCM_DEFAULT_URL``), and each
   deploy entry's wiring runs 300 control steps at the reference's 20 ms
   against it: ``deploy_policy`` on the velocity run (RC profile, 70-dim
   obs x 30 history), ``deploy_traj_policy`` on the bench run (front_goal,
   261 x 15).  The runner does not wait for the RC's R2 switch, which the
   loopback never presses.  Checks telemetry, obs widths, finite obs and
   actions, the card's actions against the CPU runtime's on the logged
   histories, the bridge's joints settling on the last published targets,
   and B1 launched 0 times (the agent stubs the height scan); prints the
   policy's latency a step (CUDA events around the forward; the host clock
   from the obs array to the action array) and the loop period, median
   and p99.
19. actuator-net: the actuator-net trainer fitted on the card to a log of
   the bench path: the bench run's policy drives the bench configuration
   at 4096 envs for 100 steps (B1 101 times), the joint log becomes
   4,816,896 samples, the card's fit is held to the CPU's for one epoch
   over 65,536 samples, then the fit at the script's defaults runs 2
   epochs (1,175 minibatches each; seconds an epoch, microseconds a
   minibatch, peak memory), and the written npz loads back and steps.
20. dp-reference: data parallelism against one rank: the 8-env
   configuration of ``tests/test_distributed.py``, 3 env steps and 2
   ``Runner.learn`` iterations (4 steps, 2 x 2 minibatches), run by two
   ranks that share the card over gloo (named; NCCL refuses two ranks on
   one card: NCCL across cards is the ``--cards`` run's) and by one rank;
   rollout base
   positions and obs within 1e-5, parameters within atol 2e-4 / rtol 2e-3
   (the JAX package's bars), the ranks' parameters equal.
21. train-dp: the main path over two such ranks: the bench configuration at
   4096 global envs, 2048 a rank, B1 held bitwise at each rank's width and
   rows, then ``Runner.learn`` for 4 iterations, each rank held as the
   train phase is (B1 97 launches on each, rank 0 the only writer of the
   logdir), the ranks' parameter checksums equal; prints the global train
   env-steps/s beside the train phase's 1-rank rate, and each rank's
   rollout/update split, the all-reduce's share of its update (CUDA events
   around each collective) and its peak memory, which the ranks report to
   this process as JSON.
22. window-reference: windowed histories (``PPOArgs.windowed_history``)
   against stored ones at full width, on the bench (4096 envs, 261 x 15)
   and on the velocity defaults (4000 envs, 70 x 30): one rollout storing
   its histories, every one of its T x N rows rebuilt by
   ``window_histories`` from the frame stream and held to the stored row
   at atol 0, then one ``update`` each way from one TrainState and
   permutation: parameters, Adam moments, learning rate and losses
   bitwise, or within the update-reference limits with the errors printed.
23. train-window: the main path with windowed histories, the bench at 4096
   envs through ``Runner.learn`` with ``PPOArgs(windowed_history=True)``
   for 4 iterations, held as the train phase is (B1 97 launches), its
   train env-steps/s and peak memory printed beside the train phase's of
   this call; then the bench at 16,384 envs (16 envs a tile), B1 held
   bitwise at that width, and one ``train_iteration`` with stored and one
   with windowed histories after an untimed one: the peak memory and
   seconds of each.
24. bench-tools: the port's measurement tools on the main path, each run
   as a user runs it, in a process of its own: the bench entry
   (``python -m legged_tracking_torch.bench`` at 4096 envs, 2 warm-up and
   2 timed calls of 2 ``train_iteration``s), its last line held to the
   JAX bench line's four keys with a finite positive rate and B1's
   launches to (2 + 2) x 2 x 24 + 1 = 193; then ``tools/profile_bench
   --trace --iters 1 --ops`` into a temporary directory (removed at the
   end) and ``tools/analyze_trace`` on that trace, then
   ``tools/roofline`` at the bench entry's iteration time with the policy
   GEMMs' device ms from ``analyze_trace``'s line: one line each of the
   top 10 kernels, the top 10 source lines by device ms an iteration, the
   top 10 by launches and by syncs a step, the idle share, and the two
   FLOP counts with the share of the float32 peak.  Fails unless the
   port's lines claim 90 % of the device's busy time and B1 is filed
   under ``terrain/scan.py``.

Then each phase's wall seconds and the kernel table (B1's launches on every
path, eval, actuator-log, data-parallel, windowed and bench-entry paths
included, and none on the velocity and deploy paths; W1's on the
cnn-update-reference path, and none on the CSE and goal paths, the
rollout and the forward-only eval and deploy paths), each as one JSON
line, the card's name and power limit as ``nvidia-smi`` prints them, and
last ``{"ok": true, "device": ...}``.

``--cards K`` (K > 1; 4 on a four-card host) drives data parallelism across
the cards over NCCL, one rank a card, each rank on ``rank_device("cuda")``
(the card of its local rank), and none of the one-card phases but build and
train.  It needs K cards and exits 2 naming the count it sees when there
are fewer; nothing moves to gloo, to fewer ranks or to the CPU.  Phases:

1. build: as above.
2. kernels-per-card: B1 held bitwise (atol 0) against its plain version on
   each card, and against the CPU, at the kernels phase's shapes and
   inputs (made on card 0, copied to each), and its device time on each.
3. dp-reference-nccl: the dp-reference phase with K NCCL ranks (8 / K
   envs a rank) against one rank on card 0, at the same bars, every rank's
   backend NCCL.
4. train: the one-card train phase, the 1-rank rate both scalings are
   read against in the same call (the host moves the rate between calls).
5. train-nccl-weak: the train-dp phase with K NCCL ranks at 4096 envs a
   card (K x 4096 global): each rank held as the train phase is (B1 97
   launches, rank 0 the only writer), the ranks' parameter checksums
   equal; prints the global train env-steps/s over the slowest rank's
   iterations 2-4, the efficiency (global / (K x the train phase's)), each
   rank's card, rollout/update split, all-reduce seconds inside and
   outside the update (CUDA events around each collective) and their
   share of the update, peak memory and CPU affinity, and the host's CPU
   count.
6. train-nccl-strong: the same at the bench's 4096 global envs, 4096 / K a
   rank (what ``--num_devices K`` does to a run of the bench's width).
7. entries: ``train``, ``train_hierarchy`` and ``train_velocity_tracking``
   at ``--num_devices K``, and ``train --distributed`` under ``python -m
   torch.distributed.run --standalone --nproc_per_node K``, each at its
   own defaults for 2 iterations, as subprocesses: each exits 0, rank 0
   alone prints, its ``metrics.jsonl`` counts the global envs, and its
   checkpoint loads back into the entry's Runner on card 0 (8 envs).
   B1's launches in these processes are not counted.
8. scaling-nccl: ``tools/scaling_bench --devices 1 2 K --dist_backend
   nccl`` at the bench's 4096 total envs (its plane, P-control
   configuration), 2 iterations each: its summary, every rank on NCCL and
   a card of its own.

Then the phases' seconds, the kernel table (B1 with each card's time, and
its launches on every rank of the two train phases), every card's name and
power limit, one a line, and the same last line, whose ``count`` is the
cards torch sees.

The script exits non-zero, without that last line, when CUDA is missing,
when the port is not beside it, or when any phase fails.  It imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

from legged_tracking_torch.bench import bench_cfg, device_line
from legged_tracking_torch.tools.roofline import (F32_OPS_PER_S, HBM_BYTES_PER_S, dense_ms,
                                                  update_flop)

HERE = os.path.dirname(os.path.abspath(__file__))

# the bench's width (bench.py:build): envs stepped in parallel on the card
NUM_ENVS = 4096


def card(index: int = 0) -> str:
    """Card ``index``'s name and power limit, as nvidia-smi prints them."""
    return device_line(f"cuda:{index}")


def emit(obj):
    print(json.dumps(obj), flush=True)


def goal_args(num_envs: int | None = None, tiles: int = 32):
    """The published goal recipe's flags as stage A of
    ``tools/goal_recipe.sh`` gives them (random_pyramid tunnels of 100x32
    cells, TrajectoryTrackingRewards, valid_goal, the fix-target curriculum,
    the default ActorCriticCNN policy with its MLP height encoder), parsed
    by the port's ``train.parse_args``."""
    from legged_tracking_torch import train
    return train.parse_args([
        "--strategy", "goal", "--terrain", "random_pyramid",
        "--num_envs", str(num_envs or NUM_ENVS),
        "--max_noise_std", "1.0", "--cl_goal_target_dist", "3.8", "--cl_downstep", "0.5",
        "--terrain_rows", str(tiles), "--terrain_cols", str(tiles)])


def hierarchy_args(num_envs: int = 4000, tiles: int = 20, plan_interval: int = 100):
    """``train_hierarchy``'s defaults (4000 envs, 20x20 random_pyramid tiles
    of 100x32 cells, the planner replanning every 100 steps), parsed by the
    port's ``train_hierarchy.parse_args``."""
    from legged_tracking_torch import train_hierarchy
    return train_hierarchy.parse_args([
        "--num_envs", str(num_envs), "--terrain_rows", str(tiles),
        "--terrain_cols", str(tiles), "--plan_interval", str(plan_interval)])


def velocity_args(num_envs: int = 4000, tiles: int = 30):
    """``scripts/train_velocity_tracking.py``'s defaults (4000 envs, 30x30
    trimesh tiles of 5 m at 0.10 m, a 30-frame history, actuator-net
    torques, ji22 shaping at sigma 0.02, the CSE policy), parsed by the
    port's ``train_velocity_tracking.parse_args``."""
    from legged_tracking_torch import train_velocity_tracking
    return train_velocity_tracking.parse_args([
        "--num_envs", str(num_envs), "--terrain_rows", str(tiles), "--terrain_cols", str(tiles)])


def velocity_reference_env(device):
    """The velocity configuration cut to 8 envs on 2x2 tiles, with a
    command resample every 2 steps, 5-step episodes, the curriculum starting
    from its centre bin and success thresholds an eighth of the defaults:
    within 8 steps the curriculum update, the resample and the auto-reset
    run, and the weights move."""
    from legged_tracking_torch import train_velocity_tracking
    from legged_tracking_torch.envs.velocity_env import TRACK_KEYS, VelocityTrackingEnv

    cfg = train_velocity_tracking.build_cfg(velocity_args(8, tiles=2))
    cfg.commands.resampling_time = 0.04
    cfg.env.episode_length_s = 0.1
    cfg.commands.lin_vel_x = cfg.commands.ang_vel_yaw = [-0.3, 0.3]
    th = cfg.curriculum_thresholds
    for k in TRACK_KEYS:
        setattr(th, k, getattr(th, k) / 8)
    return VelocityTrackingEnv(cfg, seed=3, device=device)


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
    KERNELS.build(["scan_heights", "conv3x3_wgrad"], force=True)
    seconds = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines() if "ptxas" in ln]
             for name, log in KERNELS.build_logs.items()}
    emit({"phase": "build", "ok": True, "card": card_line, "seconds": seconds, "ptxas": ptxas})


def scan_args(terrain, table, cfg, dev):
    """B1's arguments for every env of ``terrain``, in thirds: random bases
    on the tiles, spawn bases (every scan point on a cell boundary), and
    bases 10 m past the tiles (every point clamps)."""
    import torch

    n_envs = terrain.env_origin.shape[0]
    g = torch.Generator(device=dev).manual_seed(0)
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
    return table, terrain.env_tile, frames, grid, terrain.horizontal_scale


def scan_check(env, dev) -> dict:
    """B1 against its plain version on an env's own terrain and width,
    atol 0, and both timed: the shapes a new path gives the kernel."""
    import torch

    from legged_tracking_torch.terrain import scan

    args = scan_args(env.terrain, env.tile_table, env.cfg, dev)
    out = scan.scan_heights(*args)
    ref = scan.scan_heights_reference(*args)
    err = float((out - ref).abs().max())
    if err != 0.0:
        raise AssertionError(f"scan_heights at N={args[2].shape[0]}, table "
                             f"{tuple(args[0].shape)}: kernel vs plain max abs err {err}")
    return {"N": args[2].shape[0], "P": args[3].shape[0], "table": list(args[0].shape),
            "launch_shape": list(scan.launch_shape(
                args[2].shape[0], args[3].shape[0],
                torch.cuda.get_device_properties(dev).multi_processor_count)),
            "max_abs_err": err, "ms": cuda_ms(lambda: scan.scan_heights(*args))[0],
            "plain_ms": cuda_ms(lambda: scan.scan_heights_reference(*args), iters=20)[0]}


def scan_bound(args) -> dict:
    """B1's least work on ``args`` and the least time the card could take
    for it: each input read once, the output written once; of the table,
    the cells these points touch (both layers)."""
    import torch

    from legged_tracking_torch.terrain import scan

    table, frames, grid = args[0], args[2], args[3]
    N, P, L = frames.shape[0], grid.shape[0], table.shape[1]
    touched = int(torch.unique(scan.scan_cells(*args)).numel())
    nbytes = (N * 2 * P * 4 + N * 3 * 2 * 4 + N * 4 + P * 2 * 4 + touched * L * 2)
    ops = N * P * 2 * 4          # per axis: two adds, a subtract, a multiply
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "table_cells_touched": touched, "ops": ops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def scan_row(err: float, ms: float, plain_ms: float, bound: dict) -> dict:
    """B1's entry of the kernel table (its launches filled in at the end)."""
    return {"name": "scan_heights", "route": "cuda",
            "source": "legged_tracking_torch/csrc/scan_heights.cu",
            "replaces": "legged_tracking_tpu/terrain/pallas_scan.py:97",
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"], "library_ms": None}


def bench_scan_args(dev):
    """B1's arguments at the bench's shapes on ``dev``: :func:`scan_args` of
    the bench terrain at 4096 envs."""
    from legged_tracking_torch.terrain import heightfield as hf
    from legged_tracking_torch.terrain.tunnel import build_terrain

    cfg = bench_cfg(NUM_ENVS)
    terrain = build_terrain(cfg, NUM_ENVS, cfg.seed, device=dev)
    return scan_args(terrain, hf.bf16_table(terrain), cfg, dev)


def phase_kernels(dev, card_line: str):
    """Kernel B1 against its plain version at the main path's shapes."""
    import torch

    from legged_tracking_torch.terrain import scan

    args = bench_scan_args(dev)
    table, frames, grid = args[0], args[2], args[3]

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

    bound = scan_bound(args)
    row = scan_row(err, ms, plain_ms, bound)
    emit({"phase": "kernels", "ok": True, "card": card_line, "kernel": "scan_heights",
          "shape": {"N": N, "P": P, "table": list(table.shape)}, "max_abs_err": err,
          "max_abs_err_vs_cpu": err_cpu, "ms": ms, "plain_ms": plain_ms,
          "call_ms": call_ms, "plain_call_ms": plain_call_ms,
          "bytes": bound["bytes"], "table_cells_touched": bound["table_cells_touched"],
          "ops": bound["ops"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
          "bound_share": row["bound_ms"] / ms, "launch_floor_ms": launch_floor_ms,
          "write_floor_ms": write_floor_ms,
          "launch_shape": dict(zip(("E", "blocks", "smem"), chosen)),
          "launch_shapes": shapes, "library_ms": None})
    return [row]


# the conv + GRU cell's update (benchmark/configs/tunnel_cnn_gru.json): a
# minibatch of 24,576 histories of 15 frames; frames of 261 floats, the
# height block (2, 10, 11) after 41 scalars
WGRAD_FRAMES = 24_576 * 15
WGRAD_OBS, WGRAD_SCALARS = 261, 41


def wgrad_inputs(dev, cin: int, cout: int, h: int, w: int, frames: int, seed: int):
    """W1's inputs as the encoder's backward hands them: for 2 input
    channels x a slice of observation rows (frame stride 261), else a
    channels_last map; dy channels_last; normal draws from ``seed``."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    if cin == 2:
        rows = torch.randn(frames, WGRAD_SCALARS + cin * h * w, generator=g, device=dev)
        x = rows[:, WGRAD_SCALARS:].reshape(frames, h, w, cin).permute(0, 3, 1, 2)
    else:
        x = torch.randn(frames, h, w, cin, generator=g, device=dev).permute(0, 3, 1, 2)
    dy = torch.randn(frames, h, w, cout, generator=g, device=dev).permute(0, 3, 1, 2)
    return x, dy


def wgrad_float64(x, dy, chunk: int = 16_384):
    """W1's plain version in float64, over chunks of frames."""
    from legged_tracking_torch.learn.conv3x3 import conv3x3_wgrad_reference

    dw = db = 0
    for i in range(0, x.shape[0], chunk):
        a, b = conv3x3_wgrad_reference(x[i:i + chunk].double(), dy[i:i + chunk].double())
        dw, db = dw + a, db + b
    return dw, db


def event_ms(fn, iters: int, warm: int = 2) -> float:
    """Mean ms of ``iters`` back-to-back calls of ``fn`` between two CUDA
    events, after ``warm`` calls: device time where the host queues ahead
    of the card, as it does for a kernel of milliseconds; a call that
    waits for the card (the plain version's large allocations) counts its
    host time too."""
    import torch

    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def wgrad_bound(cin: int, cout: int, h: int, w: int, frames: int) -> dict:
    """W1's least work: X and dY read once (the height block of X only),
    dW and db written once; 2 flops a multiply-add."""
    nbytes = 4 * frames * h * w * (cin + cout) + 4 * cout * (cin * 9 + 1)
    flop = 2 * frames * h * w * cout * (cin * 9 + 1)
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flop / F32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "flop": flop, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def phase_conv_wgrad(dev, card_line: str):
    """Kernel W1 at the conv + GRU cell's shapes (368,640 frames, both
    convs) and at the full (2, 21, 11) scan's: its dW and db within 1e-5 of
    the largest |dW| (|db|) of the float64 plain version, two launches
    bitwise equal, and its time beside its bound, the plain version's and
    cuDNN's (``torch.nn.grad.conv2d_weight``, the call the port no longer
    makes: ``library_ms``; ``library_search_ms`` with ``cudnn.benchmark``,
    the fastest algorithm cuDNN's search finds).  Returns W1's row of the
    kernel table, the shapes' rows in it."""
    import torch

    from legged_tracking_torch.learn import conv3x3 as c3

    rows = []
    for cin, cout, h, w in ((2, 16, 10, 11), (16, 32, 5, 5), (2, 16, 21, 11), (16, 32, 10, 5)):
        frames = WGRAD_FRAMES
        x, dy = wgrad_inputs(dev, cin, cout, h, w, frames, seed=cin * 1000 + h)
        before = c3.conv3x3_wgrad.launches
        dw, db = c3.conv3x3_wgrad(x, dy)
        dw2, db2 = c3.conv3x3_wgrad(x, dy)
        torch.cuda.synchronize()
        launches = c3.conv3x3_wgrad.launches - before
        ref_dw, ref_db = wgrad_float64(x, dy)
        err = {"dw": float((dw.double() - ref_dw).abs().max() / ref_dw.abs().max()),
               "db": float((db.double() - ref_db).abs().max() / ref_db.abs().max())}
        bitwise = bool(torch.equal(dw, dw2) and torch.equal(db, db2))
        if max(err.values()) > 1e-5 or not bitwise or launches != 2:
            raise AssertionError(f"conv3x3_wgrad {cin} -> {cout} on {h} x {w}: relative errors "
                                 f"{err} (limit 1e-5), repeat bitwise {bitwise}, "
                                 f"{launches} launches counted of 2")
        del dw, db, dw2, db2, ref_dw, ref_db
        plan = c3.launch_plan(cin, cout, h, w, frames, dev.index or 0)
        ms = event_ms(lambda: c3._launch(x, dy), iters=30)
        weight = torch.empty((cout, cin, 3, 3), device=dev)

        def library():
            return torch.nn.grad.conv2d_weight(x, weight.shape, dy, padding=1)

        library_ms = event_ms(library, iters=5)
        searched = torch.backends.cudnn.benchmark
        torch.backends.cudnn.benchmark = True
        try:
            library_search_ms = event_ms(library, iters=5)      # the search in the warm-up
        finally:
            torch.backends.cudnn.benchmark = searched
        plain_ms = event_ms(lambda: c3.conv3x3_wgrad_reference(x, dy), iters=2, warm=1)
        bound = wgrad_bound(cin, cout, h, w, frames)
        row = {"name": "conv3x3_wgrad", "route": "cuda",
               "source": "legged_tracking_torch/csrc/conv3x3_wgrad.cu", "replaces": None,
               "shape": {"cin": cin, "cout": cout, "h": h, "w": w, "frames": frames},
               "launch_shape": dict(zip(("slots", "per_slot", "blocks"), plan)),
               "rel_err": err, "bitwise_repeat": bitwise, "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "library_search_ms": library_search_ms,
               "bound_ms": bound["bound_ms"],
               "bound_by": bound["bound_by"], "bound_share": bound["bound_ms"] / ms,
               "tflops": bound["flop"] / ms / 1e9}
        emit({"phase": "conv_wgrad", "ok": True, "card": card_line, **row})
        rows.append({k: row[k] for k in ("shape", "launch_shape", "ms", "bound_ms", "plain_ms",
                                         "library_ms", "library_search_ms")})
        del x, dy
        torch.cuda.empty_cache()
    return {"name": "conv3x3_wgrad", "route": "cuda",
            "source": "legged_tracking_torch/csrc/conv3x3_wgrad.cu", "replaces": None,
            "shapes": rows}


def phase_kernels_per_card(cards: list):
    """Kernel B1 against its plain version on each card (``cards``: their
    nvidia-smi lines, card k's at index k) at the bench shapes, atol 0, on
    the card and against the CPU, and its device time there: the kernels
    phase's inputs, made on card 0 and copied to each card.  Returns B1's
    kernel-table entry, with card 0's times and every card's."""
    import torch

    from legged_tracking_torch.terrain import scan

    args0 = bench_scan_args(torch.device("cuda", 0))
    ref_cpu = scan.scan_heights_reference(*(a.cpu() if torch.is_tensor(a) else a
                                            for a in args0))
    per_card = []
    for k, line in enumerate(cards):
        dev = torch.device("cuda", k)
        with torch.cuda.device(dev):
            args = tuple(a.to(dev) if torch.is_tensor(a) else a for a in args0)
            out = scan.scan_heights(*args)
            torch.cuda.synchronize(dev)
            err = float((out - scan.scan_heights_reference(*args)).abs().max())
            err_cpu = float((out.cpu() - ref_cpu).abs().max())
            if out.device != dev or err != 0.0 or err_cpu != 0.0:
                raise AssertionError(f"kernels_per_card: scan_heights on {dev} wrote "
                                     f"{out.device}, max abs err {err} vs plain on the "
                                     f"card, {err_cpu} vs the CPU")
            ms, call_ms = cuda_ms(lambda: scan.scan_heights(*args))
            plain_ms, _ = cuda_ms(lambda: scan.scan_heights_reference(*args), iters=20)
            per_card.append({"card_index": k, "card": line, "device": str(out.device),
                             "launch_shape": list(scan.launch_shape(
                                 args[2].shape[0], args[3].shape[0],
                                 torch.cuda.get_device_properties(dev).multi_processor_count)),
                             "max_abs_err": err, "max_abs_err_vs_cpu": err_cpu,
                             "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms})
    bound = scan_bound(args0)
    row = scan_row(max(c["max_abs_err"] for c in per_card), per_card[0]["ms"],
                   per_card[0]["plain_ms"], bound)
    row["per_card"] = [{k: c[k] for k in ("card_index", "ms", "plain_ms", "max_abs_err")}
                       for c in per_card]
    emit({"phase": "kernels_per_card", "ok": True, "cards": cards, "kernel": "scan_heights",
          "shape": {"N": args0[2].shape[0], "P": args0[3].shape[0],
                    "table": list(args0[0].shape)},
          "bytes": bound["bytes"], "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
          "per_card": per_card})
    return row


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


# ---------------------------------------------------------------- physics-oracle
# the Go1's standing joint angles (FR, FL, RR, RL x hip, thigh, calf) and its
# total mass, the anchors of the JAX package's tests/test_physics.py
GO1_DEFAULT_Q = (-0.1, 0.8, -1.5, 0.1, 0.8, -1.5, -0.1, 1.0, -1.5, 0.1, 1.0, -1.5)
GO1_MASS = 11.309932
GRAVITY = 9.81

# the sparse engine against the dense oracle: the bars (rtol, atol) of the
# JAX package's tests/test_sparse_dynamics.py, which holds its own sparse
# engine to its dense oracle
SPARSE_BARS = {"omega": (0.0, 1e-5), "u": (0.0, 1e-5), "mass_blocks": (0.0, 2e-4),
               "solve": (2e-3, 2e-3), "forward_dynamics": (2e-3, 2e-2),
               "apparent_masses": (5e-3, 5e-4)}
# the dense oracle on the card against the same code on the CPU (the first
# ORACLE_CPU_ENVS envs), max abs error; on an H100 the errors read 1.2e-7
# (J), 3.0e-7 (M, entries up to 12), 4.0e-4 (M^-1, up to about 400),
# 5.4e-3 (qdd, up to about 7e3) and 4.8e-6 (W); each limit 8 to 11 times that
ORACLE_CPU_ENVS = 64
ORACLE_CARD_TOL = {"J": 1e-6, "M": 3e-6, "Minv": 4e-3, "qdd": 5e-2, "W": 5e-5}


def oracle_inputs(n: int, seed: int = 7) -> dict:
    """n random states and loads (CPU float32 tensors) with the ranges of
    tests/test_sparse_dynamics.py: base position U(-1, 1) + 0.4 m in z, Euler
    angles U(-0.6, 0.6), joint angles U(-1.2, 1.2), velocities U(-1, 1), a
    payload and a base-COM offset per env, joint torques N(0, 5^2), body
    wrenches N(0, 10^2) and a right-hand side N(0, 1) for the solve."""
    import numpy as np
    import torch

    from legged_tracking_torch.utils import quat
    rng = np.random.RandomState(seed)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    ang = f32(rng.uniform(-0.6, 0.6, (n, 3)))
    return {
        "base_pos": f32(rng.uniform(-1, 1, (n, 3)) + [0.0, 0.0, 0.4]),
        "base_quat": quat.quat_from_euler_xyz(ang[:, 0], ang[:, 1], ang[:, 2]),
        "qj": f32(rng.uniform(-1.2, 1.2, (n, 12))),
        "v": f32(rng.uniform(-1, 1, (n, 18))),
        "payload": f32(rng.uniform(-0.4, 0.7, n)),
        "com_offset": f32(rng.uniform(-0.05, 0.05, (n, 3))),
        "tau": f32(rng.normal(0.0, 5.0, (n, 12))),
        "f_ext": f32(rng.normal(0.0, 10.0, (n, 13, 6))),
        "gravity": f32(np.tile([0.0, 0.0, -GRAVITY], (n, 1))),
        "rhs": f32(rng.normal(size=(n, 18))),
    }


def dense_oracle(model, x: dict) -> dict:
    """The dense formulation on ``x``: body state, M, M^-1, qdd and W."""
    from legged_tracking_torch.physics import contact, dynamics
    args = (x["base_pos"], x["base_quat"], x["qj"], x["v"])
    bs = dynamics.body_state(model, *args, x["com_offset"])
    mm = dynamics.mass_matrix(model, bs, x["payload"])
    qdd = dynamics.forward_dynamics(model, *args, x["tau"], x["f_ext"], x["gravity"], bs, mm,
                                    x["com_offset"])
    return {"J": bs.J, "omega": bs.omega, "u": bs.u, "M": mm.M, "Minv": mm.Minv, "qdd": qdd,
            "W": contact.apparent_masses(model, bs, mm)}


def bar_ratio(a, b, rtol: float, atol: float) -> float:
    """max |a - b| / (atol + rtol |b|): at most 1 where allclose holds."""
    return float(((a - b).abs() / (atol + rtol * b.abs())).max())


def sparse_vs_dense(model, x: dict, dense: dict) -> dict:
    """The engine's sparse path (``sparse.velocity_jvp``, ``factorize``,
    ``solve``, ``forward_dynamics``, ``apparent_masses``) on ``x`` against
    the dense oracle's outputs: {check: (max abs error, ratio to its bar)}."""
    import torch

    from legged_tracking_torch.physics import sparse
    args = (x["base_pos"], x["base_quat"], x["qj"], x["v"])
    bs, alpha_vp, acc_vp = sparse.velocity_jvp(model, *args, x["com_offset"])
    fac = sparse.factorize(model, bs.fk, x["payload"])
    # the dense matrix assembled from the arrow blocks
    M = torch.zeros_like(dense["M"])
    M[:, :6, :6] = fac.A
    for leg in range(4):
        s = slice(6 + 3 * leg, 9 + 3 * leg)
        M[:, :6, s] = fac.B[:, leg]
        M[:, s, :6] = fac.B[:, leg].transpose(1, 2)
        M[:, s, s] = fac.D[:, leg]
    pairs = {
        "omega": (bs.omega, dense["omega"]),
        "u": (bs.u, dense["u"]),
        "mass_blocks": (M, dense["M"]),
        "solve": (sparse.solve(fac, x["rhs"]),
                  torch.matmul(dense["Minv"], x["rhs"][..., None])[..., 0]),
        "forward_dynamics": (sparse.forward_dynamics(
            model, *args, x["tau"], x["f_ext"], x["gravity"], bs, fac, x["com_offset"],
            vp=(alpha_vp, acc_vp)), dense["qdd"]),
        "apparent_masses": (sparse.apparent_masses(model, bs.fk, fac), dense["W"]),
    }
    return {k: (float((a - b).abs().max()), bar_ratio(a, b, *SPARSE_BARS[k]))
            for k, (a, b) in pairs.items()}


def anchor_free_fall(model, x: dict) -> dict:
    """At rest under gravity alone, at any configuration, every body falls
    at g: qdd = (0, 0, -9.81 | 0 | 0).  M is symmetric positive definite
    and its base-translation block is the total mass (with payload) times
    I.  {check: max abs error}, and the least eigenvalue of M."""
    import torch

    from legged_tracking_torch.physics import dynamics
    args = (x["base_pos"], x["base_quat"], x["qj"], torch.zeros_like(x["v"]))
    bs = dynamics.body_state(model, *args, x["com_offset"])
    mm = dynamics.mass_matrix(model, bs, x["payload"])
    qdd = dynamics.forward_dynamics(model, *args, torch.zeros_like(x["tau"]),
                                    torch.zeros_like(x["f_ext"]), x["gravity"], bs, mm,
                                    x["com_offset"])
    fall = torch.zeros_like(qdd[:, :6])
    fall[:, 2] = -GRAVITY
    mass = (GO1_MASS + x["payload"])[:, None, None] * torch.eye(3, device=qdd.device)
    return {"free_fall_base": float((qdd[:, :6] - fall).abs().max()),
            "free_fall_joints": float(qdd[:, 6:].abs().max()),
            "M_asymmetry": float((mm.M - mm.M.transpose(1, 2)).abs().max()),
            "M_translation_mass": float((mm.M[:, :3, :3] - mass).abs().max()),
            "M_min_eigenvalue": float(torch.linalg.eigvalsh(mm.M).min())}


def anchor_energy(model, x: dict) -> float:
    """The worst relative drift of E = T + V over 100 passive dense
    substeps of 5 ms (no contact, no torque, gravity on) from the random
    states raised by 10 m, each env as tests/test_physics.py runs its one."""
    import torch

    from legged_tracking_torch.physics import dynamics
    bp = x["base_pos"] + torch.tensor([0.0, 0.0, 10.0], device=x["v"].device)
    bq, qj, v = x["base_quat"], x["qj"], x["v"]
    zeros_tau, zeros_f = torch.zeros_like(x["tau"]), torch.zeros_like(x["f_ext"])
    payload = torch.zeros_like(x["payload"])

    def energy(bp, bq, qj, v):
        bs = dynamics.body_state(model, bp, bq, qj, v)
        mm = dynamics.mass_matrix(model, bs, payload)
        T = 0.5 * torch.einsum("ni,nij,nj->n", v, mm.M, v)
        return T + torch.sum(mm.mass * GRAVITY * bs.fk.com_w[..., 2], dim=1), bs, mm

    e0 = energy(bp, bq, qj, v)[0]
    for _ in range(100):
        _, bs, mm = energy(bp, bq, qj, v)
        qdd = dynamics.forward_dynamics(model, bp, bq, qj, v, zeros_tau, zeros_f,
                                        x["gravity"], bs, mm)
        bp, bq, qj, v = dynamics.integrate(bp, bq, qj, v, qdd, 0.005)
    return float(((energy(bp, bq, qj, v)[0] - e0) / e0.abs()).abs().max())


def plane_world(fr, dev, gravity: float = GRAVITY):
    """``heightfield.plane_terrain`` for len(fr) envs, its bf16 table, and
    physics parameters with friction ``fr``, gravity ``gravity`` m/s^2 down,
    no restitution, payload or COM offset."""
    import torch

    from legged_tracking_torch.physics import engine
    from legged_tracking_torch.terrain import heightfield as hf

    m = fr.shape[0]
    terrain = hf.plane_terrain(m, device=dev)
    z = torch.zeros(m, device=dev)
    params = engine.PhysParams(
        friction=fr, restitution=z, payload=z, com_offset=torch.zeros(m, 3, device=dev),
        gravity=torch.tensor([0.0, 0.0, -gravity], device=dev).expand(m, 3).contiguous())
    return terrain, hf.bf16_table(terrain), params


def go1_start(terrain, dev, z0: float, actions=None):
    """Go1s at rest at the default joint angles, ``z0`` above the terrain's
    origins, with the actuator carry of tests/test_physics.py's
    ``_make_step``; ``actions`` (n, 12) the scaled action it holds (0)."""
    import torch

    from legged_tracking_torch.actuation import actuators
    from legged_tracking_torch.physics import engine

    n = terrain.env_origin.shape[0]
    ones, zeros = torch.ones(n, 12, device=dev), torch.zeros(n, 12, device=dev)
    carry = (actuators.init_actuator_state(6, n, device=dev), ones, zeros, ones, ones,
             zeros.clone() if actions is None else actions)
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=dev).expand(n, -1)
    state = engine.PhysState(base_pos=terrain.env_origin + f([0.0, 0.0, z0]),
                             base_quat=f([0.0, 0.0, 0.0, 1.0]).clone(),
                             qj=f(GO1_DEFAULT_Q).clone(), v=torch.zeros(n, 18, device=dev))
    return state, carry


def control_steps(model, torque_fn, state, carry, terrain, table, params, k: int,
                  qj: list | None = None):
    """k control steps (4 substeps of 5 ms, contact stiffness 5000 and
    damping 50, as tests/test_physics.py steps); appends each step's joint
    angles to ``qj``.  Returns the state, the carry and the last step's aux."""
    from legged_tracking_torch.physics import contact, engine
    from legged_tracking_torch.terrain import heightfield as hf

    aux = None
    for _ in range(k):
        win = contact.ContactWindow(table, terrain.env_tile, *hf.contact_window(
            terrain, state.base_pos[:, :2], 24, 16))
        state, carry, aux = engine.control_step(
            model, terrain, win, terrain.env_terrain_origin, state, torque_fn, carry,
            params, 0.005, 4, 5000.0, 50.0, 80.0, 2.0)
        if qj is not None:
            qj.append(state.qj)
    return state, carry, aux


def go1_torques(model, dev, control_type: str):
    """The torque function of ``control_type`` at kp 20, kd 0.5, no lag."""
    import torch

    from legged_tracking_torch.actuation import actuators
    net = actuators.load_actuator_net(device=dev)
    return actuators.make_torque_fn(control_type, net, torch.tensor(GO1_DEFAULT_Q, device=dev),
                                    20.0, 0.5, model.dof_effort, randomize_lag=False)


def drop_and_stand(model, n: int, dev, control_type: str, friction,
                   push_at: int | None = None, steps: int = 150):
    """n Go1s dropped from 0.4 m onto ``heightfield.plane_terrain`` and held
    by ``control_type`` torques (kp 20, kd 0.5) for ``steps`` control steps
    (4 substeps of 5 ms, contact stiffness 5000 and damping 50), as
    tests/test_physics.py drops them; ``friction`` per env.  With
    ``push_at``, the run is copied at that step, the copy pushed sideways at
    0.5 m/s, and both run on to the last step side by side.  Returns the
    final state, the last step's contact report and the copy's lateral
    travel (None without a push)."""
    import torch

    from legged_tracking_torch.physics import engine

    torque_fn = go1_torques(model, dev, control_type)
    fr = torch.as_tensor(friction, dtype=torch.float32, device=dev).expand(n).contiguous()
    terrain, table, params = plane_world(fr, dev)
    state, carry = go1_start(terrain, dev, 0.4)
    if push_at is None:
        state, _, aux = control_steps(model, torque_fn, state, carry, terrain, table, params,
                                      steps)
        return state, aux.contact_report, None
    state, carry, _ = control_steps(model, torque_fn, state, carry, terrain, table, params,
                                    push_at)
    # the run and its pushed copy side by side, 2n envs; each copy keeps its
    # place on a grid of 2n origins
    two = lambda t: torch.cat([t, t])
    terrain2, table2, params2 = plane_world(two(fr), dev)
    v = two(state.v)
    v[n:, 1] = 0.5
    state = engine.PhysState(base_pos=two(state.base_pos - terrain.env_origin)
                             + terrain2.env_origin, base_quat=two(state.base_quat),
                             qj=two(state.qj), v=v)
    carry = (type(carry[0])(*map(two, carry[0])),) + tuple(map(two, carry[1:]))
    y0 = state.base_pos[n:, 1].clone()
    state, _, aux = control_steps(model, torque_fn, state, carry, terrain2, table2, params2,
                                  steps - push_at)
    return (engine.PhysState(*(t[:n] for t in state)), aux.contact_report[:n],
            state.base_pos[n:, 1] - y0)


def feet_only(state, report) -> dict:
    """The feet-only stance anchor of tests/test_calibration.py on a calm
    P stance's last contact report (n, 17, 3): the largest force on a
    non-foot slot (base, hips, thighs, calves), each foot's share of the
    weight (min, max), the feet's total against m g, and the base heights
    (min, max)."""
    import torch

    from legged_tracking_torch.physics.go1_model_data import FOOT_REPORT_SLOTS
    weight = GO1_MASS * GRAVITY
    nonfoot = [i for i in range(report.shape[1]) if i not in FOOT_REPORT_SLOTS]
    fz = report[:, FOOT_REPORT_SLOTS, 2]
    share, h = fz / weight, state.base_pos[:, 2]
    return {"nonfoot_force": float(report[:, nonfoot].abs().max()),
            "foot_share": [float(share.min()), float(share.max())],
            "feet_weight_rel_err": float(((fz.sum(dim=1) - weight) / weight).abs().max()),
            "stance_height": [float(h.min()), float(h.max())],
            "finite": bool(torch.isfinite(report).all() and torch.isfinite(h).all())}


def thigh_response(model, n: int, dev, delta: float = 0.3, steps: int = 50):
    """The PD step response of tests/test_calibration.py: n Go1s at rest 1 m
    up with gravity off, the four thigh targets stepped by ``delta`` rad
    under P control (kp 20, kd 0.5), ``steps`` control steps of 20 ms.  The
    normalized thigh angles (q - q_default) / delta, (steps, n, 4)."""
    import torch

    thighs = [1, 4, 7, 10]
    terrain, table, params = plane_world(torch.ones(n, device=dev), dev, gravity=0.0)
    act = torch.zeros(n, 12, device=dev)
    act[:, thighs] = delta
    state, carry = go1_start(terrain, dev, 1.0, actions=act)
    qj = []
    control_steps(model, go1_torques(model, dev, "P"), state, carry, terrain, table, params,
                  steps, qj=qj)
    q0 = torch.tensor(GO1_DEFAULT_Q, device=dev)[thighs]
    return (torch.stack(qj)[:, :, thighs] - q0) / delta


def thigh_step(model, n: int, dev) -> dict:
    """:func:`thigh_response` over every env and thigh: the least of each
    one's peak over the first 15 steps (the rise), the largest value (the
    peak) and the largest |x - 1| over the last 5 steps (the settling)."""
    import torch

    x = thigh_response(model, n, dev)
    return {"step_rise": float(x[:15].amax(dim=0).min()), "step_peak": float(x.max()),
            "step_settle": float((x[-5:] - 1.0).abs().max()),
            "step_finite": bool(torch.isfinite(x).all())}


def ji22_env(n: int, dev):
    """The velocity env of tests/test_calibration.py's ji22 gate:
    ``train_velocity_tracking``'s configuration with ``--terrain plane
    --pd_control`` at n envs, 20 s episodes."""
    from legged_tracking_torch import train_velocity_tracking as tv
    from legged_tracking_torch.envs.velocity_env import VelocityTrackingEnv
    cfg = tv.build_cfg(tv.parse_args(["--num_envs", str(n), "--terrain", "plane",
                                      "--pd_control", "--device", str(dev)]))
    cfg.env.episode_length_s = 20.0
    return VelocityTrackingEnv(cfg, device=dev)


def ji22_run(env, steps: int = 60, settle: int = 30):
    """The ji22 gate's run: reset, the velocity commands zeroed (the gait
    keeps its draw), zero actions for ``steps`` steps.  Per env: the mean
    per-step change of the ``rew_neg`` episode sum after step ``settle``,
    whether it was ever done, and the largest non-foot force of the last
    contact report."""
    import torch

    from legged_tracking_torch.physics.go1_model_data import FOOT_REPORT_SLOTS
    n, dev = env.num_envs, env.device
    env.reset(randomize_ep_len=False)
    commands = env.state.commands.clone()
    commands[:, :3] = 0.0
    env.state = env.state._replace(commands=commands)
    a = torch.zeros(n, 12, device=dev)
    done_any = torch.zeros(n, dtype=torch.bool, device=dev)
    neg_prev, delta = None, []
    for t in range(steps):
        _, _, done, info = env.step(a)
        done_any = done_any | done
        neg = info["episode_sums"][:, -1]                 # the rew_neg column
        if neg_prev is not None and t >= settle:
            delta.append(neg - neg_prev)
        neg_prev = neg
    report = env.state.contact_forces
    nonfoot = [i for i in range(report.shape[1]) if i not in FOOT_REPORT_SLOTS]
    return (torch.stack(delta).mean(dim=0), done_any,
            report[:, nonfoot].abs().amax(dim=(1, 2)))


def ji22_gate(n: int, dev) -> dict:
    """:func:`ji22_run` at n envs of the port's own draws: the least per-step
    change of ``rew_neg`` and the largest non-foot force, and the shares of
    envs past the anchor's bounds (per step at or below -0.15, ever done,
    non-foot force at or above 1 N)."""
    lim = ANCHOR_LIMITS
    per_step, done, nonfoot = ji22_run(ji22_env(n, dev))
    share = lambda m: float(m.float().mean())
    return {"ji22_neg_per_step": float(per_step.min()),
            "ji22_nonfoot_force": float(nonfoot.max()),
            "ji22_below_share": share(per_step <= lim["ji22_neg_per_step"]),
            "ji22_done_share": share(done),
            "ji22_nonfoot_share": share(nonfoot >= lim["nonfoot_force"])}


# the contact sampler (bf16 weights and stage-1 sums) against the flat
# float32 sampler on the same bf16-quantized tiles.  The JAX package's bars
# (tests/test_heightfield.py: atol 6e-3 on heights, 5e-2 on gradients) were
# read at 8 envs x 16 points; on the bench's tiles at 1024 envs its own
# patch path reads 6.91e-2 on gradients (tests/test_torch_terrain.py, which
# holds the port's errors equal to the JAX package's there).  So the phase prints
# the errors against those bars and holds them to the worst case of the bf16
# stages (:func:`bf16_stage_bounds`).  The flat sampler and the contact
# sampler on the card against the CPU (the first FLAT_CPU_ENVS envs): max
# abs error, within FLAT_CARD_TOL (both read 0, bitwise)
FLAT_BARS = {"height": 6e-3, "grad": 5e-2}
FLAT_CPU_ENVS = 256
FLAT_CARD_TOL = {"height": 1e-6, "grad": 2e-5}
BF16_UNIT_ROUNDOFF = 2.0 ** -8


def bf16_stage_bounds(tiles, hs: float) -> dict:
    """The most the contact sampler can stand from the flat one on a bf16
    table, with M the largest |height| and S the spread of heights: each
    bf16 weight and each bf16 stage-1 sum is off by at most u = 2^-8 of
    itself, so a height by 3 u M, an x-gradient (bf16 differences over hs)
    by 2 u S / hs and a y-gradient (a difference of two stage-1 sums over
    hs) by 4 u M / hs."""
    from legged_tracking_torch.terrain import heightfield as hf
    u, inv = BF16_UNIT_ROUNDOFF, hf.inv_hs(hs)
    t = tiles.float()
    M, S = float(t.abs().max()), float(t.max() - t.min())
    return {"height": 3 * u * M, "grad": max(2 * u * S * inv, 4 * u * M * inv)}


def bench_terrain(n: int, dev):
    """The bench's single_path terrain for n envs: 32 x 32 tiles of 80 x 40
    cells, or the most tiles a side up to 32 whose count divides n (the
    tunnel terrain gives each tile the same number of envs)."""
    from legged_tracking_torch.terrain.tunnel import build_terrain
    tiles = max(t for t in range(1, 33) if n % (t * t) == 0)
    cfg = bench_cfg(n, tiles)
    return build_terrain(cfg, n, cfg.seed, device=dev)


def flat_vs_window(terrain, seed: int = 0, points: int = 16, window: int = 32) -> dict:
    """``sample_window_bilinear`` on the bf16 table against
    ``sample_height_bilinear`` on the same tiles quantized to bf16, at
    ``points`` points an env drawn from a numpy seed within 0.5 m of each
    env's origin, with the window of tests/test_heightfield.py (32 x 32
    cells): {height, grad: max abs error}, the points past the JAX bars
    under "past_bars", and the inputs and both samplers' outputs under
    "run"."""
    import numpy as np
    import torch

    from legged_tracking_torch.terrain import heightfield as hf
    dev = terrain.tiles.device
    n = terrain.env_tile.shape[0]
    base = terrain.env_origin[:, :2].cpu().numpy()
    rng = np.random.RandomState(seed)
    pts = torch.as_tensor((base[:, None] + rng.uniform(-0.5, 0.5, (n, points, 2)))
                          .astype(np.float32), device=dev)
    quantized = terrain._replace(tiles=hf.bf16_table(terrain))
    window_out = sample_window(quantized, pts, window)
    flat_out = hf.sample_height_bilinear(quantized, quantized.env_tile,
                                         quantized.env_terrain_origin, pts)
    err = [(w - f).abs() for w, f in zip(window_out, flat_out)]
    return {"height": float(err[0].max()), "grad": float(err[1].max()),
            "past_bars": {k: int((e > FLAT_BARS[k]).sum()) for k, e in zip(FLAT_BARS, err)},
            "run": (quantized, pts, window, window_out, flat_out)}


def sample_window(quantized, pts, window: int):
    """The contact sampler at the window of ``window`` cells around each
    env's origin, on the bf16 table ``quantized.tiles``."""
    from legged_tracking_torch.terrain import heightfield as hf
    win = hf.contact_window(quantized, quantized.env_origin[:, :2], window, window)
    return hf.sample_window_bilinear(quantized.tiles, quantized.env_tile, *win,
                                     quantized.horizontal_scale,
                                     quantized.env_terrain_origin, pts)


def samplers_card_vs_cpu(quantized, pts, window: int, window_out, flat_out, m: int) -> dict:
    """Both samplers' outputs on the card against the same samplers on the
    CPU for the first m envs: {flat, window: {height, grad: max abs err}}."""
    from legged_tracking_torch.terrain import heightfield as hf
    cpu = lambda t: t[:m].cpu()
    q = quantized._replace(tiles=quantized.tiles.cpu(), env_tile=cpu(quantized.env_tile),
                           env_origin=cpu(quantized.env_origin),
                           env_terrain_origin=cpu(quantized.env_terrain_origin))
    ref = {"flat": hf.sample_height_bilinear(q, q.env_tile, q.env_terrain_origin, cpu(pts)),
           "window": sample_window(q, cpu(pts), window)}
    got = {"flat": flat_out, "window": window_out}
    return {k: {"height": float((cpu(got[k][0]) - ref[k][0]).abs().max()),
                "grad": float((cpu(got[k][1]) - ref[k][1]).abs().max())} for k in ref}


# the anchors' limits: tests/test_physics.py's bars (atol, or the bounds of
# a range), the friction check's as its ratio
ANCHOR_LIMITS = {"free_fall_base": 1e-4, "free_fall_joints": 2e-3, "M_asymmetry": 1e-5,
                 "M_translation_mass": 1e-4, "M_min_eigenvalue": 0.0, "energy_drift": 0.01,
                 "height": (0.18, 0.34), "speed_P": 0.05, "speed_actuator_net": 1.2,
                 "weight_rtol": 0.02, "dy_high_friction": 0.15, "dy_ratio": 2.0,
                 # tests/test_calibration.py's: feet-only stance, the thigh
                 # step (rise above, peak and settling below) and the ji22
                 # gate (above)
                 "nonfoot_force": 1.0, "foot_share": (0.14, 0.36),
                 "stance_height": (0.24, 0.30), "step_rise": 0.9, "step_peak": 1.6,
                 "step_settle": 0.05, "ji22_neg_per_step": -0.15,
                 # the ji22 gate depends on the draws (the domain
                 # randomization, the gait commands): over 256 envs of its
                 # own draws the JAX package has 12.9 % of envs at or below
                 # -0.15 a step, 3.5 % done and 12.9 % with a non-foot
                 # contact (`PYTHONPATH=. python tests/test_torch_calibration.py
                 # 256`); each limit is that share plus three standard errors
                 "ji22_below_share": 0.19, "ji22_done_share": 0.07,
                 "ji22_nonfoot_share": 0.19}


def calibration_checks(readings: dict) -> tuple[dict, list]:
    """Each reading of :func:`feet_only`, :func:`thigh_step` and
    :func:`ji22_gate` beside its limit in ANCHOR_LIMITS, and the names of
    those outside it."""
    lim = ANCHOR_LIMITS
    inside = lambda v, lo_hi: lo_hi[0] < v[0] and v[1] < lo_hi[1]
    rules = {"nonfoot_force": (lim["nonfoot_force"], lambda v: v < lim["nonfoot_force"]),
             "foot_share": (lim["foot_share"], lambda v: inside(v, lim["foot_share"])),
             "feet_weight_rel_err": (lim["weight_rtol"], lambda v: v <= lim["weight_rtol"]),
             "stance_height": (lim["stance_height"],
                               lambda v: inside(v, lim["stance_height"])),
             "step_rise": (lim["step_rise"], lambda v: v > lim["step_rise"]),
             "step_peak": (lim["step_peak"], lambda v: v < lim["step_peak"]),
             "step_settle": (lim["step_settle"], lambda v: v < lim["step_settle"]),
             # the ji22 gate over many envs: each env against the anchor's
             # bounds, the shares of envs past them against the reference's
             "ji22_neg_per_step": (lim["ji22_neg_per_step"], None),
             "ji22_nonfoot_force": (lim["nonfoot_force"], None),
             **{k: (lim[k], lambda v, k=k: v <= lim[k])
                for k in ("ji22_below_share", "ji22_done_share", "ji22_nonfoot_share")},
             "finite": (True, bool), "step_finite": (True, bool)}
    rows = {k: {"value": v, "limit": rules[k][0]} for k, v in readings.items()}
    return rows, [k for k, v in readings.items() if rules[k][1] and not rules[k][1](v)]


def physics_oracle(dev, n: int) -> dict:
    """The physics-oracle phase's checks at n envs; returns its row, with
    ``bad`` naming every check that failed."""
    import torch

    from legged_tracking_torch.physics.model import make_go1_model
    t0 = time.perf_counter()
    model = make_go1_model(dev)
    x_cpu = oracle_inputs(n)
    x = {k: v.to(dev) for k, v in x_cpu.items()}
    dense = dense_oracle(model, x)
    bad = []
    sparse = {}
    for k, (err, ratio) in sparse_vs_dense(model, x, dense).items():
        sparse[k] = {"max_abs_err": err, "ratio_to_bar": ratio, "rtol_atol": SPARSE_BARS[k]}
        if not ratio <= 1.0:
            bad.append(f"sparse {k}")
    m = min(n, ORACLE_CPU_ENVS)
    ref = dense_oracle(make_go1_model("cpu"), {k: v[:m] for k, v in x_cpu.items()})
    card_cpu = {}
    for k, limit in ORACLE_CARD_TOL.items():
        err = float((dense[k][:m].cpu() - ref[k]).abs().max())
        card_cpu[k] = {"max_abs_err": err, "limit": limit}
        if not err <= limit:
            bad.append(f"card vs CPU {k}")

    lim = ANCHOR_LIMITS
    anchors = {k: {"value": val, "limit": lim[k]}
               for k, val in anchor_free_fall(model, x).items()}
    anchors["energy_drift"] = {"value": anchor_energy(model, x), "limit": lim["energy_drift"]}
    bad += [k for k, a in anchors.items()
            if not (a["value"] > 0.0 if k == "M_min_eigenvalue" else a["value"] <= a["limit"])]
    weight = GO1_MASS * GRAVITY
    high = torch.arange(n, device=dev) < n // 2
    for control, friction, push in (("P", torch.where(high, 1.5, 0.0), 100),
                                    ("actuator_net", 1.0, None)):
        s, report, dy = drop_and_stand(model, n, dev, control, friction, push_at=push)
        h = s.base_pos[:, 2]
        fz = report[..., 2].sum(dim=1)
        a = {"height": {"value": [float(h.min()), float(h.max())], "limit": lim["height"]},
             "speed": {"value": float(s.v.abs().max()), "limit": lim[f"speed_{control}"]},
             "weight_rel_err": {"value": float(((fz - weight) / weight).abs().max()),
                                "limit": lim["weight_rtol"]},
             "finite": {"value": bool(torch.isfinite(s.base_pos).all()
                                      and torch.isfinite(s.v).all()), "limit": True}}
        ok = {"height": lim["height"][0] < a["height"]["value"][0]
              and a["height"]["value"][1] < lim["height"][1],
              "speed": a["speed"]["value"] < a["speed"]["limit"],
              "weight_rel_err": a["weight_rel_err"]["value"] <= lim["weight_rtol"],
              "finite": a["finite"]["value"]}
        if dy is not None:
            dy_high, dy_zero = float(dy[high].max()), float(dy[~high].min())
            a["dy_high_friction"] = {"value": dy_high, "limit": lim["dy_high_friction"]}
            a["dy_zero_over_high"] = {"value": dy_zero / dy_high, "limit": lim["dy_ratio"]}
            ok["dy_high_friction"] = dy_high < lim["dy_high_friction"]
            ok["dy_zero_over_high"] = dy_zero > lim["dy_ratio"] * dy_high
        anchors.update({f"{control}_{k}": v for k, v in a.items()})
        bad += [f"{control} {k}" for k, good in ok.items() if not good]
        if control == "P":
            # the calm stance of the unpushed envs (the copies slide by design)
            readings = feet_only(s, report)

    # tests/test_calibration.py's anchors: feet-only stance (above), the
    # thigh step and the ji22 gate, on every env
    seconds = {"before_calibration": time.perf_counter() - t0}
    readings.update(thigh_step(model, n, dev))
    seconds["thigh_step"] = time.perf_counter() - t0 - sum(seconds.values())
    readings.update(ji22_gate(n, dev))
    seconds["ji22_gate"] = time.perf_counter() - t0 - sum(seconds.values())
    calibration, failed = calibration_checks(readings)
    bad += [f"calibration {k}" for k in failed]

    # the contact sampler against the flat one on the bench's tiles, and
    # both on the card against the CPU
    terrain = bench_terrain(n, dev)
    fw = flat_vs_window(terrain)
    bound = bf16_stage_bounds(fw["run"][0].tiles, terrain.horizontal_scale)
    flat = {"window_vs_flat": {k: {"max_abs_err": fw[k], "jax_bar": FLAT_BARS[k],
                                   "ratio_to_jax_bar": fw[k] / FLAT_BARS[k],
                                   "past_jax_bar": fw["past_bars"][k],
                                   "bf16_bound": bound[k]} for k in FLAT_BARS},
            "table": list(terrain.tiles.shape), "points": list(fw["run"][1].shape)}
    bad += [f"window vs flat {k}" for k in FLAT_BARS if not fw[k] <= bound[k]]
    m = min(n, FLAT_CPU_ENVS)
    flat["card_vs_cpu"] = samplers_card_vs_cpu(*fw["run"], m)
    flat["card_vs_cpu_envs"] = m
    bad += [f"{s_} card vs CPU {k}" for s_, errs in flat["card_vs_cpu"].items()
            for k, e in errs.items() if not e <= FLAT_CARD_TOL[k]]
    seconds["flat_sampler"] = time.perf_counter() - t0 - sum(seconds.values())
    return {"envs": n, "sparse_vs_dense": sparse, "card_vs_cpu": card_cpu,
            "anchors": anchors, "calibration": calibration, "flat_sampler": flat,
            "part_seconds": seconds, "bad": bad}


def phase_physics_oracle(dev, card_line: str):
    """The sparse engine against the dense oracle on the card, the dense
    oracle on the card against the CPU, the physical and calibration
    anchors, and the contact sampler against the flat one, at the bench's
    4096 envs."""
    t0 = time.perf_counter()
    row = physics_oracle(dev, NUM_ENVS)
    emit({"phase": "physics_oracle", "ok": not row["bad"], "card": card_line, **row,
          "seconds": time.perf_counter() - t0})
    if row["bad"]:
        raise AssertionError(f"physics-oracle checks failed: {row['bad']}")


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


def update_reference(dev, card_line: str, phase: str, make_env, make_ac, tol: dict,
                     extra_errs=None):
    """One train_iteration of 8 envs on the card against the CPU: the same
    reset state and env draws, parameters, action noise and permutation.
    ``make_env(device)`` builds the env, ``make_ac(env)`` the policy (None:
    the CSE MLP); its errors are held to ``tol``.  ``extra_errs(cpu_state,
    card_state)`` adds errors of the final env states, held alike."""
    import torch

    from legged_tracking_torch.learn.ppo import PPO, PPOArgs

    n, T = 8, 8
    g = torch.Generator().manual_seed(1)
    noise = torch.randn(T, n, 12, generator=g)
    perm = torch.randperm(T * n, generator=g)
    log, outs = None, {}
    for d in ("cpu", dev):
        env = make_env(d)
        if log is None:
            log = env.draw = DrawLog(env)
        else:
            env.draw = log.replay(dev)
        torch.manual_seed(0)                    # the same initial weights on both
        alg = PPO(env, args=PPOArgs(num_steps_per_env=T), ac=make_ac(env), seed=0)
        state = env.reset_fn(True)
        ts = alg.init()
        start = {k: v.detach().cpu().clone() for k, v in ts.params.items()}
        ts, state, _, metrics = alg.train_iteration(ts, state, env.observe(state),
                                                    action_noise=noise.to(d), perm=perm)
        outs[d] = (ts, metrics, state)
    (ts_c, m_c, s_c), (ts_g, m_g, s_g) = outs["cpu"], outs[dev]

    def rms_rel(a, b, keys):
        """rms difference of the leaves ``keys`` over the rms distance they
        moved from the start (0 for a leaf that stayed, on both: a GRU's
        hidden weights over a 1-frame history, whose hidden state is 0)."""
        d = sum(float((a[k].detach().cpu() - b[k].detach()).square().sum()) for k in keys)
        m = sum(float((b[k].detach() - start[k]).square().sum()) for k in keys)
        return (d / m) ** 0.5 if m else (0.0 if d == 0 else float("inf"))

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
    if extra_errs is not None:
        errs.update(extra_errs(s_c, s_g))
    bad = {k: v for k, v in errs.items() if not v <= tol[k]}
    emit({"phase": phase, "ok": not bad, "card": card_line, "envs": n,
          "steps": T, "policy": type(alg.ac).__name__, "max_err": errs, "tolerance": tol,
          "worst_leaf": worst, "leaf_rms_rel": leaf,
          "learning_rate": float(ts_c.learning_rate),
          "losses_cpu": {k: float(m_c[k]) for k in losses}})
    if bad:
        raise AssertionError(f"{phase}: train_iteration, card vs CPU beyond tolerance: {bad}")


def phase_update_reference(dev, card_line: str):
    """The bench configuration's CSE policy."""
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
    from legged_tracking_torch.envs import LeggedEnv
    update_reference(dev, card_line, "update_reference",
                     lambda d: LeggedEnv(bench_cfg(8, tiles=2), seed=3, device=d),
                     lambda env: None, tol)


def phase_cnn_update_reference(dev, card_line: str):
    """The goal configuration with ActorCriticCNN, conv encoder and GRU."""
    from legged_tracking_torch import train

    args = goal_args(8, tiles=2)
    args.cnn = args.gru = True
    # as in the CSE policy's phase; on an H100 the errors read: parameters
    # 7.1e-4 of the rms distance they moved (3.3e-3 for the worst leaf),
    # Adam moments 2.9e-3 and 1.1e-3, losses 2.0e-5, the learning rate
    # bitwise; each limit is 5 to 10 times that
    tol = {"params_rms_rel": 5e-3, "params_leaf_rms_rel": 3e-2, "opt_state": 2e-2,
           "adapt_opt_state": 1e-2, "learning_rate": 0.0, "losses": 2e-4}
    from legged_tracking_torch.envs import LeggedEnv
    from legged_tracking_torch.learn import conv3x3
    from legged_tracking_torch.learn.ppo import PPOArgs

    before = conv3x3.conv3x3_wgrad.launches
    update_reference(dev, card_line, "cnn_update_reference",
                     lambda d: LeggedEnv(train.build_cfg(args), seed=3, device=d),
                     lambda env: train.make_policy(args, env.cfg, env), tol)
    # W1 for both convs in each encoder backward: the one history pass that
    # action_dist_and_value shares between the heads under the loss, then
    # adapt under each adaptation substep, every minibatch of every epoch
    # (the CPU's side runs the plain version)
    a = PPOArgs()
    want = 2 * (1 + a.num_adaptation_module_substeps) * a.num_learning_epochs * a.num_mini_batches
    launches = conv3x3.conv3x3_wgrad.launches - before
    if launches != want:
        raise AssertionError(f"cnn_update_reference: conv3x3_wgrad launched {launches} times "
                             f"in the card's train_iteration, not {want}")


def velocity_state_errs(s_cpu, s_card) -> dict:
    """Elements of the curriculum's state (weights, bins, categories) and of
    the commands that differ between the card and the CPU after the
    iteration: the curriculum's draws are replayed, and its update and
    inverse CDF are exact, so every count must be 0.  ``curriculum_unmoved``
    is 1 if the weights still hold only the one starting bin per gait
    category, a run in which no bump was held to the CPU's."""
    out = {k: int((getattr(s_card, k).cpu() != getattr(s_cpu, k)).sum())
           for k in ("curriculum_weights", "env_command_bins", "env_command_categories",
                     "commands")}
    w = s_cpu.curriculum_weights
    out["curriculum_unmoved"] = int(int((w > 0).sum()) <= w.shape[0])
    return out


def phase_velocity_reference(dev, card_line: str):
    """The velocity env with the CSE policy: one train_iteration of 8 envs,
    the card against the CPU, and the curriculum's state bitwise."""
    # the same float32 sums in another order as in the CSE policy's phase;
    # the curriculum (weights, bins, categories) and the commands bitwise.
    # On an H100 the errors read: parameters 2.5e-5 of the rms distance
    # they moved (6.0e-4 for the worst leaf), Adam moments 5.6e-5 and
    # 7.9e-6, losses 6.0e-7, the learning rate bitwise; each limit is 10
    # to 20 times that
    tol = {"params_rms_rel": 5e-4, "params_leaf_rms_rel": 6e-3, "opt_state": 6e-4,
           "adapt_opt_state": 8e-5, "learning_rate": 0.0, "losses": 6e-6,
           "curriculum_weights": 0, "env_command_bins": 0, "env_command_categories": 0,
           "commands": 0, "curriculum_unmoved": 0}
    update_reference(dev, card_line, "velocity_reference", velocity_reference_env,
                     lambda env: None, tol, extra_errs=velocity_state_errs)


def phase_rma_update_reference(dev, card_line: str):
    """The same with the RMA policy (ActorCriticRMA)."""
    from legged_tracking_torch.learn.actor_critic_rma import ActorCriticRMA

    # on an H100 the errors read: parameters 7.0e-5 of the rms distance
    # they moved (3.8e-4 for the worst leaf), Adam moments 5.0e-5 and
    # 9.3e-6, losses 3.9e-7, the learning rate and the curriculum bitwise;
    # each limit is about 10 times that
    tol = {"params_rms_rel": 7e-4, "params_leaf_rms_rel": 4e-3, "opt_state": 5e-4,
           "adapt_opt_state": 9e-5, "learning_rate": 0.0, "losses": 4e-6,
           "curriculum_weights": 0, "env_command_bins": 0, "env_command_categories": 0,
           "commands": 0, "curriculum_unmoved": 0}
    update_reference(dev, card_line, "rma_update_reference", velocity_reference_env,
                     lambda env: ActorCriticRMA(env.num_obs, env.num_privileged_obs,
                                                env.num_obs_history, env.num_actions),
                     tol, extra_errs=velocity_state_errs)


def planner_inputs(env, dev):
    """The planner's inputs for every env of ``env``: the reset state, its
    bases moved up to 2.5 m into the obstacle window and turned, and the
    scans (B1) there."""
    import torch

    from legged_tracking_torch.utils import quat as qt

    state = env.reset_fn(True)
    N = env.num_envs
    g = torch.Generator(device=dev).manual_seed(2)
    phys = state.phys
    base_pos = phys.base_pos + torch.cat(
        [torch.rand(N, 1, generator=g, device=dev) * 2.5,
         torch.rand(N, 1, generator=g, device=dev) * 0.6 - 0.3,
         torch.zeros(N, 1, device=dev)], dim=1)
    yaw = torch.rand(N, generator=g, device=dev) * 1.6 - 0.8
    base_quat = qt.quat_from_angle_axis(yaw, torch.tensor([0.0, 0.0, 1.0], device=dev)
                                        .expand(N, 3))
    base_rpy = qt.quaternion_to_roll_pitch_yaw(base_quat)
    mh = env._get_heights(base_pos, base_rpy)
    target = env._select_waypoint(state.trajectories, state.curr_pose_index)
    rel_lin, _ = env._relative_pose(target, base_pos, base_quat, base_rpy)
    ep_len = torch.ones(N, dtype=torch.int32, device=dev)      # every env plans
    return (state, target, rel_lin, base_pos, base_quat, base_rpy, mh, ep_len)


def phase_planner(dev, card_line: str):
    """The local planner at 4096 envs x 462 scan points x 1,575 candidates:
    quadform against its direct form, and one _plan_local_targets timed."""
    import torch

    from legged_tracking_torch import train_hierarchy
    from legged_tracking_torch.envs import LeggedEnv

    env = LeggedEnv(train_hierarchy.build_cfg(hierarchy_args(NUM_ENVS, tiles=32)), device=dev)
    inputs = planner_inputs(env, dev)
    pts = env.scan_points(inputs[6])
    quad = env.candidates_valid(pts, quadform=True)
    direct = env.candidates_valid(pts, quadform=False)
    mismatches = int((quad != direct).sum())
    N, P2, C = pts.shape[0], pts.shape[1], quad.shape[1]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    out = env._plan_local_targets(*inputs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    ms, call_ms = cuda_ms(lambda: env._plan_local_targets(*inputs), iters=5, reps=3)
    # the direct form launches about twenty kernels per chunk of 28
    # candidates, more than the device queues behind a sleep: one call on
    # the host clock between two synchronizes (it is device-bound)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    env.candidates_valid(pts, quadform=False)
    torch.cuda.synchronize()
    direct_ms = (time.perf_counter() - t0) * 1e3
    # the implementation's traffic: per chunk F (N, 2P, 8) read, q (N, 2P,
    # chunk) written by the product and read by the reduction; the least
    # traffic of the function: the points, the weights and (N, C) out
    q_bytes = 2 * N * P2 * C * 4
    f_bytes = (C // env._plan_chunk) * N * P2 * 8 * 4
    least_bytes = N * P2 * 3 * 4 + 8 * C * 4 + N * C
    flop = 2 * 8 * N * P2 * C
    emit({"phase": "planner", "ok": mismatches == 0, "card": card_line, "envs": N,
          "scan_points": P2, "candidates": C, "chunk": env._plan_chunk,
          "direct_vs_quadform_mismatches": mismatches,
          "valid_share": float(quad.float().mean()),
          "envs_with_a_valid_candidate": int(quad.any(dim=1).sum()),
          "planned_finite": bool(torch.isfinite(out[0]).all()),
          "plan_ms": ms, "plan_call_ms": call_ms, "direct_valid_call_ms": direct_ms,
          "peak_mem_gib": peak / 2 ** 30,
          "q_bytes": q_bytes, "f_bytes": f_bytes,
          "bytes_ms": (q_bytes + f_bytes) / HBM_BYTES_PER_S * 1e3,
          "least_bytes_ms": least_bytes / HBM_BYTES_PER_S * 1e3,
          "flop": flop, "flop_ms": flop / F32_OPS_PER_S * 1e3})
    if mismatches:
        raise AssertionError(f"planner: {mismatches} candidates differ between the "
                             f"quadform and the direct form")


def phase_planner_reference(dev, card_line: str):
    """8 envs of the hierarchy configuration, replanning every 2 steps,
    stepped 5 times on the card and on the CPU from one state with the same
    draws."""
    import torch

    from legged_tracking_torch import train_hierarchy
    from legged_tracking_torch.envs import LeggedEnv

    n, steps = 8, 5
    cfg = lambda: train_hierarchy.build_cfg(hierarchy_args(n, tiles=2, plan_interval=2))
    cpu, card_env = (LeggedEnv(cfg(), seed=3, device=d) for d in ("cpu", dev))
    log = DrawLog(cpu)
    cpu.draw = log
    # episodes start at step 0, so every env plans at its first step
    s_cpu = s_reset = cpu.reset_fn(False)
    acts = [0.3 * torch.sin(0.1 * i + torch.arange(n * 12, dtype=torch.float32)).reshape(n, 12)
            for i in range(steps)]
    outs_cpu = []
    for a in acts:
        s_cpu, out = cpu.step_fn(s_cpu, a)
        outs_cpu.append((s_cpu, out))
    card_env.draw = log.replay(dev)
    s = card_env.reset_fn(False)
    if not torch.equal(s.measured_heights.cpu(), s_reset.measured_heights):
        raise AssertionError("the reset scan differs between the card and the CPU")
    worst = {"base_pos": 0.0, "obs": 0.0, "rew": 0.0, "local_target_poses": 0.0}
    differing, planned = 0, 0
    for a, (sc, out_cpu) in zip(acts, outs_cpu):
        s, out = card_env.step_fn(s, a.to(dev))
        if not torch.equal(out.done.cpu(), out_cpu.done):
            raise AssertionError("done flags differ between the card and the CPU")
        for k in ("plan_length", "plan_buf", "replan"):
            if not torch.equal(getattr(s, k).cpu(), getattr(sc, k)):
                raise AssertionError(f"{k} differs between the card and the CPU")
        for k, x, y in (("base_pos", s.phys.base_pos, sc.phys.base_pos),
                        ("obs", out.obs, out_cpu.obs), ("rew", out.rew, out_cpu.rew),
                        ("local_target_poses", s.local_target_poses, sc.local_target_poses)):
            worst[k] = max(worst[k], float((x.cpu() - y).abs().max()))
        differing += int(((s.local_target_poses.cpu() - sc.local_target_poses).abs()
                          .amax(dim=1) > 1e-3).sum())
        planned += int((sc.plan_length == 0).sum())
    # the same float32 sums in another order as in the reference phase; on
    # an H100 the errors read 1.8e-7 (base_pos), 3.2e-5 (obs), 4.8e-7 (rew,
    # of rewards up to |rew_max|) and 0 (local targets: every env planned
    # at its first step, from the same reset state); each limit is 5 to 20
    # times that, and 1e-6 for the local targets, the float32 arithmetic of
    # the world transform at a few metres should a later plan differ
    tol = {"base_pos": 2e-6, "obs": 5e-4, "rew": 5e-6, "local_target_poses": 1e-6}
    bad = {k: v for k, v in worst.items() if not v <= tol[k]}
    rew_max = max(float(o.rew.abs().max()) for _, o in outs_cpu)
    emit({"phase": "planner_reference", "ok": not bad and not differing, "card": card_line,
          "envs": n, "steps": steps, "plans": planned, "envs_choosing_differently": differing,
          "max_abs_err": worst, "tolerance": tol, "rew_max": rew_max})
    if bad or differing:
        raise AssertionError(f"planner card vs CPU: {bad}, {differing} differing choices")


def run_training(phase: str, env, make_runner, iters: int, at_setup: int, logdir: str,
                 scans: bool = True, writes: bool = True, spans: dict | None = None):
    """Train ``env`` with the Runner ``make_runner(logdir)`` builds, through
    Runner.learn, for ``iters`` iterations into ``logdir``: finite
    metrics, parameters that moved, B1 launched ``at_setup`` times while
    the Runner starts and 24 times an iteration (never, without ``scans``:
    a path that observes no heights), and, where the process ``writes``,
    metrics.jsonl, a checkpoint that loads back, policy.npz.  Measures
    train env-steps/s over the iterations after the first (host clock,
    each iteration between two synchronizes; of the envs the run trains,
    all ranks' in a data-parallel one), the rollout/update split and, with
    the planner on, the planner's share of the rollout (CUDA events, no
    barrier inside an iteration), and the peak memory.  ``spans``: more
    named lists of CUDA event pairs, filled during the run and read out as
    seconds.  Returns (runner, row); the row's ``scan_heights_launches``
    are B1's."""
    import numpy as np
    import torch

    from legged_tracking_torch.learn.actor_critic import ActorCriticCSE
    from legged_tracking_torch.terrain import scan

    dev = env.device
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    scan.scan_heights.launches = 0
    runner = make_runner(logdir)
    torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    setup_launches = scan.scan_heights.launches
    alg = runner.alg
    T = alg.args.num_steps_per_env
    n_envs = alg.num_envs_global
    start = {k: v.detach().clone() for k, v in runner.train_state.params.items()}

    # each iteration on the host clock between two synchronizes (Runner.learn
    # reads its metrics back every iteration at log_freq 1, so the loop
    # has that barrier anyway); its parts from CUDA events, which add none
    timed, launches = [], []
    spans = {"rollout": [], "update": [], "planner": [], **(spans or {})}

    def clocked(fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize(dev)
            before = scan.scan_heights.launches
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize(dev)
            timed.append(time.perf_counter() - t)
            launches.append(scan.scan_heights.launches - before)
            return out
        return run

    def evented(name, fn):
        def run(*args, **kwargs):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record(torch.cuda.current_stream(dev))
            out = fn(*args, **kwargs)
            end.record(torch.cuda.current_stream(dev))
            spans[name].append((start, end))
            return out
        return run

    planning = env.cfg.commands.sampling_based_planning
    alg.train_iteration = clocked(alg.train_iteration)
    alg.rollout = evented("rollout", alg.rollout)
    alg.update = evented("update", alg.update)
    if planning:
        env._plan_local_targets = evented("planner", env._plan_local_targets)
    history = runner.learn(iters)
    if planning:
        del env._plan_local_targets
    total = scan.scan_heights.launches
    per_it = T if scans else 0
    if (setup_launches != at_setup or launches != [per_it] * iters
            or total != at_setup + per_it * iters):
        raise AssertionError(f"{phase}: scan_heights launches: {setup_launches} while the "
                             f"Runner starts, {launches} per iteration, {total} in all; "
                             f"expected {at_setup}, {per_it} each")
    bad = [(r["it"], k) for r in history for k, v in r.items()
           if isinstance(v, float) and not np.isfinite(v)]
    if len(history) != iters or bad:
        raise AssertionError(f"{phase}: metrics: {len(history)} records, non-finite {bad}")
    moved = {k: float((v.detach() - start[k]).abs().max())
             for k, v in runner.train_state.params.items()}
    if not all(m > 0 for m in moved.values()):
        raise AssertionError(f"{phase}: parameters that did not move: "
                             f"{[k for k, m in moved.items() if m == 0]}")
    if writes:
        with open(os.path.join(logdir, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        if [r["it"] for r in records] != list(range(iters)):
            raise AssertionError(f"{phase}: metrics.jsonl holds iterations "
                                 f"{[r['it'] for r in records]}")
        policy = np.load(os.path.join(logdir, "policy.npz"))
        if "params/actor_body/Dense_0/kernel" not in policy:
            raise AssertionError(f"{phase}: policy.npz keys: {sorted(policy)[:5]}")
        now = {k: v.detach().clone() for k, v in runner.train_state.params.items()}
        runner.load(os.path.join(logdir, "ac_weights_last.pkl"))
        if not all(torch.equal(now[k], v) for k, v in runner.train_state.params.items()):
            raise AssertionError(f"{phase}: ac_weights_last.pkl does not load back the "
                                 f"parameters")
    files = sorted(os.listdir(logdir)) if os.path.isdir(logdir) else []

    torch.cuda.synchronize(dev)
    split = {k: [a.elapsed_time(b) / 1e3 for a, b in v] for k, v in spans.items()}
    # the first iteration carries one-time work (allocator growth, cuBLAS
    # heuristics); the rate is over the rest
    it_s, roll_s, upd_s = (float(np.mean(v[1:])) for v in (timed, split["rollout"],
                                                            split["update"]))
    row = {"phase": phase, "ok": True, "envs": n_envs, "steps": T,
           "policy": type(alg.ac).__name__, "iterations": iters,
           "minibatches": alg.args.num_learning_epochs * alg.args.num_mini_batches,
           "setup_s": setup_s, "train_env_steps_per_s": n_envs * T / it_s,
           "iteration_s": it_s, "rollout_s": roll_s, "update_s": upd_s,
           "iteration_s_all": timed, "rollout_s_all": split["rollout"],
           "update_s_all": split["update"],
           "scan_heights_launches": total, "at_setup": setup_launches,
           "per_iteration": launches,
           "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
           "logdir_files": files,
           "last": {k: history[-1][k] for k in ("value_loss", "surrogate_loss",
                                                 "adaptation_loss", "kl_mean", "learning_rate",
                                                 "mean_reward_per_step", "rew_total",
                                                 "curriculum_unlocked_frac",
                                                 "curriculum_weight_mean")
                    if k in history[-1]}}
    if planning:
        plan = split["planner"][T:]           # the iterations after the first
        row["planner_s_per_step"] = float(np.mean(plan))
        row["planner_share_of_rollout"] = float(np.sum(plan) / np.sum(split["rollout"][1:]))
    if isinstance(alg.ac, ActorCriticCSE):
        flop = update_flop(alg.ac, env.num_envs * T * alg.args.num_learning_epochs)
        row.update({"update_matmul_flop": flop, "update_flop_per_s": flop / upd_s,
                    "update_bound_s": flop / F32_OPS_PER_S})
    row.update({k: split[k] for k in spans if k not in ("rollout", "update", "planner")})
    return runner, row


def train_phase(dev, card_line: str, phase: str, env, make_runner, iters: int,
                at_setup: int, profile_dir: str | None, logdir: str, extra: dict | None = None,
                scans: bool = True):
    """:func:`run_training` of ``env`` into ``logdir`` (the eval phases read
    it after), its row printed; with ``profile_dir``, a profile of one
    train iteration (and of one update, on the train phase).  Returns the
    row."""
    runner, row = run_training(phase, env, make_runner, iters, at_setup, logdir, scans)
    row["card"] = card_line
    row.update(extra or {})
    emit(row)
    alg = runner.alg
    if profile_dir:
        state, obs = runner.env_state, runner.obs_dict
        profile(lambda: alg.train_iteration(runner.train_state, state, obs),
                f"{phase}_iteration", profile_dir, card_line)
        if phase == "train":
            _, last_obs, traj, _, _ = alg.rollout(state, obs)
            returns, adv = alg.compute_gae(traj, alg._last_values(last_obs, None))
            profile(lambda: alg.update(runner.train_state, traj, returns, adv), "update",
                    profile_dir, card_line)
    return row


def phase_train(dev, card_line: str, profile_dir: str | None, logdir: str):
    """The main path: the bench configuration trained by Runner.learn."""
    from legged_tracking_torch.envs import LeggedEnv
    from legged_tracking_torch.learn.runner import Runner, RunnerArgs

    env = LeggedEnv(bench_cfg(NUM_ENVS), device=dev)
    return train_phase(dev, card_line, "train", env, lambda logdir: Runner(
        env, runner_args=RunnerArgs(log_freq=1, save_interval=2), logdir=logdir, seed=0),
        iters=4, at_setup=1, profile_dir=profile_dir, logdir=logdir)


def phase_train_goal(dev, card_line: str, profile_dir: str | None, logdir: str):
    """The goal path: stage A of the published recipe at 4096 envs, its
    default policy, trained by Runner.learn; B1 held at its terrain first."""
    from legged_tracking_torch import train
    from legged_tracking_torch.envs import LeggedEnv

    args = goal_args()
    cfg = train.build_cfg(args)
    env = LeggedEnv(cfg, device=dev)
    scan_row = scan_check(env, dev)

    def make_runner(logdir):
        args.logdir = logdir
        return train.make_runner(args, cfg, env, log_freq=1, save_interval=2)
    # one scan at the Runner's observe
    return train_phase(dev, card_line, "train_goal", env, make_runner, iters=4, at_setup=1,
                       profile_dir=profile_dir, logdir=logdir,
                       extra={"scan_heights_check": scan_row})


def phase_train_hierarchy(dev, card_line: str, profile_dir: str | None, logdir: str):
    """The planner path: train_hierarchy's defaults (4000 envs, the planner
    replanning every 100 steps) trained by Runner.learn; B1 held at its
    terrain and width first."""
    from legged_tracking_torch import train_hierarchy
    from legged_tracking_torch.envs import LeggedEnv

    args = hierarchy_args()
    env = LeggedEnv(train_hierarchy.build_cfg(args), device=dev)
    scan_row = scan_check(env, dev)

    def make_runner(logdir):
        args.logdir = logdir
        return train_hierarchy.make_runner(args, env, log_freq=1, save_interval=2)
    # two scans while the Runner starts: reset_fn stores one for the
    # planner, observe takes one; each step then takes one, the planner
    # reading the scan the step before stored
    return train_phase(dev, card_line, "train_hierarchy", env, make_runner, iters=4,
                       at_setup=2, profile_dir=profile_dir, logdir=logdir,
                       extra={"scan_heights_check": scan_row})


def phase_train_velocity(dev, card_line: str, profile_dir: str | None, logdir: str):
    """The velocity path: scripts/train_velocity_tracking.py's defaults (4000
    envs, 30x30 tiles of 50x50 cells, the command curriculum, the CSE
    policy) trained by Runner.learn.  It observes no heights: B1 is never
    launched."""
    import torch

    from legged_tracking_torch import train_velocity_tracking
    from legged_tracking_torch.envs.velocity_env import VelocityTrackingEnv

    args = velocity_args()
    t0 = time.perf_counter()
    env = VelocityTrackingEnv(train_velocity_tracking.build_cfg(args), device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    def make_runner(logdir):
        args.logdir = logdir
        return train_velocity_tracking.make_runner(args, env, log_freq=1, save_interval=2)
    return train_phase(dev, card_line, "train_velocity", env, make_runner, iters=4, at_setup=0,
                       profile_dir=profile_dir, logdir=logdir, scans=False,
                       extra={"env_build_s": build_s, "tiles": list(env.terrain.tiles.shape),
                              "curriculum_bins": env.curriculum.num_bins,
                              "num_obs": env.num_obs, "num_obs_history": env.num_obs_history,
                              "num_commands": env.cfg.commands.num_commands})


# data parallelism in the default run: two ranks share cuda:0 over gloo
# (NCCL refuses two ranks on one card); ``--cards K`` runs K NCCL ranks, one
# a card
DP_RANKS = 2
DP_BACKEND = "gloo"
# the JAX package's sharding-invariance bars (tests/test_distributed.py:53-55,
# :101-103): rollout base positions and obs, and parameters after two
# iterations
DP_ROLLOUT_TOL = 1e-5
DP_PARAMS_ATOL, DP_PARAMS_RTOL = 2e-4, 2e-3


def dp_reference_env(device, shard=None):
    """tests/test_distributed.py's 8-env configuration (plane, xy commands,
    P control, 2 s episodes, decimation 2)."""
    from legged_tracking_torch.config import Cfg, config_go1
    from legged_tracking_torch.envs import LeggedEnv

    cfg = config_go1(Cfg())
    cfg.env.num_envs = 8
    cfg.terrain.mesh_type = "plane"
    cfg.env.command_type = "xy"
    cfg.control.control_type = "P"
    cfg.env.episode_length_s = 2.0
    cfg.control.decimation = 2
    return LeggedEnv(cfg, device=device, shard=shard)


def dp_reference_run(outdir: str, device: str):
    """One rank's dp-reference work (the whole of it outside a process
    group): 3 env steps of a fixed action from a seeded reset, then
    ``Runner.learn(2)`` (4 steps, 2 x 2 minibatches, seed 7), written to
    ``outdir/rank<r>.pt`` with the rank's device (``rank_device(device)``
    in a group) and backend."""
    import torch
    import torch.distributed as dist

    from legged_tracking_torch.learn.ppo import PPOArgs
    from legged_tracking_torch.learn.runner import Runner, RunnerArgs
    from legged_tracking_torch.parallel import Shard, rank_device

    group = dist.is_initialized()
    dev = rank_device(device) if group else torch.device(device)
    rank, world = (dist.get_rank(), dist.get_world_size()) if group else (0, 1)
    env = dp_reference_env(dev, Shard(rank, world, 8) if group else None)
    env.generator.manual_seed(3)
    state = env.reset_fn(False)
    a = torch.full((env.num_envs, 12), 0.05, device=dev)
    steps = []
    for _ in range(3):
        state, out = env.step_fn(state, a)
        steps.append({"base_pos": state.phys.base_pos.cpu(), "obs": out.obs.cpu()})
    runner = Runner(dp_reference_env(dev),
                    runner_args=RunnerArgs(num_steps_per_env=4, log_freq=1),
                    ppo_args=PPOArgs(num_mini_batches=2, num_learning_epochs=2), seed=7,
                    distributed=group)
    runner.learn(2)
    params = {k: v.detach().cpu() for k, v in runner.train_state.params.items()}
    torch.save({"steps": steps, "params": params, "device": str(dev),
                "backend": dist.get_backend() if group else None},
               os.path.join(outdir, f"rank{rank}.pt"))


def phase_dp_reference(dev, card_line: str, ranks: int = DP_RANKS, backend: str = DP_BACKEND,
                       device: str | None = None, phase: str = "dp_reference"):
    """Data parallelism against one rank on the card: the 8-env
    configuration of tests/test_distributed.py run by ``ranks`` ranks over
    ``backend``, each on ``rank_device(device)`` (``device`` defaults to
    ``dev``, the card two gloo ranks share; ``cuda`` puts each rank on the
    card of its local rank), and by one rank on ``dev``, held to the JAX
    package's bars; every rank on the backend named."""
    import torch

    from legged_tracking_torch.parallel import launch

    device = device or str(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as out:
        launch(dp_reference_run, ranks, out, device, backend=backend, device=device)
        res = [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(ranks)]
        one_dir = os.path.join(out, "one")
        os.makedirs(one_dir)
        dp_reference_run(one_dir, str(dev))
        one = torch.load(os.path.join(one_dir, "rank0.pt"))
    rollout = {k: max(float((torch.cat([r["steps"][t][k] for r in res]) - s[k]).abs().max())
                      for t, s in enumerate(one["steps"]))
               for k in ("base_pos", "obs")}
    # the share of the bar each parameter uses: |a - b| / (atol + rtol |b|)
    used = {k: float(((res[0]["params"][k] - v).abs()
                      / (DP_PARAMS_ATOL + DP_PARAMS_RTOL * v.abs())).max())
            for k, v in one["params"].items()}
    params_abs = max(float((res[0]["params"][k] - v).abs().max())
                     for k, v in one["params"].items())
    ranks_equal = all(torch.equal(res[0]["params"][k], res[r]["params"][k])
                      for k in one["params"] for r in range(1, ranks))
    devices = [r["device"] for r in res]
    backends = [r["backend"] for r in res]
    ok = (max(rollout.values()) <= DP_ROLLOUT_TOL and max(used.values()) <= 1.0
          and ranks_equal and backends == [backend] * ranks)
    row = {"phase": phase, "ok": ok, "card": card_line, "ranks": ranks, "backend": backend,
           "device": device, "rank_devices": devices, "rank_backends": backends, "envs": 8,
           "steps": 3, "iterations": 2}
    if len(set(devices)) == 1:
        row["note"] = ("the ranks share one card; NCCL across cards runs in "
                       "chip_smoke.py --cards 4")
    row.update({"rollout_max_abs": rollout, "rollout_tol": DP_ROLLOUT_TOL,
                "params_max_abs": params_abs, "params_tol": {"atol": DP_PARAMS_ATOL,
                                                             "rtol": DP_PARAMS_RTOL},
                "params_share_of_tol": max(used.values()),
                "worst_leaf": max(used, key=used.get), "ranks_params_equal": ranks_equal})
    emit(row)
    if not ok:
        raise AssertionError(f"{phase}: {ranks} {backend} ranks ({backends}) vs one beyond "
                             f"the bars: rollout {rollout}, parameters at "
                             f"{max(used.values())} of the bar, ranks equal {ranks_equal}")


def train_dp_run(outdir: str, logroot: str, device: str, num_envs: int = NUM_ENVS,
                 phase: str = "train_dp"):
    """One rank of a data-parallel train phase on ``rank_device(device)``:
    B1 held bitwise at its shard's width and rows, then :func:`run_training`
    of the bench configuration at ``num_envs`` global envs sharded over the
    ranks, with the all-reduces timed (CUDA events) inside and outside the
    update; its row (with its card, backend and CPU affinity), B1's check
    and a checksum of the parameters written to ``outdir/rank<r>.json``."""
    import hashlib

    import torch
    import torch.distributed as dist

    from legged_tracking_torch.envs import LeggedEnv, legged_env
    from legged_tracking_torch.learn import ppo
    from legged_tracking_torch.learn.runner import Runner, RunnerArgs
    from legged_tracking_torch.parallel import Shard, rank_device

    dev = rank_device(device)
    rank, world = dist.get_rank(), dist.get_world_size()
    env = LeggedEnv(bench_cfg(num_envs), device=dev, shard=Shard(rank, world, num_envs))
    scan_row = scan_check(env, dev)
    spans = {"update_allreduce": [], "other_allreduce": []}
    in_update = [False]

    def evented(fn):
        def run(tensors, *a, **k):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record(torch.cuda.current_stream(dev))
            out = fn(tensors, *a, **k)
            end.record(torch.cuda.current_stream(dev))
            spans["update_allreduce" if in_update[0] else "other_allreduce"].append((start, end))
            return out
        return run

    ppo.all_reduce_sum = evented(ppo.all_reduce_sum)
    legged_env.all_reduce_sum = evented(legged_env.all_reduce_sum)

    def make_runner(logdir):
        runner = Runner(env, runner_args=RunnerArgs(log_freq=1, save_interval=2),
                        logdir=logdir, seed=0, distributed=True)
        update = runner.alg.update

        def flagged(*a, **k):
            in_update[0] = True
            try:
                return update(*a, **k)
            finally:
                in_update[0] = False
        runner.alg.update = flagged
        return runner

    runner, row = run_training(phase, env, make_runner, iters=4, at_setup=1,
                               logdir=os.path.join(logroot, f"rank{rank}"), writes=rank == 0,
                               spans=spans)
    digest = hashlib.sha256()
    for k, v in runner.train_state.params.items():
        digest.update(k.encode() + v.detach().cpu().numpy().tobytes())
    upd = row.pop("update_allreduce")
    other = row.pop("other_allreduce")
    its = row["iterations"]
    per_it = lambda v: [sum(v[i * len(v) // its:(i + 1) * len(v) // its]) for i in range(its)]
    upd_it = per_it(upd)
    row.update({"rank": rank, "local_envs": env.num_envs, "device": str(dev),
                "backend": dist.get_backend(), "cpu_affinity": sorted(os.sched_getaffinity(0)),
                "torch_threads": torch.get_num_threads(),
                "allreduce_s_in_update": upd_it, "allreduce_calls_in_update": len(upd) // its,
                "allreduce_share_of_update": sum(upd_it[1:]) / sum(row["update_s_all"][1:]),
                "allreduce_s_outside_update": per_it(other),
                "allreduce_calls_outside_update": len(other) // its,
                "params_sha256": digest.hexdigest(), "scan_heights_check": scan_row})
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(row, f)


def phase_train_dp(dev, card_line: str, train_row: dict, ranks: int = DP_RANKS,
                   backend: str = DP_BACKEND, device: str | None = None,
                   num_envs: int = NUM_ENVS, phase: str = "train_dp"):
    """The main path over ``ranks`` ranks: the bench configuration at
    ``num_envs`` global envs trained by Runner.learn for 4 iterations, each
    rank on ``rank_device(device)`` (by default ``dev``, which two gloo
    ranks share) over ``backend``; each rank held as the train phase is
    (rank 0 the only writer), their parameters equal, and the global train
    env-steps/s printed beside the 1-rank train phase's of this call (and,
    where the ranks have a card each, the efficiency against it)."""
    from legged_tracking_torch.parallel import launch

    device = device or str(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as out:
        logroot = os.path.join(out, "runs")
        launch(train_dp_run, ranks, out, logroot, device, num_envs, phase, backend=backend,
               device=device)
        res = []
        for r in range(ranks):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                res.append(json.load(f))
        writers = sorted(os.listdir(logroot))
    digests = {r["params_sha256"] for r in res}
    if len(digests) != 1:
        raise AssertionError(f"{phase}: the ranks' parameters differ: {digests}")
    if writers != ["rank0"] or not res[0]["logdir_files"] \
            or any(r["logdir_files"] for r in res[1:]):
        raise AssertionError(f"{phase}: logdirs written {writers}, files "
                             f"{[r['logdir_files'] for r in res]}")
    backends = [r["backend"] for r in res]
    if backends != [backend] * ranks:
        raise AssertionError(f"{phase}: the ranks' backends {backends}, not {backend}")
    # the ranks' iterations meet at every all-reduce: the global rate is the
    # global envs' steps over the slowest rank's iteration
    it_s = [max(r["iteration_s_all"][i] for r in res) for i in range(1, res[0]["iterations"])]
    rate = res[0]["envs"] * res[0]["steps"] / (sum(it_s) / len(it_s))
    one_rate = train_row["train_env_steps_per_s"]
    devices = [r["device"] for r in res]
    row = {"phase": phase, "ok": True, "card": card_line, "ranks": ranks, "backend": backend,
           "device": device, "rank_devices": devices}
    if len(set(devices)) == 1:
        row["note"] = ("the ranks share one card; NCCL across cards runs in "
                       "chip_smoke.py --cards 4")
    row.update({"envs": res[0]["envs"], "envs_per_rank": res[0]["local_envs"],
                "train_env_steps_per_s": rate, "one_rank_train_env_steps_per_s": one_rate,
                "one_rank_envs": train_row["envs"]})
    if len(set(devices)) == ranks:
        row.update({"speedup_over_one_rank": rate / one_rate,
                    "efficiency": rate / (ranks * one_rate), "cpu_count": os.cpu_count()})
    row.update({"params_sha256": digests.pop(), "logdirs_written": writers,
                "per_rank": [{k: r[k] for k in (
                    "rank", "device", "backend", "cpu_affinity", "torch_threads",
                    "iteration_s_all", "rollout_s", "update_s", "rollout_s_all",
                    "update_s_all", "allreduce_share_of_update", "allreduce_s_in_update",
                    "allreduce_calls_in_update", "allreduce_s_outside_update",
                    "allreduce_calls_outside_update", "peak_mem_gib", "setup_s",
                    "scan_heights_launches", "per_iteration", "at_setup",
                    "scan_heights_check", "last", "logdir_files")} for r in res]})
    emit(row)
    return {f"{phase}_rank{r['rank']}": {"scan_heights": r["scan_heights_launches"]}
            for r in res}


# the train entries the --cards mode drives across the cards, each for 2
# iterations at its own defaults; timesteps count 24 steps an iteration
ENTRIES = ("train", "train_hierarchy", "train_velocity_tracking")
ENTRY_ITERS, ENTRY_STEPS = 2, 24


def entry_commands(k: int, logroot: str, extra=()) -> dict:
    """The command of each train entry on ``k`` ranks, by name: ``--num_devices
    k`` on each entry, and torchrun's ``k`` processes joining through
    ``train --distributed``; each for 2 iterations into ``logroot/<name>``,
    with ``extra`` flags."""
    py = sys.executable
    cmds = {name: [py, "-m", f"legged_tracking_torch.{name}", "--num_devices", str(k)]
            for name in ENTRIES}
    cmds["train_distributed"] = [py, "-m", "torch.distributed.run", "--standalone",
                                 "--nproc_per_node", str(k), "-m",
                                 "legged_tracking_torch.train", "--distributed"]
    return {name: [*cmd, "--iterations", str(ENTRY_ITERS),
                   "--logdir", os.path.join(logroot, name), *extra]
            for name, cmd in cmds.items()}


def entry_load_back(name: str, ckpt: str, dev) -> bool:
    """The entry's Runner at 8 envs on 2x2 tiles on ``dev``, resumed from
    ``ckpt`` through the entry's own ``--resume``: True where its
    parameters are the checkpoint's, bitwise."""
    import importlib

    import torch

    from legged_tracking_torch.envs import LeggedEnv
    from legged_tracking_torch.envs.velocity_env import VelocityTrackingEnv
    from legged_tracking_torch.io.checkpoint import flax_params_to_state_dict, load_pickle

    module = "train" if name == "train_distributed" else name
    entry = importlib.import_module(f"legged_tracking_torch.{module}")
    args = entry.parse_args(["--num_envs", "8", "--terrain_rows", "2", "--terrain_cols", "2",
                             "--resume", ckpt, "--device", str(dev)])
    cfg = entry.build_cfg(args)
    if module == "train":
        runner = entry.make_runner(args, cfg, LeggedEnv(cfg, device=dev))
    else:
        make_env = VelocityTrackingEnv if module == "train_velocity_tracking" else LeggedEnv
        runner = entry.make_runner(args, make_env(cfg, device=dev))
    saved = flax_params_to_state_dict(load_pickle(ckpt)["params"])
    params = runner.train_state.params
    return params.keys() == saved.keys() and all(
        torch.equal(v.detach().cpu(), saved[k]) for k, v in params.items())


def phase_entries(dev, card_line: str, k: int, extra=()):
    """The train entries across ``k`` ranks as a user starts them
    (:func:`entry_commands`), one after another: each exits 0, rank 0 alone
    prints, its ``metrics.jsonl`` holds 2 iterations of the global envs'
    steps, and its checkpoint loads back into the entry's Runner on ``dev``
    (:func:`entry_load_back`)."""
    import re

    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_entries_") as logroot:
        for name, cmd in entry_commands(k, logroot, extra).items():
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=900)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(f"entries: {' '.join(cmd)} exited {proc.returncode}:\n"
                                     f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
            logdir = os.path.join(logroot, name)
            with open(os.path.join(logdir, "metrics.jsonl")) as f:
                records = [json.loads(line) for line in f]
            envs = [int(n) for n in re.findall(r"^env: (\d+) envs", proc.stdout, re.M)]
            last = re.findall(r"^it +1 \|", proc.stdout, re.M)
            files = sorted(os.listdir(logdir))
            loads = entry_load_back(name, os.path.join(logdir, "ac_weights_last.pkl"), dev)
            run = {"seconds": seconds, "envs": envs, "iterations": [r["it"] for r in records],
                   "timesteps": [r["timesteps"] for r in records],
                   "last_iteration_lines": len(last), "logdir_files": files,
                   "checkpoint_loads_back": loads,
                   "last": {key: records[-1][key] for key in ("value_loss", "kl_mean",
                                                             "rew_total", "fps")
                            if key in records[-1]}}
            good = (len(envs) == 1 and len(last) == 1
                    and run["iterations"] == list(range(ENTRY_ITERS))
                    and run["timesteps"] == [envs[0] * ENTRY_STEPS * (i + 1)
                                             for i in range(ENTRY_ITERS)]
                    and {"metrics.jsonl", "ac_weights_last.pkl", "policy.npz"} <= set(files)
                    and loads)
            if not good:
                raise AssertionError(f"entries: {name}: {run}")
            runs[name] = {"command": cmd[1:], **run}
    emit({"phase": "entries", "ok": True, "card": card_line, "ranks": k, "runs": runs})


def window_reference(dev, make_env, tol: dict) -> dict:
    """Windowed histories against stored ones at an env's full width: one
    rollout of ``make_env(dev)`` storing its histories, every one of its
    T x N rows rebuilt from the frame stream (``window_histories``) and
    held to the stored row at atol 0, then one ``update`` each way from one
    TrainState, one permutation and the same returns and advantages: the
    parameters, Adam moments, learning rate and losses bitwise, or else
    within ``tol`` (the update-reference limits), the errors printed."""
    import torch

    from legged_tracking_torch.learn.ppo import PPO, PPOArgs, copy_state, window_histories

    t0 = time.perf_counter()
    env = make_env(dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    torch.manual_seed(0)
    stored = PPO(env, seed=0)
    windowed = PPO(env, args=PPOArgs(windowed_history=True), ac=stored.ac, seed=0)
    state = env.reset_fn(True)
    obs = env.observe(state)
    h0 = (obs["obs_history"], state.obs_history)
    _, last, traj, _, _ = stored.rollout(state, obs)
    T, N = traj.rewards.shape
    no = env.num_obs
    K = env.num_obs_history // no
    i = torch.arange(T * N, device=dev)
    rows = window_histories(*h0, traj.obs, i // N, i % N, K, no)
    rows_apart = int((rows != traj.obs_history.reshape(T * N, -1)).any(dim=1).sum())
    del rows
    if rows_apart:
        raise AssertionError(f"window_reference: {rows_apart} of {T * N} rebuilt history rows "
                             f"differ from the stored ones")

    returns, adv = stored.compute_gae(traj, stored._last_values(last, None))
    perm = torch.randperm(T * N, generator=torch.Generator(device=dev).manual_seed(1),
                          device=dev)
    live = stored.init()
    start = copy_state(live)
    out = {}
    for name, alg, tr, h in (("stored", stored, traj, None),
                             ("windowed", windowed, traj._replace(
                                 obs_history=traj.obs_history[:, :, :0]), h0)):
        with torch.no_grad():
            for k, v in live.params.items():
                v.copy_(start.params[k])
        ts = copy_state(start)._replace(params=live.params)
        torch.cuda.synchronize()
        t = time.perf_counter()
        ts, m = alg.update(ts, tr, returns, adv, perm=perm, h0=h)
        torch.cuda.synchronize()
        out[name] = (copy_state(ts), m, time.perf_counter() - t)
    (a, ma, sa), (b, mb, sb) = out["windowed"], out["stored"]
    pairs = [a.params, b.params], [a.opt_state.mu, b.opt_state.mu], \
        [a.opt_state.nu, b.opt_state.nu], [a.adapt_opt_state.mu, b.adapt_opt_state.mu], \
        [a.adapt_opt_state.nu, b.adapt_opt_state.nu]
    losses = ("value_loss", "surrogate_loss", "adaptation_loss", "adaptation_test_loss",
              "kl_mean")
    bitwise = (all(torch.equal(x[k], y[k]) for x, y in pairs for k in y)
               and torch.equal(a.learning_rate, b.learning_rate)
               and all(torch.equal(ma[k], mb[k]) for k in losses))
    errs = {}
    if not bitwise:
        moved = sum(float((v - start.params[k]).square().sum()) for k, v in b.params.items())
        apart = sum(float((a.params[k] - v).square().sum()) for k, v in b.params.items())
        rel = lambda x, y: max(float((x[k] - y[k]).abs().max() / y[k].abs().max().clamp(
            min=1e-30)) for k in y)
        errs = {"params_rms_rel": (apart / moved) ** 0.5,
                "opt_state": rel(a.opt_state.mu, b.opt_state.mu),
                "adapt_opt_state": rel(a.adapt_opt_state.mu, b.adapt_opt_state.mu),
                "learning_rate": abs(float(a.learning_rate) / float(b.learning_rate) - 1),
                "losses": max(abs(float(ma[k]) - float(mb[k])) / max(abs(float(mb[k])), 1.0)
                              for k in losses)}
        bad = {k: v for k, v in errs.items() if not v <= tol[k]}
        if bad:
            raise AssertionError(f"window_reference: windowed vs stored update beyond the "
                                 f"update-reference limits: {bad}")
    return {"envs": N, "steps": T, "num_obs": no, "frames": K, "env_build_s": build_s,
            "rows": T * N, "rows_apart": rows_apart, "update_bitwise": bitwise,
            "update_errors": errs, "update_s": {"stored": sb, "windowed": sa},
            "stored_history_mb": traj.obs_history.numel() * 2 / 1e6,
            "frame_stream_mb": N * (2 * K - 2 + T) * no * 2 / 1e6,
            "losses": {k: float(mb[k]) for k in losses}}


def phase_window_reference(dev, card_line: str):
    """Windowed histories against stored ones at full width, on the bench
    (4096 envs, 261 x 15) and on the velocity defaults (4000 envs, 70 x
    30), each as :func:`window_reference` holds it."""
    import torch

    from legged_tracking_torch import train_velocity_tracking
    from legged_tracking_torch.envs import LeggedEnv
    from legged_tracking_torch.envs.velocity_env import VelocityTrackingEnv

    # the update-reference limits (phase_update_reference), where the two
    # updates are not bitwise
    tol = {"params_rms_rel": 1e-2, "opt_state": 3e-2, "adapt_opt_state": 4e-2,
           "learning_rate": 0.0, "losses": 5e-4}
    rows = {"bench": window_reference(dev, lambda d: LeggedEnv(bench_cfg(NUM_ENVS), device=d),
                                      tol)}
    torch.cuda.empty_cache()
    cfg = train_velocity_tracking.build_cfg(velocity_args())
    rows["velocity"] = window_reference(dev, lambda d: VelocityTrackingEnv(cfg, device=d), tol)
    emit({"phase": "window_reference", "ok": True, "card": card_line, "tolerance": tol,
          **rows})


def phase_train_window(dev, card_line: str, train_row: dict) -> dict:
    """The main path with windowed histories: the bench configuration at
    4096 envs trained by Runner.learn with ``PPOArgs(windowed_history=True)``
    for 4 iterations, held as the train phase is, its rate and peak memory
    printed beside the train phase's of this call.  Then the bench
    configuration at 16,384 envs (16 envs a tile): B1 held bitwise at that
    width, and one train_iteration with stored and one with windowed
    histories (after an untimed one), each with its peak memory and
    seconds.  Returns B1's launches on the 4096-env path."""
    import torch

    from legged_tracking_torch.envs import LeggedEnv
    from legged_tracking_torch.learn.ppo import PPO, PPOArgs
    from legged_tracking_torch.learn.runner import Runner, RunnerArgs

    env = LeggedEnv(bench_cfg(NUM_ENVS), device=dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_window_") as logdir:
        runner, row = run_training("train_window", env, lambda logdir: Runner(
            env, runner_args=RunnerArgs(log_freq=1, save_interval=2),
            ppo_args=PPOArgs(windowed_history=True), logdir=logdir, seed=0),
            iters=4, at_setup=1, logdir=logdir)
    if not runner.alg._window_history:
        raise AssertionError("train_window: the Runner's PPO stores its histories")
    del runner, env
    torch.cuda.empty_cache()
    row["train_phase"] = {k: train_row[k] for k in (
        "train_env_steps_per_s", "peak_mem_gib", "iteration_s", "rollout_s", "update_s",
        "iteration_s_all")}

    big = LeggedEnv(bench_cfg(4 * NUM_ENVS), device=dev)
    scan_row = scan_check(big, dev)
    modes = {}
    for name, windowed in (("first", False), ("stored", False), ("windowed", True)):
        alg = PPO(big, args=PPOArgs(windowed_history=windowed), seed=0)
        ts = alg.init()
        state = big.reset_fn(True)
        obs = big.observe(state)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        out = alg.train_iteration(ts, state, obs)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        if not all(bool(torch.isfinite(v.float()).all()) for k, v in out[3].items()
                    if k != "video"):
            raise AssertionError(f"train_window: non-finite metrics at {big.num_envs} envs, "
                                 f"{name}")
        modes[name] = {"iteration_s": secs,
                       "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                       "before_gib": base / 2 ** 30}
        del alg, ts, state, obs, out
    row.update({"card": card_line, "envs_16k": big.num_envs, "scan_heights_check_16k": scan_row,
                "iteration_16k": modes})
    emit(row)
    return {"scan_heights": row["scan_heights_launches"]}


# the bench entry's run in the bench-tools phase: 2 warm-up and then
# BENCH_TOOLS_ITERS timed calls of BENCH_TOOLS_K train iterations each
BENCH_TOOLS_ITERS = BENCH_TOOLS_K = 2
# the share of the device's busy time the port's source lines must claim
PORT_SHARE_MIN = 0.9


def tool_run(phase: str, args: list, env: dict | None = None, timeout: int = 900):
    """``python -m <args>`` from the checkout's root: its stdout lines and
    its last line's JSON object; raises on a non-zero exit."""
    proc = subprocess.run([sys.executable, "-m", *args], cwd=HERE, capture_output=True,
                          text=True, timeout=timeout, env=env)
    if proc.returncode != 0:
        raise AssertionError(f"{phase}: python -m {' '.join(args)} exited {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    lines = proc.stdout.strip().splitlines()
    return lines, json.loads(lines[-1])


def phase_bench_tools(dev, card_line: str) -> dict:
    """The port's measurement tools on the main path, each as a user runs
    it: the bench entry at 4096 envs (its last line held to the JAX line's
    four keys, B1's launches to the count its calls give), then
    ``profile_bench --trace --ops`` of one iteration into a temporary
    directory and ``analyze_trace`` on that trace, then ``roofline`` at
    the bench entry's (untraced) iteration time with the policy GEMMs'
    device ms from ``analyze_trace``'s line, so that nothing reads the
    trace twice; one line each of the top kernels, the top source lines by
    device ms, by launches and by syncs, the idle share and the FLOP
    counts.  Fails unless the port's lines claim PORT_SHARE_MIN of the
    device's busy time and B1 is filed under ``terrain/scan.py``.  Returns
    B1's launches on the bench entry's path."""
    import math

    pkg = "legged_tracking_torch"
    env = dict(os.environ, BENCH_NUM_ENVS=str(NUM_ENVS), BENCH_ITERS=str(BENCH_TOOLS_ITERS),
               BENCH_ITERS_PER_CALL=str(BENCH_TOOLS_K))
    t0 = time.perf_counter()
    lines, line = tool_run("bench_tools", [f"{pkg}.bench"], env)
    bench_s = time.perf_counter() - t0
    run = json.loads(lines[-2])
    keys = {"metric", "value", "unit", "vs_baseline"}
    if set(line) != keys or line["metric"] != "train_env_steps_per_s" \
            or not (math.isfinite(line["value"]) and line["value"] > 0):
        raise AssertionError(f"bench_tools: the bench entry's last line {line}")
    launches = run["scan_heights_launches"]
    expected = (2 + BENCH_TOOLS_ITERS) * BENCH_TOOLS_K * 24 + 1
    if launches != expected or run["envs"] != NUM_ENVS:
        raise AssertionError(f"bench_tools: B1 launched {launches} times at {run['envs']} envs; "
                             f"expected {expected} at {NUM_ENVS}")
    emit({"phase": "bench_tools", "of": "bench", "card": card_line, "line": line, "run": run,
          "iteration_s": run["envs"] * 24 / line["value"], "process_s": bench_s})

    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        t0 = time.perf_counter()
        _, prof = tool_run("bench_tools", [f"{pkg}.tools.profile_bench", "--trace", tmp,
                                           "--iters", "1", "--ops", "--top", "10"])
        profile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, trace = tool_run("bench_tools", [f"{pkg}.tools.analyze_trace", tmp, "--iters", "1",
                                            "--top", "10"])
        analyze_s = time.perf_counter() - t0
    bench_iter_ms = run["envs"] * 24 / line["value"] * 1e3
    t0 = time.perf_counter()
    _, roof = tool_run("bench_tools", [f"{pkg}.tools.roofline", "--ms-per-iter",
                                       repr(bench_iter_ms), "--dense-ms",
                                       repr(dense_ms(trace["kernel_files"])),
                                       "--num-envs", str(NUM_ENVS)])
    roofline_s = time.perf_counter() - t0
    ops = prof["ops"]
    emit({"phase": "bench_tools", "of": "kernels", "card": card_line,
          "top_by_device_ms_per_iter": trace["kernels"]})
    emit({"phase": "bench_tools", "of": "lines", "card": card_line,
          "top_by_device_ms_per_iter": trace["by_line"], "by_file": trace["by_file"],
          "port_share": trace["port_share"]})
    emit({"phase": "bench_tools", "of": "ops", "card": card_line, "per_step": ops["per_step"],
          "sync_kinds_per_step": ops["sync_kinds_per_step"],
          "top_by_launches_per_step": ops["by_line_launches"],
          "top_by_syncs_per_step": ops["by_line_syncs"],
          "top_by_aten_ops_per_step": ops["by_line_aten_ops"]})
    emit({"phase": "bench_tools", "of": "idle", "card": card_line,
          "busy_ms_per_iter": trace["busy_ms_per_iter"],
          "traced_ms_per_iter": trace["window_ms_per_iter"], "idle_share": trace["idle_share"],
          "traced_iteration_s": prof["seconds"], "trace_stats": prof["trace_stats"]})
    emit({"phase": "bench_tools", "of": "roofline", "card": card_line,
          "jax_flop_per_iter": roof["jax_flop_per_iter"],
          "jax_flop_per_iter_bench_widths": roof["jax_flop_per_iter_bench_widths"],
          "shape_flop_per_iter": roof["shape_flop_per_iter"], "f32_floor_ms": roof["f32_floor_ms"],
          "bench_ms_per_iter": roof["ms_per_iter"], "policy_gemm_ms_per_iter": roof["dense_ms"],
          "f32_peak_share": roof["f32_peak_share"],
          "policy_gemm_f32_peak_share": roof.get("dense_f32_peak_share"),
          "process_s": {"profile_bench": profile_s, "analyze_trace": analyze_s,
                        "roofline": roofline_s}})
    scan_files = {}
    for name, files in trace["kernel_files"].items():
        if "scan_heights" in name:
            for f, ms in files.items():
                scan_files[f] = scan_files.get(f, 0.0) + ms
    if trace["port_share"] is None or trace["port_share"] < PORT_SHARE_MIN \
            or set(scan_files) != {"terrain/scan.py"}:
        raise AssertionError(f"bench_tools: the port's lines claim {trace['port_share']} of the "
                             f"device's busy time (at least {PORT_SHARE_MIN}); B1 filed under "
                             f"{scan_files}")
    return {"scan_heights": launches}


def phase_scaling(cards_line: str, k: int):
    """``tools/scaling_bench`` over NCCL, one rank a card, at 1, 2 and k
    ranks: the bench's 4096 total envs, 2 iterations each; its summary."""
    counts = sorted({1, 2, k})
    _, summary = tool_run("scaling_nccl", [
        "legged_tracking_torch.tools.scaling_bench", "--devices", *map(str, counts),
        "--dist_backend", "nccl", "--total_envs", str(NUM_ENVS), "--iters", "2"])
    backends = {r["backend"] for ranks in summary["ranks"].values() for r in ranks}
    devices = [sorted(r["device"] for r in summary["ranks"][str(n)]) for n in counts]
    if backends != {"nccl"} or any(len(set(d)) != n for d, n in zip(devices, counts)) \
            or set(summary["ms_per_iter"]) != set(map(str, counts)):
        raise AssertionError(f"scaling_nccl: backends {backends}, rank cards {devices}, "
                             f"counts {sorted(summary['ms_per_iter'])}")
    emit({"phase": "scaling_nccl", "ok": True, "cards": cards_line, **summary})


# the eval-reference phase's limits on the rollout's errors (see there)
EVAL_ROLLOUT_TOL = {"lin_vel_rmsd": 1e-5, "ang_vel_rmsd": 2e-4, "lin_vel_x": 3e-5,
                    "ang_vel_yaw": 3e-4, "base_height": 6e-7, "max_torques": 5e-4,
                    "power_consumption": 4e-3, "CoT": 4e-3, "froude_number": 6e-6,
                    "adaptation_loss": 7e-5, "base_pos": 1e-6}


def to_device(x, device):
    """An env state (named tuples of tensors) on ``device``."""
    import torch
    if torch.is_tensor(x):
        return x.to(device)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_device(v, device) for v in x))
    return x


def phase_eval_reference(dev, card_line: str, logdir: str):
    """``eval.rollout_metrics`` of the bench run's checkpoint, 8 envs with DR
    and noise off, 5 steps on the card and on the CPU from one reset state
    with the same draws: every env's nine metrics and adaptation loss at
    the final state, and the frames' base positions.  Then the metrics of
    the CPU's final state computed on the card, against the CPU's."""
    from legged_tracking_torch import eval as ev

    n, steps = 8, 5
    out = {}
    log = None
    for d in ("cpu", dev):
        env = ev.load_env(logdir, n, device=d)
        if log is None:
            log = env.draw = DrawLog(env)
        else:
            env.draw = log.replay(dev)
        alg, policy = ev.load_policy(env, logdir)
        m, frames = ev.rollout_metrics(env, alg, policy, steps, state=env.reset_fn(False))
        out[d] = (env, alg, {k: v.cpu() for k, v in ev.per_env_metrics(env, alg).items()},
                  frames, m)
    (env_c, _, per_cpu, fr_cpu, m_cpu), (env_g, alg_g, per_card, fr_card, m_card) = \
        out["cpu"], out[dev]
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max().clamp(min=1.0))
    errs = {"rollout_" + k: rel(per_card[k], v) for k, v in per_cpu.items()}
    errs["rollout_base_pos"] = max(float(abs(a["base_pos"] - b["base_pos"]).max())
                                   for a, b in zip(fr_card, fr_cpu))
    env_g.state = to_device(env_c.state, dev)
    same = {k: v.cpu() for k, v in ev.per_env_metrics(env_g, alg_g).items()}
    errs.update({"same_state_" + k: rel(same[k], v) for k, v in per_cpu.items()})
    # the rollout: the same float32 sums in another order (cuBLAS products,
    # reductions) in 5 steps of physics and in the policy, whose feedback
    # the contacts amplify; the same state: the metrics run the same
    # elementwise operations on both devices (bitwise), the adaptation loss
    # a cuBLAS product.  On an H100 the errors read, of max(|value|, 1):
    # 5.5e-7 (lin_vel_rmsd), 1.3e-5 (ang_vel_rmsd), 1.5e-6 (lin_vel_x),
    # 1.6e-5 (ang_vel_yaw), 3.0e-8 (base_height), 2.7e-5 (max_torques),
    # 2.2e-4 (power_consumption, CoT), 3.0e-7 (froude_number), 3.9e-6
    # (adaptation_loss), 6.0e-8 m (base positions); on the same state 0, and
    # 1.9e-8 for the adaptation loss.  Each limit is 15 to 20 times that
    tol = {f"rollout_{k}": v for k, v in EVAL_ROLLOUT_TOL.items()}
    tol.update({f"same_state_{k}": 0.0 for k in per_cpu})
    tol["same_state_adaptation_loss"] = 3e-7
    bad = {k: v for k, v in errs.items() if not v <= tol[k]}
    emit({"phase": "eval_reference", "ok": not bad, "card": card_line, "envs": n,
          "steps": steps, "policy": type(alg_g.ac).__name__,
          "max_err_over_max_abs": errs, "tolerance": tol,
          "metrics_cpu": m_cpu, "metrics_card": m_card})
    if bad:
        raise AssertionError(f"eval_reference: card vs CPU beyond tolerance: {bad}")


def eval_rollout(dev, name: str, run, steps: int, expected_launches: int) -> dict:
    """Time ``run()``, one rollout of ``steps`` env steps, and hold B1's
    launches in it to ``expected_launches``; the rollout's row."""
    import torch

    from legged_tracking_torch.terrain import scan

    torch.cuda.synchronize()
    scan.scan_heights.launches = 0
    t0 = time.perf_counter()
    row = run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = scan.scan_heights.launches
    if launches != expected_launches:
        raise AssertionError(f"{name}: scan_heights launched {launches} times, expected "
                             f"{expected_launches}")
    row.update({"path": name, "steps": steps, "seconds": seconds,
                "env_steps_per_s": row["envs"] * steps / seconds,
                "scan_heights_launches": launches})
    return row


def phase_eval(dev, card_line: str, logdirs: dict) -> tuple[dict, dict]:
    """The eval entries on the train phases' runs, at their own widths and
    depths cut to 100 steps: ``eval`` (16 envs, the reference's 500 steps)
    on each of the four runs, ``eval_reached`` (1,024 envs, its 1,200
    steps) on the goal run, and ``play_hierarchical`` (1 env, plan_interval
    100, its 500 steps) on the hierarchy run.  Each rollout's metrics, its
    env-steps/s and B1's launches: one a step and one at each observe (and
    one at a reset that stores the planner's scan), none on the velocity
    run.  B1 is held bitwise at each tunnel eval env's width first."""
    import numpy as np

    from legged_tracking_torch import eval as ev
    from legged_tracking_torch import eval_reached, play_hierarchical
    from legged_tracking_torch.envs.velocity_env import VelocityTrackingEnv

    steps = 100
    rows, by_path, off_path = [], {}, {}
    for path, logdir in logdirs.items():
        env = ev.load_env(logdir, 16, device=dev)
        alg, policy = ev.load_policy(env, logdir)
        scans = not isinstance(env, VelocityTrackingEnv) and not env.terrain.is_plane
        check = scan_check(env, dev) if scans else None
        # a reset's observe, record_rollout's observe, the steps, the final
        # observe; and the planner's scan at reset
        expected = (3 + steps + env.cfg.commands.sampling_based_planning) if scans else 0

        def run():
            m, _ = ev.rollout_metrics(env, alg, policy, steps)
            return {"envs": env.num_envs, "policy": type(alg.ac).__name__, "metrics": m}
        row = eval_rollout(dev, f"eval_{path}", run, steps, expected)
        row["scan_heights_check"] = check
        rows.append(row)
        (by_path if scans else off_path)[row["path"]] = {
            "scan_heights": row["scan_heights_launches"]}
        bad = [k for k, v in row["metrics"].items()
               if not (np.isfinite(v) or (k == "CoT" and not np.isnan(v)))]
        if bad:
            raise AssertionError(f"eval_{path}: metrics not finite: {bad} {row['metrics']}")

    env, policy = eval_reached.load(logdirs["goal"], 1024, device=dev)
    check = scan_check(env, dev)
    # the observe after the reset, and the steps
    row = eval_rollout(dev, "eval_reached", lambda: {
        "envs": env.num_envs, "result": eval_reached.evaluate(env, policy, steps)},
        steps, 1 + steps)
    rows.append({**row, "scan_heights_check": check})
    by_path["eval_reached"] = {"scan_heights": row["scan_heights_launches"]}

    env = play_hierarchical.load_env(logdirs["hierarchy"], 1, 100, dev)
    _, policy = ev.load_policy(env, logdirs["hierarchy"])
    check = scan_check(env, dev)
    # the planner's scan at reset, the reset's and record_rollout's
    # observes, and the steps
    row = eval_rollout(dev, "play_hierarchical", lambda: {
        "envs": env.num_envs, "episode_sums": play_hierarchical.play(env, policy, steps)[0]},
        steps, 3 + steps)
    rows.append({**row, "scan_heights_check": check})
    by_path["play_hierarchical"] = {"scan_heights": row["scan_heights_launches"]}
    emit({"phase": "eval", "ok": True, "card": card_line,
          "depth_cut": {"eval": [500, steps], "eval_reached": [1200, steps],
                        "play_hierarchical": [500, steps]},
          "rollouts": rows})
    return by_path, off_path


# the deploy phase's bus (LCM_DEFAULT_URL), apart from the reference's
# default one; its runs of 300 control steps at the reference's dt
DEPLOY_URL = "udpm://239.255.76.67:7760?ttl=0"
DEPLOY_STEPS = 300
# the loopback robot's joint limits (deploy/bridge/robot_link.hpp, Safety:
# hip, thigh, calf), which clamp the published targets
BRIDGE_Q_LIMITS = ((-0.863, 0.863), (-0.686, 4.501), (-2.818, -0.888))
# the policy runtime on the card against the CPU, the same histories (a
# float32 product over 2,100 or 3,915 inputs, cuBLAS against the CPU's
# GEMM): on an H100 1.9e-6 to 3.1e-6 over three runs; the limit is 6 to
# 10 times that
DEPLOY_RUNTIME_TOL = 2e-5
# the actuator-net fit on the card against the CPU, one epoch of 15
# minibatches from the same weights: on an H100 3.0e-8 on the weights; the
# limit is 13 times that
ACTUATOR_FIT_TOL = 4e-7


def deploy_run(dev, entry: str, logdir: str, profile: str | None, steps: int) -> dict:
    """One deploy entry's wiring (``build_runner``) against the loopback
    bridge for ``steps`` control steps with the policy on the card, its
    runner given no estimator (``runner.se = None``): the loopback bridge
    publishes the RC's switches zeroed at 500 Hz, so
    ``DeploymentRunner.calibrate`` would wait for R2 forever through
    ``runner.se`` (without it the runner also skips its roll/pitch watch;
    the loopback IMU is level).  Each policy call is
    timed (CUDA events around the forward; the host clock from the obs
    array to the action array, both copies included) and its obs history
    kept; the card's actions are held to the CPU runtime's on those
    histories; the bridge's joints, after the run, to the last published
    targets.  Then the same forward is timed alone, with the estimator's
    receive thread stopped: in the loop that thread decodes 1,500 messages
    a second in Python beside the policy's dispatch."""
    import numpy as np
    import torch

    from legged_tracking_torch import deploy_policy, deploy_traj_policy
    from legged_tracking_torch.deploy import go1_bridge
    from legged_tracking_torch.deploy.lcm_lite import LCMLite
    from legged_tracking_torch.deploy.policy_runtime import PolicyRuntime
    from legged_tracking_torch.deploy.state_estimator import StateEstimator
    from legged_tracking_torch.terrain import scan

    # the calibration's 100 steps, the run, and the 1.5 s the joints are
    # given to settle, in ticks of 2 ms, with room
    proc = go1_bridge.start(int((100 + steps) * 0.02 / 0.002 * 1.5) + 2000)
    se = StateEstimator(LCMLite())
    se.spin()
    try:
        t0 = time.perf_counter()
        while not se.received_first_legdata and time.perf_counter() - t0 < 10.0:
            time.sleep(0.02)
        if not se.received_first_legdata:
            raise AssertionError(f"{entry}: no leg telemetry from the bridge in 10 s")
        if entry == "deploy_policy":
            runner = deploy_policy.build_runner(logdir, se, device=dev)
        else:
            runner = deploy_traj_policy.build_runner(logdir, se, profile, device=dev)
        runner.se = None
        rt, agent = runner.policy, runner.agents["hardware"]
        hist, host_ms, spans = [], [], []
        forward = rt.act_student

        def evented(x):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            y = forward(x)
            b.record()
            spans.append((a, b))
            return y
        rt.act_student = evented

        def policy(obs_history):
            t = time.perf_counter()
            y = rt(obs_history)
            host_ms.append((time.perf_counter() - t) * 1e3)
            hist.append(obs_history.copy())
            return y
        runner.policy = policy
        torch.cuda.synchronize()
        scan.scan_heights.launches = 0
        runner.run(max_steps=steps)
        launches = scan.scan_heights.launches
        target = agent.joint_pos_target.copy()
        time.sleep(1.5)                  # the stub's PD settles in about 0.26 s a time constant
        q = se.get_dof_pos().copy()
        se.close()
        # the same forward outside the loop, with no LCM receive thread
        # beside it: device ms (cuda_ms) and the host clock of the numpy call
        del rt.act_student
        x1 = hist[-1]
        x1_dev = torch.from_numpy(x1).to(dev)
        alone_ms = cuda_ms(lambda: rt.act_student(x1_dev), iters=40)
        alone_host = []
        for _ in range(200):
            t = time.perf_counter()
            rt(x1)
            alone_host.append((time.perf_counter() - t) * 1e3)
    finally:
        se.close()
        proc.terminate()
        proc.wait(timeout=10)
    torch.cuda.synchronize()
    obs = np.concatenate([r["obs"] for r in runner.log])
    act = np.concatenate([r["action"] for r in runner.log])
    if not (np.isfinite(obs).all() and np.isfinite(act).all()):
        raise AssertionError(f"{entry}: non-finite obs or actions")
    histories = np.concatenate(hist)
    cpu = PolicyRuntime(os.path.join(logdir, "policy.npz"), device="cpu")
    err = float(np.abs(act - cpu(histories)).max())
    lo = np.array([BRIDGE_Q_LIMITS[j % 3][0] for j in range(12)])
    hi = np.array([BRIDGE_Q_LIMITS[j % 3][1] for j in range(12)])
    track = float(np.abs(q - np.clip(target, lo, hi)).max())
    dev_ms = [a.elapsed_time(b) for a, b in spans]
    period_ms = np.diff([r["t"] for r in runner.log]) * 1e3
    pct = lambda v, p: float(np.percentile(v, p))
    return {"path": entry, "profile": profile or "rc", "steps": steps,
            "obs_width": obs.shape[1], "history_width": histories.shape[1],
            "dt_ms": agent.dt * 1e3, "scan_heights_launches": launches,
            "card_vs_cpu_max_abs_err": err, "joint_tracking_err_rad": track,
            "policy_device_ms": {"median": pct(dev_ms, 50), "p99": pct(dev_ms, 99)},
            "policy_host_ms": {"median": pct(host_ms, 50), "p99": pct(host_ms, 99)},
            "policy_alone_ms": {"device": alone_ms[0], "call": alone_ms[1],
                                "host_median": pct(alone_host, 50),
                                "host_p99": pct(alone_host, 99)},
            "loop_period_ms": {"median": pct(period_ms, 50), "p99": pct(period_ms, 99),
                               "max": float(period_ms.max())}}


def phase_deploy(dev, card_line: str, logdirs: dict) -> dict:
    """The deploy stack on the card: the port's C++ bridge built from its
    sources and started as a subprocess on a bus of the phase's own, then
    ``deploy_policy``'s wiring on the velocity run (RC profile, 70-dim obs x
    30) and ``deploy_traj_policy``'s on the bench run (front_goal, 261 x
    15), 300 control steps each.  Checks: telemetry, obs widths, finite obs
    and actions, the card's actions against the CPU runtime's within
    DEPLOY_RUNTIME_TOL, the bridge's joints within 0.02 rad of the last
    published targets, and B1 launched 0 times (the agent stubs the
    height scan).  Returns B1's launches by path."""
    from legged_tracking_torch.deploy import go1_bridge

    t0 = time.perf_counter()
    shutil.rmtree(go1_bridge.BUILD_DIR, ignore_errors=True)
    go1_bridge.build()
    build_s = time.perf_counter() - t0
    saved = os.environ.get("LCM_DEFAULT_URL")
    os.environ["LCM_DEFAULT_URL"] = DEPLOY_URL
    try:
        rows = [deploy_run(dev, "deploy_policy", logdirs["velocity"], None, DEPLOY_STEPS),
                deploy_run(dev, "deploy_traj_policy", logdirs["bench"], "front_goal",
                           DEPLOY_STEPS)]
    finally:
        if saved is None:
            del os.environ["LCM_DEFAULT_URL"]
        else:
            os.environ["LCM_DEFAULT_URL"] = saved
    bad = [(r["path"], k) for r in rows for k, ok in (
        ("obs_width", r["obs_width"] == (70 if r["path"] == "deploy_policy" else 261)),
        ("card_vs_cpu", r["card_vs_cpu_max_abs_err"] <= DEPLOY_RUNTIME_TOL),
        ("joint_tracking", r["joint_tracking_err_rad"] <= 0.02),
        ("scan_heights_launches", r["scan_heights_launches"] == 0)) if not ok]
    emit({"phase": "deploy", "ok": not bad, "card": card_line, "bridge_build_s": build_s,
          "bridge_build": "cmake, make (deploy/bridge/CMakeLists.txt, Release)",
          "bus": DEPLOY_URL, "rc_wait": "off: the runner has no estimator (the loopback "
          "never presses R2)", "tolerance": DEPLOY_RUNTIME_TOL, "runs": rows})
    if bad:
        raise AssertionError(f"deploy: failed checks {bad}: {rows}")
    return {r["path"]: {"scan_heights": r["scan_heights_launches"]} for r in rows}


def phase_actuator_net(dev, card_line: str, logdir: str) -> dict:
    """The actuator-net trainer on the card, fitted to a log of the bench
    path: the bench run's policy drives the bench configuration at 4096
    envs for 100 control steps (B1 once at observe and once a step), each
    step's PD target, joint positions and velocities and torques recorded;
    ``build_dataset`` of each env's log in env order (4096 x 98 x 12
    samples); the card's fit against the CPU's, one epoch over the first
    65,536 samples from the same initial weights, within ACTUATOR_FIT_TOL;
    then the fit at the script's defaults (batch 4096, lr 8e-4, seed 0)
    cut to 2 epochs, its losses finite and falling, written with
    ``save_npz``, loaded back into ``ActuatorNet`` and stepped once in the
    bench env.  Returns B1's launches."""
    import numpy as np
    import torch

    from legged_tracking_torch import eval as ev
    from legged_tracking_torch import train_actuator_net as tam
    from legged_tracking_torch.actuation.actuators import ActuatorNet
    from legged_tracking_torch.envs import LeggedEnv
    from legged_tracking_torch.terrain import scan

    steps, epochs = 100, 2
    env = LeggedEnv(bench_cfg(NUM_ENVS), device=dev)
    _, policy = ev.load_policy(env, logdir)
    torch.cuda.synchronize()
    scan.scan_heights.launches = 0
    t0 = time.perf_counter()
    log = tam.record_log(env, policy, steps)
    torch.cuda.synchronize()
    log_s = time.perf_counter() - t0
    launches = scan.scan_heights.launches
    if launches != steps + 1:
        raise AssertionError(f"actuator_net: scan_heights launched {launches} times in the "
                             f"log's rollout, expected {steps + 1}")
    if not all(bool(torch.isfinite(v).all()) for v in log.values()):
        raise AssertionError("actuator_net: non-finite values in the joint log")
    t0 = time.perf_counter()
    X, Y = tam.build_dataset({k: v.cpu().numpy() for k, v in log.items()})
    dataset_s = time.perf_counter() - t0
    if X.shape != (NUM_ENVS * (steps - 2) * 12, 6):
        raise AssertionError(f"actuator_net: dataset {X.shape}")

    w_init = tam.init_weights(0)
    sub = 65536
    fits = {d: tam.fit(X[:sub], Y[:sub], epochs=1, device=d, weights=w_init)
            for d in (dev, "cpu")}
    fit_err = max(float(np.abs(fits[dev].weights[k] - fits["cpu"].weights[k]).max())
                  for k in w_init)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = tam.fit(X, Y, epochs=epochs, device=dev)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not (all(np.isfinite(res.losses)) and res.losses[-1] < res.losses[0]):
        raise AssertionError(f"actuator_net: losses {res.losses}")

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "actuator_net.npz")
        tam.save_npz(path, res.weights)
        arrays = dict(np.load(path))
    net = ActuatorNet.from_arrays(arrays, device=dev)
    if not all(np.array_equal(arrays[k], res.weights[k]) for k in res.weights):
        raise AssertionError("actuator_net: the written npz does not hold the fitted weights")
    with torch.no_grad():
        env.actuator_net.load_state_dict(net.state_dict())
        state = env.reset_fn(True)
        obs = env.observe(state)
        state, out = env.step_fn(state, policy(obs["obs"], obs["obs_history"].float()))
    if not all(bool(torch.isfinite(x).all()) for x in (out.obs, out.rew, state.torques)):
        raise AssertionError("actuator_net: a step with the fitted net is not finite")
    ok = fit_err <= ACTUATOR_FIT_TOL
    emit({"phase": "actuator_net", "ok": ok, "card": card_line, "envs": NUM_ENVS,
          "log_steps": steps, "log_s": log_s, "log_env_steps_per_s": NUM_ENVS * steps / log_s,
          "scan_heights_launches": launches, "samples": int(X.shape[0]),
          "input_mb": X.nbytes / 1e6, "dataset_s": dataset_s,
          "epochs": epochs, "depth_cut": {"epochs": [100, epochs]}, "batch": 4096,
          "minibatches_per_epoch": res.minibatches, "losses": res.losses,
          "epoch_s": res.epoch_s,
          "minibatch_us": [s / res.minibatches * 1e6 for s in res.epoch_s],
          "peak_mem_gib": peak, "card_vs_cpu_max_abs_err": fit_err,
          "card_vs_cpu_samples": sub, "tolerance": ACTUATOR_FIT_TOL,
          "step_with_fitted_net": {"rew_mean": float(out.rew.mean()),
                                   "torque_abs_max": float(state.torques.abs().max())}})
    if not ok:
        raise AssertionError(f"actuator_net: card vs CPU fit {fit_err} > {ACTUATOR_FIT_TOL}")
    return {"scan_heights": launches}


def profile(fn, label: str, out_dir: str, card_line: str):
    """``fn`` once more under torch.profiler: device time by kernel, written
    to ``out_dir``, and the device's busy time (the union of its events'
    intervals) and idle share over the traced window, from the first
    traced event to the last (``tools/analyze_trace.device_busy`` of the
    profile's Chrome trace, kept in a temporary file)."""
    import torch
    from torch.profiler import ProfilerActivity

    from legged_tracking_torch.tools import analyze_trace
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
    runtime = {e.key: {"count": e.count, "cpu_ms": e.cpu_time_total / 1e3} for e in ka
               if e.key.startswith("cuda") and e.count}
    with open(os.path.join(out_dir, f"{label}_kernels.txt"), "w") as f:
        f.write(ka.table(sort_by=attr, row_limit=60))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_profile_") as tmp:
        trace = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        busy = analyze_trace.device_busy(analyze_trace.load_trace_events(trace))
    emit({"phase": "profile", "of": label, "card": card_line, "wall_s": wall,
          "traced_s": busy["window_us"] / 1e6, "device_busy_s": busy["busy_us"] / 1e6,
          "device_idle_share": busy["idle_share"],
          "kernel_launches": sum(r[2] for r in rows), "runtime_calls": runtime,
          "top": [{"name": k[:80], "ms": t / 1e3, "count": c} for k, t, c in rows[:15]]})


def clocked_phase(seconds: dict, name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its wall seconds stored as ``seconds[name]``."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    seconds[name] = time.perf_counter() - t0
    return out


def main_cards(k: int) -> int:
    """The ``--cards K`` run: data parallelism across K cards over NCCL, one
    rank a card (its phases: the module docstring's)."""
    import torch

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cards = [card(i) for i in range(k)]
    cards_line = "; ".join(cards)
    seconds = {}
    timed = functools.partial(clocked_phase, seconds)
    timed("build", phase_build, cards_line)
    row = timed("kernels_per_card", phase_kernels_per_card, cards)
    timed("dp_reference_nccl", phase_dp_reference, dev, cards_line, ranks=k, backend="nccl",
          device="cuda", phase="dp_reference_nccl")
    # the 1-rank bench train both scalings are read against
    runs = tempfile.mkdtemp(prefix="chip_smoke_runs_")
    try:
        one = timed("train", phase_train, dev, cards[0], None, os.path.join(runs, "bench"))
    finally:
        shutil.rmtree(runs, ignore_errors=True)
    by_path = {"train": {"scan_heights": one["scan_heights_launches"]}}
    for phase, envs in (("train_nccl_weak", k * NUM_ENVS), ("train_nccl_strong", NUM_ENVS)):
        by_path.update(timed(phase, phase_train_dp, dev, cards_line, one, ranks=k,
                             backend="nccl", device="cuda", num_envs=envs, phase=phase))
    timed("entries", phase_entries, dev, cards_line, k)
    timed("scaling_nccl", phase_scaling, cards_line, k)
    emit({"phase_seconds": seconds, "cards": cards})
    row["launches_by_path"] = {path: n[row["name"]] for path, n in by_path.items()}
    row["launches"] = by_path["train_nccl_weak_rank0"][row["name"]]
    if not all(row["launches_by_path"].values()):
        raise AssertionError(f"{row['name']} was not launched on every path of its own: "
                             f"{row['launches_by_path']}")
    emit({"kernels": [row], "cards": cards})
    for line in cards:
        print(line)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also profile one rollout and one train iteration and write the "
                         "kernel tables to DIR")
    ap.add_argument("--cards", type=int, default=1, metavar="K",
                    help="with K > 1, drive data parallelism across K cards over NCCL, "
                         "one rank a card, instead of the one-card run")
    args = ap.parse_args(argv)
    if args.cards < 1 or (args.cards > 1 and args.profile):
        ap.error("--cards takes K >= 1, and --profile profiles the one-card run only")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < args.cards:
        print(f"chip_smoke: --cards {args.cards} needs {args.cards} CUDA devices; torch sees "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    if args.cards > 1:
        return main_cards(args.cards)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card_line = card()

    from legged_tracking_torch.learn import conv3x3

    # wall seconds of each phase, set-up included: the run has to stay
    # well inside its time limit as phases are added; W1's launches in each
    seconds, w1 = {}, {}

    def timed(name, fn, *args, **kwargs):
        before = conv3x3.conv3x3_wgrad.launches
        out = clocked_phase(seconds, name, fn, *args, **kwargs)
        w1[name] = conv3x3.conv3x3_wgrad.launches - before
        return out

    timed("build", phase_build, card_line)
    rows = timed("kernels", phase_kernels, dev, card_line)
    wgrad = timed("conv_wgrad", phase_conv_wgrad, dev, card_line)
    timed("reference", phase_reference, dev, card_line)
    timed("physics_oracle", phase_physics_oracle, dev, card_line)
    by_path = {"rollout": timed("rollout", phase_rollout, dev, card_line, args.profile)}
    timed("update_reference", phase_update_reference, dev, card_line)
    timed("cnn_update_reference", phase_cnn_update_reference, dev, card_line)
    timed("velocity_reference", phase_velocity_reference, dev, card_line)
    timed("rma_update_reference", phase_rma_update_reference, dev, card_line)
    timed("planner", phase_planner, dev, card_line)
    timed("planner_reference", phase_planner_reference, dev, card_line)
    # the train phases' runs, which the eval phases read; removed at exit
    runs = tempfile.mkdtemp(prefix="chip_smoke_runs_")
    try:
        logdirs = {name: os.path.join(runs, name)
                   for name in ("bench", "goal", "hierarchy", "velocity")}
        trained = {}
        for path, fn, run in (("train", phase_train, "bench"),
                              ("train_goal", phase_train_goal, "goal"),
                              ("train_hierarchy", phase_train_hierarchy, "hierarchy")):
            trained[path] = timed(path, fn, dev, card_line, args.profile, logdirs[run])
            by_path[path] = {"scan_heights": trained[path]["scan_heights_launches"]}
        # the velocity path observes no heights: B1 is not one of its kernels
        row = timed("train_velocity", phase_train_velocity, dev, card_line, args.profile,
                    logdirs["velocity"])
        off_path = {"train_velocity": {"scan_heights": row["scan_heights_launches"]}}
        timed("eval_reference", phase_eval_reference, dev, card_line, logdirs["bench"])
        eval_paths, eval_off = timed("eval", phase_eval, dev, card_line, logdirs)
        by_path.update(eval_paths)
        off_path.update(eval_off)
        # the deploy stack stubs the height scan: B1 is not one of its kernels
        off_path.update(timed("deploy", phase_deploy, dev, card_line, logdirs))
        by_path["actuator_log"] = timed("actuator_net", phase_actuator_net, dev, card_line,
                                        logdirs["bench"])
    finally:
        shutil.rmtree(runs, ignore_errors=True)
    # data parallelism: two ranks against one, then the main path over two
    timed("dp_reference", phase_dp_reference, dev, card_line)
    by_path.update(timed("train_dp", phase_train_dp, dev, card_line, trained["train"]))
    # windowed histories: against stored ones at full width, then the main path
    timed("window_reference", phase_window_reference, dev, card_line)
    by_path["train_window"] = timed("train_window", phase_train_window, dev, card_line,
                                    trained["train"])
    # the measurement tools: the bench entry, its trace, the per-line
    # attribution and the roofline
    by_path["bench"] = timed("bench_tools", phase_bench_tools, dev, card_line)
    emit({"phase_seconds": seconds, "card": card_line})
    for row in rows:
        row["launches_by_path"] = {path: n[row["name"]] for path, n in by_path.items()}
        row["launches_off_path"] = {path: n[row["name"]] for path, n in off_path.items()}
        row["launches"] = by_path["train"][row["name"]]
        if not all(row["launches_by_path"].values()) or any(row["launches_off_path"].values()):
            raise AssertionError(f"{row['name']} was not launched on every path of its own, "
                                 f"or was on another: {row['launches_by_path']}, "
                                 f"{row['launches_off_path']}")
    # W1 runs in the conv encoder's backward only: the conv + GRU policy's
    # update, and no CSE or MLP-encoder path and no forward-only one
    wgrad["launches_by_path"] = {"cnn_update_reference": w1["cnn_update_reference"]}
    wgrad["launches_off_path"] = {path: w1[path] for path in (
        "rollout", "update_reference", "train", "train_goal", "train_velocity", "eval", "deploy")}
    wgrad["launches"] = w1["cnn_update_reference"]
    if any(wgrad["launches_off_path"].values()):
        raise AssertionError(f"conv3x3_wgrad was launched off its path: "
                             f"{wgrad['launches_off_path']}")
    rows.append(wgrad)
    emit({"kernels": rows, "card": card_line})
    print(card_line)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
