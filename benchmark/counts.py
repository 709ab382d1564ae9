"""Frozen arithmetic of the benchmark: the published peaks of the card, the
matrix-product operations of a train iteration counted from a
configuration's widths, and kernel B1's least bytes with its own cell
arithmetic.  Later changes to the program do not move these numbers."""

from __future__ import annotations

import numpy as np
import torch

# NVIDIA H100 SXM data sheet, at the card's full 700 W power limit: float32
# operations/s outside the tensor cores and HBM3 bytes/s
F32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def _macs(dims) -> int:
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def policy_dims(config: dict) -> dict:
    """The layer widths of the CSE policy of ``config``: the adaptation
    module (history -> privileged obs), the actor (history and latent ->
    actions) and the critic (history and privileged obs -> value)."""
    w, ac = config["widths"], config["ac"]
    hist = w["num_obs"] * w["history_frames"]
    priv = w["num_privileged_obs"]
    return {"adapt": [hist, *ac["adaptation_module_branch_hidden_dims"], priv],
            "actor": [hist + priv, *ac["actor_hidden_dims"], w["num_actions"]],
            "critic": [hist + priv, *ac["critic_hidden_dims"], 1]}


def iteration_flop(config: dict, num_envs: int) -> dict:
    """Matrix-product operations of one PPO train iteration: the rollout's
    forward passes (adaptation module, actor and critic for each of
    ``num_envs`` x T samples) and the update's ``epochs`` passes over those
    samples.  In the update each layer takes its forward, its weight
    gradient and, where its input needs one, its input gradient; the
    critic's and the adaptation module's first layers read the history only
    and take none, and the adaptation module runs twice a minibatch (in the
    policy and in its own substep)."""
    d = policy_dims(config)
    ppo = config["ppo"]
    samples = num_envs * ppo["num_steps_per_env"]
    first = lambda dims: dims[0] * dims[1]
    rollout = 2.0 * (_macs(d["adapt"]) + _macs(d["actor"]) + _macs(d["critic"])) * samples
    per_sample = (3 * _macs(d["actor"]) + (3 * _macs(d["critic"]) - first(d["critic"]))
                  + 2 * (3 * _macs(d["adapt"]) - first(d["adapt"])))
    update = 2.0 * per_sample * samples * ppo["num_learning_epochs"]
    return {"rollout": rollout, "update": update, "total": rollout + update}


def scan_cells(tiles, env_tile, frames, grid_pts, hs: float) -> torch.Tensor:
    """(N, P) int64: the flat index into ``tiles.reshape(-1)`` of the ceiling
    cell each of B1's scan points reads (its floor cell is ``h * w``
    further): ``x0 = clip(trunc(((grid_x + base_x) + cam_x - origin_x) *
    inv_hs), 0, h - 2)``, likewise y, with ``inv_hs`` the float32
    reciprocal of the cell size."""
    T, L, h, w = tiles.shape
    inv = torch.full((), float(np.float32(1.0) / np.float32(hs)), dtype=frames.dtype,
                     device=frames.device)
    px = (grid_pts[None, :, 0] + frames[:, 0, 0, None]) + frames[:, 1, 0, None]
    py = (grid_pts[None, :, 1] + frames[:, 0, 1, None]) + frames[:, 1, 1, None]
    x0 = torch.clamp(((px - frames[:, 2, 0, None]) * inv).to(torch.int32), 0, h - 2).long()
    y0 = torch.clamp(((py - frames[:, 2, 1, None]) * inv).to(torch.int32), 0, w - 2).long()
    return env_tile.long()[:, None] * (L * h * w) + x0 * w + y0


def scan_bytes(tiles, env_tile, frames, grid_pts, hs: float) -> int:
    """B1's least bytes on these inputs: the output (N, 2, P) float32
    written once, the frames, tile indices and grid read once, and of the
    bf16 table only the cells these points touch, both layers."""
    N, P, L = frames.shape[0], grid_pts.shape[0], tiles.shape[1]
    touched = int(torch.unique(scan_cells(tiles, env_tile, frames, grid_pts, hs)).numel())
    return N * 2 * P * 4 + N * 3 * 2 * 4 + N * 4 + P * 2 * 4 + touched * L * 2


def scan_bound_s(tiles, env_tile, frames, grid_pts, hs: float) -> float:
    """The least seconds the card could take for one B1 launch: its bytes
    over the HBM rate, or its operations (two adds, a subtract and a
    multiply per axis and point) over the float32 rate, whichever is
    larger."""
    N, P = frames.shape[0], grid_pts.shape[0]
    return max(scan_bytes(tiles, env_tile, frames, grid_pts, hs) / HBM_BYTES_PER_S,
               N * P * 2 * 4 / F32_OPS_PER_S)
