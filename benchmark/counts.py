"""Frozen arithmetic of the benchmark: the published peaks of the card, the
matrix-product operations of a train iteration counted from a
configuration's widths, and kernel B1's least bytes with its own cell
arithmetic.  Later changes to the program do not move these numbers."""

from __future__ import annotations

import numpy as np
import torch

from . import manifest

# NVIDIA H100 SXM data sheet, at the card's full 700 W power limit: float32
# operations/s outside the tensor cores and HBM3 bytes/s
F32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def _macs(dims) -> int:
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def _heads(config: dict, pin: int) -> dict:
    """The layer widths of the heads over a policy input of ``pin``
    features: the adaptation module (-> privileged obs), the actor (input
    and adaptation -> actions) and the critic (input and privileged obs ->
    value)."""
    w, ac = config["widths"], config["ac"]
    priv = w["num_privileged_obs"]
    return {"adapt": [pin, *ac["adaptation_module_branch_hidden_dims"], priv],
            "actor": [pin + priv, *ac["actor_hidden_dims"], w["num_actions"]],
            "critic": [pin + priv, *ac["critic_hidden_dims"], 1]}


def _cse_macs(config: dict) -> tuple[int, int]:
    """(rollout, minibatch) multiply-adds a sample of ``ActorCriticCSE``,
    whose heads read the whole history.  Rollout: the adaptation module,
    the actor and the critic forward.  Minibatch: each layer's forward, its
    weight gradient and, where its input needs one, its input gradient;
    the critic's and the adaptation module's first layers read the history
    only and take none, and the adaptation module runs in the policy and in
    each adaptation substep."""
    w = config["widths"]
    d = _heads(config, w["num_obs"] * w["history_frames"])
    k = config["ppo"]["num_adaptation_module_substeps"]
    first = lambda dims: dims[0] * dims[1]
    rollout = _macs(d["adapt"]) + _macs(d["actor"]) + _macs(d["critic"])
    minibatch = (3 * _macs(d["actor"]) + (3 * _macs(d["critic"]) - first(d["critic"]))
                 + (1 + k) * (3 * _macs(d["adapt"]) - first(d["adapt"])))
    return rollout, minibatch


def _cnn_macs(config: dict) -> tuple[int, int]:
    """(rollout, minibatch) multiply-adds a sample of ``ActorCriticCNN``,
    from the ``ac`` widths: the height block ``(c, h, w)``, the embedding
    ``E`` and the GRU's ``G``; ``S`` scalars and ``F`` frames a history.

    A frame, in each call of ``process_obs_history``: the conv encoder's
    ``Conv_0`` ``h w 16 c 9`` (3 x 3, zero padding), ``Conv_1`` ``(h/2)(w/2)
    32 16 9`` after the 2 x 2 pool, ``Dense_0`` ``32 (h/4)(w/4) E`` (the
    pools compute no product; ``/`` rounds down), or the MLP encoder's ``c h
    w 256 + 256 E``; with the GRU, ``3 (S + E) G`` input and ``3 G G``
    hidden products.  The heads read ``S + G`` features (``S + S + E``
    without the GRU).  In the update every layer also takes its weight
    gradient, and its input gradient where the input needs one: all but the
    encoder's first layer (it reads the observation) and the first frame's
    hidden products (``h_0 = 0``).  A call forward is ``F frame``; in the
    update ``F (3 frame - first encoder layer) - 3 G G``.

    Rollout: ``action_dist`` and ``evaluate``, two calls, and the three
    heads forward.  Minibatch: ``action_dist``, ``evaluate`` and each of
    the ``k`` adaptation substeps, ``2 + k`` calls, and the actor, the
    critic and ``1 + k`` times the adaptation module, three times each."""
    w, ac = config["widths"], config["ac"]
    c, h, wd = ac["height_map_shape"]
    E, G, F = ac["cnn_num_embedding"], ac["gru_num_embedding"], w["history_frames"]
    S = w["num_obs"] - c * h * wd
    if ac["use_cnn"]:
        enc = [h * wd * 16 * c * 9, (h // 2) * (wd // 2) * 32 * 16 * 9,
               32 * (h // 4) * (wd // 4) * E]
    else:
        enc = [c * h * wd * 256, 256 * E]
    gru_x, gru_h = (3 * (S + E) * G, 3 * G * G) if ac["use_gru"] else (0, 0)
    frame = sum(enc) + gru_x + gru_h
    call_train = F * (3 * frame - enc[0]) - gru_h
    d = _heads(config, S + (G if ac["use_gru"] else S + E))
    k = config["ppo"]["num_adaptation_module_substeps"]
    rollout = 2 * F * frame + _macs(d["adapt"]) + _macs(d["actor"]) + _macs(d["critic"])
    minibatch = (2 + k) * call_train + 3 * (_macs(d["actor"]) + _macs(d["critic"])
                                            + (1 + k) * _macs(d["adapt"]))
    return rollout, minibatch


# the policy a configuration names -> its multiply-adds a sample
POLICY_MACS = {"ActorCriticCSE": _cse_macs, "ActorCriticCNN": _cnn_macs}


def iteration_flop(config: dict, num_envs: int) -> dict:
    """Matrix-product operations (two a multiply-add) of one PPO train
    iteration of the policy ``config`` names (:data:`POLICY_MACS`): the
    rollout's forward passes for each of ``num_envs`` x T samples and the
    update's ``epochs`` passes over those samples."""
    name = manifest.policy_name(config)
    if name not in POLICY_MACS:
        raise ValueError(f"no count for policy {name!r}; one of {sorted(POLICY_MACS)}")
    per_rollout, per_minibatch = POLICY_MACS[name](config)
    ppo = config["ppo"]
    samples = num_envs * ppo["num_steps_per_env"]
    rollout = 2.0 * per_rollout * samples
    update = 2.0 * per_minibatch * samples * ppo["num_learning_epochs"]
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
