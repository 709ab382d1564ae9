"""Actuator-network training (counterpart of ``scripts/train_actuator_net.py``).

    python -m legged_tracking_torch.train_actuator_net --log L --name N [--device cpu]

Fits the softsign MLP of ``actuation/actuators.py`` (``ActuatorNet``, 6 ->
32 -> 32 -> 1, reference utils.py:27-34,66-76), which maps per-joint
(q_err, q_err_last, q_err_last2, qd, qd_last, qd_last2) to torque, to a
logged joint trace, on the card unless ``--device cpu`` is given, and
writes the weights to ``assets/actuator_nets/<name>.npz`` in the layout
both packages' ``actuation/actuators.py`` read (``w0, b0, w1, b1, w2, b2``,
weights (out, in)).

The log is an npz or pickle with arrays ``joint_pos_target``,
``joint_pos``, ``joint_vel``, ``tau_est`` of shape (T, 12), the format the
deployment logger writes; ``record_log`` writes one from the port's sim,
with a leading env axis (N, T, 12).

As the JAX script does: the initial weights are uniform(-1, 1) / sqrt(fan_in)
with zero biases (here from a seeded ``torch.Generator``; a caller may give
its own), Adam in optax's arithmetic (``learn/optim.py``) at ``--lr``, the
mean-square loss, and each epoch ``np.random.RandomState(seed)``'s
permutation cut into batches at ``range(0, n - batch, batch)``, which drops
the last partial batch, and a whole last batch when ``batch`` divides n.
The losses stay on the device; the epoch's mean is read once an epoch.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from .actuation.actuators import ActuatorNet
from .io.checkpoint import load_pickle
from .learn.optim import adam_init, adam_step

ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "assets", "actuator_nets")
LOG_KEYS = ("joint_pos_target", "joint_pos", "joint_vel", "tau_est")
LAYERS = ((6, 32), (32, 32), (32, 1))     # (fan_in, fan_out)


def build_dataset(log):
    """(X (M, 6), Y (M, 1)) float32 of a log of (T, 12) arrays, or of
    (N, T, 12) arrays (each env's dataset, concatenated in env order):
    for t = 2 .. T-1 and each joint, t-major and joint-minor, the
    reference's rows bitwise (scripts/train_actuator_net.py:26-38)."""
    q_err = log["joint_pos_target"] - log["joint_pos"]   # (..., T, 12)
    qd = log["joint_vel"]
    tau = log["tau_est"]
    X = np.stack([q_err[..., 2:, :], q_err[..., 1:-1, :], q_err[..., :-2, :],
                  qd[..., 2:, :], qd[..., 1:-1, :], qd[..., :-2, :]], axis=-1)
    return (X.reshape(-1, 6).astype(np.float32),
            tau[..., 2:, :].reshape(-1, 1).astype(np.float32))


def init_weights(seed: int = 0) -> dict:
    """The reference's initial rule (train_actuator_net.py:53-61), drawn
    from a seeded torch.Generator: weights (out, in) uniform(-1, 1) /
    sqrt(in), biases zero."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for i, (fan_in, fan_out) in enumerate(LAYERS):
        w = torch.rand(fan_out, fan_in, generator=g, dtype=torch.float32) * 2.0 - 1.0
        out[f"w{i}"] = (w / np.sqrt(fan_in)).numpy()
        out[f"b{i}"] = np.zeros(fan_out, np.float32)
    return out


class FitResult(NamedTuple):
    weights: dict          # w0, b0, w1, b1, w2, b2 as numpy float32
    losses: list           # the mean minibatch loss of each epoch (float64)
    epoch_s: list          # host seconds of each epoch, to its loss read-back
    minibatches: int       # minibatches an epoch


def fit(X, Y, epochs: int = 100, batch: int = 4096, lr: float = 8e-4, seed: int = 0,
        device="cuda", weights: dict | None = None) -> FitResult:
    """Fit an ActuatorNet to (X (M, 6), Y (M, 1)) on ``device`` from
    ``weights`` (default ``init_weights(seed)``)."""
    device = torch.device(device)
    net = ActuatorNet.from_arrays(weights if weights is not None else init_weights(seed),
                                  device=device).requires_grad_(True)
    params = dict(net.named_parameters())
    opt = adam_init(params)
    X = torch.as_tensor(np.asarray(X, np.float32)).to(device)
    y = torch.as_tensor(np.asarray(Y, np.float32)).to(device)[:, 0]
    rng = np.random.RandomState(seed)
    n = X.shape[0]
    starts = range(0, n - batch, batch)
    losses, epoch_s = [], []
    for epoch in range(epochs):
        t0 = time.perf_counter()
        perm = torch.from_numpy(rng.permutation(n)).to(device)
        batch_losses = []
        for i in starts:
            idx = perm[i:i + batch]
            loss = torch.mean(torch.square(net(X[idx]) - y[idx]))
            grads = torch.autograd.grad(loss, list(params.values()))
            opt = adam_step(params, list(grads), opt, lr)
            batch_losses.append(loss.detach())
        # one read-back an epoch: the same float64 mean of the float32
        # losses as the reference's np.mean of float(loss) per minibatch
        mean = float(np.mean(torch.stack(batch_losses).cpu().numpy().astype(np.float64)))
        epoch_s.append(time.perf_counter() - t0)
        losses.append(mean)
        print(f"epoch {epoch}: loss {mean:.5f}", flush=True)
    layers = (net.l0, net.l1, net.l2)
    out = {}
    for i, layer in enumerate(layers):
        out[f"w{i}"] = layer.weight.detach().cpu().numpy()
        out[f"b{i}"] = layer.bias.detach().cpu().numpy()
    return FitResult(out, losses, epoch_s, len(starts))


def save_npz(path: str, weights: dict):
    """The actuator-net npz (``w0, b0, w1, b1, w2, b2``) at ``path``."""
    np.savez(path, **{k: np.asarray(weights[k]) for k in ("w0", "b0", "w1", "b1", "w2", "b2")})


@torch.no_grad()
def record_log(env, policy, steps: int) -> dict:
    """A joint log of ``env`` driven by ``policy(obs, obs_history)`` for
    ``steps`` control steps from a reset: after each
    step, the actuator's PD target of the last substep, the joint
    positions and velocities and the applied torques, each (N, steps, 12)
    on the env's device under the log's names."""
    state = env.reset_fn(True)
    obs = env.observe(state)
    rows = {k: [] for k in LOG_KEYS}
    for _ in range(steps):
        state, out = env.step_fn(state, policy(obs["obs"], obs["obs_history"].float()))
        obs = {"obs": out.obs, "obs_history": out.obs_history}
        for k, v in zip(LOG_KEYS, (state.act.joint_pos_target, state.phys.qj,
                                   state.phys.v[:, 6:], state.torques)):
            rows[k].append(v)
    return {k: torch.stack(v, dim=1) for k, v in rows.items()}


def main(args):
    log = dict(np.load(args.log)) if args.log.endswith(".npz") else load_pickle(args.log)
    X, Y = build_dataset(log)
    print(f"dataset: {X.shape[0]} samples")
    res = fit(X, Y, args.epochs, args.batch, args.lr, args.seed, args.device)
    out = os.path.join(ASSET_DIR, f"{args.name}.npz")
    save_npz(out, res.weights)
    print(f"wrote {out}")


def parse_args(argv=None):
    """The flags of ``scripts/train_actuator_net.py``, with ``--device`` in
    place of ``--cpu``."""
    p = argparse.ArgumentParser()
    p.add_argument("--log", required=True)
    p.add_argument("--name", default="actuator_net")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--lr", type=float, default=8e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device to fit on (default cuda; cpu to stay off the card)")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
