"""Per-term negative-reward ledger of the ji22 shaping on the port's
velocity env (counterpart of the repo's ``tools/ji22_ledger.py``).

    python -m legged_tracking_torch.tools.ji22_ledger [--device cpu]

The published velocity recipe (``sigma_rew_neg`` 0.02) on the plane, with
observation noise, pushes and friction randomization off: which reward
terms consume the ji22 budget for (a) a calm stance (zero actions, 30
settling steps) and (b) an untrained random policy (normal actions from an
explicit ``torch.Generator``, 10 settling steps), each over 100 measured
steps, and how the contact-report EMA (``SimCfg.contact_report_ema``) moves
them.  It runs on the card unless ``--device cpu`` is given; on ``cuda``
with no card it raises.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

GAIT_TERMS = ("tracking_contacts_shaped_force", "tracking_contacts_shaped_vel", "collision",
              "feet_slip", "raibert_heuristic", "orientation_control", "action_smoothness_1",
              "action_smoothness_2", "dof_acc", "jump")


def make_env(ema: float, num_envs: int = 16, device="cuda"):
    """The velocity env of ``train_velocity_tracking``'s flags ``--terrain
    plane --sigma_rew_neg 0.02`` with the report EMA ``ema`` and noise,
    pushes and friction randomization off."""
    from ..envs.velocity_env import VelocityTrackingEnv
    from ..parallel import entry_device
    from ..train_velocity_tracking import build_cfg, parse_args

    dev = entry_device(device)
    args = parse_args(["--device", str(dev), "--num_envs", str(num_envs), "--terrain", "plane",
                       "--sigma_rew_neg", "0.02"])
    cfg = build_cfg(args)
    cfg.sim.contact_report_ema = ema
    cfg.noise.add_noise = False
    cfg.domain_rand.push_robots = False
    cfg.domain_rand.randomize_friction = False
    return VelocityTrackingEnv(cfg, device=dev)


@torch.no_grad()
def ledger(env, policy: str, steps: int = 100, seed: int = 0, state=None):
    """(per-term per-step means over the envs, the per-step ``total_neg``)
    of ``steps`` steps after the settle, from ``state`` (a reset without
    randomized episode lengths by default)."""
    gen = torch.Generator(device=env.device).manual_seed(seed)
    state = env.reset_fn(False) if state is None else state
    warm = 30 if policy == "stand" else 10     # settle before measuring
    prev_sums = None
    for t in range(steps + warm):
        if policy == "stand":
            a = torch.zeros((env.num_envs, 12), device=env.device)
        else:
            a = torch.randn((env.num_envs, 12), generator=gen, device=env.device)
        state, _ = env.step_fn(state, a)
        if t == warm - 1:
            prev_sums = state.episode_sums.cpu().numpy()
    sums = state.episode_sums.cpu().numpy() - prev_sums
    per_step = {n: float(sums[:, i].mean()) / steps for i, n in enumerate(env.metric_names)}
    return per_step, per_step.get("total_neg", 0.0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    print(f"{'term':35s} {'stand':>10s} {'random':>10s}   (per step, "
          "published scales, sigma_rew_neg=0.02)")
    for ema in (0.0, 0.5, 0.8):
        env = make_env(ema, device=args.device)
        stand, _ = ledger(env, "stand")
        rand, _ = ledger(env, "random")
        if ema == 0.0:
            for n in sorted(stand, key=lambda n: stand[n]):
                print(f"{n:35s} {stand[n]:10.4f} {rand[n]:10.4f}")
        s_neg = stand.get("total_neg", 0.0)
        r_neg = rand.get("total_neg", 0.0)
        print(f"\nema={ema}: stance neg/step {s_neg:.4f} "
              f"(ji22 factor {np.exp(s_neg / 0.02):.3g}) | "
              f"random neg/step {r_neg:.4f} "
              f"(factor {np.exp(r_neg / 0.02):.3g})")
        for gait_term in GAIT_TERMS:
            if gait_term in stand:
                print(f"    {gait_term:35s} stand {stand[gait_term]:8.4f}  "
                      f"random {rand[gait_term]:8.4f}")
    print("\n(ema sweep shows how much of the negative ledger is "
          "contact-report texture vs posture/action terms)")


if __name__ == "__main__":
    main()
