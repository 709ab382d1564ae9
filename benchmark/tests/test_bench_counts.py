"""The frozen arithmetic against the port's own tools: the FLOP count of a
train iteration against ``tools/roofline`` on a built policy, and B1's
least bytes against ``chip_smoke.scan_bound`` at a small seeded input."""

import pytest
import torch

from benchmark import counts, manifest


def test_flop_count_equals_the_roofline_tools_shape_count():
    from legged_tracking_torch.tools import roofline

    ac, ppo = roofline.bench_policy("cpu")
    want = roofline.iteration_flop(ac, 4096, ppo.num_steps_per_env, ppo.num_learning_epochs)
    got = counts.iteration_flop(manifest.config("tunnel_cse"), 4096)
    assert got == want
    assert got["total"] / 1e12 == pytest.approx(16.042, abs=5e-4)


@pytest.mark.parametrize("seed", [0, 3])
def test_b1_bytes_equal_scan_bound(seed):
    import chip_smoke
    from legged_tracking_torch.terrain import heightfield as hf
    from legged_tracking_torch.terrain.tunnel import build_terrain

    cfg = chip_smoke.bench_cfg(16)
    terrain = build_terrain(cfg, 16, seed, device="cpu")
    args = chip_smoke.scan_args(terrain, hf.bf16_table(terrain), cfg, torch.device("cpu"))
    want = chip_smoke.scan_bound(args)
    assert counts.scan_bytes(*args) == want["bytes"]
    assert counts.scan_bound_s(*args) * 1e3 == pytest.approx(want["bound_ms"], rel=1e-12)
    from legged_tracking_torch.terrain import scan
    assert torch.equal(counts.scan_cells(*args), scan.scan_cells(*args))


@pytest.mark.parametrize("policy", ["cse", "mlp", "mlp-gru", "conv", "conv-gru"])
def test_flop_count_equals_torchs_flop_counter(policy):
    """``iteration_flop`` against ``FlopCounterMode`` over the reference
    learner's rollout forward and one minibatch step of the plain policy,
    at 8 envs and 3 frames, each scaled to the iteration's samples."""
    from types import SimpleNamespace

    from torch.utils.flop_counter import FlopCounterMode

    from benchmark import build
    from benchmark.reference import learner
    from benchmark.reference.plain.learn import POLICIES

    from .test_bench_policy import VARIANTS, cnn_ac

    config = manifest.config("tunnel_cse")
    config = {**config, "widths": {**config["widths"], "history_frames": 3},
              "ppo": {**config["ppo"], "num_steps_per_env": 2, "num_mini_batches": 2}}
    if policy != "cse":
        config.update(policy="ActorCriticCNN", ac=cnn_ac(*VARIANTS[policy]))
    N, T, F = 8, 2, 3
    w = config["widths"]
    env = SimpleNamespace(num_obs=w["num_obs"], num_privileged_obs=w["num_privileged_obs"],
                          num_obs_history=w["num_obs"] * F, num_actions=w["num_actions"])
    torch.manual_seed(0)
    ac = build.policy(POLICIES, config, env)
    gen = torch.Generator().manual_seed(1)
    shapes = {"obs": (env.num_obs,), "privileged_obs": (env.num_privileged_obs,),
              "obs_history": (env.num_obs_history,), "actions": (env.num_actions,),
              "mu": (env.num_actions,), "sigma": (env.num_actions,), "rewards": (),
              "values": (), "log_prob": ()}
    traj = {k: torch.randn((T, N) + s, generator=gen) for k, s in shapes.items()}
    traj["sigma"] = traj["sigma"].abs() + 0.5
    traj["dones"] = torch.zeros(T, N, dtype=torch.bool)
    with FlopCounterMode(display=False) as rollout, torch.no_grad():
        learner.policy(ac, traj["obs"][0], traj["privileged_obs"][0], traj["obs_history"][0])
    params = dict(ac.named_parameters())
    lrn = learner.Learner(1e-3, learner.adam_init(params), learner.adam_init(params))
    with FlopCounterMode(display=False) as minibatch:
        learner.update(ac, config["ppo"], lrn, traj, traj["values"], traj["rewards"],
                       torch.randperm(T * N, generator=gen), steps=1)
    got = counts.iteration_flop(config, N)
    assert got["rollout"] == rollout.get_total_flops() * T
    assert got["update"] == (minibatch.get_total_flops() * config["ppo"]["num_mini_batches"]
                             * config["ppo"]["num_learning_epochs"])


def test_cnn_gru_count_at_the_tunnel_widths():
    """The conv + GRU policy over the tunnel's 15 frames at 4096 envs."""
    from .test_bench_policy import cnn_ac

    config = {**manifest.config("tunnel_cse"), "policy": "ActorCriticCNN", "ac": cnn_ac()}
    got = counts.iteration_flop(config, 4096)
    assert 70e12 < got["total"] < 90e12 and got["rollout"] < 0.06 * got["total"]
