"""A configuration names its policy (``"policy"``): the program's build, the
plain reference and the TF32 control take the class from the file.  The
plain ``ActorCriticCNN`` against the port's, the CSE build against the
parent's, and a conv + GRU cell written as data files only into a folder of
its own, checked at 8 envs on 2 x 2 tiles on the CPU."""

import contextlib
import json
import os
from types import SimpleNamespace

import pytest
import torch

from benchmark import build, compare, control, manifest, program
from benchmark.reference import train as reference
from benchmark.reference.plain.learn import POLICIES

from .conftest import small

VARIANTS = {"mlp": (False, False), "mlp-gru": (False, True), "conv": (True, False),
            "conv-gru": (True, True)}


def cnn_ac(use_cnn=True, use_gru=True) -> dict:
    """``ACCnnArgs`` of the tunnel's front-half scan, (2, 10, 11) of 261 obs."""
    return {"init_noise_std": 1.0, "max_noise_std": None,
            "actor_hidden_dims": [512, 256, 128], "critic_hidden_dims": [512, 256, 128],
            "activation": "elu", "adaptation_module_branch_hidden_dims": [256, 128],
            "use_decoder": False, "use_cnn": use_cnn, "use_gru": use_gru,
            "height_map_shape": [2, 10, 11], "cnn_num_embedding": 256,
            "gru_num_embedding": 256, "normalize_obs": False, "critic_detach_encoder": False}


def write_cnn_cell(root, frames: int, envs: int, name="tunnel-cnn-gru") -> str:
    """Files only, under ``root``: the tunnel configuration with the conv +
    GRU ``ActorCriticCNN`` over ``frames`` history frames, a traffic mix of
    ``envs`` envs on one rank, and the cell ``name`` with the tunnel cell's
    limits.  Returns the cell's name."""
    cfg = manifest.config("tunnel_cse")
    cfg = {**cfg, "name": "tunnel_cnn_gru", "policy": "ActorCriticCNN", "ac": cnn_ac(),
           "widths": {**cfg["widths"], "history_frames": frames},
           "cfg": {**cfg["cfg"], "env": {**cfg["cfg"]["env"],
                                         "num_observation_history": frames}}}
    traffic = {**manifest.traffic("train-4096"), "name": f"train-{envs}", "envs_per_rank": envs}
    cell = {"name": name, "config": cfg["name"], "traffic": traffic["name"], "chips": 1,
            "why": "the conv + GRU policy on the tunnel path",
            "limits": manifest.cell("tunnel-train-4096").limits}
    for kind, doc in (("configs", cfg), ("traffic", traffic), ("workloads", cell)):
        os.makedirs(os.path.join(root, kind), exist_ok=True)
        with open(os.path.join(root, kind, f"{doc['name']}.json"), "w") as f:
            json.dump(doc, f)
    return name


def widths(frames=3):
    return SimpleNamespace(num_obs=261, num_privileged_obs=8, num_obs_history=261 * frames,
                           num_actions=12)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_plain_cnn_matches_the_ports(variant):
    from legged_tracking_torch.learn.actor_critic_cnn import ACCnnArgs, ActorCriticCNN

    config = {"name": "cnn", "policy": "ActorCriticCNN", "ac": cnn_ac(*VARIANTS[variant])}
    env = widths()
    torch.manual_seed(11)
    plain = build.policy(POLICIES, config, env)
    torch.manual_seed(11)
    port = ActorCriticCNN(env.num_obs, env.num_privileged_obs, env.num_obs_history,
                          env.num_actions, ACCnnArgs(**config["ac"]))
    a, b = plain.state_dict(), port.state_dict()
    assert list(a) == list(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
    gen = torch.Generator().manual_seed(12)
    obs = torch.randn(8, env.num_obs, generator=gen)
    priv = torch.randn(8, env.num_privileged_obs, generator=gen)
    hist = torch.randn(8, env.num_obs_history, generator=gen)
    with torch.no_grad():
        for x, y in zip((*plain.action_dist(obs, priv, hist), plain.evaluate(obs, priv, hist)),
                        (*port.action_dist(obs, priv, hist), port.evaluate(obs, priv, hist))):
            torch.testing.assert_close(x, y, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["tunnel-train-4096", "velocity-train-4000"])
def test_build_gives_the_parents_cse_weights(name):
    """The parent built the CSE inside ``PPO`` from ``ACArgs``; the table's
    build gives the same weights bitwise at the same seed."""
    from legged_tracking_torch.learn.actor_critic import ACArgs
    from legged_tracking_torch.learn.ppo import PPO

    cell, overrides = small(manifest.cell(name))
    seed = 2 ** 31 + 23
    train = build.build(program.modules(), cell.config, cell.num_envs, seed, "cpu",
                        overrides=overrides)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(manifest.seeds(seed).init)
        parent = PPO(train.env, ac_args=ACArgs(**cell.config["ac"]))
    got, want = train.alg.ac.state_dict(), parent.ac.state_dict()
    assert type(train.alg.ac) is type(parent.ac) and list(got) == list(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_an_unknown_policy_names_the_known_ones():
    config = {"name": "x", "policy": "ActorCriticRNN", "ac": {}}
    with pytest.raises(ValueError, match="ActorCriticCNN.*ActorCriticCSE"):
        build.policy(POLICIES, config, widths())


@pytest.mark.parametrize("key", ["use_decoder", "critic_detach_encoder"])
def test_the_reference_refuses_what_the_plain_cnn_leaves_out(key):
    from benchmark.reference import learner

    ppo = manifest.config("tunnel_cse")["ppo"]
    cfg = SimpleNamespace(env=SimpleNamespace(num_eval_envs=0))
    learner.supported(ppo, cnn_ac(), cfg)
    with pytest.raises(ValueError, match=key):
        learner.supported(ppo, {**cnn_ac(), key: True}, cfg)


def test_the_cpu_control_rounds_dense_and_conv_operands():
    config = {"name": "cnn", "policy": "ActorCriticCNN", "ac": cnn_ac()}
    torch.manual_seed(3)
    ac = build.policy(POLICIES, config, widths())
    conv, dense = ac.height_map_encoder.Conv_1, ac.height_map_encoder.Dense_0
    x = torch.randn(4, 16, 5, 5, generator=torch.Generator().manual_seed(4))
    y = torch.randn(4, dense.in_features, generator=torch.Generator().manual_seed(5))
    r = reference.tf32_round
    with reference.precision(True, ac, torch.device("cpu")):
        low_conv, low_dense = conv(x), dense(y)
    assert torch.equal(low_conv, torch.nn.functional.conv2d(r(x), r(conv.weight), conv.bias,
                                                            padding=1))
    assert torch.equal(low_dense, torch.nn.functional.linear(r(y), r(dense.weight), dense.bias))
    assert not torch.equal(low_conv, conv(x)) and not torch.equal(low_dense, dense(y))


@contextlib.contextmanager
def chw_flatten():
    """A fault in the port's conv encoder: the conv output flattened
    channels-rows-columns where the policy reads rows-columns-channels."""
    from legged_tracking_torch.learn import actor_critic_cnn as m

    def forward(self, x):
        lead = x.shape[:-1]
        c, h, w = self.shape
        x = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
        x = torch.nn.functional.max_pool2d(torch.relu(self.Conv_0(x)), 2, 2)
        x = torch.nn.functional.max_pool2d(torch.relu(self.Conv_1(x)), 2, 2)
        return self.Dense_0(x.reshape(x.shape[0], -1)).reshape(lead + (self.num_embedding,))

    old = m.HeightMapEncoder.forward
    m.HeightMapEncoder.forward = forward
    try:
        yield
    finally:
        m.HeightMapEncoder.forward = old


def test_a_cnn_cell_is_data_files_only(tmp_path):
    """A conv + GRU configuration and its cell, written into a folder of
    their own with no edit to the benchmark, build, run and are checked
    within the tunnel cell's limits; with the fault planted, ``policy``
    fails."""
    cell, overrides = small(manifest.cell(write_cnn_cell(str(tmp_path), 3, 8), str(tmp_path)))
    seed, cpu = 2 ** 31 + 41, torch.device("cpu")
    got = control.readings(cell, seed, "program", cpu, overrides)
    g = control.check(cell, seed, got, cpu, overrides)
    correct, rows = compare.verdict(g, cell.limits)
    assert correct and g["start"] == 0.0, rows
    assert got["traj"]["obs_history"].shape[-1] == 3 * 261
    with chw_flatten():
        bad = control.readings(cell, seed, "program", cpu, overrides)
    g = control.check(cell, seed, bad, cpu, overrides)
    assert g["policy"] > cell.limits["policy"], g
