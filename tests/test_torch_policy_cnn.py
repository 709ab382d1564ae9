"""The port's CNN/GRU actor-critic (``learn/actor_critic_cnn.py``) against the
JAX package's on the CPU: the forward pass of the four variants from
carried-over flax weights, one PPO minibatch update, and checkpoints and
``policy.npz`` crossing between the two packages' Runners.

The policies are those of the goal recipe's configuration (2x2 tiles,
4 envs), with a 3-frame history so that the GRU's hidden weights take part."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_support import (METRICS, goal_cfgs, heads_both_ways, max_err, params_errors,
                           tree_rel_err)

from legged_tracking_torch import convert
from legged_tracking_torch.envs import LeggedEnv as TEnv
from legged_tracking_torch.io.checkpoint import export_policy_npz
from legged_tracking_torch.learn import actor_critic_cnn as t_cnn
from legged_tracking_torch.learn import ppo as t_ppo
from legged_tracking_torch.learn.runner import Runner as TRunner
from legged_tracking_torch.learn.runner import RunnerArgs as TRunnerArgs
from legged_tracking_tpu.envs import LeggedEnv as JEnv
from legged_tracking_tpu.io.checkpoint import export_policy_npz as j_export_policy_npz
from legged_tracking_tpu.learn import actor_critic_cnn as j_cnn
from legged_tracking_tpu.learn import ppo as j_ppo
from legged_tracking_tpu.learn.runner import Runner as JRunner
from legged_tracking_tpu.learn.runner import RunnerArgs as JRunnerArgs

HISTORY = 3
VARIANTS = [(False, False), (True, False), (False, True), (True, True)]
VARIANT_IDS = ["mlp", "conv", "mlp_gru", "conv_gru"]


@pytest.fixture(scope="module")
def world():
    """The goal recipe's env in both packages (built, never stepped)."""
    jcfg, tcfg = goal_cfgs(num_envs=4)
    for cfg in (jcfg, tcfg):
        cfg.env.num_observation_history = HISTORY
    return JEnv(jcfg, seed=3), TEnv(tcfg, seed=3, device="cpu")


def policies(env, use_cnn, use_gru, critic_detach_encoder=False):
    """The flax policy and its port twin, as ``scripts/train.py`` builds
    them for this env (``--cnn``, ``--gru``), with the flax module's
    initial parameters carried over into the port's."""
    jenv, tenv = env
    hm = (2, 10, 11)                # the front half of the 21 x 11 scan grid
    dims = dict(num_obs=jenv.num_obs, num_privileged_obs=jenv.num_privileged_obs,
                num_obs_history=jenv.num_obs_history, num_actions=jenv.num_actions)
    kw = dict(use_cnn=use_cnn, use_gru=use_gru, height_map_shape=hm, max_noise_std=1.0,
              critic_detach_encoder=critic_detach_encoder)
    jm = j_cnn.ActorCriticCNN(**dims, args=j_cnn.ACCnnArgs(**kw))
    tm = t_cnn.ActorCriticCNN(**dims, args=t_cnn.ACCnnArgs(**kw))
    o, p, h = (jnp.zeros((1, n)) for n in (dims["num_obs"], dims["num_privileged_obs"],
                                           dims["num_obs_history"]))
    params = jm.init(jax.random.key(1), o, p, h)
    tm.load_state_dict(convert.flax_params_to_state_dict(jax.tree.map(np.asarray, params)))
    return jm, tm, params


def inputs(env, n, seed):
    """Random obs, privileged obs and histories (bf16 values, as stored)."""
    jenv, _ = env
    rng = np.random.RandomState(seed)
    o = rng.normal(size=(n, jenv.num_obs)).astype(np.float32)
    p = rng.normal(size=(n, jenv.num_privileged_obs)).astype(np.float32)
    h = np.asarray(jnp.asarray(rng.normal(size=(n, jenv.num_obs_history)), jnp.bfloat16),
                   np.float32)
    return o, p, h


@pytest.mark.parametrize("use_cnn,use_gru", VARIANTS, ids=VARIANT_IDS)
def test_forward_matches_jax(world, use_cnn, use_gru):
    """Every head of the four variants on the same inputs from carried-over
    weights, float32 on both sides: the same products and convolutions
    summed in another order, so agreement to atol 1e-5 on O(1) outputs
    (1.2e-6 read).  The conv variant reads the height block in the JAX
    module's (h, w, c) order and flattens in HWC order: a port that reads it
    channel-major, or flattens CHW, misses by 0.76 to 1.5."""
    jm, tm, params = policies(world, use_cnn, use_gru)
    o, p, h = inputs(world, 16, seed=0)
    jo, jp, jh = map(jnp.asarray, (o, p, h))
    to, tp, th = map(torch.as_tensor, (o, p, h))
    m = j_cnn.ActorCriticCNN
    apply = jax.jit(lambda prm, o, p, h: (
        *jm.apply(prm, o, p, h, method=m.action_dist), jm.apply(prm, o, p, h, method=m.evaluate),
        jm.apply(prm, h, method=m.adapt), jm.apply(prm, o, h, method=m.act_student),
        jm.apply(prm, o, p, h, method=m.act_teacher)))
    want = apply(params, jo, jp, jh)
    with torch.no_grad():
        got = (*tm.action_dist(to, tp, th), tm.evaluate(to, tp, th), tm.adapt(th),
               tm.act_student(to, th), tm.act_teacher(to, tp, th))
    names = ("mean", "std", "value", "adapt", "act_student", "act_teacher")
    for name, g, w in zip(names, got, want):
        assert tuple(g.shape) == tuple(np.shape(w)), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5, err_msg=name)
    assert float(np.abs(np.asarray(want[0])).max()) > 0.05


@pytest.mark.parametrize("use_cnn,use_gru,detach",
                         [(False, False, False), (True, False, False), (False, True, False),
                          (True, True, False), (True, True, True)],
                         ids=[*VARIANT_IDS, "conv_gru_detach"])
def test_action_dist_and_value_shares_one_history_pass(world, use_cnn, use_gru, detach):
    """``action_dist_and_value`` runs the encoder and the GRU once for both
    heads: its mean, std and value equal ``action_dist``'s and
    ``evaluate``'s bitwise, and the gradients of a loss over them, which
    now meet at the shared pass before they reach its weights, agree
    within 1e-6 of each leaf's largest element."""
    _, tm, _ = policies(world, use_cnn, use_gru, critic_detach_encoder=detach)
    o, p, h = map(torch.as_tensor, inputs(world, 16, seed=0))
    (two, two_grads), (one, one_grads) = heads_both_ways(tm, o, p, h)
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    for k, want in two_grads.items():
        err = float((one_grads[k] - want).abs().max())
        assert err <= 1e-6 * float(want.abs().max()), (k, err)
    assert float(two_grads["height_map_encoder.Dense_0.weight"].abs().max()) > 0


@pytest.mark.parametrize("use_cnn", [False, True], ids=["mlp_gru", "conv_gru"])
@pytest.mark.parametrize("detach", [False, True], ids=["attached", "detached"])
def test_value_loss_reaches_the_encoder_unless_detached(world, use_cnn, detach):
    """With ``critic_detach_encoder`` the value alone gives the height
    encoder and the GRU a zero gradient through the shared pass; without
    it, every one of their leaves takes a gradient from the value."""
    _, tm, _ = policies(world, use_cnn, True, critic_detach_encoder=detach)
    o, p, h = map(torch.as_tensor, inputs(world, 16, seed=0))
    names, params = zip(*tm.named_parameters())
    value = tm.action_dist_and_value(o, p, h)[2]
    grads = torch.autograd.grad(value.square().mean(), params, allow_unused=True,
                                materialize_grads=True)
    shared = {k: g for k, g in zip(names, grads)
              if k.startswith(("height_map_encoder.", "gru."))}
    assert len(shared) >= 8
    assert all(bool((g == 0).all()) != (not detach) for g in shared.values()), {
        k: float(g.abs().max()) for k, g in shared.items()}


@pytest.mark.parametrize("cin,cout,h,w", [(2, 16, 10, 11), (16, 32, 5, 5), (2, 16, 21, 11)])
def test_conv3x3_gradients_match_conv2d(cin, cout, h, w):
    """The encoder's conv Function (``learn/conv3x3.py``: ``F.conv2d``
    forward and input gradient, the weight and bias gradients from W1's
    plain version on the CPU) against ``nn.Conv2d`` autograd on 6 frames
    of a channels-last map, as the encoder lays it out: the forward and
    the input gradient bitwise, the weight and bias gradients, one product
    over the unfolded input against the library's, within 1e-6 of their
    largest element (1.9e-7 to 4.1e-7 read)."""
    g = torch.Generator().manual_seed(cin * 100 + h)
    conv = torch.nn.Conv2d(cin, cout, 3, padding=1)
    x = torch.randn(6, h, w, cin, generator=g).permute(0, 3, 1, 2).requires_grad_(True)
    dy = torch.randn(6, cout, h, w, generator=g)
    want_y = conv(x)
    want = torch.autograd.grad(want_y, (x, conv.weight, conv.bias), dy)
    got_y = t_cnn.conv3x3(x, conv.weight, conv.bias)
    got = torch.autograd.grad(got_y, (x, conv.weight, conv.bias), dy)
    assert torch.equal(got_y, want_y) and torch.equal(got[0], want[0])
    for name, a, b in zip(("weight", "bias"), got[1:], want[1:]):
        assert a.shape == b.shape, name
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max()), name


@pytest.mark.parametrize("use_cnn,use_gru,detach", [(False, False, False), (True, True, False),
                                                    (True, True, True)],
                         ids=["mlp", "conv_gru", "conv_gru_detach"])
def test_minibatch_update_matches_jax(world, use_cnn, use_gru, detach):
    """One ``_minibatch_update`` (the PPO step under the clip and Adam, then
    the adaptation substep, whose gradient reaches the shared encoder and
    GRU) on a random 32-sample batch made by the JAX policy, against the
    jitted JAX one.  Adam's first step moves every element by about the
    learning rate with the sign of its gradient, so an element whose
    gradient is a float32 cancellation residue can step the other way; with
    ``critic_detach_encoder`` the encoder and GRU take the policy loss's
    gradient alone, smaller, and more of them do.  Read on the CPU (mlp,
    conv_gru, conv_gru_detach): each leaf's rms parameter error over the
    rms distance it moved 2.9e-3, 5.6e-4, 1.1e-2; the share of elements
    more than 1e-4 apart 4.3e-6, 8.2e-7, 4.7e-5; the Adam moments within
    5.3e-6 (PPO) and 4.1e-4 (adaptation) of each leaf's largest value; the
    losses within 7.1e-6; the learning rate bitwise.  The limits are 5 to
    10 times that."""
    jenv, tenv = world
    jm, tm, params = policies(world, use_cnn, use_gru, critic_detach_encoder=detach)
    jalg = j_ppo.PPO(jenv, ac=jm)
    talg = t_ppo.PPO(tenv, ac=tm)
    jts = jalg.init(jax.random.key(0))._replace(params=params)
    jts_np = jax.tree.map(np.asarray, jts)
    tts = convert.train_state_from_numpy(jts_np, talg, device="cpu")

    n = 32
    o, p, h = inputs(world, n, seed=1)
    rng = np.random.RandomState(2)
    m = j_cnn.ActorCriticCNN
    mean, std = jm.apply(params, o, p, h, method=m.action_dist)
    std = jnp.broadcast_to(std, mean.shape)
    actions = mean + std * jnp.asarray(rng.normal(size=mean.shape), jnp.float32)
    values = jm.apply(params, o, p, h, method=m.evaluate)
    log_prob = j_ppo.normal_log_prob(mean, std, actions)
    advantages = jnp.asarray(rng.normal(size=n), jnp.float32)
    returns = values + jnp.asarray(rng.normal(size=n), jnp.float32)
    batch = [jnp.asarray(x) for x in (o, h, p, actions, values, advantages, returns, log_prob,
                                      mean, std)]
    carry = (jts.params, jts.opt_state, jts.adapt_opt_state, jts.learning_rate)
    (jparams, jopt, jadapt, jlr), jstats = jax.jit(jalg._minibatch_update)(carry, batch)

    tts2, tstats = talg._minibatch_update(tts, [torch.as_tensor(np.array(x)) for x in batch])
    jts2 = jax.tree.map(np.asarray, jts._replace(params=jparams, opt_state=jopt,
                                                 adapt_opt_state=jadapt, learning_rate=jlr))
    back = convert.train_state_to_numpy(tts2, jts2)
    assert float(back.learning_rate) == float(jlr)
    errs = {"opt_state": tree_rel_err(back.opt_state, jts2.opt_state),
            "adapt_opt_state": tree_rel_err(back.adapt_opt_state, jts2.adapt_opt_state),
            **params_errors(back.params, jts2.params, jts_np.params)}
    errs.update({k: max_err(tstats[i].numpy(), jstats[i]) / max(abs(float(jstats[i])), 1.0)
                 for i, k in enumerate(METRICS)})
    tol = {"opt_state": 5e-5, "adapt_opt_state": 4e-3, "leaf_rms_rel": 6e-2,
           "frac_over_1e-4": 3e-4, **{k: 5e-5 for k in METRICS}}
    bad = {k: (errs[k], tol[k]) for k in tol if not errs[k] <= tol[k]}
    assert not bad, (bad, errs)
    # the encoder moved, in both packages
    enc = "height_map_encoder"
    moved = max_err(back.params["params"][enc]["Dense_0"]["kernel"],
                    jts_np.params["params"][enc]["Dense_0"]["kernel"])
    assert moved > 0


def test_checkpoints_cross_between_runners(world, tmp_path):
    """A checkpoint the port's Runner writes for the conv+GRU policy loads
    into the JAX Runner (the flax tree, HWIO conv kernels and the GRU gates
    by name; the JAX Runner keeps fresh Adam moments for a checkpoint
    without optax states), and a JAX checkpoint with Adam moments loads
    into the port's Runner, moments included, bitwise both ways.  The
    port's ``policy.npz`` equals the JAX export of the same parameters, and
    its parameters give the port's actions through the flax module."""
    jenv, tenv = world
    jm, tm, _ = policies(world, True, True)
    runner = TRunner(tenv, runner_args=TRunnerArgs(num_steps_per_env=4), ac=tm, seed=0)
    sd = {k: v.detach().clone() for k, v in runner.train_state.params.items()}
    runner.save(str(tmp_path / "port.pkl"))

    # the JAX Runner's load and save, on its train state for the same
    # module (the env's reset and observe, which the Runner's constructor
    # would compile, play no part in them)
    jr = object.__new__(JRunner)
    jr.runner_args, jr.env_state = JRunnerArgs(), None
    jalg = j_ppo.PPO(jenv, ac=jm)
    fresh = jalg.init(jax.random.key(0))
    jr.train_state = fresh
    jr.load(str(tmp_path / "port.pkl"))
    loaded = jax.tree.map(np.asarray, jr.train_state.params)
    assert jax.tree.structure(loaded) == jax.tree.structure(fresh.params)
    flat = convert.flax_params_to_state_dict(loaded)
    assert sorted(flat) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(flat[k].numpy(), sd[k].numpy(), err_msg=k)
    o, p, h = inputs(world, 8, seed=3)
    want = np.asarray(jm.apply(jr.train_state.params, jnp.asarray(o), jnp.asarray(h),
                               method=j_cnn.ActorCriticCNN.act_student))
    with torch.no_grad():
        got = runner.alg.ac.act_student(torch.as_tensor(o), torch.as_tensor(h)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)

    # JAX -> port, with nonzero Adam moments and a moved iteration
    rng = np.random.RandomState(4)
    rand = lambda x: rng.normal(size=np.shape(x)).astype(np.float32)
    ts = jax.tree.map(np.asarray, jr.train_state)
    adam = lambda s: s._replace(count=np.int32(3), mu=jax.tree.map(rand, s.mu),
                                nu=jax.tree.map(lambda x: np.abs(rand(x)), s.nu))
    inject = ts.opt_state[1]
    jr.train_state = ts._replace(
        params=jax.tree.map(rand, ts.params),
        opt_state=(ts.opt_state[0], inject._replace(
            inner_state=(adam(inject.inner_state[0]), inject.inner_state[1]))),
        adapt_opt_state=(adam(ts.adapt_opt_state[0]), ts.adapt_opt_state[1]),
        learning_rate=np.float32(4e-4), iteration=np.int32(7))
    jr.save(str(tmp_path / "jax.pkl"), target_dist=1.5)
    runner.load(str(tmp_path / "jax.pkl"))
    tts, jts = runner.train_state, jr.train_state
    want_sd = convert.flax_params_to_state_dict(jts.params)
    for k, v in tts.params.items():
        np.testing.assert_array_equal(v.detach().numpy(), want_sd[k].numpy(), err_msg=k)
    assert tts.iteration == 7 and float(tts.learning_rate) == np.float32(4e-4)
    for got_s, want_s in ((tts.opt_state, jts.opt_state[1].inner_state[0]),
                          (tts.adapt_opt_state, jts.adapt_opt_state[0])):
        assert got_s.count == 3
        for name in ("mu", "nu"):
            want_m = convert.flax_params_to_state_dict(getattr(want_s, name))
            for k, v in getattr(got_s, name).items():
                np.testing.assert_array_equal(v.numpy(), want_m[k].numpy(), err_msg=k)
    with open(tmp_path / "jax.pkl", "rb") as f:
        assert pickle.load(f)["target_dist"] == 1.5

    # policy.npz: the JAX export's keys and values; back to the flax tree
    meta = {"num_obs": tenv.num_obs, "num_actions": tenv.num_actions}
    ours = dict(np.load(export_policy_npz(str(tmp_path / "port.npz"), sd, meta=meta)))
    theirs = dict(np.load(j_export_policy_npz(str(tmp_path / "jax.npz"),
                                              convert.state_dict_to_flax_params(sd),
                                              meta=meta)))
    assert sorted(ours) == sorted(theirs)
    assert ours["params/height_map_encoder/Conv_0/kernel"].shape == (3, 3, 2, 16)
    assert "params/gru/hn/bias" in ours and "params/gru/hr/bias" not in ours
    tree = {}
    for k, v in ours.items():
        np.testing.assert_array_equal(v, theirs[k], err_msg=k)
        if k.startswith("params/"):
            node = tree
            *path, leaf = k.split("/")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = v
    want = np.asarray(jm.apply(tree, jnp.asarray(o), jnp.asarray(h),
                               method=j_cnn.ActorCriticCNN.act_student))
    with torch.no_grad():
        tm.load_state_dict(sd)
        got = tm.act_student(torch.as_tensor(o), torch.as_tensor(h)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
