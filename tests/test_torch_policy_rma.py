"""The port's RMA teacher-student actor-critic (``learn/actor_critic_rma.py``)
against the JAX package's on the CPU: every head from carried-over flax
weights, one PPO minibatch update (the adaptation module regressing onto the
encoder's latent), checkpoints and ``policy.npz`` crossing between the two
Runners, and one whole ``train_iteration`` of the velocity env with the RMA
policy, the slice as a whole.

The policies have the velocity env's dimensions: 70 obs, 2 privileged obs,
a 30-frame history of 2,100 inputs, 12 actions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_support import (METRICS, N, VelocityDraws, heads_both_ways, install_velocity_draws,
                           max_err, params_errors, to_numpy, tree_rel_err, uninstall,
                           velocity_cfgs)

from legged_tracking_torch import convert
from legged_tracking_torch.envs.velocity_env import VelocityTrackingEnv as TEnv
from legged_tracking_torch.io.checkpoint import export_policy_npz
from legged_tracking_torch.learn import actor_critic_rma as t_rma
from legged_tracking_torch.learn import ppo as t_ppo
from legged_tracking_torch.learn.runner import Runner as TRunner
from legged_tracking_torch.learn.runner import RunnerArgs as TRunnerArgs
from legged_tracking_tpu.envs.velocity_env import VelocityTrackingEnv as JEnv
from legged_tracking_tpu.io.checkpoint import export_policy_npz as j_export_policy_npz
from legged_tracking_tpu.learn import actor_critic_rma as j_rma
from legged_tracking_tpu.learn import ppo as j_ppo
from legged_tracking_tpu.learn.runner import Runner as JRunner
from legged_tracking_tpu.learn.runner import RunnerArgs as JRunnerArgs

DIMS = dict(num_obs=70, num_privileged_obs=2, num_obs_history=2100, num_actions=12)
HEADS = ("mean", "std", "value", "adapt", "adaptation_target", "act_student", "act_teacher")


def policies(max_noise_std=None, seed=1):
    """The flax RMA policy and its port twin with the flax module's initial
    parameters carried over."""
    jm = j_rma.ActorCriticRMA(**DIMS, args=j_rma.ACRmaArgs(max_noise_std=max_noise_std))
    tm = t_rma.ActorCriticRMA(**DIMS, args=t_rma.ACRmaArgs(max_noise_std=max_noise_std))
    o, p, h = (jnp.zeros((1, DIMS[k])) for k in ("num_obs", "num_privileged_obs",
                                                  "num_obs_history"))
    params = jm.init(jax.random.key(seed), o, p, h)
    tm.load_state_dict(convert.flax_params_to_state_dict(jax.tree.map(np.asarray, params)))
    return jm, tm, params


def inputs(n, seed):
    """Random obs, privileged obs and histories (bf16 values, as stored)."""
    rng = np.random.RandomState(seed)
    o = rng.normal(size=(n, DIMS["num_obs"])).astype(np.float32)
    p = rng.normal(size=(n, DIMS["num_privileged_obs"])).astype(np.float32)
    h = np.asarray(jnp.asarray(rng.normal(size=(n, DIMS["num_obs_history"])), jnp.bfloat16),
                   np.float32)
    return o, p, h


@pytest.mark.parametrize("max_noise_std", [None, 0.5])
def test_rma_forward_matches_jax(max_noise_std):
    """Every head (action_dist's mean and std, evaluate, adapt,
    adaptation_target, act_student, act_teacher) on the same inputs from
    carried-over weights: float32 products summed in another order, so
    within atol 1e-5 on O(1) outputs (read 1.3e-6).  The std touches the
    floor and, with a ceiling of 0.5, the ceiling."""
    jm, tm, params = policies(max_noise_std)
    params["params"]["std"] = jnp.asarray(np.linspace(-1.2, 1.2, 12, dtype=np.float32))
    tm.std.data = torch.as_tensor(np.linspace(-1.2, 1.2, 12, dtype=np.float32))
    o, p, h = inputs(16, seed=0)
    m = j_rma.ActorCriticRMA
    want = jax.jit(lambda prm, o, p, h: (
        *jm.apply(prm, o, p, h, method=m.action_dist), jm.apply(prm, o, p, h, method=m.evaluate),
        jm.apply(prm, h, method=m.adapt), jm.apply(prm, p, method=m.adaptation_target),
        jm.apply(prm, o, h, method=m.act_student),
        jm.apply(prm, o, p, h, method=m.act_teacher)))(params, *map(jnp.asarray, (o, p, h)))
    to, tp, th = map(torch.as_tensor, (o, p, h))
    with torch.no_grad():
        got = (*tm.action_dist(to, tp, th), tm.evaluate(to, tp, th), tm.adapt(th),
               tm.adaptation_target(tp), tm.act_student(to, th), tm.act_teacher(to, tp, th))
    for name, g, w in zip(HEADS, got, want):
        assert tuple(g.shape) == tuple(np.shape(w)), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5, err_msg=name)
    assert float(np.abs(np.asarray(want[0])).max()) > 0.05


@pytest.mark.parametrize("max_noise_std", [None, 0.5])
def test_rma_action_dist_and_value_is_the_two_heads(max_noise_std):
    """``action_dist_and_value`` of the RMA policy runs ``action_dist`` then
    ``evaluate``, each with its own encoder pass: its outputs and the
    gradients of a loss over them equal theirs bitwise."""
    _, tm, _ = policies(max_noise_std)
    o, p, h = map(torch.as_tensor, inputs(16, seed=0))
    (two, two_grads), (one, one_grads) = heads_both_ways(tm, o, p, h)
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    assert all(torch.equal(one_grads[k], two_grads[k]) for k in two_grads)
    assert float(two_grads["env_factor_encoder.layers.0.weight"].abs().max()) > 0


def test_rma_minibatch_update_matches_jax():
    """One ``_minibatch_update`` on a random 40-sample batch made by the JAX
    policy, against the jitted JAX one: the PPO step under the clip and Adam
    (the encoder takes the actor's and the critic's gradient), then the
    adaptation substep, whose target is the encoder's latent on the
    post-step parameters, without its gradient.  Adam's first step moves
    every element by about the learning rate with the sign of its
    gradient, so an element whose gradient is a float32 cancellation
    residue can step the other way.  Read on the CPU: each leaf's rms
    parameter error over the rms distance it moved 9.2e-3 (the adaptation
    module's second layer, where 1 element of 8,192 stepped apart); the
    share of all elements more than 1e-4 apart 3.0e-6; the Adam moments
    within 4.1e-6 (PPO) and 9.8e-6 (adaptation) of each leaf's largest
    value; the losses within 3.6e-7; the learning rate bitwise.  The limits
    are 5 to 10 times that, as for the CSE and CNN policies."""
    jenv = object.__new__(JEnv)
    for k, v in DIMS.items():
        setattr(jenv, k, v)
    jenv.num_envs, jenv.cfg = 8, velocity_cfgs()[0]
    jm, tm, params = policies()
    jalg = j_ppo.PPO(jenv, ac=jm)
    talg = t_ppo.PPO(TEnv(velocity_cfgs(["--num_envs", "8", "--terrain", "plane"])[1],
                          device="cpu"), ac=tm)
    assert not talg.normalize_obs            # ACRmaArgs has no normalize_obs
    jts = jalg.init(jax.random.key(0))._replace(params=params)
    jts_np = jax.tree.map(np.asarray, jts)
    tts = convert.train_state_from_numpy(jts_np, talg, device="cpu")

    n = 40
    o, p, h = inputs(n, seed=1)
    rng = np.random.RandomState(2)
    m = j_rma.ActorCriticRMA
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
    tol = {"opt_state": 3e-5, "adapt_opt_state": 1e-4, "leaf_rms_rel": 5e-2,
           "frac_over_1e-4": 3e-5, **{k: 5e-6 for k in METRICS}}
    bad = {k: (errs[k], tol[k]) for k in tol if not errs[k] <= tol[k]}
    assert not bad, (bad, errs)
    # the adaptation module moved, and the encoder with the PPO step alone
    for branch in ("adaptation_module", "env_factor_encoder"):
        assert max_err(back.params["params"][branch]["Dense_0"]["kernel"],
                       jts_np.params["params"][branch]["Dense_0"]["kernel"]) > 0, branch


def test_rma_checkpoints_cross_between_runners(tmp_path):
    """An RMA checkpoint the port's Runner writes loads into the JAX Runner
    (the flax tree with ``env_factor_encoder``), bitwise, and its student
    acts alike through the flax module; a JAX checkpoint loads into the
    port's Runner; the port's ``policy.npz`` equals the JAX export."""
    jm, tm, _ = policies()
    tenv = TEnv(velocity_cfgs(["--num_envs", "8", "--terrain", "plane"])[1], device="cpu")
    runner = TRunner(tenv, runner_args=TRunnerArgs(num_steps_per_env=4), ac=tm, seed=0)
    sd = {k: v.detach().clone() for k, v in runner.train_state.params.items()}
    runner.save(str(tmp_path / "port.pkl"))

    jenv = object.__new__(JEnv)
    for k, v in DIMS.items():
        setattr(jenv, k, v)
    jenv.num_envs, jenv.cfg = 8, velocity_cfgs()[0]
    jr = object.__new__(JRunner)
    jr.runner_args, jr.env_state = JRunnerArgs(), None
    fresh = j_ppo.PPO(jenv, ac=jm).init(jax.random.key(0))
    jr.train_state = fresh
    jr.load(str(tmp_path / "port.pkl"))
    loaded = jax.tree.map(np.asarray, jr.train_state.params)
    assert jax.tree.structure(loaded) == jax.tree.structure(fresh.params)
    flat = convert.flax_params_to_state_dict(loaded)
    assert sorted(flat) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(flat[k].numpy(), sd[k].numpy(), err_msg=k)
    o, p, h = inputs(8, seed=3)
    want = np.asarray(jm.apply(jr.train_state.params, jnp.asarray(o), jnp.asarray(h),
                               method=j_rma.ActorCriticRMA.act_student))
    with torch.no_grad():
        got = runner.alg.ac.act_student(torch.as_tensor(o), torch.as_tensor(h)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    rng = np.random.RandomState(4)
    jr.train_state = jr.train_state._replace(
        params=jax.tree.map(lambda x: rng.normal(size=np.shape(x)).astype(np.float32),
                            jr.train_state.params), iteration=np.int32(5))
    jr.env_state = type("S", (), {"curriculum_weights": None, "target_dist": jnp.asarray(0.0)})()
    jr.save(str(tmp_path / "jax.pkl"))
    runner.load(str(tmp_path / "jax.pkl"))
    want_sd = convert.flax_params_to_state_dict(jax.tree.map(np.asarray, jr.train_state.params))
    for k, v in runner.train_state.params.items():
        np.testing.assert_array_equal(v.detach().numpy(), want_sd[k].numpy(), err_msg=k)
    assert runner.train_state.iteration == 5

    meta = {"num_obs": tenv.num_obs, "num_actions": tenv.num_actions}
    ours = dict(np.load(export_policy_npz(str(tmp_path / "port.npz"), sd, meta=meta)))
    theirs = dict(np.load(j_export_policy_npz(str(tmp_path / "jax.npz"),
                                              convert.state_dict_to_flax_params(sd), meta=meta)))
    assert sorted(ours) == sorted(theirs)
    assert ours["params/env_factor_encoder/Dense_2/kernel"].shape == (128, 18)
    for k, v in ours.items():
        np.testing.assert_array_equal(v, theirs[k], err_msg=k)


def test_velocity_rma_train_iteration_matches_jax():
    """One whole ``train_iteration`` of the velocity env with the RMA policy
    (4 envs, T = 4 with a curriculum resample every 2 steps and 3-step
    episodes; GAE; 5 epochs x 2 minibatches) against the jitted JAX one
    from the same state and parameters, under the JAX env's draws, JAX's
    action normals and its permutation: the slice as a whole.  Read on the
    CPU: base positions equal, the last obs within 8.3e-7, the curriculum
    weights, bins, categories and commands bitwise, the episodic metrics
    within 4.5e-8 and the episode counts equal, the losses within 8.0e-7
    (relative, or absolute below 1), the Adam moments within 1.4e-5 (PPO)
    and 6.0e-6 (adaptation) of each leaf's largest value, each leaf's rms
    parameter error within 1.2e-4 of the distance it moved, no element
    more than 1e-4 apart; the learning rate bitwise.  The limits are 5 to
    10 times that (1e-6 for the base positions)."""
    T = 4
    jcfg, tcfg = velocity_cfgs()
    jenv, tenv = JEnv(jcfg, seed=3), TEnv(tcfg, seed=3, device="cpu")
    jm, tm, params = policies()
    # 2 minibatches of 8 samples, so that the adaptation module's 80/20
    # split has a train part (6 of 8 samples; of 4 samples it has none)
    jalg = j_ppo.PPO(jenv, ac=jm, args=j_ppo.PPOArgs(num_steps_per_env=T, num_mini_batches=2))
    talg = t_ppo.PPO(tenv, ac=tm, args=t_ppo.PPOArgs(num_steps_per_env=T, num_mini_batches=2))
    jts = jalg.init(jax.random.key(0))._replace(params=params)
    jts_np = jax.tree.map(np.asarray, jts)
    tts = convert.train_state_from_numpy(jts_np, talg, device="cpu")
    key = jax.random.key(5)
    jstate = jenv._reset_jit(key, True)
    jobs = jenv._observe_jit(jstate)
    ikey = jax.random.key(9)
    k_roll, k_update = jax.random.split(ikey)
    noise = np.stack([np.asarray(jax.random.normal(k, (N, jenv.num_actions)))
                      for k in jax.random.split(k_roll, T)])
    perm = np.asarray(jax.random.permutation(k_update, T * N))

    install_velocity_draws(tenv, VelocityDraws(key, N))
    try:
        tstate = convert.env_state_from_numpy(to_numpy(jstate), device="cpu")
        tts2, tstate2, tobs2, tmet = talg.train_iteration(
            tts, tstate, tenv.observe(tstate), action_noise=torch.as_tensor(noise),
            perm=torch.as_tensor(perm))
    finally:
        uninstall(tenv)
    jts2, jstate2, jobs2, jmet = jalg.train_iteration_jit(jts, jstate, jobs, ikey)
    jmet.pop("video")
    jts2 = jax.tree.map(np.asarray, jts2)
    back = convert.train_state_to_numpy(tts2, jts2)

    for k in ("curriculum_weights", "env_command_bins", "env_command_categories", "commands",
              "episode_length"):
        np.testing.assert_array_equal(getattr(tstate2, k).numpy(), np.asarray(getattr(jstate2, k)),
                                      err_msg=k)
    assert set(tmet) == set(jmet)
    assert int(jmet["num_episodes"]) > 0
    errs = {k: max_err(tmet[k].numpy(), jmet[k]) for k in tmet}
    errs.update({"params": params_errors(back.params, jts2.params, jts_np.params),
                 "opt_state": tree_rel_err(back.opt_state, jts2.opt_state),
                 "adapt_opt_state": tree_rel_err(back.adapt_opt_state, jts2.adapt_opt_state),
                 "obs": max_err(tobs2["obs"].numpy(), jobs2["obs"]),
                 "base_pos": max_err(tstate2.phys.base_pos.numpy(), jstate2.phys.base_pos)})
    tol = {"params": {"leaf_rms_rel": 1e-3, "frac_over_1e-4": 1e-6}, "opt_state": 1.5e-4,
           "adapt_opt_state": 6e-5, "obs": 5e-6, "base_pos": 1e-6}
    for k in tmet:
        if k in METRICS:
            errs[k] /= max(abs(float(jmet[k])), 1.0)
        tol[k] = (5e-6 if k in METRICS else 0.0 if k.endswith(("num_episodes", "learning_rate"))
                  else 5e-7)
    bad = {k: (v, tol[k]) for k, v in errs.items()
           if (any(v[x] > tol[k][x] for x in v) if isinstance(v, dict) else not v <= tol[k])}
    assert not bad, (bad, errs)
