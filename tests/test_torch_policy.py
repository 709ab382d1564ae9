"""Parity of the port's policy and rollout with the JAX package on the CPU.

The flax ``ActorCriticCSE`` parameters are carried into the torch module by
``convert.flax_params_to_state_dict``; both then see the same inputs.  The
rollout test injects JAX's action normals and the JAX env's draws, so the
port's ``PPO.rollout`` and the JAX ``PPO.rollout`` act on the same numbers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_support import (N, JaxDraws, bench_cfg, carry_over, heads_both_ways,
                           install_jax_draws, to_numpy)

from legged_tracking_torch import convert
from legged_tracking_torch.config import Cfg as TCfg
from legged_tracking_torch.config import config_go1 as t_config_go1
from legged_tracking_torch.envs import LeggedEnv as TEnv
from legged_tracking_torch.learn import actor_critic as t_ac
from legged_tracking_torch.learn import ppo as t_ppo
from legged_tracking_tpu.config import Cfg, config_go1
from legged_tracking_tpu.envs import LeggedEnv as JEnv
from legged_tracking_tpu.learn import actor_critic as j_ac
from legged_tracking_tpu.learn import ppo as j_ppo


@pytest.mark.parametrize("max_noise_std", [None, 0.5])
def test_policy_outputs_match_after_carry_over(max_noise_std):
    """Every head of the CSE actor-critic on the same inputs, float32 on
    both sides: the same products summed in another order, so agreement to
    atol 1e-5 on O(1) outputs."""
    dims = dict(num_obs=20, num_privileged_obs=7, num_obs_history=60, num_actions=12)
    jm = j_ac.ActorCriticCSE(**dims, args=j_ac.ACArgs(max_noise_std=max_noise_std))
    rng = np.random.RandomState(0)
    o, p, h = (rng.normal(size=(16, n)).astype(np.float32)
               for n in (dims["num_obs"], dims["num_privileged_obs"], dims["num_obs_history"]))
    params = jm.init(jax.random.key(1), *map(jnp.asarray, (o[:1], p[:1], h[:1])))
    # a std that the floor and the ceiling both touch
    params["params"]["std"] = jnp.asarray(np.linspace(-1.2, 1.2, 12, dtype=np.float32))
    tm = carry_over(jm, params, **dims)
    jo, jp, jh = map(jnp.asarray, (o, p, h))
    to, tp, th = map(torch.as_tensor, (o, p, h))

    def close(t, j, name, rtol=0.0, atol=1e-5):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol,
                                   err_msg=name)

    mean_j, std_j = jm.apply(params, jo, jp, jh, method=j_ac.ActorCriticCSE.action_dist)
    mean_t, std_t = tm.action_dist(to, tp, th)
    close(mean_t, mean_j, "mean")
    close(std_t, std_j, "std")
    close(tm.evaluate(to, tp, th),
          jm.apply(params, jo, jp, jh, method=j_ac.ActorCriticCSE.evaluate), "value")
    close(tm.adapt(th), jm.apply(params, jh, method=j_ac.ActorCriticCSE.adapt), "adapt")
    close(tm.act_student(to, th),
          jm.apply(params, jo, jh, method=j_ac.ActorCriticCSE.act_student), "student")
    close(tm.act_teacher(to, tp, th),
          jm.apply(params, jo, jp, jh, method=j_ac.ActorCriticCSE.act_teacher), "teacher")
    a = rng.normal(size=(16, 12)).astype(np.float32)
    close(t_ac.normal_log_prob(mean_t, std_t, torch.as_tensor(a)),
          j_ac.normal_log_prob(mean_j, std_j, jnp.asarray(a)), "log_prob",
          rtol=2e-6, atol=0.0)   # sums of 12 terms of up to O(100): a few float32 ulps
    close(t_ac.normal_entropy(std_t), j_ac.normal_entropy(std_j), "entropy")


@pytest.mark.parametrize("max_noise_std", [None, 0.5])
def test_action_dist_and_value_is_the_two_heads(max_noise_std):
    """``action_dist_and_value`` of the CSE policy runs ``action_dist`` then
    ``evaluate``: its outputs and the gradients of a loss over them equal
    theirs bitwise."""
    torch.manual_seed(0)
    ac = t_ac.ActorCriticCSE(20, 7, 60, 12, t_ac.ACArgs(max_noise_std=max_noise_std))
    o, p, h = torch.randn(16, 20), torch.randn(16, 7), torch.randn(16, 60)
    (two, two_grads), (one, one_grads) = heads_both_ways(ac, o, p, h)
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    assert all(torch.equal(one_grads[k], two_grads[k]) for k in two_grads)


def test_rollout_matches_with_injected_normals():
    """A 3-step rollout of the port's PPO against the JAX ``PPO.rollout``
    from the same reset state, with the same parameters, action normals and
    env draws.  Step 0 sees identical inputs, so its policy outputs agree to
    1e-5 (float32 reordering).  Later steps inherit the env's physics
    differences and are held to tests/test_lane_engine.py:443-446 (obs
    1e-2, rew 5e-2); dones are exact."""
    T = 3
    jenv = JEnv(bench_cfg(Cfg, config_go1), seed=3)
    tenv = TEnv(bench_cfg(TCfg, t_config_go1), seed=3, device="cpu")
    key = jax.random.key(5)
    jstate = jenv._reset_jit(key, True)
    jobs = jenv._observe_jit(jstate)

    jalg = j_ppo.PPO(jenv, args=j_ppo.PPOArgs(num_steps_per_env=T))
    params = jalg.init(jax.random.key(0)).params
    dims = dict(num_obs=jenv.num_obs, num_privileged_obs=jenv.num_privileged_obs,
                num_obs_history=jenv.num_obs_history, num_actions=jenv.num_actions)
    talg = t_ppo.PPO(tenv, args=t_ppo.PPOArgs(num_steps_per_env=T),
                     ac=carry_over(jalg.ac, params, **dims))

    rkey = jax.random.key(9)
    _, _, jtraj, _, _ = jalg.rollout(params, jstate, jobs, rkey)
    noise = np.stack([np.asarray(jax.random.normal(k, (N, jenv.num_actions)))
                      for k in jax.random.split(rkey, T)])

    install_jax_draws(tenv, JaxDraws(key, N))
    try:
        tstate = convert.env_state_from_numpy(to_numpy(jstate), device="cpu")
        _, _, ttraj, metrics, _ = talg.rollout(tstate, tenv.observe(tstate),
                                               action_noise=torch.as_tensor(noise))
    finally:
        del tenv.draw, tenv.step_fn

    assert metrics["done"].shape == (T, N)
    np.testing.assert_array_equal(ttraj.dones.numpy(), np.asarray(jtraj.dones))
    for name in ("mu", "values", "actions", "log_prob", "sigma"):
        np.testing.assert_allclose(getattr(ttraj, name)[0].numpy(),
                                   np.asarray(getattr(jtraj, name)[0]), rtol=0, atol=1e-5,
                                   err_msg=f"{name} at step 0")
    for name, atol in (("obs", 1e-2), ("obs_history", 1e-2), ("privileged_obs", 1e-5),
                       ("mu", 1e-2), ("actions", 1e-2), ("values", 1e-2),
                       ("log_prob", 1e-4), ("sigma", 0), ("rewards", 5e-2)):
        t = getattr(ttraj, name).float().numpy()
        j = np.asarray(getattr(jtraj, name), np.float32)
        np.testing.assert_allclose(t, j, rtol=0, atol=atol, err_msg=name)
