"""Parity of the port's PPO update with the JAX package on the CPU.

The JAX side runs jitted, as its own tests run it; the port runs on the
CPU, where every kernel wrapper uses its plain version.  Parameters and
optimizer states go across through ``convert``; the port is fed JAX's
action normals, its minibatch permutation and, for a whole iteration, the
JAX env's draws (``JaxDraws``), so both sides compute on the same numbers
and differ only by float32 sums taken in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_env import JaxDraws, bench_cfg, install, to_numpy
from test_torch_policy import carry_over

from legged_tracking_torch import convert
from legged_tracking_torch.config import Cfg as TCfg
from legged_tracking_torch.config import config_go1 as t_config_go1
from legged_tracking_torch.envs import LeggedEnv as TEnv
from legged_tracking_torch.learn import actor_critic as t_ac
from legged_tracking_torch.learn import ppo as t_ppo
from legged_tracking_torch.learn.utils import RunningMeanStd as TRms
from legged_tracking_tpu.config import Cfg, config_go1
from legged_tracking_tpu.envs import LeggedEnv as JEnv
from legged_tracking_tpu.learn import actor_critic as j_ac
from legged_tracking_tpu.learn import ppo as j_ppo
from legged_tracking_tpu.learn.utils import RunningMeanStd as JRms

METRICS = ("value_loss", "surrogate_loss", "adaptation_loss", "adaptation_test_loss",
           "kl_mean")
# observation frames in the history: 3 instead of the bench's 15 keeps the
# CPU work of the default-width networks small (783 inputs, not 3915)
HISTORY = 3



@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side runs single-threaded: the tests run beside other
    test processes, and idle intra-op threads of every process spinning on
    the shared cores slow them all."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def small_cfg(cfg_cls, go1, num_envs=4):
    cfg = bench_cfg(cfg_cls, go1, num_envs=num_envs)
    cfg.env.num_observation_history = HISTORY
    return cfg


def max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)),
                        initial=0.0))


def tree_err(a, b):
    """Largest abs difference over the leaves of two pytrees of one layout."""
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb) > 0
    return max(max_err(x, y) for x, y in zip(la, lb))


def test_normal_kl_and_running_mean_std_match():
    """normal_kl (with the + 1e-5 inside the log) and RunningMeanStd
    (ddof-0 variance, Chan's merge over three bf16 batches) against JAX:
    float32 elementwise, a few ulps."""
    rng = np.random.RandomState(0)
    mu1, mu2 = rng.normal(size=(2, 16, 12)).astype(np.float32)
    s1, s2 = rng.uniform(0.2, 2.0, size=(2, 16, 12)).astype(np.float32)
    kl_t = t_ac.normal_kl(*map(torch.as_tensor, (mu1, s1, mu2, s2))).numpy()
    kl_j = np.asarray(j_ac.normal_kl(*map(jnp.asarray, (mu1, s1, mu2, s2))))
    np.testing.assert_allclose(kl_t, kl_j, rtol=1e-6, atol=1e-6)
    same = t_ac.normal_kl(*map(torch.as_tensor, (mu1, s1, mu1, s1))).numpy()
    # equal distributions: 12 x log(1 + 1e-5), the 1 + 1e-5 rounded to float32
    np.testing.assert_allclose(same, 12 * np.log(np.float32(1) + np.float32(1e-5)), rtol=1e-5)

    jr, tr = JRms.create((7,)), TRms.create((7,), device="cpu")
    for i in range(3):
        x = (rng.normal(size=(5 + i, 7)) * 3 + 1).astype(np.float32)
        xj = jnp.asarray(x, jnp.bfloat16)
        jr = jax.jit(JRms.update)(jr, xj)
        tr = tr.update(torch.as_tensor(np.asarray(xj, np.float32)).to(torch.bfloat16))
    for name in ("mean", "var", "count"):
        np.testing.assert_allclose(getattr(tr, name).numpy(), np.asarray(getattr(jr, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    z = rng.normal(size=(4, 7)).astype(np.float32)
    np.testing.assert_allclose(tr.normalize(torch.as_tensor(z)).numpy(),
                               np.asarray(jr.normalize(jnp.asarray(z))), rtol=1e-6, atol=1e-6)


def test_compute_gae_matches():
    """GAE over a trajectory with dones (20 %) and timeout-bootstrapped
    rewards: the same float32 recursion, so returns agree to 1e-6; the
    normalized advantages (ddof-0 std over the buffer) to 1e-5."""
    jenv = JEnv(small_cfg(Cfg, config_go1), seed=3)
    tenv = TEnv(small_cfg(TCfg, t_config_go1), seed=3, device="cpu")
    jalg, talg = j_ppo.PPO(jenv), t_ppo.PPO(tenv)
    T, N = 7, 5
    rng = np.random.RandomState(1)
    values = rng.normal(size=(T, N)).astype(np.float32)
    time_outs = rng.rand(T, N) < 0.1
    dones = (rng.rand(T, N) < 0.2) | time_outs
    rewards = (rng.normal(size=(T, N)) + 0.99 * values * time_outs).astype(np.float32)
    last = rng.normal(size=N).astype(np.float32)
    fields = dict(obs=None, privileged_obs=None, obs_history=None, actions=None,
                  log_prob=None, mu=None, sigma=None)
    jtraj = j_ppo.Transition(rewards=jnp.asarray(rewards), dones=jnp.asarray(dones),
                             values=jnp.asarray(values), **fields)
    ttraj = t_ppo.Transition(rewards=torch.as_tensor(rewards), dones=torch.as_tensor(dones),
                             values=torch.as_tensor(values), **fields)
    rj, aj = jax.jit(jalg.compute_gae)(jtraj, jnp.asarray(last))
    rt, at = talg.compute_gae(ttraj, torch.as_tensor(last))
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=0, atol=1e-5)


# ------------------------------------------------------------------ update
@pytest.fixture(scope="module")
def world():
    """A JAX env and its port twin (built, never stepped here)."""
    return (JEnv(small_cfg(Cfg, config_go1), seed=3),
            TEnv(small_cfg(TCfg, t_config_go1), seed=3, device="cpu"))


def test_train_state_carry_over_both_ways(world):
    """A JAX TrainState with nonzero Adam moments, step counts, an adapted
    learning rate and an obs normalizer goes into the port and back
    bitwise, in optax's own tree structure (the inject_hyperparams count
    and learning rate included); the port's state survives the round trip
    the other way."""
    jenv, tenv = world
    jalg = j_ppo.PPO(jenv, ac_args=j_ac.ACArgs(normalize_obs=True))
    rng = np.random.RandomState(3)
    rand = lambda x: rng.normal(size=np.shape(x)).astype(np.float32)
    jts = jax.tree.map(np.asarray, jalg.init(jax.random.key(0)))
    adam = lambda s, n: s._replace(count=np.int32(n), mu=jax.tree.map(rand, s.mu),
                                   nu=jax.tree.map(lambda x: np.abs(rand(x)), s.nu))
    inject = jts.opt_state[1]
    jts = jts._replace(
        opt_state=(jts.opt_state[0], inject._replace(
            count=np.int32(7), hyperparams={**inject.hyperparams,
                                            "learning_rate": np.float32(3e-4)},
            inner_state=(adam(inject.inner_state[0], 7), inject.inner_state[1]))),
        adapt_opt_state=(adam(jts.adapt_opt_state[0], 7), jts.adapt_opt_state[1]),
        learning_rate=np.float32(3e-4), iteration=np.int32(5),
        obs_rms=jts.obs_rms._replace(mean=rand(jts.obs_rms.mean),
                                     var=np.abs(rand(jts.obs_rms.var)),
                                     count=np.float32(123.5)))
    talg = t_ppo.PPO(tenv, ac_args=t_ac.ACArgs(normalize_obs=True))
    tts = convert.train_state_from_numpy(jts, talg, device="cpu")
    assert tts.params["std"] is talg.ac.std          # the module's own parameters
    assert tts.opt_state.count == tts.adapt_opt_state.count == 7 and tts.iteration == 5
    back = convert.train_state_to_numpy(tts, jts)
    assert jax.tree.structure(back) == jax.tree.structure(jts)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(jts)):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))

    again = convert.train_state_from_numpy(back, talg, device="cpu")
    for a, b in ((again.opt_state, tts.opt_state), (again.adapt_opt_state, tts.adapt_opt_state)):
        assert a.count == b.count
        for k in b.mu:
            assert torch.equal(a.mu[k], b.mu[k]) and torch.equal(a.nu[k], b.nu[k])
    assert torch.equal(again.learning_rate, tts.learning_rate)
    assert all(torch.equal(a, b) for a, b in zip(again.obs_rms, tts.obs_rms))


def jax_made_trajectory(jalg, params, T, N, seed):
    """Random observations (histories bf16, as stored) through the JAX
    policy: its means, stds, sampled actions, log-probs and values, with
    random rewards and dones."""
    env = jalg.env
    rng = np.random.RandomState(seed)
    obs = jnp.asarray(rng.normal(size=(T, N, env.num_obs)), jnp.float32)
    priv = jnp.asarray(rng.normal(size=(T, N, env.num_privileged_obs)), jnp.float32)
    hist = jnp.asarray(rng.normal(size=(T, N, env.num_obs_history)), jnp.bfloat16)
    m = j_ac.ActorCriticCSE
    mean, std = jalg.ac.apply(params, obs, priv, hist, method=m.action_dist)
    std = jnp.broadcast_to(std, mean.shape)
    actions = mean + std * jnp.asarray(rng.normal(size=mean.shape), jnp.float32)
    traj = j_ppo.Transition(
        obs=obs, privileged_obs=priv, obs_history=hist, actions=actions,
        rewards=jnp.asarray(rng.normal(size=(T, N)), jnp.float32),
        dones=jnp.asarray(rng.rand(T, N) < 0.2),
        values=jalg.ac.apply(params, obs, priv, hist, method=m.evaluate),
        log_prob=j_ac.normal_log_prob(mean, std, actions), mu=mean, sigma=std)
    last_values = jnp.asarray(rng.normal(size=N), jnp.float32)
    return traj, last_values


def to_torch_traj(traj):
    out = {}
    for k, v in traj._asdict().items():
        a = np.asarray(v, np.float32) if v.dtype == jnp.bfloat16 else np.asarray(v)
        t = torch.as_tensor(np.array(a))
        out[k] = t.to(torch.bfloat16) if k == "obs_history" else t
    return t_ppo.Transition(**out)


class Recorder:
    """Wraps a function of the port's ppo module and keeps what it saw."""

    def __init__(self, monkeypatch, name, keep):
        self.seen, fn = [], getattr(t_ppo, name)

        def wrapped(*args, **kwargs):
            self.seen.append(keep(*args, **kwargs))
            return fn(*args, **kwargs)
        monkeypatch.setattr(t_ppo, name, wrapped)


def jax_lr_sequence(jalg, step, jts, traj, returns, advs, perm):
    """The learning rate after each minibatch of JAX's ``update``: its
    ``_minibatch_update`` (``step(carry, batch)``) run over the same permuted
    minibatches."""
    a = jalg.args
    T, N = traj.rewards.shape
    nm, mb = a.num_mini_batches, T * N // a.num_mini_batches
    grp = lambda x: x.reshape((T * N,) + x.shape[2:])[perm].reshape((nm, mb) + x.shape[2:])
    data = [grp(x) for x in (traj.obs, traj.obs_history, traj.privileged_obs, traj.actions,
                             traj.values, advs, returns, traj.log_prob, traj.mu, traj.sigma)]
    carry = (jts.params, jts.opt_state, jts.adapt_opt_state, jts.learning_rate)
    lrs = []
    for _ in range(a.num_learning_epochs):
        for i in range(nm):
            carry, _ = step(carry, [x[i] for x in data])
            lrs.append(float(carry[3]))
    return lrs


@pytest.fixture(scope="module")
def jax_update(world):
    """The jitted JAX ``compute_gae``, ``update`` and ``_minibatch_update``
    shared by the update cases: desired_kl and max_grad_norm enter as traced
    float32 arguments (the same values the cases' constants round to, and
    the same arithmetic), so that the cases share one compile of each."""
    jenv, _ = world

    def alg(desired_kl, max_grad_norm):
        return j_ppo.PPO(jenv, args=j_ppo.PPOArgs(desired_kl=desired_kl,
                                                  max_grad_norm=max_grad_norm,
                                                  num_steps_per_env=8))
    gae = jax.jit(alg(0.01, 1.0).compute_gae)
    update = jax.jit(lambda ts, traj, returns, advs, key, kl, norm: alg(kl, norm).update(
        ts, traj, returns, advs, key))
    step = jax.jit(lambda carry, batch, kl, norm: alg(kl, norm)._minibatch_update(carry, batch))
    return gae, update, step


def tree_rel_err(a, b):
    """Largest abs difference of each leaf over the leaf's largest value."""
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb) > 0
    return max(max_err(x, y) / max(float(np.max(np.abs(y), initial=0.0)), 1e-30)
               for x, y in zip(la, lb) if np.asarray(y).size)


def flat_abs_err(a, b):
    return np.concatenate([np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64)).ravel()
                           for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b))])


def params_errors(got, want, start):
    """Of two updated parameter trees: the largest rms error of a leaf over
    the rms distance that leaf moved from ``start``, and the share of all
    elements more than 1e-4 apart."""
    leaves = list(zip(jax.tree.leaves(got), jax.tree.leaves(want), jax.tree.leaves(start)))
    rms_rel = max(float(np.sqrt(np.mean(flat_abs_err(x, y) ** 2)
                                / np.mean(flat_abs_err(x0, y) ** 2))) for x, y, x0 in leaves)
    return {"leaf_rms_rel": rms_rel,
            "frac_over_1e-4": float(np.mean(flat_abs_err(got, want) > 1e-4))}


@pytest.mark.parametrize("desired_kl,max_grad_norm", [
    (1e-5, 1.0), (1e-5, 1e4), (0.01, 1.0), (0.01, 1e4), (1e3, 1.0)],
    ids=["lr_down-clip", "lr_down-noclip", "lr_mixed-clip", "lr_mixed-noclip", "lr_up-clip"])
def test_update_matches(world, jax_update, monkeypatch, desired_kl, max_grad_norm):
    """One ``update`` (5 epochs x 4 minibatches) from a JAX-made 8x8
    trajectory with JAX's permutation, against the jitted JAX ``update``:
    parameters, both Adam states, the learning rate and the five losses.

    The learning rate after every minibatch is bitwise JAX's (its
    ``_minibatch_update`` run minibatch by minibatch), so the adaptive rate
    takes the same branch each time: at desired_kl 1e-5 it is lowered at
    every minibatch down to the 1e-5 floor; at 0.01 raised once, then
    lowered; at 1e3 raised up to the 1e-2 ceiling and held there.  At
    max_grad_norm 1 the clip fires on most minibatches and not on others
    (gradient norms 0.1 to 360), at 1e4 on none.  (At the ceiling without
    the clip the steps are chaotic, the KL in the thousands, and float32
    differences grow from minibatch to minibatch: no case there.)

    The gradients agree to float32 reordering, but Adam divides by sqrt(nu)
    + 1e-8: an element whose gradient is a cancellation residue near 1e-8
    can step the other way, and the differences feed the later minibatches.
    Read on the CPU: the Adam moments within 3.9e-3 (PPO) and 3.9e-4
    (adaptation) of each leaf's largest value; the rms parameter error of
    each leaf within 8.5e-4 of the rms distance the leaf moved; at most
    1.5e-6 of the 1.4M parameters more than 1e-4 apart; the losses within
    1.5e-5 (relative, or absolute below 1).  The limits are 5 to 10 times
    that."""
    jenv, tenv = world
    gae, jupdate, jstep = jax_update
    hyper = tuple(jnp.float32(x) for x in (desired_kl, max_grad_norm))
    T, N = 8, 8
    args = dict(desired_kl=desired_kl, max_grad_norm=max_grad_norm, num_steps_per_env=T)
    jalg = j_ppo.PPO(jenv, args=j_ppo.PPOArgs(**args))
    jts = jalg.init(jax.random.key(0))
    traj, last_values = jax_made_trajectory(jalg, jts.params, T, N, seed=2)
    returns, advs = gae(traj, last_values)
    key = jax.random.key(4)
    perm = np.asarray(jax.random.permutation(key, T * N))
    jts_np = jax.tree.map(np.asarray, jts)

    dims = dict(num_obs=jenv.num_obs, num_privileged_obs=jenv.num_privileged_obs,
                num_obs_history=jenv.num_obs_history, num_actions=jenv.num_actions)
    talg = t_ppo.PPO(tenv, args=t_ppo.PPOArgs(**args), ac=carry_over(jalg.ac, jts.params, **dims))
    tts = convert.train_state_from_numpy(jts_np, talg, device="cpu")
    lrs = Recorder(monkeypatch, "adam_step",
                   lambda *a, injected=False, **k: float(a[3]) if injected else None)
    norms = Recorder(monkeypatch, "clip_by_global_norm", lambda g, m: float(
        torch.sqrt(sum(torch.sum(x * x) for x in g))))
    tts2, tm = talg.update(tts, to_torch_traj(traj), torch.as_tensor(np.asarray(returns)),
                           torch.as_tensor(np.asarray(advs)), perm=torch.as_tensor(perm))

    lr_seq = [x for x in lrs.seen if x is not None]
    assert lr_seq == jax_lr_sequence(jalg, lambda c, b: jstep(c, b, *hyper), jts, traj,
                                     returns, advs, perm)
    up = [y > x for x, y in zip([1e-3] + lr_seq, lr_seq) if x != y]
    if desired_kl == 1e-5:
        assert not any(up) and lr_seq[-1] == np.float32(1e-5)
    elif desired_kl == 0.01:
        assert up[0] and not any(up[1:])
    else:
        assert all(up) and lr_seq[-1] == np.float32(1e-2)
    clipped = [n >= max_grad_norm for n in norms.seen]
    assert len(clipped) == 20 and (any(clipped) if max_grad_norm == 1.0 else not any(clipped))

    jts2, jm = jupdate(jts, traj, returns, advs, key, *hyper)
    jts2 = jax.tree.map(np.asarray, jts2)
    back = convert.train_state_to_numpy(tts2, jts2)
    assert float(back.learning_rate) == float(jts2.learning_rate) == lr_seq[-1]
    assert int(back.iteration) == int(jts2.iteration) == 1
    errs = {"opt_state": tree_rel_err(back.opt_state, jts2.opt_state),
            "adapt_opt_state": tree_rel_err(back.adapt_opt_state, jts2.adapt_opt_state),
            **params_errors(back.params, jts2.params, jts_np.params)}
    errs.update({k: max_err(tm[k].numpy(), jm[k]) / max(abs(float(jm[k])), 1.0)
                 for k in METRICS})
    tol = {"opt_state": 2e-2, "adapt_opt_state": 4e-3, "leaf_rms_rel": 5e-3,
           "frac_over_1e-4": 1.5e-5, **{k: 1.5e-4 for k in METRICS}}
    assert all(errs[k] <= tol[k] for k in tol), errs


# --------------------------------------------------------- train_iteration
def iteration_cfg(cfg_cls, go1, n_eval):
    cfg = small_cfg(cfg_cls, go1, num_envs=8)
    cfg.env.num_eval_envs = n_eval
    if n_eval:
        # rehearsal mixing: the frontier_* metrics and the mixed reset draw
        cfg.curriculum_thresholds.cl_fix_target = True
        cfg.curriculum_thresholds.cl_dist_mix = 0.5
    return cfg


@pytest.mark.parametrize("n_eval,normalize_obs", [(0, False), (2, True)],
                         ids=["plain", "eval_envs_normalized"])
def test_train_iteration_matches(n_eval, normalize_obs):
    """A whole ``train_iteration`` (a 4-step rollout of 8 envs with
    3-step episodes, GAE, 5 x 4 minibatches) against the jitted JAX one
    from the same state and parameters, with the JAX env's draws, JAX's
    action normals and its permutation; once plain, once with two eval
    envs, rehearsal mixing (frontier_* metrics) and normalize_obs.

    Read on the CPU: base positions equal, the last obs within 4.3e-6, the
    episodic metrics within 6e-8 and the episode counts equal, the losses
    within 1.5e-6 (relative, or absolute below 1), the obs normalizer
    within 1.4e-7 of its largest value, the Adam moments within 4.9e-5 of
    each leaf's largest value, the rms parameter error of each leaf within
    8.7e-5 of the distance it moved, no element of 1.4M more than 1e-4
    apart; the learning rate bitwise.  The limits are about 10 times that.
    The port records env0's training-video frames (base_pos, base_quat, qj
    after each step), as the Runner asks it to with save_video_interval, and
    they match the JAX ones within the base_pos limit."""
    T, N = 4, 8
    jenv = JEnv(iteration_cfg(Cfg, config_go1, n_eval), seed=3)
    tenv = TEnv(iteration_cfg(TCfg, t_config_go1, n_eval), seed=3, device="cpu")
    jalg = j_ppo.PPO(jenv, ac_args=j_ac.ACArgs(normalize_obs=normalize_obs),
                     args=j_ppo.PPOArgs(num_steps_per_env=T))
    talg = t_ppo.PPO(tenv, ac_args=t_ac.ACArgs(normalize_obs=normalize_obs),
                     args=t_ppo.PPOArgs(num_steps_per_env=T))
    talg.record_video = True        # as the Runner asks with save_video_interval
    jts = jalg.init(jax.random.key(0))
    jts_np = jax.tree.map(np.asarray, jts)
    tts = convert.train_state_from_numpy(jts_np, talg, device="cpu")
    key = jax.random.key(5)
    jstate = jenv._reset_jit(key, True)
    jobs = jenv._observe_jit(jstate)
    ikey = jax.random.key(9)
    k_roll, k_update = jax.random.split(ikey)
    noise = np.stack([np.asarray(jax.random.normal(k, (N, jenv.num_actions)))
                      for k in jax.random.split(k_roll, T)])
    n_train = N - n_eval
    perm = np.asarray(jax.random.permutation(k_update, T * n_train))

    install(tenv, JaxDraws(key, N))
    try:
        tstate = convert.env_state_from_numpy(to_numpy(jstate), device="cpu")
        tts2, tstate2, tobs2, tm = talg.train_iteration(
            tts, tstate, tenv.observe(tstate), action_noise=torch.as_tensor(noise),
            perm=torch.as_tensor(perm))
    finally:
        del tenv.draw, tenv.step_fn
    jts2, jstate2, jobs2, jm = jalg.train_iteration_jit(jts, jstate, jobs, ikey)
    # env0's training-video frames: (T, 3), (T, 4) and (T, 12), within the
    # base_pos limit below
    tvid, jvid = tm.pop("video"), jm.pop("video")
    assert sorted(tvid) == sorted(jvid) == ["base_pos", "base_quat", "qj"]
    for k, v in jvid.items():
        assert tvid[k].shape == v.shape == (T, {"base_pos": 3, "base_quat": 4, "qj": 12}[k])
        np.testing.assert_allclose(tvid[k].numpy(), np.asarray(v), rtol=0, atol=1e-6, err_msg=k)
    jts2 = jax.tree.map(np.asarray, jts2)
    back = convert.train_state_to_numpy(tts2, jts2)

    assert set(tm) == set(jm)
    assert ("eval_reached_mean" in tm) == bool(n_eval) == ("frontier_reached_mean" in tm)
    errs = {k: max_err(tm[k].numpy(), jm[k]) for k in tm}
    errs.update({"params": params_errors(back.params, jts2.params, jts_np.params),
                 "opt_state": tree_rel_err(back.opt_state, jts2.opt_state),
                 "adapt_opt_state": tree_rel_err(back.adapt_opt_state, jts2.adapt_opt_state),
                 "obs": max_err(tobs2["obs"].numpy(), jobs2["obs"]),
                 "base_pos": max_err(tstate2.phys.base_pos.numpy(), jstate2.phys.base_pos)})
    if normalize_obs:
        errs["obs_rms"] = tree_rel_err(back.obs_rms, jts2.obs_rms)
    tol = {"params": {"leaf_rms_rel": 1e-3, "frac_over_1e-4": 2e-6}, "opt_state": 5e-4,
           "adapt_opt_state": 5e-4, "obs": 5e-5, "base_pos": 1e-6, "obs_rms": 1e-6}
    for k in tm:
        if k in METRICS:
            errs[k] /= max(abs(float(jm[k])), 1.0)
        tol[k] = (1e-5 if k in METRICS else 0.0 if k.endswith(("num_episodes", "learning_rate"))
                  else 5e-7)
    bad = {k: (v, tol[k]) for k, v in errs.items()
           if (any(v[x] > tol[k][x] for x in v) if isinstance(v, dict) else not v <= tol[k])}
    assert not bad, bad
