"""What the port's CPU tests share: torch on one CPU thread, and the helpers
that more than one ``tests/test_torch_*.py`` module uses.

Every port test module imports this one (``test_torch_cuda.py`` excepted: it
runs on the card's machine, without JAX).  Importing it sets the thread
rule for the whole process and for every interpreter a test starts.
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from legged_tracking_torch import convert
from legged_tracking_torch import train as t_train
from legged_tracking_torch import train_velocity_tracking as t_tv
from legged_tracking_torch.learn import actor_critic as t_ac

# The tests run a few envs op by op, beside the other test workers on shared
# cores, where every idle intra-op thread spins: one thread is fastest.
torch.set_num_threads(1)
# Ranks and train entries the tests start inherit the environment: one
# thread there too.
os.environ.setdefault("OMP_NUM_THREADS", "1")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "legged_tracking_tpu")
METRICS = ("value_loss", "surrogate_loss", "adaptation_loss", "adaptation_test_loss",
           "kl_mean")
# observation frames in the history: 3 instead of the bench's 15 keeps the
# CPU work of the default-width networks small (783 inputs, not 3915)
HISTORY = 3


def script(name):
    """``scripts/<name>.py`` of the JAX package, as a module."""
    spec = importlib.util.spec_from_file_location(f"scripts_{name}",
                                                  os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J_TRAIN, J_TV = script("train"), script("train_velocity_tracking")


# ------------------------------------------------------ the JAX env's draws
class JaxDraws:
    """Stands in for the port's ``LeggedEnv.draw``: the value the JAX env
    draws for the same tag, from the JAX env's keys.  A tag element
    ``("split", n, i)`` takes the i-th of ``jax.random.split(key, n)``."""

    def __init__(self, reset_key, num_envs):
        gkey, ekey, lkey = jax.random.split(reset_key, 3)
        self.reset_keys = jax.random.split(ekey, num_envs)
        self.lkey = lkey
        self.rng = self._fold(self.reset_keys, 999)
        self.global_rng = gkey
        self._split()

    @staticmethod
    def _fold(keys, tag):
        return jax.vmap(jax.random.fold_in, in_axes=(0, None))(keys, tag)

    def _split(self):
        keys2 = jax.vmap(lambda k: jax.random.split(k, 2))(self.rng)
        self.rng_next, self.kstep = keys2[:, 0], keys2[:, 1]
        self.g_next, self.gk = jax.random.split(self.global_rng, 2)

    def advance(self):
        """Move on to the next step's keys (LeggedEnv.step_fn's key split)."""
        self.rng, self.global_rng = self.rng_next, self.g_next
        self._split()

    def __call__(self, tag, shape, lo, hi, integer=False):
        ns, path = tag[0], tag[1:]
        if ns == "global":
            v = jax.random.uniform(self.gk, shape, minval=lo, maxval=hi)
        elif path == ("ep_len",):
            v = jax.random.randint(self.lkey, shape, lo, hi)
        else:
            keys = self.reset_keys if ns == "reset" else self.kstep
            for t in path:
                if isinstance(t, tuple):          # ("split", n, i): split(key, n)[i]
                    _, n, i = t
                    keys = jax.vmap(lambda k: jax.random.split(k, n)[i])(keys)
                else:
                    keys = self._fold(keys, t)
            v = jax.vmap(lambda k: jax.random.uniform(k, shape[1:], minval=lo, maxval=hi))(keys)
        return torch.as_tensor(np.array(v))


def install_jax_draws(env, draws):
    """Route env's draws to ``draws`` and advance its keys after each step."""
    env.draw = draws
    step_fn = env.step_fn

    def stepped(state, actions):
        out = step_fn(state, actions)
        draws.advance()
        return out

    env.step_fn = stepped
    return env


class VelocityDraws(JaxDraws):
    """``JaxDraws`` for the velocity env: integer draws (the gait category),
    draws under the state key (``("rng", ...)``, the reset's resample), and
    :meth:`bins`, the JAX curriculum's categorical, in place of the env's
    ``draw_bins``."""

    def _keys(self, ns, path):
        keys = {"reset": self.reset_keys, "step": self.kstep, "rng": self.rng}[ns]
        for t in path:
            if isinstance(t, tuple):
                _, n, i = t
                keys = jax.vmap(lambda k: jax.random.split(k, n)[i])(keys)
            else:
                keys = self._fold(keys, t)
        return keys

    def __call__(self, tag, shape, lo, hi, integer=False):
        ns, path = tag[0], tag[1:]
        if ns == "rng" or (integer and path != ("ep_len",)):
            keys = self._keys(ns, path)
            if integer:
                v = jax.vmap(lambda k: jax.random.randint(k, shape[1:], lo, hi))(keys)
                return torch.as_tensor(np.array(v, np.int32))
            v = jax.vmap(lambda k: jax.random.uniform(k, shape[1:], minval=lo, maxval=hi))(keys)
            return torch.as_tensor(np.array(v))
        return super().__call__(tag, shape, lo, hi, integer)

    def bins(self, tag, weights, categories):
        keys = self._keys(tag[0], tag[1:])
        return torch.as_tensor(np.asarray(
            _categorical(keys, jnp.asarray(weights.numpy()), jnp.asarray(categories.numpy())),
            np.int32))


@jax.jit
def _categorical(keys, weights, categories):
    """DeviceCurriculum.sample's bin draw (tasks/curriculum.py:214-219)."""
    logits = jnp.log(jnp.maximum(weights[categories], 1e-12))
    return jax.vmap(jax.random.categorical)(keys, logits)


def install_velocity_draws(env, draws):
    """:func:`install_jax_draws`, with the curriculum's bins drawn by
    ``draws.bins``."""
    env.draw_bins = draws.bins
    return install_jax_draws(env, draws)


def uninstall(env):
    for name in ("draw", "draw_bins", "step_fn"):
        env.__dict__.pop(name, None)


# ---------------------------------------------------------- configurations
def bench_cfg(cfg_cls, go1, num_envs=N, episode_s=0.06):
    """bench.py:18's configuration cut to 2x2 tiles and a few envs; episodes
    of 3 steps so that the auto-reset runs."""
    cfg = go1(cfg_cls())
    cfg.env.num_envs = num_envs
    cfg.terrain.mesh_type = "trimesh"
    cfg.terrain.terrain_type = "single_path"
    cfg.terrain.num_rows = 2
    cfg.terrain.num_cols = 2
    cfg.terrain.terrain_length = 4.0
    cfg.terrain.terrain_width = 2.0
    cfg.terrain.terrain_ratio_x = 0.9
    cfg.terrain.terrain_ratio_y = 0.5
    cfg.terrain.ceiling_height = 0.8
    cfg.terrain.start_loc = 0.32
    cfg.env.episode_length_s = episode_s
    cfg.env.command_type = "xy"
    cfg.terrain.measure_front_half = True
    cfg.terrain.measured_points_x = np.linspace(-1, 1, 21)
    cfg.terrain.measured_points_y = np.linspace(-0.5, 0.5, 11)
    cfg.control.control_type = "actuator_net"
    cfg.asset.penalize_contacts_on = ["thigh", "calf", "base"]
    cfg.asset.terminate_after_contacts_on = []
    cfg.rewards.terminal_body_height = 0.0
    cfg.reward_scales.set("exploration_lin", 1.0)
    cfg.reward_scales.set("exploration_yaw", 0.4)
    cfg.commands.traj_function = "fixed_target"
    cfg.commands.traj_length = 1
    cfg.commands.switch_dist = 0.3
    cfg.commands.base_x = 2.6
    cfg.sim.lane_engine = False
    return cfg


def small_cfg(cfg_cls, go1, num_envs=4):
    cfg = bench_cfg(cfg_cls, go1, num_envs=num_envs)
    cfg.env.num_observation_history = HISTORY
    return cfg


def iteration_cfg(cfg_cls, go1, n_eval):
    cfg = small_cfg(cfg_cls, go1, num_envs=8)
    cfg.env.num_eval_envs = n_eval
    if n_eval:
        # rehearsal mixing: the frontier_* metrics and the mixed reset draw
        cfg.curriculum_thresholds.cl_fix_target = True
        cfg.curriculum_thresholds.cl_dist_mix = 0.5
    return cfg


GOAL_FLAGS = ["--strategy", "goal", "--terrain", "random_pyramid", "--terrain_rows", "2",
              "--terrain_cols", "2"]


def goal_cfgs(num_envs=N, flags=()):
    """The goal recipe's configuration from each package's train entry."""
    argv = GOAL_FLAGS + ["--num_envs", str(num_envs), *flags]
    return J_TRAIN.build_cfg(J_TRAIN.parse_args(argv)), t_train.build_cfg(t_train.parse_args(argv))


SMALL = ["--num_envs", str(N), "--terrain_rows", "2", "--terrain_cols", "2"]


def velocity_cfgs(flags=SMALL, resampling_time=0.04, episode_s=0.06):
    """The script's configuration from each package's entry, with commands
    resampled every ``resampling_time`` s (2 steps), episodes of
    ``episode_s`` (3 steps), lower curriculum thresholds, and the JAX env's
    env-major physics."""
    out = []
    for mod in (J_TV, t_tv):
        cfg = mod.build_cfg(mod.parse_args(flags))
        cfg.commands.resampling_time = resampling_time
        cfg.env.episode_length_s = episode_s
        cfg.sim.lane_engine = False
        # the curriculum starts from its centre bin alone, and its success
        # thresholds are an eighth of the defaults, so that some envs clear
        # them within 2 steps and the weights around them move
        cfg.commands.lin_vel_x = cfg.commands.ang_vel_yaw = [-0.3, 0.3]
        for k in ("tracking_lin_vel", "tracking_ang_vel", "tracking_contacts_shaped_force",
                  "tracking_contacts_shaped_vel"):
            setattr(cfg.curriculum_thresholds, k, getattr(cfg.curriculum_thresholds, k) / 8)
        out.append(cfg)
    return out


def cfg_tree(obj):
    """A configuration as nested dicts and lists of plain values."""
    if dataclasses.is_dataclass(obj):
        return {k: cfg_tree(v) for k, v in vars(obj).items()}
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (list, tuple)):
        return [cfg_tree(x) for x in obj]
    return obj


# ----------------------------------------------------- states and policies
def to_numpy(jstate):
    """A JAX EnvState as numpy leaves (phys and act as dicts), PRNG keys and
    unused fields left out."""
    out = {}
    for k, v in jstate._asdict().items():
        if k in ("rng", "global_rng") or v is None:
            continue
        out[k] = ({f: np.asarray(x) for f, x in v._asdict().items()}
                  if k in ("phys", "act") else np.asarray(v))
    return out


def assert_state_close(tstate, jstate, atol, exact=()):
    t = convert.env_state_to_numpy(tstate)
    j = to_numpy(jstate)
    for name, a in t.items():
        pairs = (a.items() if isinstance(a, dict) else [(None, a)])
        for sub, x in pairs:
            y = j[name][sub] if sub else j[name]
            y = np.asarray(y, dtype=np.float32) if np.asarray(y).dtype.name == "bfloat16" else y
            label = f"{name}.{sub}" if sub else name
            if x.dtype.kind in "biu" or name in exact:
                np.testing.assert_array_equal(x, np.asarray(y), err_msg=label)
            else:
                np.testing.assert_allclose(x, np.asarray(y), rtol=0, atol=atol, err_msg=label)


def carry_over(jmodule, params, **dims):
    """The torch twin of a flax ActorCriticCSE, with its parameters."""
    ac = t_ac.ActorCriticCSE(**dims, args=t_ac.ACArgs(max_noise_std=jmodule.args.max_noise_std))
    np_params = jax.tree.map(np.asarray, params)
    ac.load_state_dict(convert.flax_params_to_state_dict(np_params))
    return ac


# ------------------------------------------------------------------ errors
def max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)),
                        initial=0.0))


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


# ------------------------------------------------------------ policy heads
def heads_both_ways(ac, o, p, h):
    """A policy's heads as ``action_dist`` then ``evaluate``, and as
    ``action_dist_and_value``, on the same inputs: for each way its (mean,
    std, value) and the gradients of one loss over all three, by parameter
    name."""
    names, params = zip(*ac.named_parameters())

    def run(heads):
        out = mean, std, value = heads()
        loss = mean.square().mean() + torch.log(std).sum() + value.square().mean()
        grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
        return [x.detach() for x in out], dict(zip(names, grads))
    return (run(lambda: (*ac.action_dist(o, p, h), ac.evaluate(o, p, h))),
            run(lambda: ac.action_dist_and_value(o, p, h)))
