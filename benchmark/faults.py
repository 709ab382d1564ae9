"""Faults planted under a train path, for the tests and the control
readings that show the comparison fails them.  Each is a context manager
that patches the program's classes and functions and undoes it on
leaving."""

from __future__ import annotations

import contextlib

import torch

KINDS = ("frozen", "half_batch", "reward", "obs", "reset", "no_allreduce")


@contextlib.contextmanager
def _patched(owner, name, make):
    """``owner.name = make(old)`` while inside."""
    old = getattr(owner, name)
    setattr(owner, name, make(old))
    try:
        yield
    finally:
        setattr(owner, name, old)


def _own(classes, name):
    """The classes among ``classes`` that define ``name`` themselves."""
    return [c for c in classes if name in vars(c)]


def _outermost(make_body):
    """``make(orig)`` for methods of a class and its subclasses that apply
    ``make_body(orig)`` only in the outermost call (a subclass's method that
    calls its base's through ``super()`` changes the result once)."""
    depth = [0]

    def make(orig):
        body = make_body(orig)

        def call(self, *args, **kwargs):
            depth[0] += 1
            try:
                return body(self, *args, **kwargs) if depth[0] == 1 else orig(self, *args,
                                                                               **kwargs)
            finally:
                depth[0] -= 1
        return call
    return make


def plant(kind: str, ppo_module, env_classes):
    """The fault ``kind`` in the program's ``ppo_module`` (its
    ``learn/ppo.py``) and its ``env_classes``:

    - ``frozen``: every optimizer step returns its state and leaves the
      parameters unchanged;
    - ``half_batch``: each minibatch keeps its first half of the samples,
      and the means run over those;
    - ``reward``: the env step's reward of env 0 is raised by 1 where it is
      produced, at every step;
    - ``obs``: env 0's observation is raised by 1 where it is produced,
      at the reset's observation and at every step;
    - ``reset``: the fresh states of the env step's auto-reset have their
      joint angles raised by 0.1 where they are drawn;
    - ``no_allreduce``: the exchange between ranks is left out (each rank
      keeps its own sums).
    """
    stack = contextlib.ExitStack()
    if kind == "frozen":
        def make(_):
            def adam_step(params, grads, state, lr, *args, **kwargs):
                return state._replace(count=state.count + 1)
            return adam_step
        stack.enter_context(_patched(ppo_module, "adam_step", make))
    elif kind == "half_batch":
        def make(permuted):
            def half(self, tensors, perm):
                mb, batches = permuted(self, tensors, perm)
                cut = lambda x: (tuple(y[: y.shape[0] // 2] for y in x)
                                 if isinstance(x, tuple) else x[: x.shape[0] // 2])
                return mb // 2, [([cut(x) for x in b], None if p is None else cut(p))
                                 for b, p in batches]
            return half
        stack.enter_context(_patched(ppo_module.PPO, "_permuted", make))
    elif kind == "reward":
        def make(step_fn):
            def raised(self, state, actions):
                state, out = step_fn(self, state, actions)
                rew = out.rew.clone()
                rew[0] += 1.0
                return state, out._replace(rew=rew)
            return raised
        make = _outermost(make)
        for cls in _own(env_classes, "step_fn"):
            stack.enter_context(_patched(cls, "step_fn", make))
    elif kind == "obs":
        def raise_obs(obs):
            o = obs["obs"].clone()
            o[0] += 1.0
            return {**obs, "obs": o}

        def make_observe(observe):
            return lambda self, *args, **kwargs: raise_obs(observe(self, *args, **kwargs))

        def make_step(step_fn):
            def raised(self, state, actions):
                state, out = step_fn(self, state, actions)
                o = out.obs.clone()
                o[0] += 1.0
                return state, out._replace(obs=o)
            return raised
        for cls in _own(env_classes, "observe"):
            stack.enter_context(_patched(cls, "observe", _outermost(make_observe)))
        for cls in _own(env_classes, "step_fn"):
            stack.enter_context(_patched(cls, "step_fn", _outermost(make_step)))
    elif kind == "reset":
        def make(reset_values):
            def raised(self, tag, *args, **kwargs):
                phys, *rest = reset_values(self, tag, *args, **kwargs)
                if tag[0] == "step":
                    phys = phys._replace(qj=phys.qj + 0.1)
                return (phys, *rest)
            return raised
        for cls in _own(env_classes, "_reset_values"):
            stack.enter_context(_patched(cls, "_reset_values", make))
    elif kind == "no_allreduce":
        stack.enter_context(_patched(ppo_module, "all_reduce_sum",
                                     lambda _: (lambda tensors: list(tensors))))
    else:
        raise ValueError(f"no fault {kind!r}; one of {KINDS}")
    return stack
