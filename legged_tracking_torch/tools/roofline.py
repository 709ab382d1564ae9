"""FLOP and roofline reckoning of the bench workload on the card
(counterpart of the repo's ``tools/roofline.py``, which reckons for the
TPU).

    python -m legged_tracking_torch.tools.roofline --ms-per-iter 2900
    python -m legged_tracking_torch.tools.roofline --ms-per-iter 2900 --from-trace DIR --iters 3

Two counts of the policy's matrix-product FLOP in one PPO train iteration
(the rollout's forward passes and the 5-epoch update):
:func:`model_flops_per_iter` is the JAX tool's, with its signature,
defaults and arithmetic (the numbers the JAX records used), and
:func:`iteration_flop` counts from the layer shapes of a built policy
(:func:`update_flop` for the update).  The JAX count's defaults are stale
for the bench (6 privileged observations where the env has 8), and it
reckons the update as three forward passes an epoch; the shape count gives
the first layers of the critic and the adaptation module no input gradient
and runs the adaptation module twice a minibatch.

Prints both counts for the bench at ``--num-envs``, the float32 floor of an
iteration on the card (the policy runs in float32 with TF32 off), the JAX
tool's bf16 tensor-core floor line, and the whole program's TFLOP/s and
share of the float32 peak at ``--ms-per-iter``: an iteration as the bench
entry times it, untraced (the ``with_stack`` profiler stretches a traced
iteration 2-3 times, so a traced window is no iteration time).  With
``--dense-ms``, or ``--from-trace`` (a ``profile_bench --trace``, whose
GEMM kernels ``analyze_trace`` files under ``learn/actor_critic*.py``), it
also prints the policy products' share over their own device time, which
the tracer does not stretch.  The policy is built on ``--device`` (the card
by default; raises without one) to read its widths; the last line printed
is one JSON object with the numbers.
"""

from __future__ import annotations

import argparse
import json
import re

# NVIDIA H100 SXM data sheet: float32 operations/s outside the tensor
# cores, HBM3 bytes/s, and the dense bf16 tensor-core rate, all at the
# card's full 700 W power limit
F32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
BF16_DENSE_OPS_PER_S = 989.4e12

# the cuBLAS / CUTLASS kernels of a matrix product, by name
GEMM_KERNELS = r"gemm|gemv|splitK"
POLICY_FILES = re.compile(r"learn/actor_critic\w*\.py$")


def model_flops_per_iter(num_envs=4096, steps=24, epochs=5,
                         num_obs=261, history=15, num_priv=6, num_actions=12,
                         hidden=(512, 256, 128), adapt_hidden=(256, 128)):
    """The JAX tool's count (``tools/roofline.py:24``): Dense FLOPs of the
    CSE policy per train iteration, the rollout's forward passes plus the
    update reckoned as three forward passes an epoch.  Returns (FLOP,
    multiply-adds per env step)."""
    H = num_obs * history
    adapt = H * adapt_hidden[0]
    for a, b in zip(adapt_hidden[:-1], adapt_hidden[1:]):
        adapt += a * b
    adapt += adapt_hidden[-1] * num_priv

    def mlp(inp, out):
        mac = inp * hidden[0]
        for a, b in zip(hidden[:-1], hidden[1:]):
            mac += a * b
        return mac + hidden[-1] * out

    actor = mlp(H + num_priv, num_actions)
    critic = mlp(H + num_priv, 1)
    per_step_mac = adapt + actor + critic
    samples = num_envs * steps
    rollout = per_step_mac * samples * 2                 # fwd FLOPs
    update = rollout * 3 * epochs                        # fwd + 2 bwd matmuls
    return rollout + update, per_step_mac


def _macs(mlp) -> int:
    return sum(layer.in_features * layer.out_features for layer in mlp.layers)


def update_flop(ac, samples: int) -> float:
    """Matrix-product operations of a PPO update of the CSE policy over
    ``samples`` sample passes, from the layer shapes: each layer's forward,
    its weight gradient and, where its input needs one, its input gradient.
    The actor's input holds the latent, so all its layers take an input
    gradient; the critic's and the adaptation module's first layers read
    the history only.  The adaptation module runs twice a minibatch (in the
    policy, and in its own substep)."""
    first = lambda mlp: mlp.layers[0].in_features * mlp.layers[0].out_features
    a, c, d = ac.actor_body, ac.critic_body, ac.adaptation_module
    per_sample = 3 * _macs(a) + (3 * _macs(c) - first(c)) + 2 * (3 * _macs(d) - first(d))
    return 2.0 * per_sample * samples


def iteration_flop(ac, num_envs: int, steps: int, epochs: int) -> dict:
    """Matrix-product operations of one train iteration of the CSE policy
    ``ac``, with its widths read from its layers: the rollout's forward
    passes (the adaptation module, the actor and the critic for each of
    ``num_envs`` x ``steps`` samples) and :func:`update_flop` over
    ``epochs`` passes of those samples."""
    samples = num_envs * steps
    rollout = 2.0 * (_macs(ac.adaptation_module) + _macs(ac.actor_body)
                     + _macs(ac.critic_body)) * samples
    update = update_flop(ac, samples * epochs)
    return {"rollout": rollout, "update": update, "total": rollout + update}


def dense_ms(kernel_files: dict) -> float:
    """The policy products' device ms of ``analyze_trace``'s
    ``kernel_files`` ({kernel name: {file: ms}}): the GEMM kernels filed
    under ``learn/actor_critic*.py``."""
    rx = re.compile(GEMM_KERNELS)
    return sum(ms for name, files in kernel_files.items() if rx.search(name)
               for f, ms in files.items() if POLICY_FILES.search(f))


def from_trace(trace: str, iters: int) -> float:
    """The policy products' device ms per iteration of a ``profile_bench
    --trace`` holding ``iters`` iterations (:func:`dense_ms`)."""
    from . import analyze_trace as at

    files = at.kernel_files(at.load_trace_events(trace))
    return dense_ms({k: {f: us / 1e3 for f, us in v.items()} for k, v in files.items()}) / iters


def bench_policy(device):
    """The bench's policy, built on ``device`` from the bench env's widths
    (4 envs on 2x2 tiles: the widths do not depend on the envs)."""
    from ..envs import LeggedEnv
    from ..learn.ppo import PPO
    from ..parallel import entry_device
    from ..bench import bench_config

    cfg, args = bench_config(4)
    alg = PPO(LeggedEnv(cfg, device=entry_device(device)), args=args)
    return alg.ac, alg.args


def report(ac, num_envs: int, steps: int, epochs: int, ms_per_iter: float,
           dense_ms: float | None) -> dict:
    """The numbers :func:`main` prints."""
    jax_flop, per_step_mac = model_flops_per_iter(num_envs, steps, epochs)
    jax_at_bench, _ = model_flops_per_iter(
        num_envs, steps, epochs, num_priv=ac.actor_body.layers[0].in_features
        - ac.adaptation_module.layers[0].in_features)
    shape = iteration_flop(ac, num_envs, steps, epochs)
    t = ms_per_iter / 1e3
    out = {"num_envs": num_envs, "ms_per_iter": ms_per_iter, "dense_ms": dense_ms,
           "jax_flop_per_iter": jax_flop, "jax_flop_per_iter_bench_widths": jax_at_bench,
           "jax_mac_per_env_step": per_step_mac, "shape_flop_per_iter": shape,
           "f32_floor_ms": shape["total"] / F32_OPS_PER_S * 1e3,
           "bf16_floor_ms": shape["total"] / BF16_DENSE_OPS_PER_S * 1e3,
           "tflop_per_s": shape["total"] / t / 1e12,
           "f32_peak_share": shape["total"] / t / F32_OPS_PER_S}
    if dense_ms:
        out["dense_f32_peak_share"] = shape["total"] / F32_OPS_PER_S / (dense_ms / 1e3)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ms-per-iter", type=float, required=True,
                   help="an untraced iteration's ms (the bench entry's envs x 24 / rate)")
    p.add_argument("--num-envs", type=int, default=4096)
    p.add_argument("--dense-ms", type=float, default=None,
                   help="device ms an iteration of the policy's GEMM kernels")
    p.add_argument("--from-trace", metavar="TRACE", default=None,
                   help="derive --dense-ms from a profile_bench --trace")
    p.add_argument("--iters", type=int, default=3,
                   help="train iterations inside the trace")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    args = p.parse_args(argv)
    if args.dense_ms is not None and args.from_trace is not None:
        p.error("pass --dense-ms or --from-trace, not both")
    if args.iters < 1:
        p.error("--iters must be >= 1")

    ac, ppo = bench_policy(args.device)
    if args.from_trace:
        args.dense_ms = from_trace(args.from_trace, args.iters)
        print(f"[from-trace] policy GEMMs {args.dense_ms:.1f} ms/iter")
    r = report(ac, args.num_envs, ppo.num_steps_per_env, ppo.num_learning_epochs,
               args.ms_per_iter, args.dense_ms)
    shape = r["shape_flop_per_iter"]
    print(f"model matmuls (JAX count): {r['jax_mac_per_env_step'] / 1e6:.2f}M MAC/env-step, "
          f"{r['jax_flop_per_iter'] / 1e12:.3f} TFLOP/iter at its defaults, "
          f"{r['jax_flop_per_iter_bench_widths'] / 1e12:.3f} at the bench's widths")
    print(f"model matmuls (layer shapes): {shape['total'] / 1e12:.3f} TFLOP/iter "
          f"(rollout {shape['rollout'] / 1e12:.3f}, update {shape['update'] / 1e12:.3f})")
    print(f"H100 float32 floor: {r['f32_floor_ms']:.1f} ms "
          f"(bf16 tensor cores: {r['bf16_floor_ms']:.1f} ms)")
    if args.dense_ms:
        print(f"policy-GEMM utilization: {100 * r['dense_f32_peak_share']:.0f}% of the "
              f"float32 peak over the attributed {args.dense_ms:.1f} ms")
    print(f"whole-program: {r['tflop_per_s']:.2f} TFLOP/s sustained = "
          f"{100 * r['f32_peak_share']:.1f}% of the float32 peak at "
          f"{args.ms_per_iter:.1f} ms/iter")
    print(json.dumps(r))


if __name__ == "__main__":
    main()
