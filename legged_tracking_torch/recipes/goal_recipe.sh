#!/bin/bash
# The 10k-iteration goal recipe on the port (the staged run behind the goal
# training records in docs/): the same stages, flags and time limits as the
# JAX package's tools/goal_recipe.sh, through the port's train entry on
# ${DEVICE:-cuda}.
#
# Why staged (docs/TRAINING_NOTES.md round 3): the as-published reward ledger
# makes the sparse frontier bistable — once the reach window dips, attempting
# (~-90/episode of action penalties) loses to abstention (~-0.3/episode of
# stalling) and PPO correctly finds standing still.  Two stabilizers: a std
# ceiling (kills the entropy/KL inflation entry into the trap) and curriculum
# safeties (downstep + rehearsal mixing, which keep the expected return of
# attempting positive).  Stage A runs the published hyperparameters +
# ceiling; stage B resumes A's best window with rehearsal mixing for the
# climb to the 3.8 m frontier.
#
#   nohup bash legged_tracking_torch/recipes/goal_recipe.sh > goal_recipe.log 2>&1 &
set -e
cd "$(dirname "$0")/../.."
ENVS=${ENVS:-4096}
A_ITERS=${A_ITERS:-4400}
B_ITERS=${B_ITERS:-5600}
DEVICE=${DEVICE:-cuda}

echo "=== stage A: published hparams + std ceiling + downstep ($A_ITERS) ==="
timeout 14400 python -m legged_tracking_torch.train --strategy goal --terrain random_pyramid \
  --num_envs $ENVS --iterations $A_ITERS --max_noise_std 1.0 \
  --cl_goal_target_dist 3.8 --cl_downstep 0.5 --logdir runs/goal_stageA --device $DEVICE

echo "=== stage B: resume best-window A + rehearsal mixing ($B_ITERS) ==="
CKPT=runs/goal_stageA/ac_weights_best.pkl
[ -f "$CKPT" ] || CKPT=runs/goal_stageA/ac_weights_last.pkl
timeout 14400 python -m legged_tracking_torch.train --strategy goal --terrain random_pyramid \
  --num_envs $ENVS --iterations $B_ITERS --max_noise_std 1.0 \
  --cl_goal_target_dist 3.8 --cl_downstep 0.5 --cl_dist_mix 0.25 \
  --critic_warmup 10 --resume "$CKPT" --logdir runs/goal_stageB --device $DEVICE

echo "=== recipe done: runs/goal_stageB/ac_weights_best.pkl ==="
