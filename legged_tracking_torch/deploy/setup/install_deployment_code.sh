#!/bin/bash
# Install the deployment stack on the Go1's onboard Jetson
# (equivalent of go1_gym_deploy/installer/install_deployment_code.sh).
# The policy runs through PyTorch on the Jetson's GPU; the robot needs
# torch and numpy installed.
set -euo pipefail

ROBOT=${1:-unitree@192.168.123.15}
REPO_ROOT="$(cd "$(dirname "$0")/../../.." && pwd)"

echo "== copying deployment code to $ROBOT =="
rsync -av --exclude build --exclude __pycache__ \
    "$REPO_ROOT/legged_tracking_torch" \
    "$ROBOT:~/legged_tracking/"

echo "== building the C++ bridge on the robot =="
ssh "$ROBOT" 'cd ~/legged_tracking/legged_tracking_torch/deploy/bridge && mkdir -p build && cd build \
  && cmake .. -DUNITREE_SDK_DIR=$HOME/unitree_legged_sdk && make -j'

echo "done — start with legged_tracking_torch/deploy/setup/start_bridge.sh on the robot,"
echo "then: cd ~/legged_tracking && python3 -m legged_tracking_torch.deploy_traj_policy --logdir RUN"
