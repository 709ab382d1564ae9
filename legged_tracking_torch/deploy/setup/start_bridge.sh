#!/bin/bash
# Start the 500 Hz motor bridge (equivalent of start_unitree_sdk.sh).
# Run ON the robot with the legs OFF the ground first.
set -euo pipefail
cd "$(dirname "$0")/../bridge/build"
echo "WARNING: make sure the robot is hung up. Press Enter to continue..."
read -r
exec ./go1_bridge
