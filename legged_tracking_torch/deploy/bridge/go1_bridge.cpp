// Go1 low-level LCM bridge — the deploy stack's equivalent of the reference
// go1_gym_deploy/unitree_legged_sdk_bin/lcm_position.cpp (:21-236).
//
// Runs on the robot at 500 Hz:
//   - subscribes "pd_plustau_targets" (joint PD targets from the policy)
//   - applies position limits + power protection, forwards to the motors
//   - publishes "leg_control_data" (joint state), "state_estimator_data"
//     (IMU), and "rc_command" (joystick) back to the policy process
//   - on startup holds the current pose until the first command arrives
//
// With -DUSE_LOOPBACK (default build) the motor link is an in-process PD
// stub so the binary is buildable/testable without the vendor SDK; the
// UnitreeSdkLink adapter slot is where the closed unitree_legged_sdk UDP
// object plugs in on the real Jetson.

#include <atomic>
#include <chrono>
#include <cstdio>
#include <cstring>
#include <memory>
#include <thread>

#include "mini_lcm.hpp"
#include "robot_link.hpp"

namespace {

struct Bridge {
  explicit Bridge(std::unique_ptr<go1::RobotLink> link, int max_ticks = -1)
      : link_(std::move(link)), max_ticks_(max_ticks) {
    lcm_.subscribe("pd_plustau_targets", [this](const uint8_t* d, size_t n) {
      minilcm::PdTauTargets msg;
      if (msg.decode(d, n)) {
        command_ = msg;
        have_command_ = true;
      }
    });
    rx_thread_ = std::thread([this] {
      while (running_) lcm_.handle_once(100);
    });
  }

  ~Bridge() {
    running_ = false;
    rx_thread_.join();
  }

  void control_tick() {
    go1::LowState state;
    link_->recv(state);

    // joystick passthrough (wirelessRemote layout: reference :136-166)
    minilcm::RcCommand rc;
    std::memcpy(&rc.left_stick[0], state.wirelessRemote.data() + 4, 4);
    std::memcpy(&rc.left_stick[1], state.wirelessRemote.data() + 20, 4);
    std::memcpy(&rc.right_stick[0], state.wirelessRemote.data() + 8, 4);
    std::memcpy(&rc.right_stick[1], state.wirelessRemote.data() + 12, 4);
    rc.mode = mode_;
    lcm_.publish("rc_command", rc.encode());

    minilcm::LegControlData legs;
    for (int i = 0; i < 12; ++i) {
      legs.q[i] = state.motorState[i].q;
      legs.qd[i] = state.motorState[i].dq;
      legs.tau_est[i] = state.motorState[i].tauEst;
    }
    legs.timestamp_us = now_us();
    lcm_.publish("leg_control_data", legs.encode());

    minilcm::StateEstimatorData body;
    for (int i = 0; i < 4; ++i) {
      body.quat[i] = state.imu.quaternion[i];
      body.contact_estimate[i] = state.footForce[i];
    }
    for (int i = 0; i < 3; ++i) {
      body.rpy[i] = state.imu.rpy[i];
      body.aBody[i] = state.imu.accelerometer[i];
      body.omegaBody[i] = state.imu.gyroscope[i];
    }
    body.timestamp_us = now_us();
    lcm_.publish("state_estimator_data", body.encode());

    // hold the measured pose until the first policy command (reference :192-197)
    if (first_run_ && state.motorState[0].q != 0.0f) {
      for (int i = 0; i < 12; ++i) {
        command_.q_des[i] = state.motorState[i].q;
        command_.kp[i] = 20.0;
        command_.kd[i] = 0.5;
      }
      first_run_ = false;
    }

    go1::LowCmd cmd;
    for (int i = 0; i < 12; ++i) {
      cmd.motorCmd[i].q = static_cast<float>(command_.q_des[i]);
      cmd.motorCmd[i].dq = static_cast<float>(command_.qd_des[i]);
      cmd.motorCmd[i].Kp = static_cast<float>(command_.kp[i]);
      cmd.motorCmd[i].Kd = static_cast<float>(command_.kd[i]);
      cmd.motorCmd[i].tau = static_cast<float>(command_.tau_ff[i]);
    }
    go1::Safety::position_limit(cmd);
    go1::Safety::power_protect(cmd, state, 9);
    link_->send(cmd);
    ++ticks_;
  }

  void run(float dt = 0.002f) {
    using clock = std::chrono::steady_clock;
    auto next = clock::now();
    while (running_ && (max_ticks_ < 0 || ticks_ < max_ticks_)) {
      control_tick();
      next += std::chrono::microseconds(static_cast<int>(dt * 1e6f));
      std::this_thread::sleep_until(next);
    }
  }

  static int64_t now_us() {
    return std::chrono::duration_cast<std::chrono::microseconds>(
               std::chrono::system_clock::now().time_since_epoch())
        .count();
  }

  minilcm::LCM lcm_;
  std::unique_ptr<go1::RobotLink> link_;
  minilcm::PdTauTargets command_{};
  std::atomic<bool> have_command_{false};
  std::atomic<bool> running_{true};
  bool first_run_ = true;
  int mode_ = 0;
  int ticks_ = 0;
  int max_ticks_;
  std::thread rx_thread_;
};

}  // namespace

int main(int argc, char** argv) {
  int max_ticks = -1;
  if (argc > 1) max_ticks = std::atoi(argv[1]);  // bounded run for tests
#ifdef USE_UNITREE_SDK
  // Real robot: adapt the vendor SDK's UDP object here (LOWLEVEL,
  // 192.168.123.10:8007) — see reference lcm_position.cpp:24.
  std::fprintf(stderr, "unitree sdk link not built in this environment\n");
  return 1;
#else
  auto link = std::make_unique<go1::LoopbackLink>();
#endif
  std::printf("go1_bridge: 500 Hz loop starting (loopback=%d)\n",
#ifdef USE_UNITREE_SDK
              0
#else
              1
#endif
  );
  Bridge bridge(std::move(link), max_ticks);
  bridge.run();
  std::printf("go1_bridge: done after %d ticks\n", bridge.ticks_);
  return 0;
}
