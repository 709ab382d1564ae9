// Robot low-level link abstraction.
//
// The reference bridge talks to the vendor's closed unitree_legged_sdk
// (UDP @ 192.168.123.10:8007 + Safety layer, lcm_position.cpp:24,35).  This
// header defines the same LowCmd/LowState data model behind a RobotLink
// interface with two implementations:
//   - UnitreeSdkLink (go1_bridge.cpp, compiled only when UNITREE_SDK_DIR is
//     provided to CMake): thin adapter over the vendor SDK.
//   - LoopbackLink: an in-process PD-robot stub used for CI/interop tests.

#pragma once

#include <array>
#include <cmath>
#include <cstdint>

namespace go1 {

struct MotorCmd {
  float q = 0, dq = 0, tau = 0, Kp = 0, Kd = 0;
};
struct MotorState {
  float q = 0, dq = 0, tauEst = 0;
};
struct IMU {
  std::array<float, 4> quaternion{0, 0, 0, 1};
  std::array<float, 3> gyroscope{};
  std::array<float, 3> accelerometer{0, 0, 9.81f};
  std::array<float, 3> rpy{};
};
struct LowCmd {
  std::array<MotorCmd, 12> motorCmd;
};
struct LowState {
  std::array<MotorState, 12> motorState;
  IMU imu;
  std::array<int16_t, 4> footForce{};
  std::array<uint8_t, 40> wirelessRemote{};
};

class RobotLink {
 public:
  virtual ~RobotLink() = default;
  virtual void recv(LowState& state) = 0;
  virtual void send(const LowCmd& cmd) = 0;
};

// Soft safety layer mirroring the SDK's PositionLimit/PowerProtect
// (reference lcm_position.cpp:207-208).
class Safety {
 public:
  // Go1 joint limits (hip, thigh, calf) per leg — from go1.urdf.
  static constexpr float kLow[3] = {-0.863f, -0.686f, -2.818f};
  static constexpr float kHigh[3] = {0.863f, 4.501f, -0.888f};
  static constexpr float kTauMax[3] = {23.7f, 23.7f, 35.55f};

  static void position_limit(LowCmd& cmd) {
    for (int i = 0; i < 12; ++i) {
      int j = i % 3;
      if (cmd.motorCmd[i].q < kLow[j]) cmd.motorCmd[i].q = kLow[j];
      if (cmd.motorCmd[i].q > kHigh[j]) cmd.motorCmd[i].q = kHigh[j];
    }
  }
  static void power_protect(LowCmd& cmd, const LowState& state, int level) {
    // clamp the commanded PD torque estimate to level/10 of max torque
    float frac = static_cast<float>(level) / 10.0f;
    for (int i = 0; i < 12; ++i) {
      const auto& m = cmd.motorCmd[i];
      float tau = m.tau + m.Kp * (m.q - state.motorState[i].q) +
                  m.Kd * (m.dq - state.motorState[i].dq);
      float cap = kTauMax[i % 3] * frac;
      if (tau > cap) cmd.motorCmd[i].tau -= (tau - cap);
      if (tau < -cap) cmd.motorCmd[i].tau -= (tau + cap);
    }
  }
};

// In-process stand-in robot: first-order PD joint response + static IMU.
class LoopbackLink : public RobotLink {
 public:
  explicit LoopbackLink(float dt = 0.002f) : dt_(dt) {
    const float nominal[3] = {-0.1f, 0.8f, -1.5f};
    for (int i = 0; i < 12; ++i) state_.motorState[i].q = nominal[i % 3];
  }
  void recv(LowState& state) override { state = state_; }
  void send(const LowCmd& cmd) override {
    for (int i = 0; i < 12; ++i) {
      auto& ms = state_.motorState[i];
      const auto& mc = cmd.motorCmd[i];
      float tau = mc.tau + mc.Kp * (mc.q - ms.q) + mc.Kd * (mc.dq - ms.dq);
      ms.dq = 0.9f * ms.dq + tau * dt_ * 10.0f;
      ms.q += ms.dq * dt_;
      ms.tauEst = tau;
    }
    for (int i = 0; i < 4; ++i) state_.footForce[i] = 250;  // standing
  }

 private:
  float dt_;
  LowState state_{};
};

}  // namespace go1
