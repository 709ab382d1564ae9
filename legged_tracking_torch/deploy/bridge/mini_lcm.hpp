// Minimal self-contained LCM transport + message codecs for the Go1 bridge.
//
// Implements the LCM UDP-multicast wire protocol (single-fragment "LC02"
// packets) and the lcm-gen fingerprint/encoding scheme for the four bridge
// message types, so this binary interoperates with both stock liblcm peers
// and the python deploy stack (legged_tracking_torch/deploy/lcm_lite.py) with
// zero external dependencies.  The bus is stock LCM's LCM_DEFAULT_URL
// (udpm://ADDR:PORT) when it is set, else 239.255.76.67:7667, as in lcm_lite.py.
//
// Equivalent role to liblcm + lcm-gen headers in the reference bridge
// (go1_gym_deploy/unitree_legged_sdk_bin/lcm_position.cpp:12-16).

#pragma once

#include <arpa/inet.h>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <map>
#include <netinet/in.h>
#include <string>
#include <sys/socket.h>
#include <unistd.h>
#include <vector>

namespace minilcm {

constexpr uint32_t kMagic = 0x4C433032;  // "LC02"

// ----------------------------------------------------------- type hashing
inline uint64_t hash_update(uint64_t v, uint8_t c) {
  v = (v << 8) ^ (v >> 55);
  return v + c;
}
inline uint64_t hash_string(uint64_t v, const char* s) {
  size_t n = std::strlen(s);
  v = hash_update(v, static_cast<uint8_t>(n));
  for (size_t i = 0; i < n; ++i) v = hash_update(v, static_cast<uint8_t>(s[i]));
  return v;
}

struct Member {
  const char* name;
  const char* type;   // primitive type name
  int dim;            // 0 = scalar, n = fixed array length
};

inline uint64_t fingerprint(const Member* members, int n) {
  uint64_t v = 0x12345678;
  for (int i = 0; i < n; ++i) {
    v = hash_string(v, members[i].name);
    v = hash_string(v, members[i].type);
    v = hash_update(v, members[i].dim ? 1 : 0);
    if (members[i].dim) {
      v = hash_update(v, 0);  // LCM_CONST
      char buf[16];
      std::snprintf(buf, sizeof(buf), "%d", members[i].dim);
      v = hash_string(v, buf);
    }
  }
  return (v << 1) + ((v >> 63) & 1);
}

// -------------------------------------------------------- BE serialization
struct Writer {
  std::vector<uint8_t> buf;
  void u64(uint64_t v) {
    for (int i = 7; i >= 0; --i) buf.push_back((v >> (8 * i)) & 0xFF);
  }
  void i64(int64_t v) { u64(static_cast<uint64_t>(v)); }
  void i16(int16_t v) {
    buf.push_back((v >> 8) & 0xFF);
    buf.push_back(v & 0xFF);
  }
  void f32(float v) {
    uint32_t u;
    std::memcpy(&u, &v, 4);
    for (int i = 3; i >= 0; --i) buf.push_back((u >> (8 * i)) & 0xFF);
  }
  void f64(double v) {
    uint64_t u;
    std::memcpy(&u, &v, 8);
    u64(u);
  }
};

struct Reader {
  const uint8_t* p;
  size_t n, off = 0;
  bool ok = true;
  uint64_t u64() {
    if (off + 8 > n) { ok = false; return 0; }
    uint64_t v = 0;
    for (int i = 0; i < 8; ++i) v = (v << 8) | p[off++];
    return v;
  }
  int64_t i64() { return static_cast<int64_t>(u64()); }
  int16_t i16() {
    if (off + 2 > n) { ok = false; return 0; }
    int16_t v = (p[off] << 8) | p[off + 1];
    off += 2;
    return v;
  }
  float f32() {
    if (off + 4 > n) { ok = false; return 0; }
    uint32_t u = 0;
    for (int i = 0; i < 4; ++i) u = (u << 8) | p[off++];
    float v;
    std::memcpy(&v, &u, 4);
    return v;
  }
  double f64() {
    uint64_t u = u64();
    double v;
    std::memcpy(&v, &u, 8);
    return v;
  }
};

// ----------------------------------------------------------- message types
struct PdTauTargets {
  double q_des[12]{}, qd_des[12]{}, tau_ff[12]{}, kp[12]{}, kd[12]{};
  int64_t timestamp_us{}, id{}, robot_id{};
  double se_contactState[4]{};

  static uint64_t fp() {
    static const Member m[] = {
        {"q_des", "double", 12},   {"qd_des", "double", 12},
        {"tau_ff", "double", 12},  {"kp", "double", 12},
        {"kd", "double", 12},      {"timestamp_us", "int64_t", 0},
        {"id", "int64_t", 0},      {"robot_id", "int64_t", 0},
        {"se_contactState", "double", 4}};
    return fingerprint(m, 9);
  }
  std::vector<uint8_t> encode() const {
    Writer w;
    w.u64(fp());
    for (double v : q_des) w.f64(v);
    for (double v : qd_des) w.f64(v);
    for (double v : tau_ff) w.f64(v);
    for (double v : kp) w.f64(v);
    for (double v : kd) w.f64(v);
    w.i64(timestamp_us); w.i64(id); w.i64(robot_id);
    for (double v : se_contactState) w.f64(v);
    return w.buf;
  }
  bool decode(const uint8_t* data, size_t n) {
    Reader r{data, n};
    if (r.u64() != fp()) return false;
    for (double& v : q_des) v = r.f64();
    for (double& v : qd_des) v = r.f64();
    for (double& v : tau_ff) v = r.f64();
    for (double& v : kp) v = r.f64();
    for (double& v : kd) v = r.f64();
    timestamp_us = r.i64(); id = r.i64(); robot_id = r.i64();
    for (double& v : se_contactState) v = r.f64();
    return r.ok;
  }
};

struct LegControlData {
  float q[12]{}, qd[12]{}, p[12]{}, v[12]{}, tau_est[12]{};
  int64_t timestamp_us{}, id{}, robot_id{};

  static uint64_t fp() {
    static const Member m[] = {
        {"q", "float", 12},  {"qd", "float", 12}, {"p", "float", 12},
        {"v", "float", 12},  {"tau_est", "float", 12},
        {"timestamp_us", "int64_t", 0}, {"id", "int64_t", 0},
        {"robot_id", "int64_t", 0}};
    return fingerprint(m, 8);
  }
  std::vector<uint8_t> encode() const {
    Writer w;
    w.u64(fp());
    for (float x : q) w.f32(x);
    for (float x : qd) w.f32(x);
    for (float x : p) w.f32(x);
    for (float x : v) w.f32(x);
    for (float x : tau_est) w.f32(x);
    w.i64(timestamp_us); w.i64(id); w.i64(robot_id);
    return w.buf;
  }
};

struct StateEstimatorData {
  float p[3]{}, vWorld[3]{}, vBody[3]{}, rpy[3]{}, omegaBody[3]{},
      omegaWorld[3]{}, quat[4]{}, contact_estimate[4]{}, aBody[3]{}, aWorld[3]{};
  int64_t timestamp_us{}, id{}, robot_id{};

  static uint64_t fp() {
    static const Member m[] = {
        {"p", "float", 3},        {"vWorld", "float", 3},
        {"vBody", "float", 3},    {"rpy", "float", 3},
        {"omegaBody", "float", 3}, {"omegaWorld", "float", 3},
        {"quat", "float", 4},     {"contact_estimate", "float", 4},
        {"aBody", "float", 3},    {"aWorld", "float", 3},
        {"timestamp_us", "int64_t", 0}, {"id", "int64_t", 0},
        {"robot_id", "int64_t", 0}};
    return fingerprint(m, 13);
  }
  std::vector<uint8_t> encode() const {
    Writer w;
    w.u64(fp());
    for (float x : p) w.f32(x);
    for (float x : vWorld) w.f32(x);
    for (float x : vBody) w.f32(x);
    for (float x : rpy) w.f32(x);
    for (float x : omegaBody) w.f32(x);
    for (float x : omegaWorld) w.f32(x);
    for (float x : quat) w.f32(x);
    for (float x : contact_estimate) w.f32(x);
    for (float x : aBody) w.f32(x);
    for (float x : aWorld) w.f32(x);
    w.i64(timestamp_us); w.i64(id); w.i64(robot_id);
    return w.buf;
  }
};

struct RcCommand {
  int16_t mode{};
  float left_stick[2]{}, right_stick[2]{}, knobs[2]{};
  int16_t left_upper_switch{}, left_lower_left_switch{},
      left_lower_right_switch{}, right_upper_switch{},
      right_lower_left_switch{}, right_lower_right_switch{};

  static uint64_t fp() {
    static const Member m[] = {
        {"mode", "int16_t", 0},        {"left_stick", "float", 2},
        {"right_stick", "float", 2},   {"knobs", "float", 2},
        {"left_upper_switch", "int16_t", 0},
        {"left_lower_left_switch", "int16_t", 0},
        {"left_lower_right_switch", "int16_t", 0},
        {"right_upper_switch", "int16_t", 0},
        {"right_lower_left_switch", "int16_t", 0},
        {"right_lower_right_switch", "int16_t", 0}};
    return fingerprint(m, 10);
  }
  std::vector<uint8_t> encode() const {
    Writer w;
    w.u64(fp());
    w.i16(mode);
    for (float x : left_stick) w.f32(x);
    for (float x : right_stick) w.f32(x);
    for (float x : knobs) w.f32(x);
    w.i16(left_upper_switch); w.i16(left_lower_left_switch);
    w.i16(left_lower_right_switch); w.i16(right_upper_switch);
    w.i16(right_lower_left_switch); w.i16(right_lower_right_switch);
    return w.buf;
  }
};

// --------------------------------------------------------------- transport
struct Url {
  std::string addr = "239.255.76.67";
  int port = 7667;
};

// LCM_DEFAULT_URL ("udpm://ADDR:PORT", options after '?' ignored), else the
// reference's bus.
inline Url default_url() {
  Url url;
  const char* env = std::getenv("LCM_DEFAULT_URL");
  if (env == nullptr || *env == 0) return url;
  std::string s(env);
  const std::string scheme = "udpm://";
  if (s.compare(0, scheme.size(), scheme) != 0) {
    std::fprintf(stderr, "LCM_DEFAULT_URL=%s: only udpm://ADDR:PORT is supported\n", env);
    std::exit(2);
  }
  s = s.substr(scheme.size());
  s = s.substr(0, s.find('?'));
  size_t colon = s.find(':');
  url.addr = s.substr(0, colon);
  if (colon != std::string::npos) url.port = std::atoi(s.c_str() + colon + 1);
  return url;
}

class LCM {
 public:
  LCM() : LCM(default_url()) {}
  explicit LCM(const Url& url) {
    const char* addr = url.addr.c_str();
    int port = url.port;
    fd_ = ::socket(AF_INET, SOCK_DGRAM, IPPROTO_UDP);
    int one = 1;
    setsockopt(fd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    unsigned char loop = 1, ttl = 0;
    setsockopt(fd_, IPPROTO_IP, IP_MULTICAST_LOOP, &loop, sizeof(loop));
    setsockopt(fd_, IPPROTO_IP, IP_MULTICAST_TTL, &ttl, sizeof(ttl));
    std::memset(&dest_, 0, sizeof(dest_));
    dest_.sin_family = AF_INET;
    dest_.sin_port = htons(port);
    inet_pton(AF_INET, addr, &dest_.sin_addr);
    sockaddr_in local = dest_;
    local.sin_addr.s_addr = htonl(INADDR_ANY);
    bind(fd_, reinterpret_cast<sockaddr*>(&local), sizeof(local));
    ip_mreq mreq{};
    inet_pton(AF_INET, addr, &mreq.imr_multiaddr);
    mreq.imr_interface.s_addr = htonl(INADDR_ANY);
    setsockopt(fd_, IPPROTO_IP, IP_ADD_MEMBERSHIP, &mreq, sizeof(mreq));
  }
  ~LCM() { ::close(fd_); }

  void publish(const std::string& channel, const std::vector<uint8_t>& payload) {
    std::vector<uint8_t> pkt(8);
    uint32_t magic = htonl(kMagic), seq = htonl(seq_++);
    std::memcpy(pkt.data(), &magic, 4);
    std::memcpy(pkt.data() + 4, &seq, 4);
    pkt.insert(pkt.end(), channel.begin(), channel.end());
    pkt.push_back(0);
    pkt.insert(pkt.end(), payload.begin(), payload.end());
    sendto(fd_, pkt.data(), pkt.size(), 0,
           reinterpret_cast<sockaddr*>(&dest_), sizeof(dest_));
  }

  using Handler = std::function<void(const uint8_t*, size_t)>;
  void subscribe(const std::string& channel, Handler h) { handlers_[channel] = h; }

  // handle one packet; returns false on timeout
  bool handle_once(int timeout_ms) {
    timeval tv{timeout_ms / 1000, (timeout_ms % 1000) * 1000};
    setsockopt(fd_, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    uint8_t buf[65536];
    ssize_t n = recv(fd_, buf, sizeof(buf), 0);
    if (n < 9) return false;
    uint32_t magic;
    std::memcpy(&magic, buf, 4);
    if (ntohl(magic) != kMagic) return false;
    size_t i = 8;
    while (i < static_cast<size_t>(n) && buf[i] != 0) ++i;
    std::string channel(reinterpret_cast<char*>(buf) + 8, i - 8);
    auto it = handlers_.find(channel);
    if (it != handlers_.end() && i + 1 <= static_cast<size_t>(n))
      it->second(buf + i + 1, n - i - 1);
    return true;
  }

 private:
  int fd_;
  sockaddr_in dest_{};
  uint32_t seq_ = 0;
  std::map<std::string, Handler> handlers_;
};

}  // namespace minilcm
