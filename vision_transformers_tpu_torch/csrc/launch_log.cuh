// The kernels a library launched, counted by name.
//
// Every launch site of csrc/*.cu returns vtt::launched("<kernel>"): the
// launch's cudaGetLastError(), and the kernel counted when it launched. The
// three C entries below read and clear the counts (ops/_build.py's
// `launched` and `reset_launched`), so a caller can tell which kernels a
// call took (the route checks of chip_smoke.py and of the card tests)
// without a profiler. Each source is its own library, so each has its own
// log.
#pragma once

#include <cuda_runtime.h>

#include <cstring>
#include <mutex>

namespace vtt {
namespace {

struct LaunchLog {
  static constexpr int kSlots = 32;  // kernels of one library, at most
  std::mutex mu;
  const char* names[kSlots] = {};
  long long counts[kSlots] = {};
};

LaunchLog& launch_log() {
  static LaunchLog log;
  return log;
}

// The error of the launch just made; `kernel` counted once if there is none.
inline int launched(const char* kernel) {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  LaunchLog& log = launch_log();
  std::lock_guard<std::mutex> lock(log.mu);
  for (int i = 0; i < LaunchLog::kSlots; ++i) {
    if (log.names[i] == nullptr) log.names[i] = kernel;
    if (std::strcmp(log.names[i], kernel) == 0) {
      ++log.counts[i];
      break;
    }
  }
  return 0;
}

}  // namespace
}  // namespace vtt

extern "C" {

// The name of the kernel in `slot` of this library's log, or null past the
// last one launched.
const char* vtt_launch_name(int slot) {
  vtt::LaunchLog& log = vtt::launch_log();
  std::lock_guard<std::mutex> lock(log.mu);
  return slot >= 0 && slot < vtt::LaunchLog::kSlots ? log.names[slot]
                                                    : nullptr;
}

// Launches of the kernel in `slot` since the last vtt_launch_log_reset.
long long vtt_launch_count(int slot) {
  vtt::LaunchLog& log = vtt::launch_log();
  std::lock_guard<std::mutex> lock(log.mu);
  return slot >= 0 && slot < vtt::LaunchLog::kSlots ? log.counts[slot] : 0;
}

void vtt_launch_log_reset(void) {
  vtt::LaunchLog& log = vtt::launch_log();
  std::lock_guard<std::mutex> lock(log.mu);
  for (long long& c : log.counts) c = 0;
}

}  // extern "C"
