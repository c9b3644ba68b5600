// What a kernel launch asks the runtime that is not a stream operation —
// the dynamic shared memory limit a function is allowed, and how many of
// its CTAs stay resident on the card — made once per process: on the first
// launch that needs a value (an eager one: the engine runs each tick
// eagerly before it captures it), and read from a table after that.  So a
// launch being captured into a CUDA graph makes stream calls only.  The
// tables are keyed by the current device (cudaGetDevice reads the calling
// thread's device and reaches no stream), function and size.
#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>

namespace launch_once {

inline std::mutex& table_mutex() {
  static std::mutex m;
  return m;
}

// Allows `kern` `bytes` of dynamic shared memory once it needs over 48 KB.
// The limit a (device, function) was given only grows, so the runtime is
// asked again only for a size larger than any before.
inline int allow_smem(const void* kern, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  static std::map<std::tuple<int, const void*>, size_t> allowed;
  std::lock_guard<std::mutex> lock(table_mutex());
  size_t& have = allowed[{dev, kern}];
  if (have >= bytes) return 0;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (e == cudaSuccess) have = bytes;
  return static_cast<int>(e);
}

// CTAs of `kern` (at `threads` threads and `smem` bytes of dynamic shared
// memory) resident on the whole card at once, at least one per SM: the SM
// count times the occupancy calculator's blocks per SM.
inline int resident_ctas(const void* kern, int threads, size_t smem,
                         int* ctas) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  static std::map<std::tuple<int, const void*, int, size_t>, int> known;
  std::lock_guard<std::mutex> lock(table_mutex());
  const auto key = std::make_tuple(dev, kern, threads, smem);
  const auto it = known.find(key);
  if (it != known.end()) {
    *ctas = it->second;
    return 0;
  }
  int sms = 0, occ = 0;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, threads,
                                                         smem)) != cudaSuccess)
    return static_cast<int>(e);
  *ctas = known[key] = sms * std::max(occ, 1);
  return 0;
}

}  // namespace launch_once
