// The library's count of its kernel launches, kept on the host.
//
// Every launch of every kernel in this directory passes its stream through
// tvc::counted, which adds one, so that a caller can check how many kernels
// a call launched from a count that cannot lose a launch (a profiler's
// kernel records are buffered and now and then dropped: they time, this
// counts). tvc_launch_count() reads it. Both are inline, so every source
// that includes this header shares the one counter of the library.
#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace tvc {

inline std::atomic<long long> launches{0};

inline cudaStream_t counted(cudaStream_t s) {
  launches.fetch_add(1, std::memory_order_relaxed);
  return s;
}

}  // namespace tvc

// `used`: emitted (and exported) by every source that includes this header.
extern "C" __attribute__((used)) inline long long tvc_launch_count() {
  return tvc::launches.load(std::memory_order_relaxed);
}
