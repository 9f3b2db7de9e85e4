// Ordered segmented f32 sum for Hopper: lanes already sorted so that each
// group is contiguous and in work-list item order -> one sum a group, left
// to right from +0.0, one rounding an add.
//
// The port's own kernel: it replaces no TPU kernel. The reference sums a
// (row, doc)'s clause scores with XLA scatters and scans that have a fixed
// order; on the card every torch call that could take their place
// (index_add_, index_put_ with accumulate, scatter_add_) adds with float
// atomics, in an order that changes from run to run. The flat executor's
// candidate branch (search/executor.py) sums through this kernel instead.
// Twin: ops/ordered_sum.py segment_sum_ordered_plain, a CPU index_add_
// (which adds in index order).
//
// Bound: device-memory bytes. A segmented sum must read each lane's value
// and start flag once and write each group's sum once; this kernel also
// reads each group head's id (the wrapper's scan of the flags), which the
// bound does not count. One thread a lane: a thread whose lane starts a
// group walks that group's lanes in order (its neighbours' loads hit the
// same lines, so the walk reads each line about once) and writes the sum
// at its group id; the others return. Groups are a (row, doc)'s clauses, a few lanes each, so
// the serial walk is short; the executor gives each out-of-range lane a
// group of its own, so no long pad group forms.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
segment_sum_ordered_kernel(const float* __restrict__ values,
                           const bool* __restrict__ seg_start,
                           const int64_t* __restrict__ gid,
                           float* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n || !seg_start[i]) return;
  float s = 0.0f;
  int64_t j = i;
  do {
    s = __fadd_rn(s, values[j]);
    ++j;
  } while (j < n && !seg_start[j]);
  out[gid[i]] = s;
}

}  // namespace

// values f32[n]; seg_start bool[n] (seg_start[0] true); gid i64[n], the
// group of each lane (0 at lane 0, +1 at each later start); out f32[>=
// groups]: each group's slot written, nothing else. Returns
// cudaGetLastError().
extern "C" int rtt_segment_sum_ordered(const void* values, const void* seg_start,
                                       const void* gid, void* out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  segment_sum_ordered_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), static_cast<const bool*>(seg_start),
      static_cast<const int64_t*>(gid), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
