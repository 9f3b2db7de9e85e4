// Position-plane build for Hopper: the planes of many terms of one leaf in
// one launch, one CTA a work item (a postings block of one term).
//
// Replaces no TPU kernel: the reference builds a plane with XLA ops in a
// lax.scan (rucene_tpu/ops/phrase_plane.py build_position_plane), and the
// port built it with about 40 ATen launches a term
// (ops/phrase_plane.py build_position_plane, now the CPU twin). A leaf's
// misses are a few thousand blocks, so the device work is tiny and the
// chain of launches, issued term after term, held the card idle. This
// kernel takes the work list over the concatenated blocks of every miss
// and builds every plane at once. Twin: ops/phrase_plane.py
// build_position_plane applied to each term.
//
// Bound: device-memory bytes. An item reads its lanes' docs and freqs
// (12 bytes a lane, from the wrapper's one work_lanes call), its four
// table entries and the position words its lanes' first FMAX occurrences
// span, and sets bits in the words of its docs' plane rows and overflow
// bytes. At a serving call's few thousand items that is a few MB, so what
// bounds the kernel is latency: one CTA of 128 threads an item, one thread
// a lane; a block-wide exclusive scan of the freqs (warp shuffles, then the
// four warp totals through shared memory, the only barrier) gives each lane
// its first occurrence's index in the term's delta stream; each lane then
// walks up to min(freq, FMAX) deltas, two 32-bit words a read as
// unpack_positions does, prefix-summing them into positions. No
// [C, 128, fwin] transient exists: the twin's temporaries were that.
//
// Each in-range position's bit goes into its plane word with a 32-bit
// atomicAdd of 1 << (p & 31): the same integer sum as the twin's
// index_add_, so the planes are bit-equal even if two occurrences shared a
// position (the add carries, as the twin's does). A lane whose freq
// exceeds FMAX, or one of whose positions is at least 32 * words, sets
// its doc's overflow byte; positions never fall, so the walk stops at the
// first one past the plane. Lanes of freq 0 (past a block's count) do
// nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;  // postings a block, one thread each
constexpr int kWarps = kLanes / 32;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kLanes)
build_position_planes_kernel(const int32_t* __restrict__ docs,
                             const int64_t* __restrict__ freqs,
                             const int64_t* __restrict__ item_plane,
                             const int32_t* __restrict__ item_pos_base,
                             const int64_t* __restrict__ item_width,
                             const int64_t* __restrict__ item_word_start,
                             const uint32_t* __restrict__ positions, int64_t pos_last,
                             const int64_t* __restrict__ plane_ptr,
                             const int64_t* __restrict__ overflow_ptr, int words,
                             int64_t max_doc, int fmax) {
  __shared__ long long warp_total[kWarps];
  const int64_t item = blockIdx.x;
  const int lane = threadIdx.x;
  const int wl = lane & 31;
  const int64_t at = item * kLanes + lane;
  const long long f = freqs[at];

  long long incl = f;  // inclusive scan of the freqs within the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = __shfl_up_sync(kFull, incl, d);
    if (wl >= d) incl += y;
  }
  if (wl == 31) warp_total[lane >> 5] = incl;
  __syncthreads();
  long long occ = incl - f;  // exclusive: occurrences of the earlier lanes
  for (int w = 0; w < (lane >> 5); ++w) occ += warp_total[w];
  if (f <= 0) return;
  const int64_t doc = docs[at];
  if (doc < 0 || doc >= max_doc) return;

  const int64_t t = item_plane[item];
  auto* row = reinterpret_cast<unsigned int*>(plane_ptr[t]) + doc * words;
  const int64_t width = item_width[item];
  const int64_t word_start = item_word_start[item];
  const uint64_t mask = (1ull << width) - 1;
  const int64_t pmax = 32LL * words;
  const int n = f < fmax ? static_cast<int>(f) : fmax;
  bool over = f > fmax;
  int64_t bitpos = (static_cast<int64_t>(item_pos_base[item]) + occ) * width;
  int64_t pos = 0;
  for (int j = 0; j < n; ++j, bitpos += width) {
    int64_t w0 = word_start + (bitpos >> 5);
    int64_t w1 = w0 + 1;
    w0 = w0 < 0 ? 0 : (w0 > pos_last ? pos_last : w0);
    w1 = w1 < 0 ? 0 : (w1 > pos_last ? pos_last : w1);
    const uint64_t pair = (static_cast<uint64_t>(__ldg(positions + w1)) << 32) |
                          static_cast<uint64_t>(__ldg(positions + w0));
    pos += static_cast<int64_t>((pair >> (bitpos & 31)) & mask);
    if (pos >= pmax) {
      over = true;
      break;
    }
    atomicAdd(row + (pos >> 5), 1u << (pos & 31));
  }
  if (over) reinterpret_cast<uint8_t*>(overflow_ptr[t])[doc] = 1;
}

}  // namespace

// docs i32[W, 128] (INVALID_DOC past a block's count), freqs i64[W, 128]
// (0 past it): the items' lanes. item_plane, item_width, item_word_start
// i64[W]: each item's target plane (an index into plane_ptr and
// overflow_ptr), its term's delta width and the word where its term's
// stream starts; item_pos_base i32[W]: the block's first occurrence index
// in that stream. positions: the leaf's packed delta words (u32 bits),
// pos_last its last index. plane_ptr, overflow_ptr i64[T]: each target's
// zeroed i32[max_doc, words] plane and bool[max_doc] overflow column.
// Returns cudaGetLastError().
extern "C" int rtt_build_position_planes(const void* docs, const void* freqs,
                                         const void* item_plane, const void* item_pos_base,
                                         const void* item_width, const void* item_word_start,
                                         const void* positions, int64_t pos_last,
                                         const void* plane_ptr, const void* overflow_ptr,
                                         int64_t n_items, int words, int64_t max_doc, int fmax,
                                         void* stream) {
  if (n_items <= 0) return 0;
  build_position_planes_kernel<<<static_cast<unsigned>(n_items), kLanes, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(docs), static_cast<const int64_t*>(freqs),
      static_cast<const int64_t*>(item_plane), static_cast<const int32_t*>(item_pos_base),
      static_cast<const int64_t*>(item_width), static_cast<const int64_t*>(item_word_start),
      static_cast<const uint32_t*>(positions), pos_last,
      static_cast<const int64_t*>(plane_ptr), static_cast<const int64_t*>(overflow_ptr), words,
      max_doc, fmax);
  return static_cast<int>(cudaGetLastError());
}
