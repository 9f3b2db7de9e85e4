// Postings block decode for Hopper: one 128-posting block per CTA, in two
// entries that share one per-lane decode.
//
// rtt_decode_blocks replaces rucene_tpu/ops/pallas_decode.py::
// decode_work_items_pallas (K1): doc ids, freqs and norm bytes, written
// once per segment into the decoded residency. Twin: ops/cuda_decode.py
// decode_blocks_plain (on ops/decode.py).
//
// rtt_decode_score_blocks replaces decode_score_work_items_pallas (K2):
// the same decode for a batch's work items on a packed segment, with the
// norm byte replaced by the BM25 denominator cval = cache[fid * 256 + norm],
// a copy of the table's f32 entry (never arithmetic on it, so it is
// bit-equal to the twin's gather). Twin: decode_score_blocks_plain.
//
// Each CTA has 128 threads, one per posting lane. A lane's value at width
// `bits` spans at most two u32 words: read both and funnel-shift. FOR doc
// ids are the block base plus an inclusive prefix sum (warp shuffle scan,
// then a carry across the four warps). EF doc ids select the lane-th set
// bit of the 384-bit unary plane: popcount prefixes over its 12 words find
// the word, __fns finds the bit inside it. A CTA branches on its own
// block's encoding. Lanes at or past `count` write INVALID_DOC and zero
// freq / norm byte / cval.
//
// Bound: device-memory bytes. A block reads at most 128 + 128 + 32 words
// (doc, freq and norm planes) and writes 128 * (4 + 2|4 + 1|4) bytes;
// nothing is reused, so the design keeps every read coalesced (neighbouring
// lanes read neighbouring words) and writes each output plane once. K2's
// [F, 256] denominator table is 1 KB per field: lanes read it through the
// read-only cache, where a batch's few fields stay resident.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kEfTag = 64;
constexpr int kEfUnaryWords = 12;
constexpr int kInvalidDoc = 0x7fffffff;

struct Scratch {
  uint32_t unary[kEfUnaryWords];
  int ones_before[kEfUnaryWords + 1];
  uint32_t warp_total[kLanes / 32];
};

struct Lane {
  uint32_t doc;  // unsigned: wraps like the reference's int32 arithmetic
  uint32_t freq;
  uint32_t norm;
};

__device__ __forceinline__ uint32_t extract(const uint32_t* __restrict__ data,
                                            int64_t word_off, int bits, int lane) {
  const int64_t bitpos = static_cast<int64_t>(lane) * bits;
  const int64_t w = word_off + (bitpos >> 5);
  const uint32_t lo = data[w];
  const uint32_t hi = data[w + 1];
  const uint32_t v = __funnelshift_r(lo, hi, static_cast<uint32_t>(bitpos & 31));
  const uint32_t mask = bits >= 32 ? 0xffffffffu : ((1u << bits) - 1u);
  return v & mask;
}

// Lane `lane` of the block at word `o`: its doc id, freq and norm byte
// (unmasked). Every thread of the CTA must call it: it synchronises.
__device__ __forceinline__ Lane decode_lane(const uint32_t* __restrict__ data,
                                            int64_t o, int db, int fb, uint32_t b,
                                            int lane, Scratch& s) {
  uint32_t doc;
  int doc_words;
  if (db >= kEfTag) {  // uniform across the CTA
    const int l = db - kEfTag;
    const uint32_t low = extract(data, o, l, lane);
    if (lane < kEfUnaryWords) s.unary[lane] = data[o + 4 * l + lane];
    __syncthreads();
    if (lane == 0) {
      s.ones_before[0] = 0;
      for (int w = 0; w < kEfUnaryWords; ++w)
        s.ones_before[w + 1] = s.ones_before[w] + __popc(s.unary[w]);
    }
    __syncthreads();
    int w = 0;
    while (w < kEfUnaryWords - 1 && s.ones_before[w + 1] <= lane) ++w;
    const int nth = lane - s.ones_before[w] + 1;  // 1-based rank inside word w
    const uint32_t pos = static_cast<uint32_t>(w) * 32u + __fns(s.unary[w], 0u, nth);
    const uint32_t hi = pos - static_cast<uint32_t>(lane);
    doc = b + (hi << l) + low;
    doc_words = 4 * l + kEfUnaryWords;
  } else {
    uint32_t x = extract(data, o, db, lane);
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, x, d);
      if ((lane & 31) >= d) x += y;
    }
    if ((lane & 31) == 31) s.warp_total[lane >> 5] = x;
    __syncthreads();
    for (int w = 0; w < (lane >> 5); ++w) x += s.warp_total[w];
    doc = b + x;
    doc_words = 4 * db;
  }
  Lane v;
  v.doc = doc;
  v.freq = extract(data, o + doc_words, fb, lane);
  v.norm = extract(data, o + doc_words + 4 * fb, 8, lane);
  return v;
}

template <typename FreqT>
__global__ void __launch_bounds__(kLanes)
decode_blocks_kernel(const uint32_t* __restrict__ data,
                     const int32_t* __restrict__ off,
                     const int32_t* __restrict__ dbits,
                     const int32_t* __restrict__ fbits,
                     const int32_t* __restrict__ base,
                     const int32_t* __restrict__ count,
                     int32_t* __restrict__ docs_out,
                     FreqT* __restrict__ freqs_out,
                     uint8_t* __restrict__ norms_out) {
  __shared__ Scratch s;
  const int64_t item = blockIdx.x;
  const int lane = threadIdx.x;
  const Lane v = decode_lane(data, off[item], dbits[item], fbits[item],
                             static_cast<uint32_t>(base[item]), lane, s);
  const bool valid = lane < count[item];
  const int64_t at = item * kLanes + lane;
  docs_out[at] = valid ? static_cast<int32_t>(v.doc) : kInvalidDoc;
  freqs_out[at] = valid ? static_cast<FreqT>(v.freq) : FreqT(0);
  norms_out[at] = valid ? static_cast<uint8_t>(v.norm) : uint8_t(0);
}

__global__ void __launch_bounds__(kLanes)
decode_score_blocks_kernel(const uint32_t* __restrict__ data,
                           const int32_t* __restrict__ off,
                           const int32_t* __restrict__ dbits,
                           const int32_t* __restrict__ fbits,
                           const int32_t* __restrict__ base,
                           const int32_t* __restrict__ count,
                           const int32_t* __restrict__ fid,
                           const float* __restrict__ cache,
                           int32_t* __restrict__ docs_out,
                           int32_t* __restrict__ freqs_out,
                           float* __restrict__ cval_out) {
  __shared__ Scratch s;
  const int64_t item = blockIdx.x;
  const int lane = threadIdx.x;
  const Lane v = decode_lane(data, off[item], dbits[item], fbits[item],
                             static_cast<uint32_t>(base[item]), lane, s);
  const bool valid = lane < count[item];
  const int64_t at = item * kLanes + lane;
  docs_out[at] = valid ? static_cast<int32_t>(v.doc) : kInvalidDoc;
  freqs_out[at] = valid ? static_cast<int32_t>(v.freq) : 0;
  // only valid lanes touch the table: an inert item's fid is never read
  cval_out[at] = valid ? __ldg(cache + static_cast<int64_t>(fid[item]) * 256 + v.norm) : 0.0f;
}

}  // namespace

// freq_bytes: 2 writes int16 freqs, 4 writes int32. Returns cudaGetLastError().
extern "C" int rtt_decode_blocks(const void* data, const void* off, const void* dbits,
                                 const void* fbits, const void* base, const void* count,
                                 void* docs_out, void* freqs_out, void* norms_out,
                                 int64_t n_items, int freq_bytes, void* stream) {
  if (n_items <= 0) return 0;
  const dim3 grid(static_cast<unsigned>(n_items));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const uint32_t*>(data);
  const auto* po = static_cast<const int32_t*>(off);
  const auto* pd = static_cast<const int32_t*>(dbits);
  const auto* pf = static_cast<const int32_t*>(fbits);
  const auto* pb = static_cast<const int32_t*>(base);
  const auto* pc = static_cast<const int32_t*>(count);
  auto* docs = static_cast<int32_t*>(docs_out);
  auto* norms = static_cast<uint8_t*>(norms_out);
  if (freq_bytes == 2) {
    decode_blocks_kernel<int16_t><<<grid, kLanes, 0, s>>>(
        d, po, pd, pf, pb, pc, docs, static_cast<int16_t*>(freqs_out), norms);
  } else {
    decode_blocks_kernel<int32_t><<<grid, kLanes, 0, s>>>(
        d, po, pd, pf, pb, pc, docs, static_cast<int32_t*>(freqs_out), norms);
  }
  return static_cast<int>(cudaGetLastError());
}

// fid: int32[W] cache row per item; cache: f32[F, 256]. Writes int32 docs,
// int32 freqs and f32 cval, each [W, 128]. Returns cudaGetLastError().
extern "C" int rtt_decode_score_blocks(const void* data, const void* off, const void* dbits,
                                       const void* fbits, const void* base, const void* count,
                                       const void* fid, const void* cache, void* docs_out,
                                       void* freqs_out, void* cval_out, int64_t n_items,
                                       void* stream) {
  if (n_items <= 0) return 0;
  decode_score_blocks_kernel<<<dim3(static_cast<unsigned>(n_items)), kLanes, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(data), static_cast<const int32_t*>(off),
      static_cast<const int32_t*>(dbits), static_cast<const int32_t*>(fbits),
      static_cast<const int32_t*>(base), static_cast<const int32_t*>(count),
      static_cast<const int32_t*>(fid), static_cast<const float*>(cache),
      static_cast<int32_t*>(docs_out), static_cast<int32_t*>(freqs_out),
      static_cast<float*>(cval_out));
  return static_cast<int>(cudaGetLastError());
}
