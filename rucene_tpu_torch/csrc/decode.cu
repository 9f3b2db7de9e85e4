// Postings block decode for Hopper: one warp per 128-posting block, four
// consecutive lanes per thread, in two entries that share one decode.
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
// Bound: device-memory bytes. A block reads its header (5 or 6 words) and
// its packed words (doc, freq and norm planes: 71 on average on the bench
// corpus) and writes 128 * 12 bytes (K2) or 128 * (4 + 2|4 + 1) (K1);
// nothing is reused. At one batch's blocks that is tens of MB, a few
// microseconds of the card's bandwidth, so what bounds a simple kernel is
// latency: a block is a chain of dependent round trips (header, words,
// then K2's table read) and each CTA-per-block design pays them in series
// with barriers between.
//
// The design shortens the chain and keeps many chains in flight:
// - a warp owns a block and a CTA holds kWarps of them, so no barrier is
//   ever needed and one block's loads overlap its neighbours' stores;
// - lanes 0-5 load the six header fields in one round trip and broadcast
//   them with __shfl_sync;
// - every plane's words are then loaded in one round: a thread reads the
//   at most five words its valid lanes span, never past the last valid
//   lane's second word, so reads stay inside the block or the 2-word pad
//   (DATA_PAD_WORDS) even where a tail block's norm plane is short;
// - FOR doc ids: an in-register scan of the thread's four deltas, then one
//   warp shuffle scan of the thread totals (unsigned adds wrap like the
//   reference's int32 arithmetic);
// - Elias-Fano: lanes 0-11 load the 12 unary words in one instruction, a
//   shuffle scan of their popcounts finds each lane's word, __fns its bit;
// - stores are 16 bytes a thread (int4 docs, int4 / 4 x int16 freqs,
//   float4 cval, 4 x u8 norms). K2's [F, 256] denominator table is 1 KB per
//   field: only valid lanes read it, through the read-only cache.
// Lanes at or past `count` write INVALID_DOC and zero freq / norm / cval.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPer = 4;     // consecutive lanes per thread
constexpr int kWarps = 4;   // blocks per CTA
constexpr int kEfTag = 64;
constexpr int kEfUnaryWords = 12;
constexpr int kInvalidDoc = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

struct Header {
  int64_t off;
  int dbits;
  int fbits;
  uint32_t base;
  int count;
  int fid;
};

// The block's tables, one field per lane, in one round trip.
__device__ __forceinline__ Header load_header(const int32_t* __restrict__ off,
                                              const int32_t* __restrict__ dbits,
                                              const int32_t* __restrict__ fbits,
                                              const int32_t* __restrict__ base,
                                              const int32_t* __restrict__ count,
                                              const int32_t* __restrict__ fid,
                                              int64_t item, int ln) {
  const int32_t* src = ln == 0 ? off : ln == 1 ? dbits : ln == 2 ? fbits
                     : ln == 3 ? base : ln == 4 ? count : fid;
  const int32_t v = (ln < 5 || (ln == 5 && fid != nullptr)) ? __ldg(src + item) : 0;
  Header h;
  h.off = __shfl_sync(kFull, v, 0);
  h.dbits = __shfl_sync(kFull, v, 1);
  h.fbits = __shfl_sync(kFull, v, 2);
  h.base = static_cast<uint32_t>(__shfl_sync(kFull, v, 3));
  h.count = __shfl_sync(kFull, v, 4);
  h.fid = __shfl_sync(kFull, v, 5);
  return h;
}

// The `bits`-wide values of lanes 4t..4t+3 of the plane at word `o`, of
// which the first nv (0..4) are valid; the rest come out as garbage. Reads
// words o + (4t*bits >> 5) up to the last valid lane's second word: at
// most five, all independent loads. A block's norm plane holds only its
// valid lanes, so reads stop one word past the block, inside the pad.
__device__ __forceinline__ void extract4(const uint32_t* __restrict__ data, int64_t o,
                                         int bits, int t, int nv, uint32_t v[kPer]) {
  const int b0 = kPer * t * bits;
  const int first = b0 >> 5;
  // words past the first: 1..4, or none to read
  const int n = nv > 0 ? ((b0 + (nv - 1) * bits) >> 5) + 1 - first : -1;
  uint32_t w[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) w[k] = k <= n ? __ldg(data + o + first + k) : 0u;
  const uint32_t mask = bits >= 32 ? 0xffffffffu : ((1u << bits) - 1u);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int bp = b0 + j * bits;
    const int r = (bp >> 5) - first;  // 0..3
    const uint32_t lo = r == 0 ? w[0] : r == 1 ? w[1] : r == 2 ? w[2] : w[3];
    const uint32_t hi = r == 0 ? w[1] : r == 1 ? w[2] : r == 2 ? w[3] : w[4];
    v[j] = __funnelshift_r(lo, hi, static_cast<uint32_t>(bp & 31)) & mask;
  }
}

// Lanes 4t..4t+3 of the block: doc ids (unsigned: they wrap like the
// reference's int32 arithmetic), freqs and norm bytes; lanes at or past
// count hold garbage. Every lane of the warp must call it: it shuffles.
__device__ __forceinline__ void decode4(const uint32_t* __restrict__ data, const Header& h,
                                        int t, uint32_t doc[kPer], uint32_t freq[kPer],
                                        uint32_t norm[kPer]) {
  const bool ef = h.dbits >= kEfTag;  // uniform across the warp
  const int l = h.dbits - kEfTag;
  const int doc_words = ef ? 4 * l + kEfUnaryWords : 4 * h.dbits;
  const int nv = min(max(h.count - kPer * t, 0), kPer);  // this thread's valid lanes
  uint32_t v[kPer];
  extract4(data, h.off, ef ? l : h.dbits, t, nv, v);  // FOR deltas or EF low bits
  extract4(data, h.off + doc_words, h.fbits, t, nv, freq);
  extract4(data, h.off + doc_words + 4 * h.fbits, 8, t, nv, norm);
  if (ef) {
    const uint32_t word = t < kEfUnaryWords ? __ldg(data + h.off + 4 * l + t) : 0u;
    uint32_t incl = __popc(word);
#pragma unroll
    for (int d = 1; d < kEfUnaryWords; d <<= 1) {  // lanes 0-11 matter
      const uint32_t y = __shfl_up_sync(kFull, incl, d);
      if (t >= d) incl += y;
    }
    uint32_t ones[kEfUnaryWords - 1];  // ones[k]: set bits in words 0..k
#pragma unroll
    for (int k = 0; k < kEfUnaryWords - 1; ++k) ones[k] = __shfl_sync(kFull, incl, k);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const uint32_t p = static_cast<uint32_t>(kPer * t + j);
      int w = 0;  // the word holding set bit p (the last word past the end)
      uint32_t before = 0;
#pragma unroll
      for (int k = 0; k < kEfUnaryWords - 1; ++k) {
        if (ones[k] <= p) {
          w = k + 1;
          before = ones[k];
        }
      }
      const uint32_t uw = __shfl_sync(kFull, word, w);
      const int nth = static_cast<int>(p - before) + 1;  // 1-based rank inside word w
      const uint32_t pos = static_cast<uint32_t>(w) * 32u + __fns(uw, 0u, nth);
      doc[j] = h.base + ((pos - p) << l) + v[j];
    }
  } else {
    uint32_t s[kPer];
    s[0] = v[0];
#pragma unroll
    for (int j = 1; j < kPer; ++j) s[j] = s[j - 1] + v[j];
    uint32_t x = s[kPer - 1];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, x, d);
      if (t >= d) x += y;
    }
    const uint32_t before = x - s[kPer - 1];  // deltas of the lanes before 4t
#pragma unroll
    for (int j = 0; j < kPer; ++j) doc[j] = h.base + before + s[j];
  }
}

template <typename FreqT>
struct FreqVec;
template <>
struct FreqVec<int16_t> {
  using T = short4;
  static __device__ __forceinline__ T make(const uint32_t f[kPer]) {
    return make_short4(static_cast<short>(f[0]), static_cast<short>(f[1]),
                       static_cast<short>(f[2]), static_cast<short>(f[3]));
  }
};
template <>
struct FreqVec<int32_t> {
  using T = int4;
  static __device__ __forceinline__ T make(const uint32_t f[kPer]) {
    return make_int4(static_cast<int>(f[0]), static_cast<int>(f[1]),
                     static_cast<int>(f[2]), static_cast<int>(f[3]));
  }
};

template <typename FreqT>
__global__ void __launch_bounds__(kWarps * 32)
decode_blocks_kernel(const uint32_t* __restrict__ data,
                     const int32_t* __restrict__ off,
                     const int32_t* __restrict__ dbits,
                     const int32_t* __restrict__ fbits,
                     const int32_t* __restrict__ base,
                     const int32_t* __restrict__ count,
                     int32_t* __restrict__ docs_out,
                     FreqT* __restrict__ freqs_out,
                     uint8_t* __restrict__ norms_out, int64_t n_items) {
  const int64_t item = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (item >= n_items) return;  // whole warps
  const int t = threadIdx.x & 31;
  const Header h = load_header(off, dbits, fbits, base, count, nullptr, item, t);
  uint32_t doc[kPer], freq[kPer], norm[kPer];
  decode4(data, h, t, doc, freq, norm);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const bool valid = kPer * t + j < h.count;
    doc[j] = valid ? doc[j] : static_cast<uint32_t>(kInvalidDoc);
    freq[j] = valid ? freq[j] : 0u;
    norm[j] = valid ? norm[j] : 0u;
  }
  const int64_t at = item * 32 + t;  // in units of four lanes
  reinterpret_cast<int4*>(docs_out)[at] =
      make_int4(static_cast<int>(doc[0]), static_cast<int>(doc[1]),
                static_cast<int>(doc[2]), static_cast<int>(doc[3]));
  reinterpret_cast<typename FreqVec<FreqT>::T*>(freqs_out)[at] = FreqVec<FreqT>::make(freq);
  reinterpret_cast<uint32_t*>(norms_out)[at] = norm[0] | (norm[1] << 8) | (norm[2] << 16) | (norm[3] << 24);
}

__global__ void __launch_bounds__(kWarps * 32)
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
                           float* __restrict__ cval_out, int64_t n_items) {
  const int64_t item = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (item >= n_items) return;  // whole warps
  const int t = threadIdx.x & 31;
  const Header h = load_header(off, dbits, fbits, base, count, fid, item, t);
  uint32_t doc[kPer], freq[kPer], norm[kPer];
  decode4(data, h, t, doc, freq, norm);
  // only valid lanes touch the table: an inert item's fid is never read
  const float* row = cache + static_cast<int64_t>(h.fid) * 256;
  float cval[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const bool valid = kPer * t + j < h.count;
    doc[j] = valid ? doc[j] : static_cast<uint32_t>(kInvalidDoc);
    freq[j] = valid ? freq[j] : 0u;
    cval[j] = valid ? __ldg(row + norm[j]) : 0.0f;
  }
  const int64_t at = item * 32 + t;  // in units of four lanes
  reinterpret_cast<int4*>(docs_out)[at] =
      make_int4(static_cast<int>(doc[0]), static_cast<int>(doc[1]),
                static_cast<int>(doc[2]), static_cast<int>(doc[3]));
  reinterpret_cast<int4*>(freqs_out)[at] = FreqVec<int32_t>::make(freq);
  reinterpret_cast<float4*>(cval_out)[at] = make_float4(cval[0], cval[1], cval[2], cval[3]);
}

dim3 grid_for(int64_t n_items) {
  return dim3(static_cast<unsigned>((n_items + kWarps - 1) / kWarps));
}

}  // namespace

// Outputs are [W, 128] row-major and 16-byte aligned. freq_bytes: 2 writes
// int16 freqs, 4 writes int32. Returns cudaGetLastError().
extern "C" int rtt_decode_blocks(const void* data, const void* off, const void* dbits,
                                 const void* fbits, const void* base, const void* count,
                                 void* docs_out, void* freqs_out, void* norms_out,
                                 int64_t n_items, int freq_bytes, void* stream) {
  if (n_items <= 0) return 0;
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
    decode_blocks_kernel<int16_t><<<grid_for(n_items), kWarps * 32, 0, s>>>(
        d, po, pd, pf, pb, pc, docs, static_cast<int16_t*>(freqs_out), norms, n_items);
  } else {
    decode_blocks_kernel<int32_t><<<grid_for(n_items), kWarps * 32, 0, s>>>(
        d, po, pd, pf, pb, pc, docs, static_cast<int32_t*>(freqs_out), norms, n_items);
  }
  return static_cast<int>(cudaGetLastError());
}

// fid: int32[W] cache row per item; cache: f32[F, 256]. Writes int32 docs,
// int32 freqs and f32 cval, each [W, 128], 16-byte aligned. Returns
// cudaGetLastError().
extern "C" int rtt_decode_score_blocks(const void* data, const void* off, const void* dbits,
                                       const void* fbits, const void* base, const void* count,
                                       const void* fid, const void* cache, void* docs_out,
                                       void* freqs_out, void* cval_out, int64_t n_items,
                                       void* stream) {
  if (n_items <= 0) return 0;
  decode_score_blocks_kernel<<<grid_for(n_items), kWarps * 32, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(data), static_cast<const int32_t*>(off),
      static_cast<const int32_t*>(dbits), static_cast<const int32_t*>(fbits),
      static_cast<const int32_t*>(base), static_cast<const int32_t*>(count),
      static_cast<const int32_t*>(fid), static_cast<const float*>(cache),
      static_cast<int32_t*>(docs_out), static_cast<int32_t*>(freqs_out),
      static_cast<float*>(cval_out), n_items);
  return static_cast<int>(cudaGetLastError());
}
