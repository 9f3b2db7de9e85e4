// Dense combine for Hopper: decoded posting lanes -> per-row score and
// clause-count accumulators over 512-doc buckets.
//
// Replaces rucene_tpu/ops/pallas_combine.py::combine_lanes_pallas (kernel
// body _combine_kernel). Twin: rucene_tpu_torch/ops/cuda_combine.py
// combine_lanes_plain, a plain index_put_(accumulate=True).
//
// Entries (work item x overlapped bucket) arrive sorted by bucket, with
// bucket_ptr[b]..bucket_ptr[b+1] the entries of bucket b; e_item names the
// item whose lanes (target i32[W,128], sc f32[W,128]) the entry adds, read
// where the decode left them. A CTA owns one (bucket, group of up to 8
// rows) tile of f32 scores and int32 counts in shared memory: it zeroes the
// tile, adds every in-bucket lane of its group's entries with shared-memory
// atomics, then writes the tile once. Counts are exact int32; the f32 sum
// order is unspecified, the same tolerance class as the scatter it
// replaces. The tile starts at +0.0, so a (row, doc) with at most two adds
// is bit-equal to the twin's.
//
// Bound: device-memory bytes. The call must write n_rows * md * 8 bytes
// (256 MB for 32 rows over 1M docs) and read each item's lanes once plus
// 12 bytes of tables per entry; the adds are a few per output element.
// What the design does about it:
// - the tile is sized by the call's rows in groups of 8, 32 KB, so six
//   CTAs share an SM and one CTA's write-out overlaps another's adds (a
//   32-row, 128 KB tile left one CTA per SM running its phases in series,
//   and a 16-row one three: both were slower on the card);
// - a CTA gathers its group's entries of the bucket into a shared list
//   (one coalesced read of the three entry tables), so every warp has work;
// - one warp takes one entry, each thread four consecutive lanes: one
//   16-byte load of docs, and a 16-byte load of scores only where one of
//   its lanes falls in the bucket; the entry's row and encoding come from
//   the list, once per warp; the thread visits its lanes in an order
//   rotated by t >> 3 so that consecutive docs hit distinct banks;
// - two entries per warp are in flight, and the lanes are read in place:
//   the executor no longer gathers [E, 128] copies of them;
// - the tile leaves in 16-byte stores, row and column from a shift, with
//   no division.
// The TPU kernel's machinery is left out: bf16 limbs and one-hot MXU
// matmuls (the adds are exact f32 / int32 here), G-grouping of entries and
// the pow2 step padding (the CTA walks its bucket's entries directly).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBucket = 512;   // docs per bucket (ops/cuda_combine.py C_BUCKET)
constexpr int kGroupRows = 8;  // rows per CTA tile: 8 x 512 x 8 B = 32 KB
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 2;      // entries in flight per warp
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int pick(const int4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

__device__ __forceinline__ float pick(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(kThreads, 6)
combine_lanes_kernel(const int32_t* __restrict__ bucket_ptr,
                     const int32_t* __restrict__ target,
                     const float* __restrict__ sc,
                     const int32_t* __restrict__ e_item,
                     const int32_t* __restrict__ e_row,
                     const int32_t* __restrict__ e_enc,
                     float* __restrict__ out_score,
                     int32_t* __restrict__ out_counts,
                     int n_rows, int n_groups, int64_t row_stride) {
  extern __shared__ int4 tile[];
  __shared__ int s_item[kThreads];
  __shared__ int s_row[kThreads];
  __shared__ int s_enc[kThreads];
  __shared__ int s_n;

  const int bucket = blockIdx.x / n_groups;
  const int r_lo = (blockIdx.x - bucket * n_groups) * kGroupRows;
  const int g_rows = min(kGroupRows, n_rows - r_lo);
  float* t_score = reinterpret_cast<float*>(tile);
  int32_t* t_count = reinterpret_cast<int32_t*>(t_score + g_rows * kBucket);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int ln = tid & 31;
  const int rot = ln >> 3;

  const int n_vec = g_rows * kBucket / 2;  // both planes, in int4
  for (int i = tid; i < n_vec; i += kThreads) tile[i] = make_int4(0, 0, 0, 0);

  const int64_t lo = static_cast<int64_t>(bucket) * kBucket;
  const int e0 = bucket_ptr[bucket];
  const int e1 = bucket_ptr[bucket + 1];
  const int4* target4 = reinterpret_cast<const int4*>(target);
  const float4* sc4 = reinterpret_cast<const float4*>(sc);
  for (int c0 = e0; c0 < e1; c0 += kThreads) {
    // this group's entries of the chunk -> the shared list
    if (tid == 0) s_n = 0;
    __syncthreads();  // the tile is zeroed and the last chunk's list read
    const int e = c0 + tid;
    int item = 0, row = -1, enc = 0;
    if (e < e1) {
      item = e_item[e];
      row = e_row[e] - r_lo;
      enc = e_enc[e];
    }
    const bool keep = row >= 0 && row < g_rows;
    const unsigned mask = __ballot_sync(kFull, keep);
    int at = 0;
    if (ln == 0 && mask) at = atomicAdd(&s_n, __popc(mask));
    at = __shfl_sync(kFull, at, 0) + __popc(mask & ((1u << ln) - 1u));
    if (keep) {
      s_item[at] = item;
      s_row[at] = row;
      s_enc[at] = enc;
    }
    __syncthreads();
    const int n = s_n;

    // one warp per entry, four lanes per thread
    for (int k0 = warp; k0 < n; k0 += kWarps * kUnroll) {
      int it[kUnroll], r[kUnroll], en[kUnroll];
      int4 d[kUnroll];
      float4 s[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = k0 + u * kWarps;
        it[u] = k < n ? s_item[k] : -1;
        r[u] = k < n ? s_row[k] : 0;
        en[u] = k < n ? s_enc[k] : 0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        d[u] = it[u] >= 0 ? __ldg(target4 + static_cast<int64_t>(it[u]) * 32 + ln)
                          : make_int4(-1, -1, -1, -1);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool any = static_cast<uint64_t>(d[u].x - lo) < kBucket ||
                         static_cast<uint64_t>(d[u].y - lo) < kBucket ||
                         static_cast<uint64_t>(d[u].z - lo) < kBucket ||
                         static_cast<uint64_t>(d[u].w - lo) < kBucket;
        s[u] = any ? __ldg(sc4 + static_cast<int64_t>(it[u]) * 32 + ln)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int q = (j + rot) & 3;
          const int64_t local = pick(d[u], q) - lo;
          if (static_cast<uint64_t>(local) < kBucket) {
            const int a = r[u] * kBucket + static_cast<int>(local);
            atomicAdd(t_score + a, pick(s[u], q));
            atomicAdd(t_count + a, en[u]);
          }
        }
      }
    }
    __syncthreads();  // the list is read before the next chunk refills it
  }
  __syncthreads();  // the tile is complete (and zeroed when no entry came)

  // write-out: row i >> 7, four docs at (i & 127) * 4 of each plane
  for (int i = tid; i < g_rows * (kBucket / 4); i += kThreads) {
    const int64_t at = static_cast<int64_t>(r_lo + (i >> 7)) * row_stride + lo + (i & 127) * 4;
    *reinterpret_cast<float4*>(out_score + at) = reinterpret_cast<const float4*>(t_score)[i];
    *reinterpret_cast<int4*>(out_counts + at) = reinterpret_cast<const int4*>(t_count)[i];
  }
}

}  // namespace

// target i32[W,128], sc f32[W,128] (16-byte aligned rows); e_item, e_row,
// e_enc i32[E]; out_score / out_counts [n_rows, row_stride] row-major,
// 16-byte aligned, row_stride a multiple of 4 and >= n_buckets * c_bucket.
// c_bucket must equal the kernel's 512. Returns cudaGetLastError() (or
// cudaErrorInvalidValue for a bucket width the kernel was not built for).
extern "C" int rtt_combine_lanes(const void* bucket_ptr, const void* target, const void* sc,
                                 const void* e_item, const void* e_row, const void* e_enc,
                                 void* out_score, void* out_counts, int n_buckets,
                                 int c_bucket, int n_rows, int64_t row_stride, void* stream) {
  if (c_bucket != kBucket) return static_cast<int>(cudaErrorInvalidValue);
  if (n_buckets <= 0 || n_rows <= 0) return 0;
  const int n_groups = (n_rows + kGroupRows - 1) / kGroupRows;
  const int tile_rows = n_rows < kGroupRows ? n_rows : kGroupRows;
  const size_t smem = static_cast<size_t>(tile_rows) * kBucket * (sizeof(float) + sizeof(int32_t));
  cudaError_t err = cudaFuncSetAttribute(
      combine_lanes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>(n_buckets) * static_cast<unsigned>(n_groups);
  combine_lanes_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(bucket_ptr), static_cast<const int32_t*>(target),
      static_cast<const float*>(sc), static_cast<const int32_t*>(e_item),
      static_cast<const int32_t*>(e_row), static_cast<const int32_t*>(e_enc),
      static_cast<float*>(out_score), static_cast<int32_t*>(out_counts), n_rows, n_groups,
      row_stride);
  return static_cast<int>(cudaGetLastError());
}
