// Select and compact: the edge rule of SCBF's channel selection, fused with
// the compaction of the kept entries into COO upload buffers.
//
//   keep[i, j] = ((row[i] + col[j]) + rest > thr) && (!drop_zeros || g != 0)
//   idx[0:k]   = flat indices i*N + j of the kept entries, row-major (int32)
//   vals[0:k]  = g at those indices, as fp32 (g is fp32 or bf16)
//   idx[k:cap] = -1, vals[k:cap] = 0, k = min(count, cap)
//   count      = the true number of kept entries (int32)
//
// Replaces the TPU kernel repro/kernels/select_mask.py:
// select_compact_pallas (body _select_compact_kernel).  That kernel
// appends each row block's kept entries at a running offset carried across
// a sequential grid.  Hopper blocks run in no order, so this is three
// launches, each deterministic:
//   1. count:   block t counts the kept entries of its tile of TILE flat
//               indices (__syncthreads_count, an exact integer sum);
//   2. scan:    one block turns the tile counts into exclusive offsets in
//               tile order, and writes the total to `count`;
//   3. scatter: block t walks its tile again in rounds of THREADS
//               neighbouring entries; a warp ballot and the per-warp totals
//               of the round give every kept entry its row-major rank, and
//               it is written at offset[t] + rank if that is below the
//               capacity (entries past the capacity drop in order).  The
//               same launch fills the unused tail with -1 / 0.
// The output is bitwise the plain version's: the order is fixed by the
// indices, not by the schedule.
//
// The port adds two operands to the TPU kernel's test: `rest` (the best
// completion through the other layers, repro/core/channels.py
// apply_channel_mask), added after the pair sum as the reference orders it
// — folding it into thr would change which ties pass — and `drop_zeros`,
// which keeps only nonzero entries, the rule of the wire encoder
// (repro/comm/wire.py encode_leaf keeps np.flatnonzero of the masked
// leaf).  With rest = 0 and drop_zeros = 0 the test is the TPU kernel's.
//
// Bound on an H100: bytes — g read once (the scatter pass reads it again,
// mostly from L2), the two capacity-long outputs written once (8 bytes an
// entry at capacity = M*N).  At the main path's largest matrix, (2917, 256)
// fp32, that is about 9 MB, about 2.7 us at 3.35 TB/s.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROUNDS = 16;
constexpr long long TILE = (long long)THREADS * ROUNDS;
constexpr int SCAN_THREADS = 1024;

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ bool kept(const T* __restrict__ g,
                                     const float* __restrict__ row,
                                     const float* __restrict__ col,
                                     float thr, float rest, long long N,
                                     long long total, long long idx,
                                     int drop_zeros, float* v) {
  if (idx >= total) return false;
  const long long i = idx / N;
  const long long j = idx - i * N;
  *v = as_float(g[idx]);
  const float pair = row[i] + col[j];
  bool k = pair + rest > thr;
  if (drop_zeros) k = k && (*v != 0.0f);
  return k;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
compact_count_kernel(const T* __restrict__ g, const float* __restrict__ row,
                     const float* __restrict__ col,
                     const float* __restrict__ thr_p,
                     const float* __restrict__ rest_p, long long M,
                     long long N, int drop_zeros,
                     int* __restrict__ tile_counts) {
  const float thr = *thr_p;
  const float rest = *rest_p;
  const long long total = M * N;
  const long long base = (long long)blockIdx.x * TILE;
  int n = 0;
  for (int r = 0; r < ROUNDS; ++r) {
    float v;
    const bool k = kept(g, row, col, thr, rest, N, total,
                        base + (long long)r * THREADS + threadIdx.x,
                        drop_zeros, &v);
    n += __syncthreads_count(k);
  }
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = n;
}

__global__ void __launch_bounds__(SCAN_THREADS)
compact_scan_kernel(const int* __restrict__ tile_counts, int tiles,
                    int* __restrict__ offsets, int* __restrict__ count) {
  __shared__ int warp_sums[SCAN_THREADS / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int carry = 0;
  for (int start = 0; start < tiles; start += SCAN_THREADS) {
    const int t = start + threadIdx.x;
    const int v = t < tiles ? tile_counts[t] : 0;
    int x = v;                                   // inclusive scan in a warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {                             // scan of the warp totals
      int w = warp_sums[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += y;
      }
      warp_sums[lane] = w;
    }
    __syncthreads();
    const int before = warp > 0 ? warp_sums[warp - 1] : 0;
    if (t < tiles) offsets[t] = carry + before + x - v;
    carry += warp_sums[SCAN_THREADS / 32 - 1];
    __syncthreads();                             // warp_sums reused next
  }
  if (threadIdx.x == 0) *count = carry;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
compact_scatter_kernel(const T* __restrict__ g,
                       const float* __restrict__ row,
                       const float* __restrict__ col,
                       const float* __restrict__ thr_p,
                       const float* __restrict__ rest_p, long long M,
                       long long N, int drop_zeros,
                       const int* __restrict__ offsets,
                       const int* __restrict__ count, long long cap,
                       int* __restrict__ idx_out,
                       float* __restrict__ vals_out) {
  __shared__ int warp_kept[WARPS];
  const float thr = *thr_p;
  const float rest = *rest_p;
  const long long total = M * N;
  const long long base = (long long)blockIdx.x * TILE;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  long long pos = offsets[blockIdx.x];
  for (int r = 0; r < ROUNDS; ++r) {
    const long long idx = base + (long long)r * THREADS + threadIdx.x;
    float v = 0.0f;
    const bool k = kept(g, row, col, thr, rest, N, total, idx, drop_zeros,
                        &v);
    const unsigned ballot = __ballot_sync(0xffffffffu, k);
    if (lane == 0) warp_kept[warp] = __popc(ballot);
    __syncthreads();
    long long ahead = 0, round_kept = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int s = warp_kept[w];
      if (w < warp) ahead += s;
      round_kept += s;
    }
    if (k) {
      const long long p = pos + ahead + __popc(ballot & below);
      if (p < cap) {
        idx_out[p] = (int)idx;
        vals_out[p] = v;
      }
    }
    pos += round_kept;
    __syncthreads();                             // warp_kept reused next
  }
  // the unused tail: -1 / 0 from min(count, cap) on
  const long long kept_total = *count;
  for (long long p = (long long)blockIdx.x * THREADS + threadIdx.x; p < cap;
       p += (long long)gridDim.x * THREADS) {
    if (p >= kept_total) {
      idx_out[p] = -1;
      vals_out[p] = 0.0f;
    }
  }
}

template <typename T>
int launch(const T* g, int M, int N, const float* row, const float* col,
           const float* thr, const float* rest, int drop_zeros, long long cap,
           int* idx, float* vals, int* count, int* work, cudaStream_t s) {
  const long long total = (long long)M * N;
  const int tiles = (int)((total + TILE - 1) / TILE);
  int* tile_counts = work;
  int* offsets = work + tiles;
  compact_count_kernel<T><<<tiles, THREADS, 0, s>>>(
      g, row, col, thr, rest, M, N, drop_zeros, tile_counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  compact_scan_kernel<<<1, SCAN_THREADS, 0, s>>>(tile_counts, tiles, offsets,
                                                 count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  compact_scatter_kernel<T><<<tiles, THREADS, 0, s>>>(
      g, row, col, thr, rest, M, N, drop_zeros, offsets, count, cap, idx,
      vals);
  return (int)cudaGetLastError();
}

}  // namespace

// int32 scratch the launcher needs for an (M, N) input: a count and an
// offset per tile.
extern "C" long long select_compact_workspace(int M, int N) {
  const long long total = (long long)M * N;
  return 2 * ((total + TILE - 1) / TILE);
}

// dtype: 0 = fp32, 1 = bf16.  thr and rest are fp32 scalars in device
// memory; every pointer is a device pointer; work holds
// select_compact_workspace(M, N) ints.  M * N must be below 2^31 (flat
// indices are int32).  Returns a cudaError_t.
extern "C" int select_compact_launch(const void* g, int dtype, int M, int N,
                                     const float* row, const float* col,
                                     const float* thr, const float* rest,
                                     int drop_zeros, long long cap, int* idx,
                                     float* vals, int* count, int* work,
                                     void* stream) {
  if (M <= 0 || N <= 0 || cap < 0 || (dtype != 0 && dtype != 1) ||
      (long long)M * N >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch(static_cast<const float*>(g), M, N, row, col, thr, rest,
                  drop_zeros, cap, idx, vals, count, work, s);
  return launch(static_cast<const __nv_bfloat16*>(g), M, N, row, col, thr,
                rest, drop_zeros, cap, idx, vals, count, work, s);
}
