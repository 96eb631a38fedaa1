// Select mask: the exact edge rule of SCBF's channel selection, over every
// weight matrix of one client's pass in one launch.
//
//   keep[i, j] = (row[i] + col[j]) + rest > thr      (fp32, in that order)
//   out[i, j]  = keep ? g[i, j] : 0                   (g's dtype, fp32 or bf16)
//   mask[i, j] = keep                                 (bool, one byte)
//   count      = number of kept entries               (int32)
//
// Replaces the TPU kernel repro/kernels/select_mask.py:
// select_mask_pallas (body _select_mask_kernel).  That kernel tests
// row[i] + col[j] > thr; the port adds the `rest` operand — the best
// completion through the other layers, repro/core/channels.py
// apply_channel_mask — and adds it after the pair sum, as the reference
// does.  Folding rest into thr would change which ties pass; rest = 0 is
// the TPU kernel's rule bitwise.  Scores of -inf (pruned or padded
// neurons) never pass.  The mask output is what upload accounting and DP
// need beside the masked values.
//
// Bound on an H100: bytes — one read of g, one write of out and of the
// mask (9 bytes an entry in fp32).  A pass over the main path's matrices,
// (2917, 256) + (256, 64) + (64, 1) fp32, moves about 6.9 MB: about 2 us at
// 3.35 TB/s.  It is compare-and-move work with no products, so tensor
// cores buy nothing, and TMA buys nothing over 16-byte loads that already
// keep the bytes in flight.
//
// Design:
// - One launch takes a table of up to MAX_LEAVES leaves (passed by value);
//   its grid is the concatenation of every leaf's tiles of TILE entries,
//   and a block finds its leaf from the tiles' prefix.
// - A thread takes VPT vectors of 4 neighbouring entries and issues all
//   their loads before it uses any: 32 bytes of g a thread, 8 KB a block,
//   about 22 KB an SM at the main path's largest matrix — what covers HBM
//   latency at 3.35 TB/s.  Flat indices are 32 bits (M * N < 2^31) and the
//   row is found once per vector.  Where N % 4 == 0 and the pointers are
//   aligned a vector is one 16-byte load of g and store of out (8 bytes in
//   bf16); elsewhere (33 x 257, 7 x 9) the 4 entries go one by one, the row
//   stepping on where a vector crosses it.  The 4 mask bytes of a vector
//   are one 32-bit store.
// - Counts: each block adds its kept count and one arrival to its leaf's
//   64-bit ticket in one atomic; the block that brings the last arrival
//   writes the leaf's count from the sum and sets the ticket back to 0.
//   Integer sums: deterministic whatever the order, no memset, no fence
//   and no second pass over partial counts.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int VPT = 2;                          // vectors a thread, a tile
constexpr int TILE = THREADS * VPT * 4;         // entries a block
constexpr int MAX_LEAVES = 16;
constexpr int ROW_WORDS = 9;                    // int64 words a table row

struct Leaf {
  const void* g;
  const float* row;
  const float* col;
  const float* thr;
  const float* rest;
  void* out;
  unsigned* mask;           // 4 mask bytes a word
  int M, N;
  int first;                // first block of the leaf in the grid
  int tiles;
  int vec;                  // 16-byte (bf16: 8-byte) access of g and out
};

struct Table {
  Leaf leaf[MAX_LEAVES];
  int L;
};

// one ticket a leaf slot: blocks arrived (high word) and their kept
// entries (low word; M * N < 2^31, so no carry).  Zero when the library
// loads, and every launch leaves them zero.
__device__ unsigned long long tickets[MAX_LEAVES];

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

__device__ __forceinline__ int find_leaf(const Table& t) {
  int l = 0;
  while (l + 1 < t.L && (int)blockIdx.x >= t.leaf[l + 1].first) ++l;
  return l;
}

// 4 aligned entries in one access: 16 bytes of fp32, 8 of bf16
__device__ __forceinline__ void load_vec(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         __nv_bfloat16 v[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  v[0] = __ushort_as_bfloat16((unsigned short)(q.x & 0xffffu));
  v[1] = __ushort_as_bfloat16((unsigned short)(q.x >> 16));
  v[2] = __ushort_as_bfloat16((unsigned short)(q.y & 0xffffu));
  v[3] = __ushort_as_bfloat16((unsigned short)(q.y >> 16));
}
__device__ __forceinline__ void store_vec(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const __nv_bfloat16 v[4]) {
  uint2 q;
  q.x = (unsigned)__bfloat16_as_ushort(v[0]) |
        ((unsigned)__bfloat16_as_ushort(v[1]) << 16);
  q.y = (unsigned)__bfloat16_as_ushort(v[2]) |
        ((unsigned)__bfloat16_as_ushort(v[3]) << 16);
  *reinterpret_cast<uint2*>(p) = q;
}

// entries e .. e+3 of g (e a multiple of 4 below total)
template <typename T>
__device__ __forceinline__ void load4(const T* __restrict__ g, unsigned e,
                                      unsigned total, bool vec, T v[4]) {
  if (vec) {
    load_vec(g + e, v);
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = e + k < total ? g[e + k] : zero<T>();
}

template <typename T>
__device__ __forceinline__ void store4(T* __restrict__ p, unsigned e,
                                       unsigned total, bool vec,
                                       const T v[4]) {
  if (vec) {
    store_vec(p + e, v);
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (e + k < total) p[e + k] = v[k];
}

// bit k: entry e + k passes the edge rule (e a multiple of 4 below total)
__device__ __forceinline__ unsigned keep4(const float* __restrict__ row,
                                          const float* __restrict__ col,
                                          unsigned N, unsigned e,
                                          unsigned total, bool vec,
                                          float thr, float rest) {
  unsigned i = e / N;
  unsigned j = e - i * N;
  unsigned bits = 0;
  if (vec) {                                    // one row, aligned columns
    const float r = row[i];
    const float4 c = *reinterpret_cast<const float4*>(col + j);
    bits |= (__fadd_rn(__fadd_rn(r, c.x), rest) > thr) ? 1u : 0u;
    bits |= (__fadd_rn(__fadd_rn(r, c.y), rest) > thr) ? 2u : 0u;
    bits |= (__fadd_rn(__fadd_rn(r, c.z), rest) > thr) ? 4u : 0u;
    bits |= (__fadd_rn(__fadd_rn(r, c.w), rest) > thr) ? 8u : 0u;
    return bits;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (e + k < total &&
        __fadd_rn(__fadd_rn(row[i], col[j]), rest) > thr)
      bits |= 1u << k;
    if (++j == N) {
      j = 0;
      ++i;
    }
  }
  return bits;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
select_mask_kernel(const Table t, int* __restrict__ counts) {
  __shared__ unsigned warp_kept[WARPS];
  const int l = find_leaf(t);
  const Leaf lf = t.leaf[l];
  const T* g = static_cast<const T*>(lf.g);
  T* out = static_cast<T*>(lf.out);
  const unsigned N = lf.N;
  const unsigned total = (unsigned)lf.M * N;
  const unsigned base = (unsigned)(blockIdx.x - lf.first) * TILE;
  const bool vec = lf.vec;
  const float thr = *lf.thr;
  const float rest = *lf.rest;

  unsigned e[VPT];
  T v[VPT][4];
#pragma unroll
  for (int r = 0; r < VPT; ++r) {               // every load first
    e[r] = base + (unsigned)(r * THREADS + threadIdx.x) * 4u;
    if (e[r] < total) load4(g, e[r], total, vec, v[r]);
  }
  unsigned kept = 0;
#pragma unroll
  for (int r = 0; r < VPT; ++r) {
    if (e[r] >= total) continue;
    const unsigned bits = keep4(lf.row, lf.col, N, e[r], total, vec, thr,
                                rest);
    kept += __popc(bits);
    T o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k] = (bits >> k) & 1u ? v[r][k] : zero<T>();
    store4(out, e[r], total, vec, o);
    if (e[r] + 4 <= total) {                    // bytes 0/1, entry order
      lf.mask[e[r] >> 2] = (bits & 1u) | ((bits & 2u) << 7) |
                           ((bits & 4u) << 14) | ((bits & 8u) << 21);
    } else {
      unsigned char* m = reinterpret_cast<unsigned char*>(lf.mask);
      for (unsigned k = 0; e[r] + k < total; ++k)
        m[e[r] + k] = (bits >> k) & 1u;
    }
  }
  kept = __reduce_add_sync(0xffffffffu, kept);
  if ((threadIdx.x & 31) == 0) warp_kept[threadIdx.x >> 5] = kept;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned n = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) n += warp_kept[w];
    // the block's partial count rides on its ticket: one atomic, no fence
    const unsigned long long old = atomicAdd(&tickets[l], (1ull << 32) | n);
    if ((unsigned)(old >> 32) == (unsigned)lf.tiles - 1u) {
      tickets[l] = 0ull;                 // every block of the leaf is in
      counts[l] = (int)((unsigned)old + n);
    }
  }
}

}  // namespace

// One launch over a table of L leaves (1 <= L <= MAX_LEAVES).  rows holds
// ROW_WORDS int64 words a leaf: g, M, N, row, col, thr, rest, out, mask —
// device pointers but M and N; thr and rest are fp32 scalars in device
// memory (read by the kernel, no host sync).  dtype: 0 = fp32, 1 = bf16,
// for every leaf.  counts gets L ints.  M * N must be below 2^31 and mask
// 4-byte aligned.  Two launches must not run at once (the tickets are
// the library's): keep them on one stream.  Returns a cudaError_t.
extern "C" int select_mask_launch(const long long* rows, int L, int dtype,
                                  int* counts, void* stream) {
  if (L <= 0 || L > MAX_LEAVES || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long long align = dtype == 0 ? 16 : 8;
  Table t;
  t.L = L;
  long long blocks = 0;
  for (int l = 0; l < L; ++l) {
    const long long* r = rows + (long long)l * ROW_WORDS;
    const long long M = r[1], N = r[2];
    if (M <= 0 || N <= 0 || M * N >= (1LL << 31) || (r[8] & 3))
      return (int)cudaErrorInvalidValue;
    Leaf& lf = t.leaf[l];
    lf.g = reinterpret_cast<const void*>(r[0]);
    lf.M = (int)M;
    lf.N = (int)N;
    lf.row = reinterpret_cast<const float*>(r[3]);
    lf.col = reinterpret_cast<const float*>(r[4]);
    lf.thr = reinterpret_cast<const float*>(r[5]);
    lf.rest = reinterpret_cast<const float*>(r[6]);
    lf.out = reinterpret_cast<void*>(r[7]);
    lf.mask = reinterpret_cast<unsigned*>(r[8]);
    lf.first = (int)blocks;
    lf.tiles = (int)((M * N + TILE - 1) / TILE);
    lf.vec = N % 4 == 0 && r[0] % align == 0 && r[7] % align == 0 &&
             r[4] % 16 == 0;
    blocks += lf.tiles;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    select_mask_kernel<float><<<(int)blocks, THREADS, 0, s>>>(t, counts);
  else
    select_mask_kernel<__nv_bfloat16><<<(int)blocks, THREADS, 0, s>>>(
        t, counts);
  return (int)cudaGetLastError();
}
