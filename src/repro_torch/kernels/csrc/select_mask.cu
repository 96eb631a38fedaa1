// Select mask: the exact edge rule of SCBF's channel selection, over every
// weight matrix of one client's pass, or of the S clients of a round, in
// one launch.
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
// - One launch takes a table of up to MAX_LEAVES leaves (passed by value),
//   each S slot-stacked matrices g (S, M, N) with their row (S, M), col
//   (S, N), thr (S,) and rest (S,) — an operand of slot stride 0 serves
//   every slot (layer 0's zero row scores).  The grid is the concatenation
//   of every leaf's S x tiles of TILE entries; a block finds its leaf from
//   the prefix, then its slot and tile.  Slot s of an S-slot launch is
//   bitwise the one-slot launch on slot s.
// - A thread takes VPT vectors of 4 neighbouring entries and issues all
//   their loads before it uses any: 32 bytes of g a thread, 8 KB a block,
//   about 22 KB an SM at the main path's largest matrix — what covers HBM
//   latency at 3.35 TB/s.  Flat indices are 32 bits (M * N < 2^31) and the
//   row is found once per vector.  Where N % 4 == 0 and the pointers are
//   aligned a vector is one 16-byte load of g and store of out (8 bytes in
//   bf16); elsewhere (33 x 257, 7 x 9) the 4 entries go one by one, the row
//   stepping on where a vector crosses it.  The 4 mask bytes of a vector
//   are one 32-bit store.
// - Counts: each block adds its kept count and one arrival to its (leaf,
//   slot)'s 64-bit ticket in one atomic; the block that brings the last
//   arrival writes that count from the sum and sets the ticket back to 0.
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
constexpr int MAX_SLOTS = 4096;                 // (leaf, slot) pairs a launch
constexpr int ROW_WORDS = 14;                   // int64 words a table row

struct Leaf {
  const void* g;            // (S, M, N)
  const float* row;         // slot s at row + s * row_ss
  const float* col;
  const float* thr;
  const float* rest;
  void* out;                // (S, M, N)
  unsigned char* mask;      // (S, M, N)
  int M, N, S;
  int row_ss, col_ss, thr_ss, rest_ss;          // slot strides, in floats
  int first;                // first block of the leaf in the grid
  int tiles;                // tiles a slot
  int pair;                 // the (leaf, slot 0) pair: ticket and count
  int vec;                  // 16-byte (bf16: 8-byte) access of g and out
};

struct Table {
  Leaf leaf[MAX_LEAVES];
  int L;
};

// one ticket a (leaf, slot) pair: blocks arrived (high word) and their
// kept entries (low word; M * N < 2^31, so no carry).  Zero when the
// library loads, and every launch leaves them zero.
__device__ unsigned long long tickets[MAX_SLOTS];

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
  const Leaf lf = t.leaf[find_leaf(t)];
  const int slot = (blockIdx.x - lf.first) / lf.tiles;
  const unsigned N = lf.N;
  const unsigned total = (unsigned)lf.M * N;
  const size_t at = (size_t)slot * total;       // this slot's matrices
  const T* g = static_cast<const T*>(lf.g) + at;
  T* out = static_cast<T*>(lf.out) + at;
  unsigned char* mask = lf.mask + at;
  const float* row = lf.row + (size_t)slot * lf.row_ss;
  const float* col = lf.col + (size_t)slot * lf.col_ss;
  const unsigned base =
      (unsigned)(blockIdx.x - lf.first - slot * lf.tiles) * TILE;
  const bool vec = lf.vec;
  // 4 mask bytes in one store where the slot's mask is 4-byte aligned
  const bool mask_vec = (reinterpret_cast<size_t>(mask) & 3) == 0;
  const float thr = lf.thr[(size_t)slot * lf.thr_ss];
  const float rest = lf.rest[(size_t)slot * lf.rest_ss];

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
    const unsigned bits = keep4(row, col, N, e[r], total, vec, thr, rest);
    kept += __popc(bits);
    T o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k] = (bits >> k) & 1u ? v[r][k] : zero<T>();
    store4(out, e[r], total, vec, o);
    if (mask_vec && e[r] + 4 <= total) {        // bytes 0/1, entry order
      *reinterpret_cast<unsigned*>(mask + e[r]) =
          (bits & 1u) | ((bits & 2u) << 7) | ((bits & 4u) << 14) |
          ((bits & 8u) << 21);
    } else {
      for (unsigned k = 0; k < 4 && e[r] + k < total; ++k)
        mask[e[r] + k] = (bits >> k) & 1u;
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
    const int pair = lf.pair + slot;
    const unsigned long long old = atomicAdd(&tickets[pair],
                                             (1ull << 32) | n);
    if ((unsigned)(old >> 32) == (unsigned)lf.tiles - 1u) {
      tickets[pair] = 0ull;              // every block of the slot is in
      counts[pair] = (int)((unsigned)old + n);
    }
  }
}

}  // namespace

// One launch over a table of L leaves (1 <= L <= MAX_LEAVES).  rows holds
// ROW_WORDS int64 words a leaf: g, S, M, N, row, row_ss, col, col_ss, thr,
// thr_ss, rest, rest_ss, out, mask — device pointers but S, M, N and the
// slot strides (in floats, 0 for an operand every slot shares); g, out and
// mask hold S contiguous (M, N) matrices; thr and rest are fp32 scalars in
// device memory (read by the kernel, no host sync).  dtype: 0 = fp32,
// 1 = bf16, for every leaf.  counts gets one int a (leaf, slot), leaf by
// leaf — at most MAX_SLOTS in all.  M * N must be below 2^31.  Two
// launches must not run at once (the tickets are the library's): keep
// them on one stream.  Returns a cudaError_t.
extern "C" int select_mask_launch(const long long* rows, int L, int dtype,
                                  int* counts, void* stream) {
  if (L <= 0 || L > MAX_LEAVES || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long long align = dtype == 0 ? 16 : 8;
  Table t;
  t.L = L;
  long long blocks = 0, pairs = 0;
  for (int l = 0; l < L; ++l) {
    const long long* r = rows + (long long)l * ROW_WORDS;
    const long long S = r[1], M = r[2], N = r[3];
    if (S <= 0 || M <= 0 || N <= 0 || M * N >= (1LL << 31) ||
        pairs + S > MAX_SLOTS)
      return (int)cudaErrorInvalidValue;
    for (int k = 5; k <= 11; k += 2)           // strides: 0 or the length
      if (r[k] < 0 || r[k] > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    Leaf& lf = t.leaf[l];
    lf.g = reinterpret_cast<const void*>(r[0]);
    lf.S = (int)S;
    lf.M = (int)M;
    lf.N = (int)N;
    lf.row = reinterpret_cast<const float*>(r[4]);
    lf.row_ss = (int)r[5];
    lf.col = reinterpret_cast<const float*>(r[6]);
    lf.col_ss = (int)r[7];
    lf.thr = reinterpret_cast<const float*>(r[8]);
    lf.thr_ss = (int)r[9];
    lf.rest = reinterpret_cast<const float*>(r[10]);
    lf.rest_ss = (int)r[11];
    lf.out = reinterpret_cast<void*>(r[12]);
    lf.mask = reinterpret_cast<unsigned char*>(r[13]);
    lf.first = (int)blocks;
    lf.tiles = (int)((M * N + TILE - 1) / TILE);
    lf.pair = (int)pairs;
    // every slot's g, out and col then share the alignment of slot 0's
    lf.vec = N % 4 == 0 && r[0] % align == 0 && r[12] % align == 0 &&
             r[6] % 16 == 0 && lf.col_ss % 4 == 0;
    blocks += S * lf.tiles;
    pairs += S;
  }
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    select_mask_kernel<float><<<(int)blocks, THREADS, 0, s>>>(t, counts);
  else
    select_mask_kernel<__nv_bfloat16><<<(int)blocks, THREADS, 0, s>>>(
        t, counts);
  return (int)cudaGetLastError();
}
