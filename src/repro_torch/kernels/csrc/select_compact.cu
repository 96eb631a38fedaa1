// Select and compact: the edge rule of SCBF's channel selection, fused with
// the compaction of the kept entries into COO upload buffers, over every
// weight matrix of one client's pass in one launch a pass.
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
// a sequential grid.  Hopper blocks run in no order, so this is two
// launches over a table of leaves (passed by value; each launch's grid is
// the concatenation of the leaves' tiles of TILE entries), each
// deterministic:
//   1. count:   block t counts the kept entries of its tile, writes the
//               count and adds it, with one arrival, to its leaf's 64-bit
//               ticket in one atomic; the block that brings the last
//               arrival writes the leaf's `count` and sets the ticket back
//               to 0.  For a leaf of more than MAX_PREFIX_TILES tiles only,
//               that block also scans the tile counts into exclusive
//               offsets (after a fence), so no block of the next launch
//               reduces more than MAX_PREFIX_TILES counts.
//   2. scatter: block t adds the counts of the tiles before it in its leaf
//               (L2-resident; a read of offsets[t] for a large leaf) while
//               its loads of g are in flight, ranks its kept entries
//               row-major with warp ballots, gathers them in shared memory
//               and writes them out as one contiguous run at its offset, in
//               16-byte stores; entries past the capacity drop in order.
//               The leaf's blocks then write the unused tail
//               [min(count, cap), cap) with -1 / 0.
// The caller may read the counts between the two launches (the upload
// encoder does, to size the buffers at the count) or not (the wrapper's
// contract route launches both back to back with no host sync).  The
// output is bitwise the plain version's: the order is fixed by the
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
// Bound on an H100: bytes — g read once (the scatter reads it again,
// mostly from L2), the outputs written once: 8 bytes a kept entry and a
// tail entry.  A pass over the main path's matrices, (2917, 256) +
// (256, 64) + (64, 1) fp32, at capacity M*N moves about 9.2 MB: about
// 2.7 us at 3.35 TB/s; at capacity = count (the encoder) fewer.  There are
// no products (tensor cores buy nothing) and the reads are 16-byte vector
// loads (TMA buys nothing).  As in select_mask.cu: flat indices are 32
// bits, the row is found once per vector of 4 entries, a thread issues all
// VPT of its loads before it uses any (about 22 KB in flight an SM), and
// a leaf whose N % 4 != 0 or whose pointers are not aligned takes the
// scalar path.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int VPT = 2;                          // vectors a thread, a tile
constexpr int TILE = THREADS * VPT * 4;         // entries a block
constexpr int MAX_LEAVES = 16;
constexpr int MAX_PREFIX_TILES = 1024;
constexpr int ROW_WORDS = 12;                   // int64 words a table row

struct Leaf {
  const void* g;
  const float* row;
  const float* col;
  const float* thr;
  const float* rest;
  int* count;
  int* idx;
  float* vals;
  long long cap;
  int M, N;
  int first;                // first block of the leaf in this launch's grid
  int tiles;
  int tc;                   // the leaf's first tile in tile_counts/offsets
  int vec;                  // 16-byte (bf16: 8-byte) loads of g
  int out_vec;              // 16-byte stores of idx and vals
};

struct Table {
  Leaf leaf[MAX_LEAVES];
  int L;
};

// one ticket a leaf slot: tiles counted (high word) and their kept
// entries (low word; M * N < 2^31, so no carry).  Zero when the library
// loads, and every count launch leaves them zero.
__device__ unsigned long long tickets[MAX_LEAVES];

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
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

// issue the loads of the thread's VPT vectors of its tile (e: their first
// flat indices)
template <typename T>
__device__ __forceinline__ void tile_load(const Leaf& lf, unsigned base,
                                          unsigned e[VPT], T v[VPT][4]) {
  const T* g = static_cast<const T*>(lf.g);
  const unsigned total = (unsigned)lf.M * lf.N;
#pragma unroll
  for (int r = 0; r < VPT; ++r) {
    e[r] = base + (unsigned)(r * THREADS + threadIdx.x) * 4u;
    if (e[r] < total) load4(g, e[r], total, (bool)lf.vec, v[r]);
  }
}

// the kept bits of those vectors: the edge rule, and g != 0 with
// drop_zeros (-0.0 is a zero)
template <typename T>
__device__ __forceinline__ void tile_bits(const Leaf& lf, int drop_zeros,
                                          const unsigned e[VPT],
                                          const T v[VPT][4],
                                          unsigned bits[VPT]) {
  const unsigned N = lf.N;
  const unsigned total = (unsigned)lf.M * N;
  const float thr = *lf.thr;
  const float rest = *lf.rest;
#pragma unroll
  for (int r = 0; r < VPT; ++r) {
    bits[r] = 0;
    if (e[r] >= total) continue;
    bits[r] = keep4(lf.row, lf.col, N, e[r], total, (bool)lf.vec, thr, rest);
    if (drop_zeros)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (!(to_float(v[r][k]) != 0.0f)) bits[r] &= ~(1u << k);
  }
}

// A large leaf's n tile counts into exclusive offsets in tile order, by
// the whole block (the one-block scan, kept for leaves of more than
// MAX_PREFIX_TILES tiles).
__device__ void leaf_offsets(const int* __restrict__ counts, int n,
                             int* __restrict__ offsets) {
  __shared__ int warp_sums[WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int carry = 0;
  for (int start = 0; start < n; start += THREADS) {
    const int t = start + threadIdx.x;
    const int v = t < n ? __ldcg(counts + t) : 0;
    int x = v;                                   // inclusive scan in a warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    int before = 0, chunk = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int s = warp_sums[w];
      if (w < warp) before += s;
      chunk += s;
    }
    if (t < n) offsets[t] = carry + before + x - v;
    carry += chunk;
    __syncthreads();                             // warp_sums reused next
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
compact_count_kernel(const Table t, int drop_zeros,
                     int* __restrict__ tile_counts,
                     int* __restrict__ offsets) {
  __shared__ unsigned warp_kept[WARPS];
  __shared__ bool last;
  const int l = find_leaf(t);
  const Leaf lf = t.leaf[l];
  const int tile = blockIdx.x - lf.first;
  unsigned e[VPT], bits[VPT];
  T v[VPT][4];
  if (drop_zeros) {
    tile_load<T>(lf, (unsigned)tile * TILE, e, v);
  } else {                          // the rule alone needs no byte of g
#pragma unroll
    for (int r = 0; r < VPT; ++r)
      e[r] = (unsigned)tile * TILE +
             (unsigned)(r * THREADS + threadIdx.x) * 4u;
  }
  tile_bits<T>(lf, drop_zeros, e, v, bits);
  unsigned kept = 0;
#pragma unroll
  for (int r = 0; r < VPT; ++r) kept += __popc(bits[r]);
  kept = __reduce_add_sync(0xffffffffu, kept);
  if ((threadIdx.x & 31) == 0) warp_kept[threadIdx.x >> 5] = kept;
  __syncthreads();
  const bool large = lf.tiles > MAX_PREFIX_TILES;
  if (threadIdx.x == 0) {
    unsigned n = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) n += warp_kept[w];
    tile_counts[lf.tc + tile] = (int)n;
    // a large leaf's last block reads the tile counts: count, then ticket
    if (large) __threadfence();
    // the tile's count rides on its ticket: one atomic
    const unsigned long long old = atomicAdd(&tickets[l], (1ull << 32) | n);
    last = (unsigned)(old >> 32) == (unsigned)lf.tiles - 1u;
    if (last) {
      tickets[l] = 0ull;                 // every block of the leaf is in
      *lf.count = (int)((unsigned)old + n);
    }
  }
  if (!large) return;
  __syncthreads();
  if (!last) return;
  __threadfence();
  leaf_offsets(tile_counts + lf.tc, lf.tiles, offsets + lf.tc);
}

// out[base, stop) = the block's gathered s_idx / s_val[0, stop - base)
__device__ void write_run(const Leaf& lf, const int* s_idx,
                          const float* s_val, long long base,
                          long long stop) {
  long long a0 = stop, a1 = stop;               // the 16-byte-aligned body
  if (lf.out_vec) {
    a0 = (base + 3) & ~3LL;
    if (a0 > stop) a0 = stop;
    a1 = stop & ~3LL;
    if (a1 < a0) a1 = a0;
  }
  for (long long p = base + threadIdx.x; p < a0; p += THREADS) {
    lf.idx[p] = s_idx[p - base];
    lf.vals[p] = s_val[p - base];
  }
  for (long long q = a0 + 4LL * threadIdx.x; q < a1; q += 4LL * THREADS) {
    const int s = (int)(q - base);
    *reinterpret_cast<int4*>(lf.idx + q) =
        make_int4(s_idx[s], s_idx[s + 1], s_idx[s + 2], s_idx[s + 3]);
    *reinterpret_cast<float4*>(lf.vals + q) =
        make_float4(s_val[s], s_val[s + 1], s_val[s + 2], s_val[s + 3]);
  }
  for (long long p = a1 + threadIdx.x; p < stop; p += THREADS) {
    lf.idx[p] = s_idx[p - base];
    lf.vals[p] = s_val[p - base];
  }
}

// idx / vals [from, cap) = -1 / 0, spread over the leaf's blocks
__device__ void write_tail(const Leaf& lf, int tile, long long from) {
  const long long cap = lf.cap;
  const long long gi = (long long)tile * THREADS + threadIdx.x;
  const long long stride = (long long)lf.tiles * THREADS;
  long long a0 = cap, a1 = cap;
  if (lf.out_vec) {
    a0 = (from + 3) & ~3LL;
    if (a0 > cap) a0 = cap;
    a1 = cap & ~3LL;
    if (a1 < a0) a1 = a0;
  }
  for (long long p = from + gi; p < a0; p += stride) {
    lf.idx[p] = -1;
    lf.vals[p] = 0.0f;
  }
  for (long long q = a0 + 4 * gi; q < a1; q += 4 * stride) {
    *reinterpret_cast<int4*>(lf.idx + q) = make_int4(-1, -1, -1, -1);
    *reinterpret_cast<float4*>(lf.vals + q) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (long long p = a1 + gi; p < cap; p += stride) {
    lf.idx[p] = -1;
    lf.vals[p] = 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
compact_scatter_kernel(const Table t, int drop_zeros,
                       const int* __restrict__ tile_counts,
                       const int* __restrict__ offsets) {
  __shared__ int s_idx[TILE];
  __shared__ float s_val[TILE];
  __shared__ int run[VPT * WARPS];   // kept a (round, warp), then its offset
  __shared__ int before_warp[WARPS];
  __shared__ int s_base, s_kept;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Leaf lf = t.leaf[find_leaf(t)];
  const int tile = blockIdx.x - lf.first;
  unsigned e[VPT], bits[VPT];
  T v[VPT][4];
  tile_load<T>(lf, (unsigned)tile * TILE, e, v);

  // while g is in flight: the kept entries of the leaf's tiles before
  // this one
  int before = 0;
  if (lf.tiles > MAX_PREFIX_TILES) {
    if (threadIdx.x == 0) before = offsets[lf.tc + tile];
  } else {
    for (int k = threadIdx.x; k < tile; k += THREADS)
      before += tile_counts[lf.tc + k];
  }
  before = __reduce_add_sync(0xffffffffu, before);
  if (lane == 0) before_warp[warp] = before;
  tile_bits<T>(lf, drop_zeros, e, v, bits);

  // rank in the tile: rounds in order, then threads, then the 4 entries;
  // a vector keeps 0..4 entries, so three ballots give each lane the kept
  // entries of the lanes below it
  const unsigned below = (1u << lane) - 1u;
  int lane_before[VPT];
#pragma unroll
  for (int r = 0; r < VPT; ++r) {
    const int c = __popc(bits[r]);
    const unsigned b0 = __ballot_sync(0xffffffffu, c & 1);
    const unsigned b1 = __ballot_sync(0xffffffffu, c & 2);
    const unsigned b2 = __ballot_sync(0xffffffffu, c & 4);
    lane_before[r] = __popc(b0 & below) + 2 * __popc(b1 & below) +
                     4 * __popc(b2 & below);
    if (lane == 0)
      run[r * WARPS + warp] = __popc(b0) + 2 * __popc(b1) + 4 * __popc(b2);
  }
  __syncthreads();
  if (warp == 0) {                 // exclusive scan of the (round, warp) runs
    const int own = lane < VPT * WARPS ? run[lane] : 0;
    int x = own;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    if (lane < VPT * WARPS) run[lane] = x - own;
    if (lane == 31) s_kept = x;
    if (lane == 0) {
      int b = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) b += before_warp[w];
      s_base = b;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < VPT; ++r) {
    int p = run[r * WARPS + warp] + lane_before[r];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if ((bits[r] >> k) & 1u) {
        s_idx[p] = (int)(e[r] + k);
        s_val[p] = to_float(v[r][k]);
        ++p;
      }
    }
  }
  __syncthreads();
  const long long base = s_base;
  long long stop = base + s_kept;
  if (stop > lf.cap) stop = lf.cap;
  if (stop > base) write_run(lf, s_idx, s_val, base, stop);
  long long kept_total = *lf.count;
  if (kept_total < lf.cap) write_tail(lf, tile, kept_total);
}

// Fill a Table from rows of ROW_WORDS int64 words a leaf: g, M, N, row,
// col, thr, rest, count, tc, cap, idx, vals.  Returns the grid's blocks,
// or -1 if a row is refused.
long long fill_table(const long long* rows, int L, int dtype,
                     long long work_len, Table* t) {
  if (L <= 0 || L > MAX_LEAVES || (dtype != 0 && dtype != 1)) return -1;
  const long long align = dtype == 0 ? 16 : 8;
  t->L = L;
  long long blocks = 0;
  for (int l = 0; l < L; ++l) {
    const long long* r = rows + (long long)l * ROW_WORDS;
    const long long M = r[1], N = r[2];
    if (M <= 0 || N <= 0 || M * N >= (1LL << 31) || r[8] < 0 || r[9] < 0)
      return -1;
    Leaf& lf = t->leaf[l];
    lf.g = reinterpret_cast<const void*>(r[0]);
    lf.M = (int)M;
    lf.N = (int)N;
    lf.row = reinterpret_cast<const float*>(r[3]);
    lf.col = reinterpret_cast<const float*>(r[4]);
    lf.thr = reinterpret_cast<const float*>(r[5]);
    lf.rest = reinterpret_cast<const float*>(r[6]);
    lf.count = reinterpret_cast<int*>(r[7]);
    lf.tc = (int)r[8];
    lf.cap = r[9];
    lf.idx = reinterpret_cast<int*>(r[10]);
    lf.vals = reinterpret_cast<float*>(r[11]);
    lf.first = (int)blocks;
    lf.tiles = (int)((M * N + TILE - 1) / TILE);
    if (r[8] + lf.tiles > work_len) return -1;
    lf.vec = N % 4 == 0 && r[0] % align == 0 && r[4] % 16 == 0;
    lf.out_vec = r[10] % 16 == 0 && r[11] % 16 == 0;
    blocks += lf.tiles;
  }
  return blocks;
}

}  // namespace

// The count launch over a table of L leaves (1 <= L <= MAX_LEAVES).  rows:
// ROW_WORDS int64 words a leaf — g, M, N, row, col, thr, rest, count, tc,
// cap, idx, vals; device pointers but M, N, tc (the leaf's first tile in
// tile_counts and offsets, which hold work_len ints each) and cap; thr and
// rest are fp32 scalars in device memory; count gets the leaf's true kept
// total; cap, idx and vals are not read.  dtype: 0 = fp32, 1 = bf16, for
// every leaf.  M * N must be below 2^31 (flat indices are int32).  Two
// count launches must not run at once (the tickets are the library's):
// keep them on one stream.  Returns a cudaError_t.
extern "C" int select_compact_count_launch(const long long* rows, int L,
                                           int dtype, int drop_zeros,
                                           int* tile_counts, int* offsets,
                                           long long work_len,
                                           void* stream) {
  Table t;
  const long long blocks = fill_table(rows, L, dtype, work_len, &t);
  if (blocks < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    compact_count_kernel<float><<<(int)blocks, THREADS, 0, s>>>(
        t, drop_zeros, tile_counts, offsets);
  else
    compact_count_kernel<__nv_bfloat16><<<(int)blocks, THREADS, 0, s>>>(
        t, drop_zeros, tile_counts, offsets);
  return (int)cudaGetLastError();
}

// The scatter launch over a table of leaves whose counts a count launch
// with the same drop_zeros has written on this stream (the rows may be a
// subset of its rows, each with its count and tc).  Each leaf's idx and
// vals hold cap entries.  Returns a cudaError_t.
extern "C" int select_compact_scatter_launch(const long long* rows, int L,
                                             int dtype, int drop_zeros,
                                             const int* tile_counts,
                                             const int* offsets,
                                             long long work_len,
                                             void* stream) {
  Table t;
  const long long blocks = fill_table(rows, L, dtype, work_len, &t);
  if (blocks < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    compact_scatter_kernel<float><<<(int)blocks, THREADS, 0, s>>>(
        t, drop_zeros, tile_counts, offsets);
  else
    compact_scatter_kernel<__nv_bfloat16><<<(int)blocks, THREADS, 0, s>>>(
        t, drop_zeros, tile_counts, offsets);
  return (int)cudaGetLastError();
}
