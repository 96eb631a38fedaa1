// Select and compact: the edge rule of SCBF's channel selection, fused with
// the compaction of the kept entries into COO upload buffers, over every
// weight matrix of one client's pass, or of the S clients of a round.
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
// launches, each deterministic.  A leaf is S slot-stacked matrices g
// (S, M, N) with their row (S, M), col (S, N), thr (S,) and rest (S,) — an
// operand of slot stride 0 serves every slot — and a (leaf, slot) pair is
// one matrix, cut into tiles of TILE entries:
//   1. count:   over a table of leaves (passed by value), every pair; the
//               grid is the concatenation of every leaf's S x tiles.
//               Block t counts the kept entries of its tile, writes the
//               count and adds it, with one arrival, to its pair's 64-bit
//               ticket in one atomic; the block that brings the last
//               arrival writes the pair's `count` and sets the ticket back
//               to 0.  For a matrix of more than MAX_PREFIX_TILES tiles
//               only, that block also scans the tile counts into exclusive
//               offsets (after a fence), so no block of the next launch
//               reduces more than MAX_PREFIX_TILES counts.
//   2. scatter: over any subset of the pairs (the leaves passed by value,
//               the pairs' table copied by the launcher into the library's
//               device memory on the launch's stream), each at its own
//               capacity and into its own idx and vals; the grid is the
//               concatenation of the pairs' tiles.  Each warp finds its
//               block's pair by a 32-way search of the table (one round
//               of loads up to 32 pairs, two up to 1,024).  Block t adds
//               the counts of the tiles before it in its pair
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
// indices, not by the schedule, and a pair's tiles, counts and ticket are
// its own, so slot s of an S-slot launch is bitwise a one-slot launch.
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
constexpr int MAX_SLOTS = 4096;                 // pairs a launch
constexpr int MAX_PREFIX_TILES = 1024;
constexpr int LEAF_WORDS = 15;                  // int64 words a leaf row
constexpr int PAIR_WORDS = 5;                   // int64 words a pair row

// a slot-stacked leaf: S matrices (M, N) and their operands
struct Leaf {
  const void* g;            // (S, M, N)
  const float* row;         // slot s at row + s * row_ss
  const float* col;
  const float* thr;
  const float* rest;
  int* count;               // (S,)
  int M, N, S;
  int row_ss, col_ss, thr_ss, rest_ss;          // slot strides, in floats
  int first;                // count launch: first block of the leaf
  int tiles;                // tiles a slot
  int tc;                   // slot 0's first tile in tile_counts/offsets
  int pair;                 // (leaf, slot 0)'s ticket
  int vec;                  // 16-byte (bf16: 8-byte) loads of g
};

// a (leaf, slot) pair the scatter launch compacts: idx at out + idx_at,
// vals at out + vals_at, cap entries each
struct Pair {
  int first;                // first block of the pair in the grid
  int cap;
  int idx_at, vals_at;      // in ints from the launch's out
  unsigned short leaf, slot;
};
static_assert(sizeof(Pair) == 20, "a pair is 5 words");

struct CountTable {
  Leaf leaf[MAX_LEAVES];
  int L;
};

struct ScatterTable {
  Leaf leaf[MAX_LEAVES];
  int* out;
  int L, P;
};

// One matrix: a leaf's slot, with the operands and outputs of that slot.
struct View {
  const void* g;
  const float* row;
  const float* col;
  float thr, rest;
  int* count;
  int* idx;
  float* vals;
  long long cap;
  int M, N;
  int tiles;
  int tc;                   // the matrix's first tile in tile_counts/offsets
  int vec;                  // 16-byte (bf16: 8-byte) loads of g
  int out_vec;              // 16-byte stores of idx and vals
};

template <typename T>
__device__ __forceinline__ View slot_view(const Leaf& lf, int slot) {
  View v;
  v.g = static_cast<const T*>(lf.g) + (size_t)slot * lf.M * lf.N;
  v.row = lf.row + (size_t)slot * lf.row_ss;
  v.col = lf.col + (size_t)slot * lf.col_ss;
  v.thr = lf.thr[(size_t)slot * lf.thr_ss];
  v.rest = lf.rest[(size_t)slot * lf.rest_ss];
  v.count = lf.count + slot;
  v.idx = nullptr;
  v.vals = nullptr;
  v.cap = 0;
  v.out_vec = 0;
  v.M = lf.M;
  v.N = lf.N;
  v.tiles = lf.tiles;
  v.tc = lf.tc + slot * lf.tiles;
  v.vec = lf.vec;
  return v;
}

// one ticket a (leaf, slot) pair: tiles counted (high word) and their kept
// entries (low word; M * N < 2^31, so no carry).  Zero when the library
// loads, and every count launch leaves them zero.
__device__ unsigned long long tickets[MAX_SLOTS];

// the pairs of a scatter launch, copied in by its launcher on its stream
// (so, as for the tickets, two scatter launches must not run at once)
__device__ Pair scatter_pairs[MAX_SLOTS];
// the launcher's host copy: a copy from pageable memory has read it when
// cudaMemcpyToSymbolAsync returns, so the next launcher may refill it
Pair staged_pairs[MAX_SLOTS];

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

__device__ __forceinline__ int find_leaf(const CountTable& t) {
  int l = 0;
  while (l + 1 < t.L && (int)blockIdx.x >= t.leaf[l + 1].first) ++l;
  return l;
}

// the pair whose blocks hold this one, the last whose first block is at
// or below it: each round the warp's lanes read 32 evenly spaced firsts of
// the range left and keep the span after the last at or below the block
// (every pair has a tile, so the firsts rise; pair 0's is 0)
__device__ __forceinline__ int find_pair(int P) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x;
  int lo = 0, n = P;                            // the pair is in [lo, lo + n)
  while (n > 1) {
    const int step = (n + 31) / 32;
    const int k = lane * step;
    const bool at_or_below = k < n && scatter_pairs[lo + k].first <= b;
    const unsigned m = __ballot_sync(0xffffffffu, at_or_below);
    const int last = 31 - __clz(m);            // bit 0 is set: lo is
    lo += last * step;
    n = min(step, n - last * step);
  }
  return lo;
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
__device__ __forceinline__ void tile_load(const View& lf, unsigned base,
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
__device__ __forceinline__ void tile_bits(const View& lf, int drop_zeros,
                                          const unsigned e[VPT],
                                          const T v[VPT][4],
                                          unsigned bits[VPT]) {
  const unsigned N = lf.N;
  const unsigned total = (unsigned)lf.M * N;
  const float thr = lf.thr;
  const float rest = lf.rest;
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
compact_count_kernel(const CountTable t, int drop_zeros,
                     int* __restrict__ tile_counts,
                     int* __restrict__ offsets) {
  __shared__ unsigned warp_kept[WARPS];
  __shared__ bool last;
  const Leaf& leaf = t.leaf[find_leaf(t)];
  const int slot = (blockIdx.x - leaf.first) / leaf.tiles;
  const int tile = blockIdx.x - leaf.first - slot * leaf.tiles;
  const int pair = leaf.pair + slot;
  const View lf = slot_view<T>(leaf, slot);
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
    const unsigned long long old = atomicAdd(&tickets[pair],
                                             (1ull << 32) | n);
    last = (unsigned)(old >> 32) == (unsigned)lf.tiles - 1u;
    if (last) {
      tickets[pair] = 0ull;              // every block of the pair is in
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
__device__ void write_run(const View& lf, const int* s_idx,
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
__device__ void write_tail(const View& lf, int tile, long long from) {
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
compact_scatter_kernel(const ScatterTable t, int drop_zeros,
                       const int* __restrict__ tile_counts,
                       const int* __restrict__ offsets) {
  __shared__ int s_idx[TILE];
  __shared__ float s_val[TILE];
  __shared__ int run[VPT * WARPS];   // kept a (round, warp), then its offset
  __shared__ int before_warp[WARPS];
  __shared__ int s_base, s_kept;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Pair pr = scatter_pairs[find_pair(t.P)];
  View lf = slot_view<T>(t.leaf[pr.leaf], pr.slot);
  lf.idx = t.out + pr.idx_at;
  lf.vals = reinterpret_cast<float*>(t.out + pr.vals_at);
  lf.cap = pr.cap;
  lf.out_vec = (reinterpret_cast<size_t>(lf.idx) & 15) == 0 &&
               (reinterpret_cast<size_t>(lf.vals) & 15) == 0;
  const int tile = blockIdx.x - pr.first;
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

// Fill the leaves from rows of LEAF_WORDS int64 words a leaf: g, S, M, N,
// row, row_ss, col, col_ss, thr, thr_ss, rest, rest_ss, count, tc, pair.
// Returns the count grid's blocks, or -1 if a row is refused.
long long fill_leaves(const long long* rows, int L, int dtype,
                      long long work_len, Leaf* leaf) {
  if (L <= 0 || L > MAX_LEAVES || (dtype != 0 && dtype != 1)) return -1;
  const long long align = dtype == 0 ? 16 : 8;
  long long blocks = 0;
  for (int l = 0; l < L; ++l) {
    const long long* r = rows + (long long)l * LEAF_WORDS;
    const long long S = r[1], M = r[2], N = r[3];
    if (S <= 0 || M <= 0 || N <= 0 || M * N >= (1LL << 31) || r[13] < 0 ||
        r[14] < 0 || r[14] + S > MAX_SLOTS)
      return -1;
    for (int k = 5; k <= 11; k += 2)           // strides: 0 or the length
      if (r[k] < 0 || r[k] > 0x7fffffffLL) return -1;
    Leaf& lf = leaf[l];
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
    lf.count = reinterpret_cast<int*>(r[12]);
    lf.tc = (int)r[13];
    lf.pair = (int)r[14];
    lf.first = (int)blocks;
    lf.tiles = (int)((M * N + TILE - 1) / TILE);
    if (r[13] + S * lf.tiles > work_len) return -1;
    // every slot's g and col then share the alignment of slot 0's
    lf.vec = N % 4 == 0 && r[0] % align == 0 && r[6] % 16 == 0 &&
             lf.col_ss % 4 == 0;
    blocks += S * lf.tiles;
  }
  return blocks > 0x7fffffffLL ? -1 : blocks;
}

}  // namespace

// The count launch over a table of L leaves (1 <= L <= MAX_LEAVES), every
// (leaf, slot) pair.  rows: LEAF_WORDS int64 words a leaf — g, S, M, N, row,
// row_ss, col, col_ss, thr, thr_ss, rest, rest_ss, count, tc, pair; device
// pointers but S, M, N, the slot strides (in floats, 0 for an operand
// every slot shares), tc (slot 0's first tile in tile_counts and offsets,
// which hold work_len ints each; slot s follows at tc + s x tiles) and
// pair (slot 0's ticket; pairs are below MAX_SLOTS); g holds S contiguous
// (M, N) matrices; thr and rest are fp32 scalars in device memory; count
// gets each slot's true kept total.  dtype: 0 = fp32, 1 = bf16, for every
// leaf.  M * N must be below 2^31 (flat indices are int32).  Two count
// launches must not run at once (the tickets are the library's): keep
// them on one stream.  Returns a cudaError_t.
extern "C" int select_compact_count_launch(const long long* rows, int L,
                                           int dtype, int drop_zeros,
                                           int* tile_counts, int* offsets,
                                           long long work_len,
                                           void* stream) {
  CountTable t;
  t.L = L;
  const long long blocks = fill_leaves(rows, L, dtype, work_len, t.leaf);
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

// The scatter launch over P (leaf, slot) pairs (1 <= P <= MAX_SLOTS) of a
// table whose counts a count launch with the same rows and drop_zeros has
// written on this stream.  pairs: PAIR_WORDS int64 words a pair (host
// memory) — leaf, slot, cap, idx_at, vals_at: the pair's idx and vals hold
// cap entries from out + idx_at and out + vals_at (offsets in ints, below
// 2^31).  The launcher copies the pairs to the device on the stream, then
// launches; two scatter launches must not run at once (one stream).
// Returns a cudaError_t.
extern "C" int select_compact_scatter_launch(const long long* rows, int L,
                                             const long long* pairs, int P,
                                             int* out, int dtype,
                                             int drop_zeros,
                                             const int* tile_counts,
                                             const int* offsets,
                                             long long work_len,
                                             void* stream) {
  ScatterTable t;
  t.L = L;
  if (fill_leaves(rows, L, dtype, work_len, t.leaf) < 0 || P <= 0 ||
      P > MAX_SLOTS)
    return (int)cudaErrorInvalidValue;
  t.P = P;
  t.out = out;
  long long blocks = 0;
  for (int k = 0; k < P; ++k) {
    const long long* r = pairs + (long long)k * PAIR_WORDS;
    if (r[0] < 0 || r[0] >= L || r[1] < 0 || r[1] >= t.leaf[r[0]].S ||
        r[2] < 0 || r[2] > 0x7fffffffLL || r[3] < 0 ||
        r[3] > 0x7fffffffLL || r[4] < 0 || r[4] > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    Pair& p = staged_pairs[k];
    p.leaf = (unsigned short)r[0];
    p.slot = (unsigned short)r[1];
    p.cap = (int)r[2];
    p.idx_at = (int)r[3];
    p.vals_at = (int)r[4];
    p.first = (int)blocks;
    blocks += t.leaf[r[0]].tiles;
  }
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t copied = cudaMemcpyToSymbolAsync(
      scatter_pairs, staged_pairs, sizeof(Pair) * P, 0,
      cudaMemcpyHostToDevice, s);
  if (copied != cudaSuccess) return (int)copied;
  if (dtype == 0)
    compact_scatter_kernel<float><<<(int)blocks, THREADS, 0, s>>>(
        t, drop_zeros, tile_counts, offsets);
  else
    compact_scatter_kernel<__nv_bfloat16><<<(int)blocks, THREADS, 0, s>>>(
        t, drop_zeros, tile_counts, offsets);
  return (int)cudaGetLastError();
}
