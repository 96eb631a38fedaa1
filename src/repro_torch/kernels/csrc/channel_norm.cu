// Channel norms: the row squared norms (M,) and the column squared norms
// (N,) of every gradient matrix G (M, N) of one client's pass, or of the
// S clients of a round (a leaf is then a slot-stacked G (S, M, N)), in one
// launch, accumulated in fp32.  G is fp32 or bf16, row-major.
//
// Replaces the TPU kernel repro/kernels/channel_norm.py:
// channel_norms_pallas (body _channel_norm_kernel), which walks a
// sequential (M/256, N/256) grid and carries both sums in the output
// blocks from one grid step to the next.  Blocks on Hopper run in no
// order, so nothing can be carried between them.
//
// Bound on an H100: bytes.  The function must read G once and write
// M + N floats; the arithmetic (a multiply and two adds per entry) is far
// below the fp32 rate.  A pass over the main path's matrices, (2917, 256)
// + (256, 64) + (64, 1) fp32, reads 3.05 MB: about 0.9 us at 3.35 TB/s,
// less than a launch.  So the design spends one launch a pass, keeps
// every block's loads in flight at once, spreads the largest matrix over
// most of the SMs, and keeps the cross-block reduction to two trips to
// L2 (a ticket, then the partials) with no fence and no second pass.
//
// Design:
// - One launch takes a table of up to MAX_LEAVES leaves (passed by
//   value), each S slot-stacked matrices (S = 1 for a client's pass).  A
//   matrix is cut into tiles of TILE_ROWS rows by STRIP columns (31 x 4
//   tiles for the main path's largest matrix); the grid is the
//   concatenation of every leaf's S x tiles, and a block finds its leaf
//   from the prefix, then its slot and tile.  A slot's tiles, partials,
//   tickets and finish are its own, so slot s of an S-slot launch is
//   bitwise the one-slot launch on slot s.
// - A block is 16 x 16 threads: 16 lanes take 4 neighbouring columns each
//   (one 16-byte load in fp32, 8 bytes in bf16, where N % 4 == 0 and G is
//   aligned; 4 scalar loads elsewhere: 33 x 257, 7 x 9, 64 x 1), 16 rows
//   at a time, RPT times.  A thread issues all its RPT loads before it
//   uses any: 96 bytes a thread, 24 KB a block in flight.
// - Row sums within the strip: a fixed xor-shuffle tree over the 16
//   lanes.  Column sums within the tile: each thread adds its rows in row
//   order, then the 16 row lanes add in order through shared memory.
// - Across tiles, deterministic with no float atomics: a tile writes its
//   row and column partials to the workspace and takes one ticket of
//   its column strip and one of its row strip (two warps, at once).  The
//   last tile to arrive in a column strip adds that strip's column
//   partials in tile order (4 slices of the tiles, then the slices in
//   order); the last to arrive in a row strip adds that strip's row
//   partials in strip order.  The finish is parallel, one block a strip.
// - No fence: a partial is stored as its bits inverted, so the workspace's
//   zero means "not landed yet"; the last arrival reads a zero again until
//   the store lands (it was issued before its tile took the ticket), and
//   sets each partial and the ticket back to 0 once read.  No memset, no
//   allocation, no second launch, and no fence, which would wait for the
//   partials' stores before the ticket: a third trip to L2.
// - The workspace (partials, then the column tickets, then the row
//   tickets) is the caller's: a zeroed device buffer that each launch
//   leaves zeroed, passed by pointer with its length, so a table of any
//   number of slots takes one launch, and the pointer a CUDA graph
//   captures stays valid for as long as the caller keeps the buffer.
// - A leaf of one strip (N <= STRIP) writes its row norms straight from
//   the tile, one of one tile row (M <= TILE_ROWS) its column norms.  Two
//   launches on the same input give bitwise the same output: the scores
//   feed an exact `>` test.
// - A thread-block cluster that adds the column partials through
//   distributed shared memory would need no trip to L2, but holds a leaf
//   to at most 16 SMs: benchmarks/cuda_channel_norm_designs.py measures
//   it at about twice this kernel's time on the main path's pass.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 256;
constexpr int LANES = 16;                       // column lanes of a block
constexpr int STRIP = LANES * 4;                // columns of a tile
constexpr int RLANES = THREADS / LANES;         // rows read at once
constexpr int RPT = 6;                          // rows a thread, a tile
constexpr int TILE_ROWS = RLANES * RPT;         // rows of a tile
constexpr int SLICES = THREADS / STRIP;         // finish slices a column
constexpr int FIN = 8;                          // finish loads in flight
constexpr int SPIN_LIMIT = 1 << 24;             // re-reads of one partial
constexpr int MAX_LEAVES = 16;
constexpr int ROW_WORDS = 6;                    // int64 words a table row

struct Leaf {
  const void* g;            // (S, M, N)
  float* row;               // (S, M)
  float* col;               // (S, N)
  long long colpart;        // offset in the partials: (S, row tiles, N)
  long long rowpart;        // offset in the partials: (S, column strips, M)
  int M, N, S;
  int first;                // first block of the leaf in the grid
  int nrt, nct;             // tile rows, column strips (a slot)
  int col_tk, row_tk;       // first ticket of each kind (slot 0)
  int vec;                  // 16-byte (bf16: 8-byte) loads of g
};

// The workspace's three parts.  Zero before a launch, and every launch
// leaves them zero.  A partial p is stored as ~bits(p), so 0 stands for
// "not written yet": no sum of squares has the bits 0xffffffff (a NaN
// the card never computes).
struct Table {
  Leaf leaf[MAX_LEAVES];
  unsigned* scratch;        // partials
  unsigned* col_tickets;
  unsigned* row_tickets;
  int L;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void load_vec(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float v[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(q.x << 16);
  v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16);
  v[3] = __uint_as_float(q.y & 0xffff0000u);
}

// columns c .. c+3 of row r, zero outside the matrix
template <typename T>
__device__ __forceinline__ void load4(const T* __restrict__ g, int r, int c,
                                      int M, int N, bool vec, float v[4]) {
  v[0] = v[1] = v[2] = v[3] = 0.f;
  if (r >= M || c >= N) return;
  const T* p = g + (size_t)r * N + c;
  if (vec) {
    load_vec(p, v);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (c + j < N) v[j] = to_f32(p[j]);
}

__device__ __forceinline__ int find_leaf(const Table& t) {
  int l = 0;
  while (l + 1 < t.L && (int)blockIdx.x >= t.leaf[l + 1].first) ++l;
  return l;
}

__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned x;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(x) : "l"(p)
               : "memory");
  return x;
}

// The partials p[k * stride] for k in [k0, k1), added in k order, each
// set back to 0 once read.  The loads of a round of FIN go out together,
// from L2; a partial whose store has not landed yet reads 0 and is read
// again (its store was issued before its tile took the ticket; a store
// that never lands would be a fault of this kernel, and traps rather than
// hangs).
__device__ __forceinline__ float take_in_order(unsigned* p, int stride,
                                               int k0, int k1) {
  float s = 0.f;
  for (int k = k0; k < k1; k += FIN) {
    unsigned x[FIN];
#pragma unroll
    for (int j = 0; j < FIN; ++j)
      x[j] = k + j < k1 ? ld_relaxed(p + (long long)(k + j) * stride)
                        : ~0u;                  // +0.0
#pragma unroll
    for (int j = 0; j < FIN; ++j) {
      if (k + j < k1) {
        unsigned* q = p + (long long)(k + j) * stride;
        for (int spin = 0; x[j] == 0u; ++spin) {
          if (spin == SPIN_LIMIT) __trap();
          x[j] = ld_relaxed(q);
        }
        *q = 0u;
      }
      s += __uint_as_float(~x[j]);
    }
  }
  return s;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
channel_norms_kernel(const Table t) {
  __shared__ float col_sh[RLANES][STRIP];
  __shared__ int last[2];
  Leaf lf = t.leaf[find_leaf(t)];
  const int tiles = lf.nrt * lf.nct;
  const int slot = (blockIdx.x - lf.first) / tiles;
  const int b = blockIdx.x - lf.first - slot * tiles;
  const T* g = static_cast<const T*>(lf.g) + (size_t)slot * lf.M * lf.N;
  lf.row += (size_t)slot * lf.M;                // this slot's outputs,
  lf.col += (size_t)slot * lf.N;                // partials and tickets
  lf.colpart += (long long)slot * lf.nrt * lf.N;
  lf.rowpart += (long long)slot * lf.nct * lf.M;
  lf.col_tk += slot * lf.nct;
  lf.row_tk += slot * lf.nrt;
  const int rt = b / lf.nct;
  const int cs = b - rt * lf.nct;
  const int tx = threadIdx.x % LANES;
  const int ty = threadIdx.x / LANES;
  const int c = cs * STRIP + tx * 4;
  const int r0 = rt * TILE_ROWS + ty;

  float v[RPT][4];
#pragma unroll
  for (int k = 0; k < RPT; ++k)                 // every load first
    load4(g, r0 + k * RLANES, c, lf.M, lf.N, lf.vec, v[k]);

  float cacc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    float sq[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sq[j] = v[k][j] * v[k][j];
      cacc[j] += sq[j];
    }
    float s = (sq[0] + sq[1]) + (sq[2] + sq[3]);
#pragma unroll
    for (int off = LANES / 2; off > 0; off >>= 1)  // within the 16 lanes
      s += __shfl_xor_sync(0xffffffffu, s, off);
    const int r = r0 + k * RLANES;
    if (tx == 0 && r < lf.M) {
      if (lf.nct == 1) lf.row[r] = s;
      else
        t.scratch[lf.rowpart + (long long)cs * lf.M + r] =
            ~__float_as_uint(s);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) col_sh[ty][tx * 4 + j] = cacc[j];
  __syncthreads();
  if (threadIdx.x < STRIP) {
    const int cc = cs * STRIP + threadIdx.x;
    float s = 0.f;
#pragma unroll
    for (int y = 0; y < RLANES; ++y) s += col_sh[y][threadIdx.x];
    if (cc < lf.N) {
      if (lf.nrt == 1) lf.col[cc] = s;
      else
        t.scratch[lf.colpart + (long long)rt * lf.N + cc] =
            ~__float_as_uint(s);
    }
  }
  if (lf.nrt == 1 && lf.nct == 1) return;      // uniform across the block

  // warp 0 takes the column ticket and warp 1 the row ticket, at once,
  // with no fence: the last arrival reads the partials until they land
  __syncthreads();
  if ((threadIdx.x & 31) == 0 && threadIdx.x < 64) {
    const int kind = threadIdx.x >> 5;          // 0: columns, 1: rows
    const int n = kind ? lf.nct : lf.nrt;
    unsigned* tk = kind ? &t.row_tickets[lf.row_tk + rt]
                        : &t.col_tickets[lf.col_tk + cs];
    int is_last = 0;
    if (n > 1 && atomicAdd(tk, 1u) == (unsigned)n - 1u) {
      *tk = 0u;                         // every tile of the strip is in
      is_last = 1;
    }
    last[kind] = is_last;
  }
  __syncthreads();
  if (last[0]) {                  // this strip's columns, tiles in order
    const int cc = cs * STRIP + threadIdx.x % STRIP;
    const int slice = threadIdx.x / STRIP;
    const int per = (lf.nrt + SLICES - 1) / SLICES;
    float s = 0.f;
    if (cc < lf.N)
      s = take_in_order(t.scratch + lf.colpart + cc, lf.N, slice * per,
                        min(lf.nrt, slice * per + per));
    col_sh[slice][threadIdx.x % STRIP] = s;   // free since the barrier
    __syncthreads();
    if (threadIdx.x < STRIP && cc < lf.N) {
      float tot = 0.f;
#pragma unroll
      for (int k = 0; k < SLICES; ++k) tot += col_sh[k][threadIdx.x];
      lf.col[cc] = tot;
    }
  }
  if (last[1] && threadIdx.x < TILE_ROWS) {    // this strip's rows
    const int r = rt * TILE_ROWS + threadIdx.x;
    if (r < lf.M)
      lf.row[r] = take_in_order(t.scratch + lf.rowpart + r, lf.M, 0,
                                lf.nct);
  }
}

inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

// One launch over a table of L leaves (1 <= L <= MAX_LEAVES).  rows holds
// ROW_WORDS int64 words a leaf: g, S, M, N, row, col — device pointers
// but S, M and N; g is S contiguous (M, N) matrices, row gets S x M
// floats, col S x N.  dtype: 0 = fp32, 1 = bf16, for every leaf.  ws is
// the workspace, ws_words 32-bit words, zero: the partials (a slot of
// more than one tile row takes row tiles x N, one of more than one column
// strip column strips x M), then a ticket for each column strip and for
// each tile row of such slots; a table that needs more returns
// cudaErrorInvalidValue.  Two launches must not share a workspace at
// once: keep them on one stream.  Returns a cudaError_t.
extern "C" int channel_norms_launch(const long long* rows, int L, int dtype,
                                    void* ws, long long ws_words,
                                    void* stream) {
  if (L <= 0 || L > MAX_LEAVES || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long long align = dtype == 0 ? 16 : 8;
  Table t;
  t.L = L;
  long long blocks = 0, used = 0;
  int col_tk = 0, row_tk = 0;
  for (int l = 0; l < L; ++l) {
    const long long* r = rows + (long long)l * ROW_WORDS;
    const long long S = r[1], M = r[2], N = r[3];
    if (S <= 0 || M <= 0 || N <= 0 || M > 0x7fffffffLL ||
        N > 0x7fffffffLL || S > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    Leaf& lf = t.leaf[l];
    lf.g = reinterpret_cast<const void*>(r[0]);
    lf.S = (int)S;
    lf.M = (int)M;
    lf.N = (int)N;
    lf.row = reinterpret_cast<float*>(r[4]);
    lf.col = reinterpret_cast<float*>(r[5]);
    lf.nrt = (int)cdiv(M, TILE_ROWS);
    lf.nct = (int)cdiv(N, STRIP);
    lf.vec = N % 4 == 0 && r[0] % align == 0;
    lf.first = (int)blocks;
    lf.colpart = lf.rowpart = 0;
    lf.col_tk = col_tk;
    lf.row_tk = row_tk;
    if (lf.nrt > 1) {
      lf.colpart = used;
      used += S * lf.nrt * N;
      if (col_tk + S * lf.nct > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
      col_tk += (int)(S * lf.nct);
    }
    if (lf.nct > 1) {
      lf.rowpart = used;
      used += S * lf.nct * M;
      if (row_tk + S * lf.nrt > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
      row_tk += (int)(S * lf.nrt);
    }
    blocks += S * lf.nrt * lf.nct;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  }
  const long long words = used + col_tk + row_tk;
  if (words > ws_words || (words && !ws)) return (int)cudaErrorInvalidValue;
  t.scratch = static_cast<unsigned*>(ws);
  t.col_tickets = t.scratch + used;
  t.row_tickets = t.col_tickets + col_tk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    channel_norms_kernel<float><<<(unsigned)blocks, THREADS, 0, s>>>(t);
  else
    channel_norms_kernel<__nv_bfloat16><<<(unsigned)blocks, THREADS, 0, s>>>(
        t);
  return (int)cudaGetLastError();
}
