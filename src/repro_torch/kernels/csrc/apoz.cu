// APoZ counts: the number of exact zeros in every column of the
// activation matrices of one validation batch, one launch for all the
// hidden layers, and optionally the APoZ fractions in the same launch.
//
//   counts[j] = #{ b : acts[b, j] == 0 }            (int32, acts fp32)
//   frac[j]   = fl((float)counts[j] * recip)        (fp32, one rounding)
//
// `== 0` is IEEE equality: -0.0 counts as a zero and NaN does not, as in
// the reference's oracle (repro/kernels/ref.py: apoz_counts_ref).  With
// recip = fl(1/B) the fraction is bitwise what XLA makes of the
// reference's `count / B`.
//
// Replaces the TPU kernel repro/kernels/apoz.py: apoz_counts_pallas (body
// _apoz_kernel).  That kernel streams the batch through a sequential grid
// and carries the int32 counts in its output block from step to step.
// Hopper blocks run in no order, so nothing is carried between them.
//
// Bound on an H100: bytes — one read of acts (4 bytes an entry) and the
// counts and fractions written once.  A prune step of the SCBFwP path,
// (2048, 256) + (2048, 64) and (1028, 256) + (1028, 64) fp32, reads 3.95
// MB: about 1.2 us at 3.35 TB/s, less than two launches.  So the design
// spends one launch a batch and no memset, and keeps every block's loads
// in flight at once.
//
// Design:
// - One launch takes a table of up to MAX_LEAVES matrices (passed by
//   value), cut into tiles of TILE_ROWS rows by STRIP columns; the grid
//   is the concatenation of every leaf's tiles, and a block finds its leaf
//   from the tiles' prefix.
// - A block is 16 x 16 threads: 16 lanes take 4 neighbouring columns each
//   (one 16-byte load where N % 4 == 0 and acts is aligned, 4 scalar loads
//   elsewhere), 16 rows at a time, RPT times, every load issued before
//   any is used: 128 bytes a thread, 32 KB a block in flight.  The 16 row
//   lanes' counts add through shared memory.
// - Counts across tiles without a memset or a second pass: a tile adds
//   its count and one arrival to the column's 64-bit ticket in one atomic;
//   the tile that brings the last arrival writes the count (and the
//   fraction) from the sum and sets the ticket back to 0.  Integer sums:
//   exact and deterministic whatever the order, and no fence.  A leaf of
//   one tile row (B <= TILE_ROWS) writes its counts straight from the
//   tile.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int LANES = 16;                       // column lanes of a block
constexpr int STRIP = LANES * 4;                // columns of a tile
constexpr int RLANES = THREADS / LANES;         // rows read at once
constexpr int RPT = 8;                          // rows a thread, a tile
constexpr int TILE_ROWS = RLANES * RPT;         // rows of a tile
constexpr int MAX_LEAVES = 16;
constexpr int ROW_WORDS = 5;                    // int64 words a table row
constexpr int MAX_COLS = 1 << 16;               // columns a launch

struct Leaf {
  const float* acts;
  int* counts;
  float* frac;              // null: counts only
  int B, N;
  int first;                // first block of the leaf in the grid
  int nrt, nct;             // tile rows, column strips
  int tk;                   // the leaf's first column ticket
  int vec;                  // 16-byte loads of acts
};

struct Table {
  Leaf leaf[MAX_LEAVES];
  int L;
};

// one ticket a column of a launch: tiles arrived (high word) and their
// zeros (low word; B < 2^31, so no carry).  Zero when the library loads,
// and every launch leaves them zero.
__device__ unsigned long long tickets[MAX_COLS];

__device__ __forceinline__ int find_leaf(const Table& t) {
  int l = 0;
  while (l + 1 < t.L && (int)blockIdx.x >= t.leaf[l + 1].first) ++l;
  return l;
}

// columns c .. c+3 of row r; 1 (not a zero) outside the matrix
__device__ __forceinline__ void load4(const float* __restrict__ a, int r,
                                      int c, int B, int N, bool vec,
                                      float v[4]) {
  v[0] = v[1] = v[2] = v[3] = 1.f;
  if (r >= B || c >= N) return;
  const float* p = a + (size_t)r * N + c;
  if (vec) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (c + j < N) v[j] = p[j];
}

__global__ void __launch_bounds__(THREADS)
apoz_leaves_kernel(const Table t, float recip) {
  __shared__ int part[RLANES][STRIP];
  const Leaf lf = t.leaf[find_leaf(t)];
  const int b = blockIdx.x - lf.first;
  const int rt = b / lf.nct;
  const int cs = b - rt * lf.nct;
  const int tx = threadIdx.x % LANES;
  const int ty = threadIdx.x / LANES;
  const int r0 = rt * TILE_ROWS + ty;

  float v[RPT][4];
#pragma unroll
  for (int k = 0; k < RPT; ++k)                 // every load first
    load4(lf.acts, r0 + k * RLANES, cs * STRIP + tx * 4, lf.B, lf.N, lf.vec,
          v[k]);
  int z[4] = {0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < RPT; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) z[j] += v[k][j] == 0.0f ? 1 : 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) part[ty][tx * 4 + j] = z[j];
  __syncthreads();
  const int c = cs * STRIP + threadIdx.x;
  if (threadIdx.x >= STRIP || c >= lf.N) return;
  unsigned n = 0;
#pragma unroll
  for (int y = 0; y < RLANES; ++y) n += part[y][threadIdx.x];
  if (lf.nrt > 1) {
    // the tile's count rides on its ticket: one atomic, no fence
    unsigned long long* tk = &tickets[lf.tk + c];
    const unsigned long long old = atomicAdd(tk, (1ull << 32) | n);
    if ((unsigned)(old >> 32) != (unsigned)lf.nrt - 1u) return;
    *tk = 0ull;                          // every tile of the column is in
    n += (unsigned)old;
  }
  lf.counts[c] = (int)n;
  if (lf.frac) lf.frac[c] = __fmul_rn(__uint2float_rn(n), recip);
}

inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

// One launch over a table of L matrices (1 <= L <= MAX_LEAVES).  rows
// holds ROW_WORDS int64 words a leaf: acts, B, N, counts, frac — device
// pointers but B and N; counts gets N ints, frac N floats (or 0 for no
// fractions), each frac[j] = fl(counts[j] * recip).  The leaves' columns
// add up to at most MAX_COLS.  Two launches must not run at once (the
// tickets are the library's): keep them on one stream.  Returns a
// cudaError_t.
extern "C" int apoz_counts_launch(const long long* rows, int L, float recip,
                                  void* stream) {
  if (L <= 0 || L > MAX_LEAVES) return (int)cudaErrorInvalidValue;
  Table t;
  t.L = L;
  long long blocks = 0, cols = 0;
  for (int l = 0; l < L; ++l) {
    const long long* r = rows + (long long)l * ROW_WORDS;
    const long long B = r[1], N = r[2];
    if (B <= 0 || N <= 0 || B > 0x7fffffffLL || N > MAX_COLS)
      return (int)cudaErrorInvalidValue;
    Leaf& lf = t.leaf[l];
    lf.acts = reinterpret_cast<const float*>(r[0]);
    lf.B = (int)B;
    lf.N = (int)N;
    lf.counts = reinterpret_cast<int*>(r[3]);
    lf.frac = reinterpret_cast<float*>(r[4]);
    lf.nrt = (int)cdiv(B, TILE_ROWS);
    lf.nct = (int)cdiv(N, STRIP);
    lf.vec = N % 4 == 0 && r[0] % 16 == 0;
    lf.first = (int)blocks;
    lf.tk = (int)cols;
    cols += N;
    blocks += (long long)lf.nrt * lf.nct;
    if (cols > MAX_COLS || blocks > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  apoz_leaves_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(t, recip);
  return (int)cudaGetLastError();
}
