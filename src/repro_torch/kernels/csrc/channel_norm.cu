// Channel norms: one pass over a gradient matrix G (M, N), row-major,
// giving the row squared norms (M,) and the column squared norms (N,),
// accumulated in fp32.  G is fp32 or bf16.
//
// Replaces the TPU kernel repro/kernels/channel_norm.py:
// channel_norms_pallas (body _channel_norm_kernel), which walks a
// sequential (M/256, N/256) grid and carries both sums in the output
// blocks from one grid step to the next.  Blocks on Hopper run in no
// order, so nothing can be carried between them.
//
// Bound on an H100: bytes.  The function must read G once and write
// M + N floats; the arithmetic (a multiply and two adds per entry) is
// far below the fp32 rate.  At the main path's largest matrix,
// (2917, 256) fp32 = 2.99 MB, that is about 0.9 us at 3.35 TB/s, so a
// launch costs more than the data.
//
// Design: deterministic, with no float atomics.  The scores feed an
// exact `>` test, so a sum whose order changed from run to run would
// flip masks from run to run.
//   pass 1: a block of 8 warps owns a tile of TM = 64 rows by TN = 32
//           columns.  Lane l reads column c0 + l, so a warp's load of a
//           row is one coalesced segment.  Each lane sums its column over
//           its warp's rows in row order; the warps' column sums then
//           add in warp order through shared memory and land in
//           colpart[row_tile][c].  For every row, a fixed shuffle-down
//           tree sums the 32 lanes and lane 0 writes rowpart[col_tile][r].
//   pass 2: one thread per output sums its partials in tile order.
// Ragged edges (N = 1, M or N not multiples of the tile) are masked in
// the kernel: lanes past N read zero, warps past M stop.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int TN = 32;            // columns per tile: one warp's lanes
constexpr int WARPS = 8;          // warps per block
constexpr int TM = 64;            // rows per tile: TM / WARPS per warp
constexpr int FINISH_THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
partials_kernel(const T* __restrict__ g, int M, int N,
                float* __restrict__ rowpart,    // (col_tiles, M)
                float* __restrict__ colpart) {  // (row_tiles, N)
  __shared__ float col_sh[WARPS][TN];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ct = blockIdx.x;
  const int rt = blockIdx.y;
  const int c = ct * TN + lane;
  float cacc = 0.f;
  for (int k = 0; k < TM / WARPS; ++k) {
    const int r = rt * TM + warp * (TM / WARPS) + k;
    if (r >= M) break;  // uniform across the warp
    const float v = c < N ? to_f32(g[(size_t)r * N + c]) : 0.f;
    const float sq = v * v;
    cacc += sq;
    float s = sq;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) rowpart[(size_t)ct * M + r] = s;
  }
  col_sh[warp][lane] = cacc;
  __syncthreads();
  if (warp == 0 && c < N) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) t += col_sh[w][lane];
    colpart[(size_t)rt * N + c] = t;
  }
}

__global__ void finish_kernel(const float* __restrict__ rowpart,
                              const float* __restrict__ colpart, int M, int N,
                              int col_tiles, int row_tiles,
                              float* __restrict__ row,
                              float* __restrict__ col) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < M) {
    float s = 0.f;
    for (int t = 0; t < col_tiles; ++t) s += rowpart[(size_t)t * M + i];
    row[i] = s;
  }
  if (i < N) {
    float s = 0.f;
    for (int t = 0; t < row_tiles; ++t) s += colpart[(size_t)t * N + i];
    col[i] = s;
  }
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

// Floats of scratch (row and column partials) for an (M, N) input.
extern "C" long long channel_norms_workspace(int M, int N) {
  return (long long)cdiv(N, TN) * M + (long long)cdiv(M, TM) * N;
}

// dtype: 0 = fp32, 1 = bf16.  All pointers are device pointers; work
// holds channel_norms_workspace(M, N) floats.  Returns a cudaError_t.
extern "C" int channel_norms_launch(const void* g, int dtype, int M, int N,
                                    float* row, float* col, float* work,
                                    void* stream) {
  if (M <= 0 || N <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int col_tiles = cdiv(N, TN);
  const int row_tiles = cdiv(M, TM);
  if (row_tiles > 65535) return (int)cudaErrorInvalidValue;
  float* rowpart = work;
  float* colpart = work + (size_t)col_tiles * M;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(col_tiles, row_tiles);
  if (dtype == 0)
    partials_kernel<float><<<grid, WARPS * 32, 0, s>>>(
        static_cast<const float*>(g), M, N, rowpart, colpart);
  else
    partials_kernel<__nv_bfloat16><<<grid, WARPS * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g), M, N, rowpart, colpart);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = M > N ? M : N;
  finish_kernel<<<cdiv(n, FINISH_THREADS), FINISH_THREADS, 0, s>>>(
      rowpart, colpart, M, N, col_tiles, row_tiles, row, col);
  return (int)cudaGetLastError();
}
