// APoZ counts: the number of exact zeros in every column of an activation
// matrix.
//
//   counts[j] = #{ b : acts[b, j] == 0 }            (int32, acts fp32)
//
// `== 0` is IEEE equality: -0.0 counts as a zero and NaN does not, as in
// the reference's oracle (repro/kernels/ref.py: apoz_counts_ref).
//
// Replaces the TPU kernel repro/kernels/apoz.py: apoz_counts_pallas (body
// _apoz_kernel).  That kernel streams the batch through a sequential grid
// and carries the int32 counts in its output block from step to step.
// Hopper blocks run in no order, so here each block counts one tile of
// (ROWS rows × 32 columns) and adds its per-column totals with one integer
// atomicAdd per column: integer addition does not depend on order, so the
// counts are exact and deterministic.  The launcher zeroes them first.
//
// Bound on an H100: bytes — one read of acts (4 bytes an entry).  At the
// SCBFwP path's largest call, (2048, 256) fp32, that is 2.1 MB, about
// 0.63 us at 3.35 TB/s.
//
// Design: a block is 32 × 8 threads.  threadIdx.x is the column within a
// 32-column strip, so a warp reads 32 neighbouring floats of one row
// (128 bytes, coalesced); threadIdx.y strides the block's ROWS rows.  The
// eight partial counts of a column are added in shared memory in a fixed
// order.  Any B and N work; the ragged edge is masked in the kernel.
#include <cuda_runtime.h>

namespace {

constexpr int COLS = 32;
constexpr int LANES = 8;     // rows read in parallel by one block
constexpr int ROWS = 128;    // rows of a block's tile

__global__ void __launch_bounds__(COLS * LANES)
apoz_counts_kernel(const float* __restrict__ acts, long long B, long long N,
                   int* __restrict__ counts) {
  __shared__ int part[LANES][COLS];
  const long long j = (long long)blockIdx.x * COLS + threadIdx.x;
  const long long b0 = (long long)blockIdx.y * ROWS;
  long long b_end = b0 + ROWS;
  if (b_end > B) b_end = B;
  int c = 0;
  if (j < N) {
    for (long long b = b0 + threadIdx.y; b < b_end; b += LANES)
      c += acts[b * N + j] == 0.0f ? 1 : 0;
  }
  part[threadIdx.y][threadIdx.x] = c;
  __syncthreads();
  if (threadIdx.y == 0 && j < N) {
    int t = 0;
#pragma unroll
    for (int y = 0; y < LANES; ++y) t += part[y][threadIdx.x];
    if (t) atomicAdd(counts + j, t);
  }
}

}  // namespace

// acts: (B, N) fp32, row-major, device pointer; counts: (N,) int32 device
// pointer.  Returns a cudaError_t.
extern "C" int apoz_counts_launch(const float* acts, int B, int N,
                                  int* counts, void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * (size_t)N, s);
  if (err != cudaSuccess) return (int)err;
  const long long gy = ((long long)B + ROWS - 1) / ROWS;
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((N + COLS - 1) / COLS), (unsigned)gy);
  dim3 block(COLS, LANES);
  apoz_counts_kernel<<<grid, block, 0, s>>>(acts, B, N, counts);
  return (int)cudaGetLastError();
}
