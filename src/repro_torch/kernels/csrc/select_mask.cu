// Select mask: the exact edge rule of SCBF's channel selection.
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
// mask (9 bytes an entry in fp32).  At the main path's largest matrix,
// (2917, 256) fp32, that is about 6.7 MB, about 2 us at 3.35 TB/s.
//
// Design: elementwise over a grid-stride loop on the flat index, so any
// (M, N) works without host padding.  The count is reduced per warp by
// a shuffle tree, per block in warp order, then one integer atomicAdd
// per block: integer addition does not depend on order, so the count is
// deterministic.  The launcher zeroes the count on the stream first.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 8;  // 8 resident blocks per SM on an H100

__device__ __forceinline__ float zero_of(float) { return 0.f; }
__device__ __forceinline__ __nv_bfloat16 zero_of(__nv_bfloat16) {
  return __float2bfloat16(0.f);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
select_mask_kernel(const T* __restrict__ g, const float* __restrict__ row,
                   const float* __restrict__ col,
                   const float* __restrict__ thr_p,
                   const float* __restrict__ rest_p, long long M, long long N,
                   T* __restrict__ out, bool* __restrict__ mask,
                   int* __restrict__ count) {
  __shared__ int warp_sums[THREADS / 32];
  const float thr = *thr_p;
  const float rest = *rest_p;
  const long long total = M * N;
  int kept = 0;
  for (long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * THREADS) {
    const long long i = idx / N;
    const long long j = idx - i * N;
    const float pair = row[i] + col[j];
    const bool keep = pair + rest > thr;
    const T v = g[idx];
    out[idx] = keep ? v : zero_of(v);
    mask[idx] = keep;
    kept += keep ? 1 : 0;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    kept += __shfl_down_sync(0xffffffffu, kept, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = kept;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) t += warp_sums[w];
    if (t) atomicAdd(count, t);
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16.  thr and rest are fp32 scalars in device
// memory (no host sync to read them); every pointer is a device pointer.
// Returns a cudaError_t.
extern "C" int select_mask_launch(const void* g, int dtype, int M, int N,
                                  const float* row, const float* col,
                                  const float* thr, const float* rest,
                                  void* out, bool* mask, int* count,
                                  void* stream) {
  if (M <= 0 || N <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)M * N;
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  if (dtype == 0)
    select_mask_kernel<float><<<(int)blocks, THREADS, 0, s>>>(
        static_cast<const float*>(g), row, col, thr, rest, M, N,
        static_cast<float*>(out), mask, count);
  else
    select_mask_kernel<__nv_bfloat16><<<(int)blocks, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g), row, col, thr, rest, M, N,
        static_cast<__nv_bfloat16*>(out), mask, count);
  return (int)cudaGetLastError();
}
