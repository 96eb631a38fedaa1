// The reduction design that lost for the channel-norm kernel, kept for
// benchmarks/cuda_channel_norm_designs.py: one thread-block cluster of CL
// blocks a leaf, each block a band of whole rows (its row norms finished
// with warp shuffles), the column partials added across the cluster in
// rank order through distributed shared memory.  No trip to L2 for the
// reduction, but a leaf gets at most CL SMs.  fp32 and N <= 256 only (the
// main path's matrices); not used by the port.  Same C interface as
// src/repro_torch/kernels/csrc/channel_norm.cu.
#include <cuda_runtime.h>

namespace {

#ifndef CL
#define CL 16                             // blocks a cluster (non-portable)
#endif
constexpr int THREADS = 512;
constexpr int LANES = 64;                 // float4 lanes: 256 columns
constexpr int RL = THREADS / LANES;       // rows read at once
constexpr int RPT = 8;                    // rows a thread, a round
constexpr int MAX_LEAVES = 16;

struct Leaf {
  const float* g;
  float* row;
  float* col;
  int M, N;
};

struct Table {
  Leaf leaf[MAX_LEAVES];
  int L;
};

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_id() {
  unsigned r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// *p in the shared memory of the cluster's block `rank`
__device__ __forceinline__ float ld_remote(const float* p, unsigned rank) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  unsigned d;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(d) : "r"(a), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(d)
               : "memory");
  return v;
}

__global__ void __launch_bounds__(THREADS) cn_cluster_kernel(const Table t) {
  __shared__ float colsh[RL][256];
  __shared__ float blockcol[256];
  __shared__ float half[RL * RPT][2];
  const Leaf lf = t.leaf[cluster_id()];
  const unsigned q = cluster_rank();
  const int band = (lf.M + CL - 1) / CL;
  const int rb = q * band;
  const int re = min(lf.M, rb + band);
  const int tx = threadIdx.x % LANES;
  const int ty = threadIdx.x / LANES;
  const int c = tx * 4;
  float cacc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int base = rb; base < re; base += RL * RPT) {
    float v[RPT][4];
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const int r = base + ty + k * RL;
      const float* p = lf.g + (size_t)r * lf.N + c;
#pragma unroll
      for (int j = 0; j < 4; ++j) v[k][j] = 0.f;
      if (r < re && c < lf.N && lf.N % 4 == 0) {
        const float4 x = *reinterpret_cast<const float4*>(p);
        v[k][0] = x.x; v[k][1] = x.y; v[k][2] = x.z; v[k][3] = x.w;
      } else if (r < re && c < lf.N) {
        for (int j = 0; j < 4; ++j) v[k][j] = c + j < lf.N ? p[j] : 0.f;
      }
    }
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
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if ((tx & 31) == 0) half[ty + k * RL][tx / 32] = s;
    }
    __syncthreads();
    if (threadIdx.x < RL * RPT && base + (int)threadIdx.x < re)
      lf.row[base + threadIdx.x] = half[threadIdx.x][0] + half[threadIdx.x][1];
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) colsh[ty][c + j] = cacc[j];
  __syncthreads();
  if (threadIdx.x < 256) {
    float s = 0.f;
#pragma unroll
    for (int y = 0; y < RL; ++y) s += colsh[y][threadIdx.x];
    blockcol[threadIdx.x] = s;
  }
  cluster_sync();
  const int per = (lf.N + CL - 1) / CL;
  const int cc = q * per + threadIdx.x;
  if ((int)threadIdx.x < per && cc < lf.N) {
    float x[CL];
#pragma unroll
    for (int k = 0; k < CL; ++k) x[k] = ld_remote(&blockcol[cc], k);
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < CL; ++k) s += x[k];
    lf.col[cc] = s;
  }
  cluster_sync();                 // no block leaves while others read it
}

}  // namespace

extern "C" int channel_norms_launch(const long long* rows, int L, int dtype,
                                    void* stream) {
  if (L <= 0 || L > MAX_LEAVES || dtype != 0)
    return (int)cudaErrorInvalidValue;
  Table t;
  t.L = L;
  for (int l = 0; l < L; ++l) {
    const long long* r = rows + 5LL * l;
    if (r[1] <= 0 || r[2] <= 0 || r[2] > 256)
      return (int)cudaErrorInvalidValue;
    t.leaf[l] = Leaf{reinterpret_cast<const float*>(r[0]),
                     reinterpret_cast<float*>(r[3]),
                     reinterpret_cast<float*>(r[4]), (int)r[1], (int)r[2]};
  }
  cudaError_t e = cudaFuncSetAttribute(
      cn_cluster_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(L * CL);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, cn_cluster_kernel, t);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
