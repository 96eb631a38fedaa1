// The clients' sum and the SGD step of one leaf, in one pass:
//
//   a[q]   = 0 + g[q, i] + g[q + 4, i] + g[q + 8, i] + ...   (fp32, q < 4)
//   acc    = ((a[0] + a[1]) + a[2]) + a[3]
//   s      = round(acc)                  (to the leaf's dtype, once)
//   new[i] = round(fl(fl(p[i]) - fl(lr * s)))
//
// bitwise what PyTorch's sum over the slot axis (accumulated in fp32 and
// rounded once to the leaf's dtype) followed by the port's sgd_leaf
// (models/model_zoo.py: p and s widened to fp32, lr * s, the difference,
// cast back) gives on the card.  The four partial sums are those of
// PyTorch's reduction over a leading axis, which gives each thread an
// entry and keeps four accumulators, slot k in accumulator k % 4; below
// K = 5 that is the slot order.  (A one-entry leaf is summed by PyTorch
// across threads, in a tree, so there the orders part from K = 3.)  The
// multiply and the subtraction are
// __fmul_rn and __fsub_rn: a contraction into one FMA would round once
// where the two separate passes round twice.  Rounding to bf16 is
// round-to-nearest-even (__float2bfloat16_rn, as PyTorch's cast on sm_80
// and later); an fp32 leaf takes the same code with identity rounding.
//
// Replaces no TPU kernel: the reference's sum and update
// (repro/core/distributed.py) are plain jnp, which XLA fuses into one
// pass.  The port ran them as a sum and five elementwise passes with three
// fp32 temporaries a leaf: 85.5 ms a step on DeepSeek-V2's 4.06 G entries
// at two clients, against the 9.7 ms that the bytes take.
//
// Bound on an H100: bytes — the K gradient slots and the param read once
// and the new param written once, (K + 2) * N * sizeof(T) over 3.35 TB/s:
// 32.5 GB, 9.70 ms a step for the 4.06 G bf16 entries at K = 2.  Nothing
// is reused, so the design only keeps bytes moving:
// - 16-byte vector loads and stores (8 bf16 or 4 fp32 a vector) with
//   streaming cache hints (__ldcs, __stcs); each thread starts the loads
//   of all K slots and of p for UNROLL vectors before any arithmetic;
// - a grid-stride loop over BLOCKS_PER_SM blocks an SM;
// - 64-bit offsets throughout: a slot of the stacked experts holds 629 M
//   entries, so slot 1 starts past 2^31 bytes;
// - the vector path needs p, g and new 16-byte aligned and, where K > 1,
//   every slot too (N a multiple of the vector); the entries past the last
//   whole vector (K = 1) and every leaf the vector path cannot take run
//   the scalar path, which computes the same bits entry by entry.
// One launch a leaf; the kernel allocates nothing and never writes p.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;           // vectors a thread keeps in flight
constexpr int BLOCKS_PER_SM = 8;

enum Dtype { F32 = 0, BF16 = 1 };

// an entry's storage, its value in fp32 (exact) and the rounding back
struct F32T {
  using Bits = float;
  static __device__ __forceinline__ float widen(float x) { return x; }
  static __device__ __forceinline__ float narrow(float x) { return x; }
};
struct BF16T {
  using Bits = unsigned short;
  static __device__ __forceinline__ float widen(unsigned short h) {
    return __uint_as_float((unsigned)h << 16);
  }
  static __device__ __forceinline__ unsigned short narrow(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
};

// one entry: the slots' sum in fp32 from 0 (acc), rounded once, then the
// step
template <typename D>
__device__ __forceinline__ typename D::Bits step(float acc, float p,
                                                 float lr) {
  const float s = D::widen(D::narrow(acc));
  return D::narrow(__fsub_rn(p, __fmul_rn(lr, s)));
}

template <typename D>
struct Vec {
  static constexpr int N = 16 / sizeof(typename D::Bits);
  union {
    int4 raw;
    typename D::Bits v[N];
  };
};

// the slots' sum of one entry: slot k into partial sum k % 4, the four
// added in order (the slot order below K = 5); ``load(k)`` is slot k's
// value in fp32
template <typename Load>
__device__ __forceinline__ float slot_sum(int K, Load load) {
  float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int k = 0;
  for (; k + 4 <= K; k += 4) {
#pragma unroll
    for (int q = 0; q < 4; ++q) a[q] = __fadd_rn(a[q], load(k + q));
  }
#pragma unroll
  for (int q = 0; q < 3; ++q)
    if (k + q < K) a[q] = __fadd_rn(a[q], load(k + q));
  return __fadd_rn(__fadd_rn(__fadd_rn(a[0], a[1]), a[2]), a[3]);
}

// KC > 0: K known at compile time (the one-device step's K = 2 and the
// one slot of the pods' and the compressed exchange's sums), the loads of
// every slot of UNROLL vectors in flight at once, summed in slot order
// (the partial sums' order at K < 5); KC == 0: K at run time, the slots
// loaded in a loop into four partial sums.  vec == 0: the whole leaf
// entry by entry.
template <typename D, int KC>
__global__ void __launch_bounds__(THREADS)
sum_sgd_kernel(const typename D::Bits* __restrict__ p,
               const typename D::Bits* __restrict__ g,
               typename D::Bits* __restrict__ out, long long n, int K,
               float lr, int vec) {
  constexpr int V = Vec<D>::N;
  constexpr int KK = KC > 0 ? KC : 1;
  const long long nvec = vec ? n / V : 0;
  const int4* __restrict__ pv = reinterpret_cast<const int4*>(p);
  const int4* __restrict__ gv = reinterpret_cast<const int4*>(g);
  int4* __restrict__ ov = reinterpret_cast<int4*>(out);
  const long long vstride = n / V;        // a slot in vectors (K > 1: exact)
  const long long threads = (long long)gridDim.x * THREADS;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;

  for (long long base = tid; base < nvec; base += threads * UNROLL) {
    Vec<D> pin[UNROLL], gin[UNROLL][KK];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long j = base + (long long)u * threads;
      if (j < nvec) {
        pin[u].raw = __ldcs(pv + j);
        if (KC > 0) {
#pragma unroll
          for (int k = 0; k < KK; ++k)
            gin[u][k].raw = __ldcs(gv + (long long)k * vstride + j);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long j = base + (long long)u * threads;
      if (j >= nvec) break;
      float acc[V];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = 0.0f;
      if (KC > 0) {
#pragma unroll
        for (int k = 0; k < KK; ++k)
#pragma unroll
          for (int e = 0; e < V; ++e)
            acc[e] = __fadd_rn(acc[e], D::widen(gin[u][k].v[e]));
      } else {
        float a[4][V];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < V; ++e) a[q][e] = 0.0f;
        for (int k = 0; k < K; k += 4) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (k + q < K) {
              Vec<D> gk;
              gk.raw = __ldcs(gv + (long long)(k + q) * vstride + j);
#pragma unroll
              for (int e = 0; e < V; ++e)
                a[q][e] = __fadd_rn(a[q][e], D::widen(gk.v[e]));
            }
          }
        }
#pragma unroll
        for (int e = 0; e < V; ++e)
          acc[e] = __fadd_rn(__fadd_rn(__fadd_rn(a[0][e], a[1][e]), a[2][e]),
                             a[3][e]);
      }
      Vec<D> o;
#pragma unroll
      for (int e = 0; e < V; ++e)
        o.v[e] = step<D>(acc[e], D::widen(pin[u].v[e]), lr);
      __stcs(ov + j, o.raw);
    }
  }
  // the entries past the last whole vector (K = 1), or the whole leaf off
  // the vector path: the same arithmetic entry by entry
  for (long long i = nvec * V + tid; i < n; i += threads) {
    const float acc = slot_sum(
        K, [&](int k) { return D::widen(g[(long long)k * n + i]); });
    out[i] = step<D>(acc, D::widen(p[i]), lr);
  }
}

// the current device's SM count, read once a device
constexpr int MAX_DEVICES = 64;
int cached_sms[MAX_DEVICES] = {};

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && cached_sms[dev] > 0) {
    *sms = cached_sms[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < MAX_DEVICES) cached_sms[dev] = *sms;
  return err;
}

template <typename D>
int launch(const void* p, const void* g, void* out, long long n, int K,
           float lr, cudaStream_t s) {
  using B = typename D::Bits;
  constexpr int V = Vec<D>::N;
  const bool aligned = (reinterpret_cast<unsigned long long>(p) |
                        reinterpret_cast<unsigned long long>(g) |
                        reinterpret_cast<unsigned long long>(out)) % 16 == 0;
  const int vec = aligned && (K == 1 || n % V == 0);
  const long long work = vec ? n / V + n % V : n;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (work + (long long)THREADS * UNROLL - 1) /
                     ((long long)THREADS * UNROLL);
  const long long cap = (long long)sms * BLOCKS_PER_SM;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  const B* pt = static_cast<const B*>(p);
  const B* gt = static_cast<const B*>(g);
  B* ot = static_cast<B*>(out);
  const unsigned b = (unsigned)blocks;
  switch (K) {
    case 1:
      sum_sgd_kernel<D, 1><<<b, THREADS, 0, s>>>(pt, gt, ot, n, K, lr, vec);
      break;
    case 2:
      sum_sgd_kernel<D, 2><<<b, THREADS, 0, s>>>(pt, gt, ot, n, K, lr, vec);
      break;
    default:
      sum_sgd_kernel<D, 0><<<b, THREADS, 0, s>>>(pt, gt, ot, n, K, lr, vec);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One leaf: p and out hold n entries, g K slots of n entries one after
// another (a contiguous (K, ...) buffer); device pointers, out not p.
// dtype 0 is fp32, 1 bf16; K >= 1, n >= 1.  Returns a cudaError_t.
extern "C" int sum_sgd_launch(const void* p, const void* g, void* out,
                              long long n, int K, float lr, int dtype,
                              void* stream) {
  if (n <= 0 || K < 1 || p == nullptr || g == nullptr || out == nullptr ||
      out == p)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == F32) return launch<F32T>(p, g, out, n, K, lr, s);
  if (dtype == BF16) return launch<BF16T>(p, g, out, n, K, lr, s);
  return (int)cudaErrorInvalidValue;
}
