// Fused free-running GP-SSM posterior rollout for Hopper (sm_90a).
//
// Replaces ffvd_tpu/ops/pallas_rollout.py::_rollout_kernel (the only Pallas
// kernel of the JAX package) and computes what ffvd_tpu/eval/rollout.py::
// _rollout_one computes, for S samples in one launch.  Per sample s and
// step t, with x̃ = (x_t, u_t):
//
//   e[d,m]  = exp(-½ Σ_k (Z[m,k]/ℓ[d,k] − x̃[k]/ℓ[d,k])²)
//   a[d,:]  = (σ²_d Lm⁻¹_d) e[d,:]                  (σ² folded by the wrapper)
//   mean_d  = Σ_m a[d,m] U[m,d]
//   var_d   = σ²_d − Σ_m a[d,m]² (+ Σ_k (q_sqrt_dᵀ a[d,:])_k²)
//   vt_d    = max(var_d + Q_d, 0)     (clamped, as the production scan; the
//                                      Pallas kernel stores it unclamped)
//   x_{t+1} = x_t + mean + √vt · ε
//
// ε is read from `noise` (S,T,D) when given; otherwise it is drawn here:
// Philox4x32-10 keyed by the 64-bit `seed`, counter (s, t, d, 0), and the
// Box-Muller of pallas_rollout.py::bits_to_normal on the first two words.
// ffvd_tpu_torch/ops/rollout.py holds the plain PyTorch version of all of it,
// the generator included, so both give the same stream for the same seed.
//
// Bound at the main shapes (S=10, T=500, D=4, M=100, Din=5): the triangular
// work is ≈93 kFLOP per sample-step, ≈0.47 GFLOP in all (≈0.85 GFLOP if the
// triangles were dense), against ≈0.5 MB of compulsory traffic.  So it is
// compute-bound on paper, ≈7 µs in fp32 at 67 TFLOP/s, and ≈7 µs in fp64
// too: ≈88% of the work is the two triangular products, an (M×M)·(M×S)
// product per step across the samples, which fp64 tensor cores (DMMA) run at
// 67 TFLOP/s in full precision.
// What holds it back is the serial dependence over T=500 steps: each step is
// four block-wide barriers and ≈100 dependent FMAs per thread, and only S
// blocks (S SMs) have work.
//
// Design (simple first): one block per sample, one thread per (d, m) pair
// (D·M = 400 threads at the main shapes), the time loop inside the block,
// e and a staged in shared memory, Lm⁻¹ (transposed, so a warp's loads are
// coalesced) and q_sqrt read from global memory, where they stay L2-resident.
// A warp per latent dim reduces mean, Σa² and Σ(q_sqrtᵀa)², and its lane 0
// updates x_d.  Later work: pack the two triangular factors into shared
// memory (2·4·5050·4 B = 161.6 KB in fp32 fits one block's 227 KB), spread a
// sample over a cluster of SMs, and batch more samples per block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x);
    const uint32_t lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z);
    const uint32_t lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ float d_exp(float x) { return expf(x); }
__device__ __forceinline__ double d_exp(double x) { return exp(x); }
__device__ __forceinline__ float d_log(float x) { return logf(x); }
__device__ __forceinline__ double d_log(double x) { return log(x); }
__device__ __forceinline__ float d_cos(float x) { return cosf(x); }
__device__ __forceinline__ double d_cos(double x) { return cos(x); }
__device__ __forceinline__ float d_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double d_sqrt(double x) { return sqrt(x); }

// One N(0,1) draw for counter (c0, c1, c2, 0): Box-Muller on 24-bit
// uniforms, u1 = ((b1>>8)+1)·2⁻²⁴ ∈ (0, 1], u2 = (b2>>8)·2⁻²⁴ ∈ [0, 1).
template <typename T>
__device__ __forceinline__ T philox_normal(uint64_t seed, uint32_t c0,
                                           uint32_t c1, uint32_t c2) {
  const uint4 b = philox4x32_10(make_uint4(c0, c1, c2, 0u),
                                static_cast<uint32_t>(seed),
                                static_cast<uint32_t>(seed >> 32));
  const T scale = T(5.9604644775390625e-08);  // 2^-24
  const T u1 = static_cast<T>((b.x >> 8) + 1u) * scale;
  const T u2 = static_cast<T>(b.y >> 8) * scale;
  const T two_pi = T(6.283185307179586);
  return d_sqrt(T(-2) * d_log(u1)) * d_cos(two_pi * u2);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void rollout_kernel(
    const T* __restrict__ x0,      // (S, D)
    const T* __restrict__ zs,      // (D, M, Din)  Z/ℓ
    const T* __restrict__ ils,     // (D, Din)     1/ℓ
    const T* __restrict__ kvar,    // (D,)         σ²
    const T* __restrict__ w,       // (D, M, M)    w[d,k,m] = σ²_d Lm⁻¹_d[m,k]
    const T* __restrict__ u,       // (M, D)
    const T* __restrict__ q,       // (D,)
    const T* __restrict__ ctrl,    // (T, CU)      may be null when CU = 0
    const T* __restrict__ qsqrt,   // (D, M, M)    upper triangular, or null
    const T* __restrict__ noise,   // (S, T, D)    or null: draw in-kernel
    T* __restrict__ xs,            // (S, T, D)
    T* __restrict__ vs,            // (S, T, D)
    int n_t, int D, int M, int CU, uint64_t seed) {
  extern __shared__ unsigned char smem_raw[];
  T* const sh = reinterpret_cast<T*>(smem_raw);
  const int DM = D * M;
  const int din = D + CU;
  T* const e = sh;                // (D, M)
  T* const a = e + DM;            // (D, M)
  T* const p_mean = a + DM;       // a·U partial products
  T* const p_asq = p_mean + DM;   // a² partial products
  T* const p_wsq = p_asq + DM;    // (q_sqrtᵀa)² partial products
  T* const x = p_wsq + DM;        // (D,) current state
  T* const xc = x + D;            // (Din,) current GP input

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = (nth + 31) >> 5;

  for (int i = tid; i < D; i += nth) x[i] = x0[(size_t)s * D + i];
  __syncthreads();

  for (int t = 0; t < n_t; ++t) {
    for (int k = tid; k < din; k += nth)
      xc[k] = k < D ? x[k] : ctrl[(size_t)t * CU + (k - D)];
    __syncthreads();

    // SE cross-covariance of x̃ against Z, per latent dim.
    for (int i = tid; i < DM; i += nth) {
      const int d = i / M;
      const T* zrow = zs + (size_t)i * din;
      const T* il = ils + (size_t)d * din;
      T r2 = T(0);
      for (int k = 0; k < din; ++k) {
        const T df = zrow[k] - xc[k] * il[k];
        r2 += df * df;
      }
      e[i] = d_exp(T(-0.5) * r2);
    }
    __syncthreads();

    // a = (σ² Lm⁻¹) e; Lm⁻¹ is lower triangular, so row m needs k ≤ m.
    for (int i = tid; i < DM; i += nth) {
      const int d = i / M;
      const int m = i - d * M;
      const T* wd = w + (size_t)d * M * M + m;
      const T* ed = e + (size_t)d * M;
      T acc = T(0);
      for (int k = 0; k <= m; ++k) acc += wd[(size_t)k * M] * ed[k];
      a[i] = acc;
    }
    __syncthreads();

    // Partial products; (q_sqrtᵀa)_k = Σ_{m ≤ k} q_sqrt[m,k] a_m.
    for (int i = tid; i < DM; i += nth) {
      const int d = i / M;
      const int k = i - d * M;
      const T ai = a[i];
      p_mean[i] = ai * u[(size_t)k * D + d];
      p_asq[i] = ai * ai;
      if (qsqrt != nullptr) {
        const T* qd = qsqrt + (size_t)d * M * M + k;
        const T* ad = a + (size_t)d * M;
        T acc = T(0);
        for (int m = 0; m <= k; ++m) acc += qd[(size_t)m * M] * ad[m];
        p_wsq[i] = acc * acc;
      }
    }
    __syncthreads();

    // One warp per latent dim: reduce, then lane 0 steps x_d.
    for (int d = warp; d < D; d += nwarps) {
      T sm = T(0), sa = T(0), sw = T(0);
      for (int k = lane; k < M; k += 32) {
        sm += p_mean[d * M + k];
        sa += p_asq[d * M + k];
        if (qsqrt != nullptr) sw += p_wsq[d * M + k];
      }
      sm = warp_sum(sm);
      sa = warp_sum(sa);
      sw = warp_sum(sw);
      if (lane == 0) {
        T var = kvar[d] - sa;
        if (qsqrt != nullptr) var += sw;
        T vt = var + q[d];
        vt = vt < T(0) ? T(0) : vt;  // keeps NaN, like jnp.maximum
        const size_t o = ((size_t)s * n_t + t) * D + d;
        const T eps = noise != nullptr
                          ? noise[o]
                          : philox_normal<T>(seed, (uint32_t)s, (uint32_t)t,
                                             (uint32_t)d);
        const T xn = (x[d] + sm) + eps * d_sqrt(vt);
        xs[o] = xn;
        vs[o] = vt;
        x[d] = xn;
      }
    }
    __syncthreads();
  }
}

__global__ void normals_kernel(uint64_t seed, float* __restrict__ out,
                               long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = philox_normal<float>(seed, (uint32_t)i, 0u, 0u);
}

// Per instantiation, looked up once: the largest block its register use
// allows (fp64 needs 80 registers a thread: at most 800 threads, not 1024),
// and the opt-in to the device's full dynamic shared memory.  A negative
// value is the CUDA error of the lookup.
template <typename T>
int max_block_threads() {
  static const int cached = [] {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, rollout_kernel<T>);
    int dev = 0, optin = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          rollout_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          optin - (int)attr.sharedSizeBytes);
    return err == cudaSuccess ? (attr.maxThreadsPerBlock / 32) * 32
                              : -(int)err;
  }();
  return cached;
}

template <typename T>
int launch_rollout(const T* x0, const T* zs, const T* ils, const T* kvar,
                   const T* w, const T* u, const T* q, const T* ctrl,
                   const T* qsqrt, const T* noise, T* xs, T* vs, int S,
                   int n_t, int D, int M, int CU, uint64_t seed,
                   void* stream) {
  const int DM = D * M;
  // One thread per (d, m) up to the block limit; the loops over (d, m)
  // cover any remainder.
  const int max_threads = max_block_threads<T>();
  if (max_threads < 0) return -max_threads;
  int nth = ((DM + 31) / 32) * 32;
  if (nth > max_threads) nth = max_threads;
  if (nth < 32) nth = 32;
  const size_t smem = (5 * (size_t)DM + 2 * (size_t)D + CU) * sizeof(T);
  if (S > 0 && n_t > 0) {
    rollout_kernel<T><<<S, nth, smem, (cudaStream_t)stream>>>(
        x0, zs, ils, kvar, w, u, q, ctrl, qsqrt, noise, xs, vs, n_t, D, M,
        CU, seed);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ffvd_rollout_f32(const float* x0, const float* zs,
                                const float* ils, const float* kvar,
                                const float* w, const float* u,
                                const float* q, const float* ctrl,
                                const float* qsqrt, const float* noise,
                                float* xs, float* vs, int S, int n_t, int D,
                                int M, int CU, uint64_t seed, void* stream) {
  return launch_rollout<float>(x0, zs, ils, kvar, w, u, q, ctrl, qsqrt, noise,
                               xs, vs, S, n_t, D, M, CU, seed, stream);
}

extern "C" int ffvd_rollout_f64(const double* x0, const double* zs,
                                const double* ils, const double* kvar,
                                const double* w, const double* u,
                                const double* q, const double* ctrl,
                                const double* qsqrt, const double* noise,
                                double* xs, double* vs, int S, int n_t, int D,
                                int M, int CU, uint64_t seed, void* stream) {
  return launch_rollout<double>(x0, zs, ils, kvar, w, u, q, ctrl, qsqrt,
                                noise, xs, vs, S, n_t, D, M, CU, seed, stream);
}

// n standard normals from the rollout's generator: out[i] is the draw of
// counter (i, 0, 0, 0), i.e. sample i, step 0, dim 0.
extern "C" int ffvd_normals(uint64_t seed, float* out, long long n,
                            void* stream) {
  if (n > 0) {
    const int nth = 256;
    const long long blocks = (n + nth - 1) / nth;
    normals_kernel<<<(unsigned int)blocks, nth, 0, (cudaStream_t)stream>>>(
        seed, out, n);
  }
  return (int)cudaGetLastError();
}
