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
// The parameters (Z/ℓ, 1/ℓ, σ², the factors, U, Q) are shared by all
// samples (the iid posterior of C1/C4) or each sample's own (the thinned
// SG-HMC chain of C2/C3/C5/C7): each array comes with a per-sample stride,
// 0 when shared, and each cluster offsets its pointers by s × stride.
//
// ε is read from `noise` (S,T,D) when given; otherwise it is drawn here:
// Philox4x32-10 keyed by the 64-bit `seed`, counter (row_offset + s, t, d,
// 0), and the Box-Muller of pallas_rollout.py::bits_to_normal on the first
// two words.  `row_offset` lets a launch of rows [r0, r1) of a larger batch
// (one launch a process of a sharded run) draw the normals that one launch
// of the whole batch gives those rows; each row's arithmetic is independent
// of the others', so the rows come out as the whole launch's.
// ffvd_tpu_torch/ops/rollout.py holds the plain PyTorch version of all of it,
// the generator included, so both give the same stream for the same seed.
//
// What bounds it.  On paper the work is ≈93 kFLOP per sample-step at the
// main shapes (S=10, T=500, D=4, M=100, Din=5), ≈7 µs for the whole launch
// at 67 TFLOP/s.  In practice each step waits on the one before: x_{t+1}
// needs all of step t.  So the time is T × the latency of one step, and the
// design shortens that latency.  A first version (one block per sample, the
// factors read from L2 by one thread per row) took ≈11 µs a step: two
// chains of ~100 dependent L2 loads per thread and five block barriers.
//
// Design: one thread-block cluster per sample.  The cluster has
// C = min(D, 8) CTAs (8 is the portable cluster limit); CTA r owns latent
// dims r, r+C, r+2C, ...  Each CTA keeps its dims' two triangular factors in
// shared memory, packed by lower rows (row m of σ²Lm⁻¹ at m(m+1)/2, entries
// 0..m; row k of q_sqrtᵀ likewise), filled once at kernel start.  A step:
//   1. e for the owned dims, one thread per inducing row (idle threads draw
//      ε for the step meanwhile);
//   2. a = σ²Lm⁻¹e, four threads per row over consecutive packed entries,
//      ended by a shuffle: no dependent chain is longer than ≈M/4 FMAs;
//   3. q_sqrtᵀa the same way;
//   4. one warp per owned dim reduces mean, Σa², Σ(q_sqrtᵀa)², steps x_d,
//      and writes the new x_d into every CTA's x buffer through distributed
//      shared memory.
// The x buffer is double-buffered by step parity (step t reads t&1, writes
// (t+1)&1), so one cluster barrier per step orders the remote writes; the
// last step's barrier is also the one before exit, so no CTA leaves while a
// peer may still write into it.  Three block barriers and one cluster
// barrier per step in all.
//
// Which shapes are resident: the packed pair takes M(M+1)·itemsize bytes a
// dim, 40.4 KB fp32 / 80.8 KB fp64 at M=100; with ≈(Din+6)·M working values
// a CTA holds its dims in the 227 KB opt-in up to M=235 fp32 and M=164 fp64
// at one dim per CTA (D ≤ 8, Din = 5).  Beyond that (or for D > 8 at large
// M) the same body reads the packed factors from global memory (L2): the
// launch plan, computed in ops/rollout.py::rollout_plan, picks the
// instantiation; the launcher checks the plan and returns an error when it
// cannot be scheduled.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kRowThreads = 4;  // threads per factor row; ROW_THREADS in
                                // ops/rollout.py
// Error codes of the launcher besides CUDA's own (which are positive).
constexpr int kErrThreads = -1;  // block size not a warp multiple or too big
constexpr int kErrSmem = -2;     // plan's shared memory too small or too big
constexpr int kErrCluster = -3;  // cluster shape invalid for D, or none fits

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

// Shared memory of one CTA, in elements of T: the packed factors of its G
// dims when resident, then the working arrays.  rollout_plan in
// ops/rollout.py computes the same size.
struct Layout {
  int lp, qp, z, u, e, a, p_mean, p_asq, p_wsq, il, kvar, q, eps, x, total;
  __host__ __device__ Layout(int D, int M, int din, int G, bool resident) {
    const int P = M * (M + 1) / 2;
    const int GM = G * M;
    lp = 0;
    qp = lp + (resident ? G * P : 0);
    z = qp + (resident ? G * P : 0);  // (G, M, Din)  Z/ℓ
    u = z + GM * din;                 // (G, M)       U[:, d]
    e = u + GM;
    a = e + GM;
    p_mean = a + GM;                  // a·U, a², (q_sqrtᵀa)² per row
    p_asq = p_mean + GM;
    p_wsq = p_asq + GM;
    il = p_wsq + GM;                  // (G, Din)     1/ℓ
    kvar = il + G * din;              // (G,)         σ²
    q = kvar + G;                     // (G,)         Q
    eps = q + G;                      // (G,)         this step's ε
    x = eps + G;                      // (2, D)       x_t by step parity
    total = x + 2 * D;
  }
};

// Row i (of G·M, dim g = i / M, row m = i % M) of a packed lower-triangular
// factor times v[g]: Σ_{k ≤ m} row[k] v[g·M + k], split over the
// kRowThreads lanes of a group and summed by shuffles.  Every thread of the
// block calls it the same number of times (rows past GM give 0).
template <typename T>
__device__ __forceinline__ T packed_row_dot(const T* base, size_t gstride,
                                            const T* v, int i, int GM, int M,
                                            int sub) {
  T acc = T(0);
  if (i < GM) {
    const int g = i / M;
    const int m = i - g * M;
    const T* row = base + g * gstride + (size_t)m * (m + 1) / 2;
    const T* vg = v + g * M;
#pragma unroll 4
    for (int k = sub; k <= m; k += kRowThreads) acc += row[k] * vg[k];
  }
#pragma unroll
  for (int off = kRowThreads / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

// Elements between two samples' slices of each parameter array; 0 when
// every sample reads the same one (ops/rollout.py::sample_strides).  A
// thinned SG-HMC posterior gives each sample its own hypers, Z, U (or
// q(U)), Q and x_N, and still takes one launch.  The strides are 32-bit and
// applied (32×32→64-bit products) only where the fill reads: 64-bit strides
// added to the pointer arguments at entry cost 24-43 registers a thread
// (resident: 72 → 96 fp32, 80 → 123 fp64), and at 96 an SM holds one CTA
// of 416 threads instead of two.
struct SampleStrides {
  unsigned int zs, ils, kvar, lp, u, q, qp;
};

// One cluster of C CTAs per sample (blocks s·C … s·C+C−1); CTA r owns dims
// r, r+C, ... < D.  kResident: the packed factors sit in shared memory;
// otherwise the same loops read them from global memory.  The shapes below
// are one sample's slice: sample s starts at s × its stride in `st`.
template <typename T, bool kResident>
__global__ void rollout_kernel(
    const T* __restrict__ x0,      // (S, D)
    const T* __restrict__ zs,      // (D, M, Din)  Z/ℓ
    const T* __restrict__ ils,     // (D, Din)     1/ℓ
    const T* __restrict__ kvar,    // (D,)         σ²
    const T* __restrict__ lp,      // (D, M(M+1)/2) σ²Lm⁻¹, packed lower rows
    const T* __restrict__ u,       // (M, D)
    const T* __restrict__ q,       // (D,)
    const T* __restrict__ ctrl,    // (T, CU)      may be null when CU = 0
    const T* __restrict__ qp,      // (D, M(M+1)/2) q_sqrtᵀ, packed, or null
    const T* __restrict__ noise,   // (S, T, D)    or null: draw in-kernel
    T* __restrict__ xs,            // (S, T, D)
    T* __restrict__ vs,            // (S, T, D)
    int n_t, int D, int M, int CU, int G, SampleStrides st, uint64_t seed,
    uint32_t row_offset) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sh = reinterpret_cast<T*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int r = (int)cluster.block_rank();
  const int s = blockIdx.x / C;
  const unsigned su = (unsigned)s;  // sample s's slice: base + su × stride
  const int din = D + CU;
  const int P = M * (M + 1) / 2;
  const Layout L(D, M, din, G, kResident);
  T* const s_z = sh + L.z;
  T* const s_u = sh + L.u;
  T* const e = sh + L.e;
  T* const a = sh + L.a;
  T* const p_mean = sh + L.p_mean;
  T* const p_asq = sh + L.p_asq;
  T* const p_wsq = sh + L.p_wsq;
  T* const s_il = sh + L.il;
  T* const s_kvar = sh + L.kvar;
  T* const s_q = sh + L.q;
  T* const s_eps = sh + L.eps;
  T* const xbuf = sh + L.x;

  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nth >> 5;
  const int n_own = (D - r + C - 1) / C;  // ≥ 1, since C ≤ D
  const int GM = n_own * M;

  // One-time fill: the owned dims' factors (when resident) and inputs.
  const T* lbase;
  const T* qbase;
  size_t gstride;
  if constexpr (kResident) {
    T* const s_lp = sh + L.lp;
    T* const s_qp = sh + L.qp;
    const T* const lps = lp + (size_t)su * st.lp;
    const T* const qps =
        qp != nullptr ? qp + (size_t)su * st.qp : nullptr;
    for (int g = 0; g < n_own; ++g) {
      const size_t src = (size_t)(r + g * C) * P;
      for (int k = tid; k < P; k += nth) {
        s_lp[g * P + k] = lps[src + k];
        if (qps != nullptr) s_qp[g * P + k] = qps[src + k];
      }
    }
    lbase = s_lp;
    qbase = qp != nullptr ? s_qp : nullptr;
    gstride = P;
  } else {
    lbase = lp + (size_t)su * st.lp + (size_t)r * P;
    qbase = qp != nullptr ? qp + (size_t)su * st.qp + (size_t)r * P
                          : nullptr;
    gstride = (size_t)C * P;
  }
  {  // this sample's U, Z/ℓ, 1/ℓ, σ² and Q
    const T* const us = u + (size_t)su * st.u;
    const T* const zss = zs + (size_t)su * st.zs;
    const T* const ilss = ils + (size_t)su * st.ils;
    const T* const kvs = kvar + (size_t)su * st.kvar;
    const T* const qs = q + (size_t)su * st.q;
    for (int i = tid; i < GM; i += nth) {
      const int g = i / M;
      const int m = i - g * M;
      const int d = r + g * C;
      s_u[i] = us[(size_t)m * D + d];
      for (int k = 0; k < din; ++k)
        s_z[i * din + k] = zss[((size_t)d * M + m) * din + k];
    }
    for (int i = tid; i < n_own * din; i += nth) {
      const int g = i / din;
      s_il[i] = ilss[(size_t)(r + g * C) * din + (i - g * din)];
    }
    for (int g = tid; g < n_own; g += nth) {
      s_kvar[g] = kvs[r + g * C];
      s_q[g] = qs[r + g * C];
    }
  }
  for (int i = tid; i < D; i += nth) xbuf[i] = x0[(size_t)s * D + i];
  // Every CTA of the cluster has started (a condition of writing into its
  // shared memory) and filled its buffers.
  cluster.sync();

  const int sub = tid % kRowThreads;
  const int rows_per_pass = nth / kRowThreads;
  for (int t = 0; t < n_t; ++t) {
    const T* const xcur = xbuf + (t & 1) * D;
    const int nxt = ((t + 1) & 1) * D;

    // 1. ε for the owned dims (from the highest threads, which the e loop
    //    leaves idle at the main shapes), and e = k(x̃, Z) per owned row.
    for (int g = nth - 1 - tid; g < n_own; g += nth) {
      const int d = r + g * C;
      s_eps[g] = noise != nullptr
                     ? noise[((size_t)s * n_t + t) * D + d]
                     : philox_normal<T>(seed, row_offset + (uint32_t)s,
                                        (uint32_t)t, (uint32_t)d);
    }
    for (int i = tid; i < GM; i += nth) {
      const T* zr = s_z + i * din;
      const T* il = s_il + (i / M) * din;
      T r2 = T(0);
      for (int k = 0; k < din; ++k) {
        const T xk = k < D ? xcur[k] : ctrl[(size_t)t * CU + (k - D)];
        const T df = zr[k] - xk * il[k];
        r2 += df * df;
      }
      e[i] = d_exp(T(-0.5) * r2);
    }
    __syncthreads();

    // 2. a = (σ² Lm⁻¹) e, with the partial products of mean and Σa².
    for (int base = 0; base < GM; base += rows_per_pass) {
      const int i = base + tid / kRowThreads;
      const T ai = packed_row_dot(lbase, gstride, e, i, GM, M, sub);
      if (i < GM && sub == 0) {
        a[i] = ai;
        p_mean[i] = ai * s_u[i];
        p_asq[i] = ai * ai;
      }
    }
    __syncthreads();

    // 3. (q_sqrtᵀa)_k = Σ_{m ≤ k} q_sqrt[m,k] a_m: row k of q_sqrtᵀ.
    if (qbase != nullptr) {
      for (int base = 0; base < GM; base += rows_per_pass) {
        const int i = base + tid / kRowThreads;
        const T wi = packed_row_dot(qbase, gstride, a, i, GM, M, sub);
        if (i < GM && sub == 0) p_wsq[i] = wi * wi;
      }
      __syncthreads();
    }

    // 4. One warp per owned dim: reduce, step x_d, send it to every CTA.
    for (int g = warp; g < n_own; g += nwarps) {
      T sm = T(0), sa = T(0), sw = T(0);
      for (int k = lane; k < M; k += 32) {
        sm += p_mean[g * M + k];
        sa += p_asq[g * M + k];
        if (qbase != nullptr) sw += p_wsq[g * M + k];
      }
      sm = warp_sum(sm);
      sa = warp_sum(sa);
      sw = warp_sum(sw);
      const int d = r + g * C;
      T xn = T(0);
      if (lane == 0) {
        T var = s_kvar[g] - sa;
        if (qbase != nullptr) var += sw;
        T vt = var + s_q[g];
        vt = vt < T(0) ? T(0) : vt;  // keeps NaN, like jnp.maximum
        const size_t o = ((size_t)s * n_t + t) * D + d;
        xn = (xcur[d] + sm) + s_eps[g] * d_sqrt(vt);
        xs[o] = xn;
        vs[o] = vt;
      }
      xn = __shfl_sync(0xffffffffu, xn, 0);
      for (int rk = lane; rk < C; rk += 32)
        *cluster.map_shared_rank(xbuf + nxt + d, (unsigned int)rk) = xn;
    }
    // Orders this step's remote writes of x before any CTA reads them, and
    // every read of buffer t&1 before step t+1 writes it again.
    cluster.sync();
  }
}

__global__ void normals_kernel(uint64_t seed, float* __restrict__ out,
                               long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = philox_normal<float>(seed, (uint32_t)i, 0u, 0u);
}

// The instantiation's block limit (its register use caps it: fp64 may not
// reach 1024 threads) and the dynamic shared memory a block may opt into,
// after opting in.  Returns a CUDA error, 0 on success.
template <typename T, bool kResident>
int kernel_limits(int* max_threads, int* smem_optin) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, rollout_kernel<T, kResident>);
  int dev = 0, optin = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(rollout_kernel<T, kResident>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)attr.sharedSizeBytes);
  if (err != cudaSuccess) return (int)err;
  *max_threads = (attr.maxThreadsPerBlock / 32) * 32;
  *smem_optin = optin - (int)attr.sharedSizeBytes;
  return 0;
}

template <typename T, bool kResident>
int launch(const T* x0, const T* zs, const T* ils, const T* kvar, const T* lp,
           const T* u, const T* q, const T* ctrl, const T* qp, const T* noise,
           T* xs, T* vs, int S, int n_t, int D, int M, int CU, int C, int G,
           int threads, int smem_bytes, SampleStrides st, uint64_t seed,
           uint32_t row_offset, cudaStream_t stream) {
  int max_threads = 0, optin = 0;
  const int err = kernel_limits<T, kResident>(&max_threads, &optin);
  if (err != 0) return err;
  if (threads < 32 || threads % 32 != 0 || threads > max_threads)
    return kErrThreads;
  const Layout L(D, M, D + CU, G, kResident);
  if ((size_t)smem_bytes < (size_t)L.total * sizeof(T) || smem_bytes > optin)
    return kErrSmem;
  if (S <= 0 || n_t <= 0) return (int)cudaGetLastError();

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned int)(S * C));
  cfg.blockDim = dim3((unsigned int)threads);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned int)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  cudaError_t e = cudaOccupancyMaxActiveClusters(
      &clusters, reinterpret_cast<const void*>(&rollout_kernel<T, kResident>),
      &cfg);
  if (e != cudaSuccess) return (int)e;
  if (clusters < 1) return kErrCluster;
  e = cudaLaunchKernelEx(&cfg, rollout_kernel<T, kResident>, x0, zs, ils,
                         kvar, lp, u, q, ctrl, qp, noise, xs, vs, n_t, D, M,
                         CU, G, st, seed, row_offset);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rollout(const T* x0, const T* zs, const T* ils, const T* kvar,
                   const T* lp, const T* u, const T* q, const T* ctrl,
                   const T* qp, const T* noise, T* xs, T* vs, int S, int n_t,
                   int D, int M, int CU, int C, int G, int threads,
                   int smem_bytes, int resident, SampleStrides st,
                   uint64_t seed, uint32_t row_offset, void* stream) {
  if (C < 1 || C > 8 || C > D || G != (D + C - 1) / C) return kErrCluster;
  auto* launcher = resident ? &launch<T, true> : &launch<T, false>;
  return launcher(x0, zs, ils, kvar, lp, u, q, ctrl, qp, noise, xs, vs, S,
                  n_t, D, M, CU, C, G, threads, smem_bytes, st, seed,
                  row_offset, (cudaStream_t)stream);
}

}  // namespace

// The limits a launch plan must keep for this itemsize (4 or 8): the
// largest block either instantiation takes and the dynamic shared memory a
// block may opt into.  Returns a CUDA error, 0 on success.
extern "C" int ffvd_rollout_limits(int itemsize, int* max_threads,
                                   int* smem_optin) {
  int t0 = 0, t1 = 0, s0 = 0, s1 = 0;
  int err = itemsize == 4 ? kernel_limits<float, false>(&t0, &s0)
                          : kernel_limits<double, false>(&t0, &s0);
  if (err == 0)
    err = itemsize == 4 ? kernel_limits<float, true>(&t1, &s1)
                        : kernel_limits<double, true>(&t1, &s1);
  if (err != 0) return err;
  *max_threads = t0 < t1 ? t0 : t1;
  *smem_optin = s0 < s1 ? s0 : s1;
  return 0;
}

extern "C" int ffvd_rollout_f32(const float* x0, const float* zs,
                                const float* ils, const float* kvar,
                                const float* lp, const float* u,
                                const float* q, const float* ctrl,
                                const float* qp, const float* noise,
                                float* xs, float* vs, int S, int n_t, int D,
                                int M, int CU, int C, int G, int threads,
                                int smem_bytes, int resident,
                                unsigned st_zs, unsigned st_ils,
                                unsigned st_kvar, unsigned st_lp,
                                unsigned st_u, unsigned st_q,
                                unsigned st_qp, uint64_t seed,
                                unsigned row_offset, void* stream) {
  const SampleStrides st{st_zs, st_ils, st_kvar, st_lp, st_u, st_q, st_qp};
  return launch_rollout<float>(x0, zs, ils, kvar, lp, u, q, ctrl, qp, noise,
                               xs, vs, S, n_t, D, M, CU, C, G, threads,
                               smem_bytes, resident, st, seed, row_offset,
                               stream);
}

extern "C" int ffvd_rollout_f64(const double* x0, const double* zs,
                                const double* ils, const double* kvar,
                                const double* lp, const double* u,
                                const double* q, const double* ctrl,
                                const double* qp, const double* noise,
                                double* xs, double* vs, int S, int n_t, int D,
                                int M, int CU, int C, int G, int threads,
                                int smem_bytes, int resident,
                                unsigned st_zs, unsigned st_ils,
                                unsigned st_kvar, unsigned st_lp,
                                unsigned st_u, unsigned st_q,
                                unsigned st_qp, uint64_t seed,
                                unsigned row_offset, void* stream) {
  const SampleStrides st{st_zs, st_ils, st_kvar, st_lp, st_u, st_q, st_qp};
  return launch_rollout<double>(x0, zs, ils, kvar, lp, u, q, ctrl, qp, noise,
                                xs, vs, S, n_t, D, M, CU, C, G, threads,
                                smem_bytes, resident, st, seed, row_offset,
                                stream);
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
