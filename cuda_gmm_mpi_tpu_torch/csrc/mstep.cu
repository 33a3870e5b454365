// K2 and K4: the whole M-step of one EM iteration, float32, for sm_90a.
//
// K2 replaces the TPU kernel `_mstep_kernel` (math in `_mstep_math`,
// cuda_gmm_mpi_tpu/ops/pallas/fused_stats.py, launched by `_mstep_call`)
// together with the Cholesky constants that follow it on the TPU
// (cuda_gmm_mpi_tpu/ops/constants.py::compute_constants, which XLA fuses
// into the same program); K4 replaces `_mstep_batched_kernel` (launched by
// `_mstep_batched_call`), the same M-step for R restarts. The design is the
// reference's `constants_kernel` (gaussian_kernel.cu:250-259): one CTA per
// cluster (blockIdx.x) and restart lane (blockIdx.y). Each CTA
//  1. sums its lane's soft count n_total = sum_k (act_k ? Nk_k : 0) in
//     double, in a fixed order (warp 0: lane l takes k = l, l+32, ..., then
//     a butterfly of shuffles), so every CTA of the lane gets the same value
//     without atomics;
//  2. runs the guarded update Nk/M1/M2 -> N, means, R (divide where
//     Nk > 0.5, zero the scatter where Nk < 1, add the avgvar diagonal
//     loading, fall back to the identity, keep inactive clusters inert),
//     keeping the cluster's R in shared memory;
//  3. factors R = L L^T in shared memory (left-looking: thread 0 takes
//     column j's pivot, the other rows of the column are spread over the
//     CTA); a pivot that is not > 0 or a non-finite factor clears `ok`
//     (torch.linalg.cholesky_ex's info != 0, or the finite check). In diag
//     mode ok = all(var > 0);
//  4. writes R (the identity where !ok), Rinv = L^-T L^-1 (forward
//     substitution for L^-1, one thread per column of I, into the buffer R
//     left; then each Rinv entry a dot over a fixed j order; the reciprocal
//     diagonal in diag mode; the identity where !ok), constant =
//     -D/2 ln(2 pi) - 1/2 log|R| (log|R| = 2 sum_j log L_jj, summed in
//     double; 0 where !ok) and pi = N < 0.5 ? 1e-10 : N / max(n_total, 1e-30).
// So one EM iteration's M-step is one launch, where the torch-ops path
// (ops/mstep.py::apply_mstep) dispatches ~40 small kernels from the host.
//
// What bounds it on an H100: bytes, at ~7 KB per cluster at D=24 (M2 in;
// R and Rinv out), against ~D^3 flops (Cholesky, L^-1, L^-T L^-1, a third
// each); at the main path's K=100 that is 0.7 MB and 1.4 MFLOP, well under
// a microsecond of either. What a launch costs is latency: the
// factorization is a chain of D dependent pivots with two barriers each.
// The CTA is sized from D (4 x the next power of two of D, 32 to 256
// threads; 128 at D=24) and holds the header, D doubles and two D x D
// float buffers of dynamic shared memory (4.8 KB at D=24), so many CTAs
// share an SM.
//
// Bit-exactness: N, means and R must equal the port's torch-ops update
// (ops/mstep.py::mstep_update) exactly. Every product, difference, sum and
// quotient of the update is spelled with a round-to-nearest intrinsic, in
// the same order as the torch expressions, and the library is built with
// --fmad=false so that nothing is contracted into an FMA behind our back;
// the factorization's multiply-adds are explicit __fmaf_rn. Rinv, constant
// and pi are held to float64 (at most twice the torch-ops path's error) and
// pi to 4 ulps: only the order of their sums differs. Every sum runs in a
// fixed order, so a launch repeats bit for bit, and each lane of K4 equals
// K2 on that lane's operands.

#include <cuda_runtime.h>

namespace {

constexpr double LOG_2PI = 1.8378770664093453;  // ln(2 pi)
constexpr int HEADER = 16;  // bytes of shared memory: ok flag, n_total

int threads_for(int d) {
  int p = 1;
  while (p < d) p <<= 1;
  return p >= 64 ? 256 : (p <= 8 ? 32 : 4 * p);
}

// Dynamic shared memory of one CTA: the header, log L_jj (or log var_j) as
// D doubles, and R plus the factor L ([D] in diag mode).
size_t smem_bytes(int d, int diag) {
  return HEADER + sizeof(double) * d +
         sizeof(float) * (diag ? (size_t)d : 2 * (size_t)d * d);
}

// False for +-inf and NaN.
__device__ __forceinline__ bool finite(float v) {
  return fabsf(v) <= 3.402823466e38f;
}

__device__ __forceinline__ float mean_of(const float* m1, float nk, float safe,
                                         int i) {
  return nk > 0.5f ? __fdiv_rn(m1[i], safe) : 0.f;
}

__global__ void mstep_kernel(const float* __restrict__ nk,
                             const float* __restrict__ m1,
                             const float* __restrict__ m2,
                             const float* __restrict__ avgvar,
                             const bool* __restrict__ act,
                             float* __restrict__ n_out,
                             float* __restrict__ mean_out,
                             float* __restrict__ r_out,
                             float* __restrict__ rinv_out,
                             float* __restrict__ const_out,
                             float* __restrict__ pi_out,
                             bool* __restrict__ ok_out, int k, int d,
                             int diag) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* ok_s = reinterpret_cast<int*>(smem);
  float* ntot_s = reinterpret_cast<float*>(smem + 4);
  double* logs = reinterpret_cast<double*>(smem + HEADER);
  float* a = reinterpret_cast<float*>(logs + d);  // R: [d, d] (diag: [d])
  float* l = a + d * d;                           // L, lower triangle
  const int tid = threadIdx.x, nt = blockDim.x;
  const int c = blockIdx.x, dd = d * d;
  const size_t lane = blockIdx.y, kc = lane * k + c;
  nk += lane * k;
  act += lane * k;
  m1 += kc * d;
  m2 += kc * (diag ? d : dd);
  mean_out += kc * d;
  r_out += kc * dd;
  rinv_out += kc * dd;

  const float n = nk[c];
  const float safe = fmaxf(n, 1e-30f);
  const float av = avgvar[lane * k + c];
  const bool live = act[c];

  // 1. The lane's soft count.
  if (tid < 32) {
    double s = 0.0;
    for (int j = tid; j < k; j += 32) s += act[j] ? (double)nk[j] : 0.0;
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (tid == 0) {
      *ntot_s = (float)s;
      *ok_s = 1;
    }
  }

  // 2. The guarded update (the expressions of ops/mstep.py::mstep_update).
  if (diag) {
    for (int i = tid; i < d; i += nt) {
      const float mean = mean_of(m1, n, safe, i);
      float cov = __fsub_rn(m2[i], __fmul_rn(__fmul_rn(n, mean), mean));
      cov = n >= 1.f ? cov : 0.f;
      cov = __fadd_rn(cov, av);
      const float var = n > 0.5f ? __fdiv_rn(cov, safe) : 1.f;
      a[i] = live ? var : 1.f;
      mean_out[i] = live ? mean : 0.f;
    }
  } else {
    for (int idx = tid; idx < dd; idx += nt) {
      const int r = idx / d, q = idx % d;
      const float mr = mean_of(m1, n, safe, r), mq = mean_of(m1, n, safe, q);
      float cov = __fsub_rn(m2[idx], __fmul_rn(n, __fmul_rn(mr, mq)));
      cov = n >= 1.f ? cov : 0.f;
      const float eye = r == q ? 1.f : 0.f;
      cov = __fadd_rn(cov, __fmul_rn(av, eye));
      const float out = n > 0.5f ? __fdiv_rn(cov, safe) : eye;
      a[idx] = live ? out : eye;
    }
    for (int i = tid; i < d; i += nt)
      mean_out[i] = live ? mean_of(m1, n, safe, i) : 0.f;
  }
  if (tid == 0) n_out[kc] = live ? n : 0.f;
  __syncthreads();

  // 3. The factorization, or the diagonal's check.
  if (diag) {
    for (int i = tid; i < d; i += nt)
      if (!(a[i] > 0.f)) *ok_s = 0;
  } else {
    for (int j = 0; j < d; ++j) {
      if (tid == 0) {
        float s = a[j * d + j];
        for (int q = 0; q < j; ++q)
          s = __fmaf_rn(-l[j * d + q], l[j * d + q], s);
        const float p = __fsqrt_rn(s);
        if (!(s > 0.f) || !finite(p)) *ok_s = 0;
        l[j * d + j] = p;
      }
      __syncthreads();
      const float p = l[j * d + j];
      for (int i = j + 1 + tid; i < d; i += nt) {
        float s = a[i * d + j];
        for (int q = 0; q < j; ++q)
          s = __fmaf_rn(-l[i * d + q], l[j * d + q], s);
        const float v = __fdiv_rn(s, p);
        if (!finite(v)) *ok_s = 0;
        l[i * d + j] = v;
      }
      __syncthreads();
    }
  }
  __syncthreads();
  // Nothing writes ok_s after this barrier, so every thread reads the same.
  const bool ok = *ok_s != 0;

  // 4. R, log|R|, constant and pi; then Rinv.
  for (int idx = tid; idx < dd; idx += nt) {
    const int r = idx / d, q = idx % d;
    const float eye = r == q ? 1.f : 0.f;
    r_out[idx] = !ok ? eye : diag ? (r == q ? a[r] : 0.f) : a[idx];
  }
  for (int j = tid; j < d; j += nt)
    logs[j] = log((double)(diag ? a[j] : fabsf(l[j * d + j])));
  __syncthreads();
  if (tid == 0) {
    double ld = 0.0;
    for (int j = 0; j < d; ++j) ld += logs[j];
    const double log_det = !ok ? 0.0 : diag ? ld : 2.0 * ld;
    const_out[kc] = (float)(-0.5 * d * LOG_2PI - 0.5 * log_det);
    const float nn = live ? n : 0.f;
    pi_out[kc] = nn < 0.5f ? 1e-10f : __fdiv_rn(nn, fmaxf(*ntot_s, 1e-30f));
    ok_out[kc] = ok;
  }
  if (diag || !ok) {
    for (int idx = tid; idx < dd; idx += nt) {
      const int r = idx / d, q = idx % d;
      rinv_out[idx] = r != q ? 0.f : (ok ? __fdiv_rn(1.f, a[r]) : 1.f);
    }
    return;
  }
  // L^-1 into a (R is out): column col of L^-1 solves L x = e_col. Only
  // its lower triangle is written, and only that is read.
  for (int col = tid; col < d; col += nt) {
    for (int i = col; i < d; ++i) {
      float s = i == col ? 1.f : 0.f;
      for (int q = col; q < i; ++q)
        s = __fmaf_rn(-l[i * d + q], a[q * d + col], s);
      a[i * d + col] = __fdiv_rn(s, l[i * d + i]);
    }
  }
  __syncthreads();
  // Rinv[i, q] = sum_j L^-1[j, i] L^-1[j, q] (ops/constants.py's einsum).
  for (int idx = tid; idx < dd; idx += nt) {
    const int i = idx / d, q = idx % d;
    float s = 0.f;
    for (int j = max(i, q); j < d; ++j)
      s = __fmaf_rn(a[j * d + i], a[j * d + q], s);
    rinv_out[idx] = s;
  }
}

}  // namespace

// Launch K4 (r lanes) or K2 (r = 1) on `stream`; returns
// cudaGetLastError(). Shapes per lane: nk, avgvar, act (bool), n_out,
// const_out, pi_out, ok_out (bool) [k]; m1, mean_out [k, d]; m2 [k, f] with
// f = diag ? d : d*d; r_out, rinv_out [k, d, d]. The arrays stack r such
// lanes.
extern "C" int gmm_mstep(const float* nk, const float* m1, const float* m2,
                         const float* avgvar, const bool* act, float* n_out,
                         float* mean_out, float* r_out, float* rinv_out,
                         float* const_out, float* pi_out, bool* ok_out, int k,
                         int d, int diag, int r, void* stream) {
  const size_t smem = smem_bytes(d, diag);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mstep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  mstep_kernel<<<dim3(k, r), threads_for(d), smem,
                 static_cast<cudaStream_t>(stream)>>>(
      nk, m1, m2, avgvar, act, n_out, mean_out, r_out, rinv_out, const_out,
      pi_out, ok_out, k, d, diag);
  return (int)cudaGetLastError();
}
