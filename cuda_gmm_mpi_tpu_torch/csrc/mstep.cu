// K2 and K4: the M-step epilogue, float32, for sm_90a.
//
// K2 replaces the TPU kernel `_mstep_kernel` (math in `_mstep_math`,
// cuda_gmm_mpi_tpu/ops/pallas/fused_stats.py, launched by `_mstep_call`);
// K4 replaces `_mstep_batched_kernel` (launched by `_mstep_batched_call`),
// the same epilogue for R restarts: blockIdx.y is the restart lane, whose
// [K, .] slices it reads and writes. K2 is K4 with R = 1, so each lane of
// K4 is bit-identical to K2 on that lane's operands.
// Nk/M1/M2 -> N/means/covariance with the reference's guards -- divide where
// Nk > 0.5, zero the scatter where Nk < 1, add the avgvar diagonal loading,
// fall back to the identity, keep inactive clusters inert.
//
// What bounds it on an H100: bytes. It is elementwise over [K, F] (a few
// flops per element on ~2*K*F*4 bytes), far below the card's ratio of
// operations to bytes; at the main path's K=100, F=576 the whole epilogue
// is ~0.5 MB and one launch's latency dominates. The design is one thread
// per [k, f] element, coalesced along f; K4 launches every lane at once,
// so R restarts pay one launch's latency, not R.
//
// Bit-identity: the result must equal the port's torch-ops update
// (ops/mstep.py::mstep_update) exactly. Every product, difference, sum and
// quotient is spelled with a round-to-nearest intrinsic, in the same order
// as the torch expressions, so no multiply-add is contracted into an FMA
// (the library is also built with --fmad=false).

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float mean_of(const float* m1, float nk, float safe,
                                         int idx) {
  return nk > 0.5f ? __fdiv_rn(m1[idx], safe) : 0.f;
}

__global__ void mstep_kernel(const float* __restrict__ nk,
                             const float* __restrict__ m1,
                             const float* __restrict__ m2,
                             const float* __restrict__ avgvar,
                             const float* __restrict__ act,
                             float* __restrict__ n_out,
                             float* __restrict__ mean_out,
                             float* __restrict__ cov_out, int k, int d,
                             int diag) {
  const int f = diag ? d : d * d;
  const size_t lane = blockIdx.y;  // restart lane
  nk += lane * k;
  m1 += lane * k * d;
  m2 += lane * k * f;
  avgvar += lane * k;
  act += lane * k;
  n_out += lane * k;
  mean_out += lane * k * d;
  cov_out += lane * k * f;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)k * f) return;
  const int kk = (int)(idx / f), fi = (int)(idx % f);
  const float n = nk[kk];
  const float safe = fmaxf(n, 1e-30f);
  const bool nonempty = n > 0.5f;
  const bool live = act[kk] > 0.5f;
  const float* m1k = m1 + (size_t)kk * d;
  float cov, fallback;
  if (diag) {
    const float mean = mean_of(m1k, n, safe, fi);
    cov = __fsub_rn(m2[idx], __fmul_rn(__fmul_rn(n, mean), mean));
    cov = n >= 1.f ? cov : 0.f;
    cov = __fadd_rn(cov, avgvar[kk]);
    fallback = 1.f;
  } else {
    const int r = fi / d, c = fi % d;
    const float mr = mean_of(m1k, n, safe, r), mc = mean_of(m1k, n, safe, c);
    cov = __fsub_rn(m2[idx], __fmul_rn(n, __fmul_rn(mr, mc)));
    cov = n >= 1.f ? cov : 0.f;
    fallback = r == c ? 1.f : 0.f;
    cov = __fadd_rn(cov, __fmul_rn(avgvar[kk], fallback));
  }
  const float out = nonempty ? __fdiv_rn(cov, safe) : fallback;
  cov_out[idx] = live ? out : fallback;
  if (fi < d) mean_out[(size_t)kk * d + fi] = live ? mean_of(m1k, n, safe, fi) : 0.f;
  if (fi == 0) n_out[kk] = live ? n : 0.f;
}

}  // namespace

// Launch K4 (gmm_mstep_batched, r lanes) or K2 (gmm_mstep) on `stream`;
// each returns cudaGetLastError(). Shapes per lane: nk, avgvar, act [k];
// m1 [k, d]; m2 [k, f]; n_out [k]; mean_out [k, d]; cov_out [k, f] with
// f = diag ? d : d*d; K4's arrays stack r such lanes.
extern "C" int gmm_mstep_batched(const float* nk, const float* m1,
                                 const float* m2, const float* avgvar,
                                 const float* act, float* n_out,
                                 float* mean_out, float* cov_out, int k, int d,
                                 int diag, int r, void* stream) {
  const long long total = (long long)k * (diag ? d : d * d);
  mstep_kernel<<<dim3((unsigned)((total + 255) / 256), r), 256, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      nk, m1, m2, avgvar, act, n_out, mean_out, cov_out, k, d, diag);
  return (int)cudaGetLastError();
}

extern "C" int gmm_mstep(const float* nk, const float* m1, const float* m2,
                         const float* avgvar, const float* act, float* n_out,
                         float* mean_out, float* cov_out, int k, int d, int diag,
                         void* stream) {
  return gmm_mstep_batched(nk, m1, m2, avgvar, act, n_out, mean_out, cov_out, k,
                           d, diag, 1, stream);
}
