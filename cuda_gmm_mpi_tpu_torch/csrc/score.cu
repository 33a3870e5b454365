// S1: the serving path's scoring pass, float32 and float64, for sm_90a.
//
// S1 replaces no Pallas kernel: the JAX package scores served requests with
// the jnp `posteriors` (cuda_gmm_mpi_tpu/ops/estep.py), compiled ahead of
// time per (kind, block, K-bucket, D) by cuda_gmm_mpi_tpu/serving/
// executor.py. On the card a math library's product would not keep the
// serving contracts: cuBLAS picks its kernel, and with it the order of each
// dot product, from the M and N of the call, so one row's bits would depend
// on the block it was scored in and on the K-pad. Here every (event, slot)
// log density is one loop over the features in a fixed order, so a row's
// result depends on that row and the model's operands alone:
//
//   logp[k] = -0.5 * (sum_t p_t A[t, k] + sum_d x_d A[T + d, k]) + g[k]
//
// where p_t = x_i x_j over the upper triangle (i <= j, row-major; T =
// D(D+1)/2 and A's rows hold Rinv_ij, off-diagonal entries doubled) or
// p_d = x_d^2 in diag mode (T = D, A's rows hold diag(Rinv)), the last D rows
// of A hold -2 Rinv mu, and g = -0.5 mu^T Rinv mu + constant + ln pi, -inf
// for an inactive slot. Every term is an explicit fma in that order, in
// double for both types: the x and A of a float32 model are widened
// exactly, so its logp carries one float32 rounding instead of the
// expanded form's |x|^2 cancellation error (a float32 library product, and
// the torch-ops ``posteriors``, lose several digits there).
//
// The centered form (the 'centered' quad mode, ops/estep.py's branch that
// stages x - mu) takes the same A rows for the triangle but mu itself in
// the last D rows, and g = constant + ln pi:
//
//   logp[k] = -0.5 * sum_{i <= j} (x_i - mu_ki)(x_j - mu_kj) A[t(i,j), k]
//             + g[k]
//
// (diag: sum_d (x_d - mu_kd)^2 A[d, k]), the differences and products in
// double, the terms in the same fixed (i, j) order. It never forms |x|^2,
// so a far blob loses nothing to cancellation. An inactive slot's logp is
// -inf in both forms, whatever its operands hold. Then, per event and in
// slot-index order, in the model's dtype:
//
//   m = max_k logp[k]  (NaN propagates; a non-finite m becomes 0, as
//                       `posteriors` sanitizes it)
//   s = sum_k exp(logp[k] - m)   logZ = m + log(s)   w[k] = exp(logp - m)/s
//
// A padded slot (-inf) adds an exact 0 to s at the end of the sum, and no
// row reads another, so the results do not change with the block, the split
// of a request, its neighbours in a coalesced batch, the lanes of a stacked
// dispatch or a wider K-pad. 'assign' writes the first index of the largest
// w (jnp.argmax's rule) instead of w.
//
// Layout: a warp scores EV events at a time; lane l takes the slots
// l, l + 32, ..., SPL of them at once; each A element a lane loads serves
// the EV events, whose x rows sit in shared memory beside their [EV, Kb]
// logp rows. The max, the
// sum and the argmax of one event are a serial scan by one lane (lane e for
// event e of the group), which fixes their order.
//
// What bounds it on an H100: operations, 2 (T + D) K flops per event (0.25
// GFLOP at 4096 events x 96 clusters x D=24 full) against ~4 (D + Kb)
// bytes; at the fp32 FMA rate, 67 TFLOP/s, that is 3.8 us (the double
// accumulation runs at the fp64 rate, half of it). This first version is
// simple rather than fast (~17x the bound at 4096 x 96, chip_smoke.py phase
// 17): each lane loads its slots' A columns through L1 once per EV events,
// and the serial scans are 3 Kb dependent steps per event. The centered
// form does 3 T + D flops per (event, cluster) -- its products depend on
// the cluster -- and loads a mu element beside each A element.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 4;  // warps per CTA
constexpr int EV = 4;     // events a warp scores together
constexpr int SPL = 4;    // slots a lane scores together

// fp32 and fp64 spellings of the math the kernel uses, so that neither type
// goes through the other's function.
__device__ __forceinline__ float exp_t(float v) { return expf(v); }
__device__ __forceinline__ double exp_t(double v) { return exp(v); }
__device__ __forceinline__ float log_t(float v) { return logf(v); }
__device__ __forceinline__ double log_t(double v) { return log(v); }

template <typename T, bool DIAG, bool ASSIGN, bool CENTERED>
__global__ void __launch_bounds__(WARPS * 32)
score_kernel(const T* __restrict__ x, const T* __restrict__ a,
             const T* __restrict__ g, T* __restrict__ w, T* __restrict__ logz,
             int* __restrict__ labels, long long n, int d, int kb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // Per warp: the group's x rows widened to double, then its [EV, kb] logp.
  double* xs = reinterpret_cast<double*>(smem_raw) +
               (size_t)warp * EV * d;
  T* lp = reinterpret_cast<T*>(reinterpret_cast<double*>(smem_raw) +
                               (size_t)WARPS * EV * d) +
          (size_t)warp * EV * kb;
  const int t_rows = DIAG ? d : d * (d + 1) / 2;
  const long long step = (long long)gridDim.x * WARPS * EV;
  for (long long e0 = ((long long)blockIdx.x * WARPS + warp) * EV; e0 < n;
       e0 += step) {
    // The group's x rows (zeros past n: their results are not written).
    for (int i = lane; i < EV * d; i += 32) {
      const long long e = e0 + i / d;
      xs[i] = e < n ? (double)x[e * d + i % d] : 0.0;
    }
    __syncwarp();
    // Lane l scores the slots k0 + 32 s (s < SPL) at once: SPL loads of A
    // in flight per feature, each used for the EV events.
    for (int k0 = lane; k0 < kb; k0 += 32 * SPL) {
      double acc[SPL][EV];
#pragma unroll
      for (int s = 0; s < SPL; ++s)
#pragma unroll
        for (int v = 0; v < EV; ++v) acc[s][v] = 0.0;
      auto term = [&](int row, const double* p) {
        double av[SPL];
#pragma unroll
        for (int s = 0; s < SPL; ++s) {
          const int k = k0 + 32 * s;
          av[s] = k < kb ? (double)a[(size_t)row * kb + k] : 0.0;
        }
#pragma unroll
        for (int s = 0; s < SPL; ++s)
#pragma unroll
          for (int v = 0; v < EV; ++v) acc[s][v] = fma(p[v], av[s], acc[s][v]);
      };
      if (CENTERED) {
        // Each slot's own differences: xc = x - mu_k per (slot, event), the
        // products xc_i xc_j, one fma per term against A's triangle row.
        auto mu_at = [&](int i, double* m) {
#pragma unroll
          for (int s = 0; s < SPL; ++s) {
            const int k = k0 + 32 * s;
            m[s] = k < kb ? (double)a[(size_t)(t_rows + i) * kb + k] : 0.0;
          }
        };
        int t = 0;
        for (int i = 0; i < d; ++i) {
          double mi[SPL], ci[SPL][EV];
          mu_at(i, mi);
#pragma unroll
          for (int s = 0; s < SPL; ++s)
#pragma unroll
            for (int v = 0; v < EV; ++v) ci[s][v] = xs[v * d + i] - mi[s];
          for (int j = i; j < (DIAG ? i + 1 : d); ++j, ++t) {
            double mj[SPL], av[SPL];
            if (j == i) {
#pragma unroll
              for (int s = 0; s < SPL; ++s) mj[s] = mi[s];
            } else {
              mu_at(j, mj);
            }
#pragma unroll
            for (int s = 0; s < SPL; ++s) {
              const int k = k0 + 32 * s;
              av[s] = k < kb ? (double)a[(size_t)t * kb + k] : 0.0;
            }
#pragma unroll
            for (int s = 0; s < SPL; ++s)
#pragma unroll
              for (int v = 0; v < EV; ++v)
                acc[s][v] = fma(__dmul_rn(ci[s][v], xs[v * d + j] - mj[s]),
                                av[s], acc[s][v]);
          }
        }
      } else {
        int t = 0;
        double p[EV];
        for (int i = 0; i < d; ++i) {
          if (DIAG) {
#pragma unroll
            for (int v = 0; v < EV; ++v)
              p[v] = __dmul_rn(xs[v * d + i], xs[v * d + i]);
            term(i, p);
          } else {
#pragma unroll 8
            for (int j = i; j < d; ++j, ++t) {
#pragma unroll
              for (int v = 0; v < EV; ++v)
                p[v] = __dmul_rn(xs[v * d + i], xs[v * d + j]);
              term(t, p);
            }
          }
        }
        for (int i = 0; i < d; ++i) {
#pragma unroll
          for (int v = 0; v < EV; ++v) p[v] = xs[v * d + i];
          term(t_rows + i, p);
        }
      }
#pragma unroll
      for (int s = 0; s < SPL; ++s) {
        const int k = k0 + 32 * s;
        if (k < kb) {
          const double gk = g[k];
#pragma unroll
          for (int v = 0; v < EV; ++v)
            lp[v * kb + k] = gk == -INFINITY
                                 ? (T)-INFINITY
                                 : (T)fma(-0.5, acc[s][v], gk);
        }
      }
    }
    __syncwarp();
    // Lane v < EV: event e0 + v's max and sum, in slot order.
    T m = T(0), s = T(0);
    if (lane < EV) {
      const T* row = lp + lane * kb;
      m = row[0];
      for (int k = 1; k < kb; ++k) {
        const T v = row[k];
        if (v > m || isnan(v)) m = isnan(m) ? m : v;
      }
      if (!isfinite(m)) m = T(0);
    }
    T mv[EV];
#pragma unroll
    for (int v = 0; v < EV; ++v) mv[v] = __shfl_sync(0xffffffffu, m, v);
    for (int k = lane; k < kb; k += 32) {
#pragma unroll
      for (int v = 0; v < EV; ++v) lp[v * kb + k] = exp_t(lp[v * kb + k] - mv[v]);
    }
    __syncwarp();
    if (lane < EV) {
      const T* row = lp + lane * kb;
      for (int k = 0; k < kb; ++k) s += row[k];
      const long long e = e0 + lane;
      if (e < n) logz[e] = m + log_t(s);
    }
    T sv[EV];
#pragma unroll
    for (int v = 0; v < EV; ++v) sv[v] = __shfl_sync(0xffffffffu, s, v);
    for (int k = lane; k < kb; k += 32) {
#pragma unroll
      for (int v = 0; v < EV; ++v) {
        const T wv = lp[v * kb + k] / sv[v];
        if (ASSIGN) {
          lp[v * kb + k] = wv;
        } else if (e0 + v < n) {
          w[(e0 + v) * kb + k] = wv;
        }
      }
    }
    if (ASSIGN) {
      __syncwarp();
      if (lane < EV && e0 + lane < n) {
        const T* row = lp + lane * kb;
        int best = 0;
        T bv = row[0];
        for (int k = 1; k < kb && !isnan(bv); ++k) {
          const T v = row[k];
          if (v > bv || isnan(v)) { bv = v; best = k; }
        }
        labels[e0 + lane] = best;
      }
    }
    __syncwarp();
  }
}

template <typename T, bool DIAG, bool ASSIGN, bool CENTERED>
cudaError_t launch(const void* x, const void* a, const void* g, void* w,
                   void* logz, int* labels, long long n, int d, int kb,
                   cudaStream_t s) {
  auto kern = score_kernel<T, DIAG, ASSIGN, CENTERED>;
  const size_t smem =
      WARPS * EV * (sizeof(double) * (size_t)d + sizeof(T) * (size_t)kb);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long per_cta = (long long)WARPS * EV;
  long long grid = (n + per_cta - 1) / per_cta;
  if (grid > 65535LL * 32) grid = 65535LL * 32;
  if (grid < 1) grid = 1;
  kern<<<(unsigned)grid, WARPS * 32, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const T*>(g), static_cast<T*>(w), static_cast<T*>(logz),
      labels, n, d, kb);
  return cudaGetLastError();
}

template <typename T, bool CENTERED>
cudaError_t launch_c(const void* x, const void* a, const void* g, void* w,
                     void* logz, int* labels, long long n, int d, int kb,
                     int diag, int assign, cudaStream_t s) {
  if (diag)
    return assign ? launch<T, true, true, CENTERED>(x, a, g, w, logz, labels,
                                                    n, d, kb, s)
                  : launch<T, true, false, CENTERED>(x, a, g, w, logz, labels,
                                                     n, d, kb, s);
  return assign ? launch<T, false, true, CENTERED>(x, a, g, w, logz, labels, n,
                                                   d, kb, s)
                : launch<T, false, false, CENTERED>(x, a, g, w, logz, labels,
                                                    n, d, kb, s);
}

template <typename T>
cudaError_t launch_t(const void* x, const void* a, const void* g, void* w,
                     void* logz, int* labels, long long n, int d, int kb,
                     int diag, int assign, int centered, cudaStream_t s) {
  return centered ? launch_c<T, true>(x, a, g, w, logz, labels, n, d, kb,
                                      diag, assign, s)
                  : launch_c<T, false>(x, a, g, w, logz, labels, n, d, kb,
                                       diag, assign, s);
}

}  // namespace

// Launches S1 on `stream`; returns cudaGetLastError(). Shapes: x [n, d],
// a [t + d, kb] (t = d(d+1)/2, or d in diag mode), g [kb], logz [n]; with
// assign = 0 w [n, kb] (labels unused), with assign = 1 labels [n] int32 (w
// unused). centered: 1 for the centered form (a's last d rows hold mu, g
// holds constant + ln pi), 0 for the expanded one. is_double: 1 for float64
// operands, 0 for float32.
extern "C" int gmm_score(const void* x, const void* a, const void* g, void* w,
                         void* logz, int* labels, int n, int d, int kb,
                         int diag, int assign, int centered, int is_double,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return (int)cudaGetLastError();
  return (int)(is_double
                   ? launch_t<double>(x, a, g, w, logz, labels, n, d, kb, diag,
                                      assign, centered, s)
                   : launch_t<float>(x, a, g, w, logz, labels, n, d, kb, diag,
                                     assign, centered, s));
}
