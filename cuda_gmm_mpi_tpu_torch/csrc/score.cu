// S1: the serving path's scoring pass, float32 and float64, for sm_90a.
//
// S1 replaces no Pallas kernel: the JAX package scores served requests with
// the jnp `posteriors` (cuda_gmm_mpi_tpu/ops/estep.py), compiled ahead of
// time per (kind, block, K-bucket, D) by cuda_gmm_mpi_tpu/serving/
// executor.py. On the card a math library's product would not keep the
// serving contracts: cuBLAS picks its kernel, and with it the order of each
// dot product, from the M and N of the call, so one row's bits would depend
// on the block it was scored in and on the K-pad. Here every (event, slot)
// log density is one chain of fmas over the features in a fixed order, so a
// row's result depends on that row and the model's operands alone:
//
//   logp[k] = -0.5 * (sum_t p_t A[t, k] + sum_d x_d A[T + d, k]) + g[k]
//
// where p_t = x_i x_j over the upper triangle (i <= j, row-major; T =
// D(D+1)/2 and A's rows hold Rinv_ij, off-diagonal entries doubled) or
// p_d = x_d^2 in diag mode (T = D, A's rows hold diag(Rinv)), the last D rows
// of A hold -2 Rinv mu, and g = -0.5 mu^T Rinv mu + constant + ln pi, -inf
// for an inactive slot. The chain starts from 0 and takes one
// fma(p_t, A[t, k], acc) per triangle row, then fma(x_d, A[T + d, k], acc)
// per feature, then logp = fma(-0.5, acc, g[k]) rounded to the model's
// type; p_t = x_i * x_j is rounded on its own (__dmul_rn). All of it is in
// double for both types: the x and A of a float32 model are widened
// exactly, so its logp carries one float32 rounding instead of the expanded
// form's |x|^2 cancellation error (a float32 library product, and the
// torch-ops ``posteriors``, lose several digits there).
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
// What bounds it on an H100: operations. The expanded form does 2 (T + D)
// flops per (event, active slot) against ~4 (D + Kb) bytes: 0.25 GFLOP at
// 4,096 events x 96 slots x D = 24 full, 3.8 us at the card's 67 TFLOP/s
// fp32 FMA rate (the bound chip_smoke.py reports). The chains run in
// double, on the FP64 FMA units, whose ceiling is about 34 TFLOP/s: 7.5 us
// there, so the kernel can reach at most 51% of that bound. The FP64 tensor
// cores (DMMA) would go past that ceiling, but a tensor-core product sums
// its k-slices in an order of its own, and the bits would no longer be one
// chain in feature order: the serving contracts (split, coalesced, stacked,
// K-pad, hot reload, bit for bit) would then need their own proof, and the
// outputs' bits would move. This design gives the tensor cores up for the
// bits, and aims at the FP64 FMA ceiling instead. Below that ceiling lies
// shared memory's 128 bytes per cycle per SM against its 64 FP64 fmas: a
// thread's TL x TL register tile reads TL x values (double) and TL A
// values per row for TL^2 fmas, 3 bytes per fma at TL = 4 in float32 (at
// most 2/3 of the ceiling), 1.5 at TL = 8, 6 at TL = 2; and on a small
// request, the latency of each thread's chain of rows.
//
// The design (two kernels per launch):
//
// 1. logp_kernel: a CTA takes a tile of `ev` events and `kt` slots; the
//    wrapper, ops/kernels/score.py, picks them from the shapes with the
//    thread's register tile, the ring's rows per stage and its stages. Its
//    events' x rows, and in the centered form its slots' mu, sit in shared
//    memory widened to double. A_ext's columns of the tile stream through a
//    ring of `stages` x [rows, kt] in the model's type, filled by cp.async
//    (16 bytes a copy where the rows allow it) one or two stages ahead of
//    the compute, so an A element fetched once serves the whole event tile
//    and no fma waits on an L2 round trip; a value is widened to double as
//    it is read. Each thread holds a TL x TL (events x slots) tile of double
//    accumulators, TL^2 independent chains, each in the order above: 2 x 2
//    on small requests (short chains of rows per thread, many threads), 4 x
//    4 otherwise, 8 x 8 in the expanded form with a full covariance on
//    large ones (half the shared-memory bytes per fma of 4 x 4). In the
//    expanded form a thread forms each event's p_t once per t and uses it
//    for its TL slots; in the centered form the differences are per
//    (event, slot). A tile whose slots are all inactive writes -inf and
//    computes nothing. The logp rows go to w itself in 'proba' and to a
//    scratch [N, Kb] in 'assign'.
// 2. scan_kernel: a CTA of SCAN_WARPS warps stages up to SCAN_EV logp rows
//    whole in shared memory; lane e of its first warp scans row e for its
//    max, its sum and (assign) its argmax, each in slot order, so up to 32
//    events scan at once; the exponentials and the quotients between the
//    scans are elementwise, and every thread of the CTA takes a share.
//
// Splitting the slots across CTAs is what puts the scans in a second
// pass; it lets a small request fill the card: the wrapper shrinks the
// event tile, then the slot tile, until the grid has some TARGET_CTAS CTAs
// (a 64-row request at Kb 128 launches 32).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

// The source's constants; ops/kernels/score.py states the same.
constexpr int TILES[3] = {2, 4, 8};  // a thread's register tile's side
constexpr int MAX_EV = 128;     // events per CTA, at most
constexpr int MAX_KT = 32;      // slots per CTA, at most
constexpr int RING_ROWS = 32;   // A_ext rows per ring stage, at most
constexpr int STAGES = 3;       // ring stages, at most
constexpr int SCAN_EV = 32;     // events per scan CTA, at most (a lane each)
constexpr int SCAN_WARPS = 4;   // warps per scan CTA
constexpr int SCAN_SMEM = 49152;  // a scan CTA's rows, at most
constexpr int SMEM_MAX = 232448;  // shared memory one CTA may use
constexpr int XB = 8;           // global loads a thread keeps in flight

// fp32 and fp64 spellings of the math the scans use, so that neither type
// goes through the other's function.
__device__ __forceinline__ float exp_t(float v) { return expf(v); }
__device__ __forceinline__ double exp_t(double v) { return exp(v); }
__device__ __forceinline__ float log_t(float v) { return logf(v); }
__device__ __forceinline__ double log_t(double v) { return log(v); }

// BYTES (4, 8 or 16) global -> shared, asynchronously; zeros where !ok.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(src), "n"(BYTES), "r"(ok ? BYTES : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// N consecutive values from shared memory (N * sizeof(T) bytes aligned to
// min(16, that)), widened to double (exact for float).
template <int N, typename T>
__device__ __forceinline__ void loadw(const T* p, double* o) {
  if constexpr (std::is_same<T, float>::value && N >= 4) {
#pragma unroll
    for (int u = 0; u < N / 4; ++u) {
      const float4 v = reinterpret_cast<const float4*>(p)[u];
      o[4 * u] = v.x;
      o[4 * u + 1] = v.y;
      o[4 * u + 2] = v.z;
      o[4 * u + 3] = v.w;
    }
  } else {
    using V2 = std::conditional_t<std::is_same<T, float>::value, float2,
                                  double2>;
#pragma unroll
    for (int u = 0; u < N / 2; ++u) {
      const V2 v = reinterpret_cast<const V2*>(p)[u];
      o[2 * u] = v.x;
      o[2 * u + 1] = v.y;
    }
  }
}

// Values 0 .. count - 1 (load(i), in global memory's order) widened to
// double and stored (store(i, v)), XB loads in flight per thread.
template <typename T, typename L, typename S>
__device__ __forceinline__ void widen(int count, L&& load, S&& store) {
  for (int i0 = threadIdx.x; i0 < count; i0 += XB * blockDim.x) {
    T v[XB];
#pragma unroll
    for (int u = 0; u < XB; ++u) {
      const int i = i0 + u * blockDim.x;
      v[u] = i < count ? load(i) : T(0);
    }
#pragma unroll
    for (int u = 0; u < XB; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < count) store(i, (double)v[u]);
    }
  }
}

// Dynamic shared bytes of logp_kernel: x [d][ev] and (centered) mu [d][kt]
// in double, then the ring, [stages][rows][kt] in the model's type.
template <typename T, bool CENTERED>
__host__ __device__ constexpr size_t smem_bytes(int d, int ev, int kt,
                                                int rows, int stages) {
  return sizeof(double) * ((size_t)d * ev + (CENTERED ? (size_t)d * kt : 0)) +
         sizeof(T) * (size_t)stages * rows * kt;
}

template <typename T, int TL, bool DIAG, bool CENTERED>
__global__ void __launch_bounds__((MAX_EV / TL) * (MAX_KT / TL) < 1024
                                      ? (MAX_EV / TL) * (MAX_KT / TL)
                                      : 1024)
logp_kernel(const T* __restrict__ x, const T* __restrict__ a,
            const T* __restrict__ g, T* __restrict__ lp, int n, int d,
            int kb, int ev, int kt, int rows, int stages) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, threads = blockDim.x;
  const int e0 = blockIdx.x * ev, k0 = blockIdx.y * kt;
  const int kend = min(kt, kb - k0);  // the tile's slots that exist
  // A tile of inactive slots: -inf, whatever A holds.
  const int ts = tid % kt;
  if (!__syncthreads_or(ts < kend && (double)g[k0 + ts] != -INFINITY)) {
    for (int i = tid; i < ev * kend; i += threads) {
      const int e = e0 + i / kend;
      if (e < n) lp[(size_t)e * kb + k0 + i % kend] = (T)-INFINITY;
    }
    return;
  }
  // This thread's events and slots, slots fastest: a warp spans several
  // event groups and several slot groups, so its x and A loads are
  // broadcasts.
  const int ns = kt / TL;
  const int eg = tid / ns, sg = tid % ns;
  double gk[TL];  // its slots' g (the epilogue's)
#pragma unroll
  for (int s = 0; s < TL; ++s) {
    const int k = sg * TL + s;
    gk[s] = k < kend ? (double)g[k0 + k] : 0.0;
  }
  double* xs = reinterpret_cast<double*>(smem_raw);  // [d][ev]
  double* mus = xs + (size_t)d * ev;                 // [d][kt], centered
  T* ring = reinterpret_cast<T*>(mus + (CENTERED ? (size_t)d * kt : 0));
  const int t_rows = DIAG ? d : d * (d + 1) / 2;
  const int nrows = CENTERED ? t_rows : t_rows + d;  // rows through the ring
  const int chunks = (nrows + rows - 1) / rows;

  // The ring's copies: 16 bytes each where A_ext's rows allow it, else one
  // element each; thread tid copies column cs of rows tid / kv,
  // tid / kv + rstep, ... (kt, and so kv, divides the threads: the launch
  // checks it).
  constexpr int V = 16 / sizeof(T);
  const bool vec = kb % V == 0 && kt % V == 0 &&
                   (reinterpret_cast<uintptr_t>(a) & 15) == 0;
  const int kv = vec ? kt / V : kt;  // copies per row
  const int cs = (tid % kv) * (vec ? V : 1), rstep = threads / kv;
  auto issue = [&](int c) {
    if (c < chunks) {
      T* dst = ring + (size_t)(c % stages) * rows * kt + cs;
      const int r0 = c * rows;
      const bool col = cs < kend;
      for (int r = tid / kv; r < rows; r += rstep) {
        const bool ok = col && r0 + r < nrows;
        const T* src = ok ? a + (size_t)(r0 + r) * kb + k0 + cs : a;
        if (vec)
          cp_async<16>(dst + (size_t)r * kt, src, ok);
        else
          cp_async<sizeof(T)>(dst + (size_t)r * kt, src, ok);
      }
    }
    cp_commit();  // empty past the last chunk, so the waits stay uniform
  };
  for (int c = 0; c < stages - 1; ++c) issue(c);
  // The tile's x rows (zeros past n: their results are not written) and,
  // centered, mu's rows of the tile's slots, widened, feature-major.
  {
    const T* xt = x + (size_t)e0 * d;
    const int have = min(ev, n - e0) * d;
    widen<T>(
        ev * d, [&](int i) { return i < have ? xt[i] : T(0); },
        [&](int i, double v) { xs[(size_t)(i % d) * ev + i / d] = v; });
    if (CENTERED)
      widen<T>(
          d * kt,
          [&](int i) {
            const int s = i % kt;
            return s < kend ? a[(size_t)(t_rows + i / kt) * kb + k0 + s]
                            : T(0);
          },
          [&](int i, double v) { mus[i] = v; });
  }

  double acc[TL][TL];
#pragma unroll
  for (int e = 0; e < TL; ++e)
#pragma unroll
    for (int s = 0; s < TL; ++s) acc[e][s] = 0.0;
  const double* xe = xs + eg * TL;    // this thread's events, stride ev
  const double* mue = mus + sg * TL;  // its slots' mu, stride kt
  int i = 0, j = 0;                   // the next triangle term's (i, j)
  double xi[TL];                      // expanded: x_i
  double ci[CENTERED ? TL : 1][TL];   // centered: x_i - mu_ki

  for (int c = 0; c < chunks; ++c) {
    issue(c + stages - 1);
    if (stages == 3)
      cp_wait<2>();
    else
      cp_wait<1>();
    __syncthreads();
    // this chunk's A rows, this thread's slots, widened as they are read
    const T* ac = ring + (size_t)(c % stages) * rows * kt + sg * TL;
    const int nr = min(rows, nrows - c * rows);
    // rows [0, tri) of this chunk are triangle rows, the rest x's rows
    const int tri = min(nr, max(0, t_rows - c * rows));
#pragma unroll 2
    for (int r = 0; r < tri; ++r) {
      double av[TL], xj[TL];
      loadw<TL>(ac + (size_t)r * kt, av);
      loadw<TL>(xe + (size_t)j * ev, xj);
      if constexpr (CENTERED) {
        double mj[TL];
        loadw<TL>(mue + (size_t)j * kt, mj);
        if (j == i) {
#pragma unroll
          for (int e = 0; e < TL; ++e)
#pragma unroll
            for (int s = 0; s < TL; ++s) ci[e][s] = xj[e] - mj[s];
        }
#pragma unroll
        for (int e = 0; e < TL; ++e)
#pragma unroll
          for (int s = 0; s < TL; ++s)
            acc[e][s] = fma(__dmul_rn(ci[e][s], xj[e] - mj[s]), av[s],
                            acc[e][s]);
      } else {
        if (j == i) {
#pragma unroll
          for (int e = 0; e < TL; ++e) xi[e] = xj[e];
        }
#pragma unroll
        for (int e = 0; e < TL; ++e) {
          const double p = __dmul_rn(xi[e], xj[e]);
#pragma unroll
          for (int s = 0; s < TL; ++s) acc[e][s] = fma(p, av[s], acc[e][s]);
        }
      }
      // the next (i, j): row-major over i <= j (diag: i = j)
      const bool wrap = DIAG || ++j == d;
      i += wrap;
      j = wrap ? i : j;
    }
    if (!CENTERED) {
#pragma unroll 2
      for (int r = tri; r < nr; ++r) {  // the last D rows: fma(x_d, A, acc)
        double av[TL], p[TL];
        loadw<TL>(ac + (size_t)r * kt, av);
        loadw<TL>(xe + (size_t)(c * rows + r - t_rows) * ev, p);
#pragma unroll
        for (int e = 0; e < TL; ++e)
#pragma unroll
          for (int s = 0; s < TL; ++s)
            acc[e][s] = fma(p[e], av[s], acc[e][s]);
      }
    }
    __syncthreads();  // the next issue overwrites this stage
  }

#pragma unroll
  for (int s = 0; s < TL; ++s) {
    const int k = sg * TL + s;
    if (k >= kend) continue;
#pragma unroll
    for (int e = 0; e < TL; ++e) {
      const int ee = e0 + eg * TL + e;
      if (ee < n)
        lp[(size_t)ee * kb + k0 + k] =
            gk[s] == -INFINITY ? (T)-INFINITY
                               : (T)fma(-0.5, acc[e][s], gk[s]);
    }
  }
}

// step(k, row[k]) for k = 0 .. n - 1 in order, the loads 8 at a time.
template <typename T, typename F>
__device__ __forceinline__ void in_order(const T* row, int n, F&& step) {
  int k = 0;
  for (; k + 8 <= n; k += 8) {
    T v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = row[k + u];
#pragma unroll
    for (int u = 0; u < 8; ++u) step(k + u, v[u]);
  }
  for (; k < n; ++k) step(k, row[k]);
}

// A CTA of SCAN_WARPS warps stages its sev logp rows (contiguous in lp)
// whole in shared memory, row stride kb + 1. Lane e of warp 0 scans row e
// for its max, then its sum, then (assign) its argmax, each in slot order;
// the exponentials and the quotients between the scans are elementwise,
// and every thread of the CTA takes a share of them.
template <typename T, bool ASSIGN>
__global__ void __launch_bounds__(SCAN_WARPS * 32)
scan_kernel(T* __restrict__ lp, T* __restrict__ logz, int* __restrict__ labels,
            int n, int kb, int sev) {
  extern __shared__ __align__(16) unsigned char scan_raw[];
  T* buf = reinterpret_cast<T*>(scan_raw);  // [sev][kb + 1]
  __shared__ T red[SCAN_EV];                // each row's max, then sum
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ld = kb + 1;
  const int e0 = blockIdx.x * sev;
  const int here = min(sev, n - e0);  // the CTA's events that exist
  T* rows = lp + (size_t)e0 * kb;
  // f(r, k, buf's element) over the staged rows: row r on warp
  // r % SCAN_WARPS, its slots over the lanes
  auto each = [&](auto&& f) {
    for (int k = lane; k < kb; k += 32)
#pragma unroll 8
      for (int r = warp; r < here; r += SCAN_WARPS)
        f(r, k, buf + (size_t)r * ld + k);
  };
  each([&](int r, int k, T* p) {
    cp_async<sizeof(T)>(p, rows + (size_t)r * kb + k, true);
  });
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  const T* mine = buf + (size_t)tid * ld;
  const bool own = tid < here;  // lane tid of warp 0 owns event e0 + tid
  T m = T(0);
  if (own) {
    m = mine[0];
    in_order(mine + 1, kb - 1, [&](int, T v) {
      if (v > m || isnan(v)) m = isnan(m) ? m : v;
    });
    if (!isfinite(m)) m = T(0);
    red[tid] = m;
  }
  __syncthreads();
  each([&](int r, int, T* p) { *p = exp_t(*p - red[r]); });
  __syncthreads();
  if (own) {
    T s = T(0);
    in_order(mine, kb, [&](int, T v) { s += v; });
    logz[e0 + tid] = m + log_t(s);
    red[tid] = s;
  }
  __syncthreads();
  each([&](int r, int k, T* p) {
    if (ASSIGN)
      *p = *p / red[r];
    else
      rows[(size_t)r * kb + k] = *p / red[r];
  });
  if (ASSIGN) {
    __syncthreads();
    if (own) {  // the first largest w; a NaN ends the scan
      int best = 0;
      T bv = mine[0];
      in_order(mine + 1, kb - 1, [&](int k, T v) {
        if (!isnan(bv) && (v > bv || isnan(v))) {
          bv = v;
          best = k + 1;
        }
      });
      labels[e0 + tid] = best;
    }
  }
}

template <typename T, int TL, bool DIAG, bool CENTERED>
cudaError_t launch_logp(const T* x, const T* a, const T* g, T* lp, int n,
                        int d, int kb, int ev, int kt, int rows, int stages,
                        int smem, cudaStream_t s) {
  const int threads = (ev / TL) * (kt / TL);
  // each thread's ring column stays fixed: the copies per row (kt of one
  // element, or kt / (16 / sizeof(T)) of 16 bytes) divide the threads
  if ((size_t)smem != smem_bytes<T, CENTERED>(d, ev, kt, rows, stages) ||
      ev % TL || kt % TL || threads % kt)
    return cudaErrorInvalidValue;
  auto kern = logp_kernel<T, TL, DIAG, CENTERED>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((n + ev - 1) / ev),
                  (unsigned)((kb + kt - 1) / kt));
  kern<<<grid, threads, smem, s>>>(x, a, g, lp, n, d, kb, ev, kt, rows,
                                   stages);
  return cudaGetLastError();
}

template <typename T, int TL>
cudaError_t launch_tile(const T* x, const T* a, const T* g, T* lp, int n,
                        int d, int kb, int diag, int centered, int ev, int kt,
                        int rows, int stages, int smem, cudaStream_t s) {
  if (centered)
    return diag ? launch_logp<T, TL, true, true>(x, a, g, lp, n, d, kb, ev,
                                                 kt, rows, stages, smem, s)
                : launch_logp<T, TL, false, true>(x, a, g, lp, n, d, kb, ev,
                                                  kt, rows, stages, smem, s);
  return diag ? launch_logp<T, TL, true, false>(x, a, g, lp, n, d, kb, ev,
                                                kt, rows, stages, smem, s)
              : launch_logp<T, TL, false, false>(x, a, g, lp, n, d, kb, ev,
                                                 kt, rows, stages, smem, s);
}

template <typename T>
cudaError_t launch_t(const void* x, const void* a, const void* g, void* lp,
                     void* logz, int* labels, int n, int d, int kb, int diag,
                     int assign, int centered, int tile, int ev, int kt,
                     int rows, int stages, int smem, int sev,
                     cudaStream_t s) {
  if ((size_t)sev * (kb + 1) * sizeof(T) > SCAN_SMEM)
    return cudaErrorInvalidValue;
  const T *xt = static_cast<const T*>(x), *at = static_cast<const T*>(a),
          *gt = static_cast<const T*>(g);
  T* lpt = static_cast<T*>(lp);
  cudaError_t err = cudaErrorInvalidValue;
  if (tile == TILES[0])
    err = launch_tile<T, TILES[0]>(xt, at, gt, lpt, n, d, kb, diag, centered,
                                   ev, kt, rows, stages, smem, s);
  else if (tile == TILES[1])
    err = launch_tile<T, TILES[1]>(xt, at, gt, lpt, n, d, kb, diag, centered,
                                   ev, kt, rows, stages, smem, s);
  else if (tile == TILES[2] && !centered && !diag)  // the wide tile
    err = launch_logp<T, TILES[2], false, false>(
        xt, at, gt, lpt, n, d, kb, ev, kt, rows, stages, smem, s);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((n + sev - 1) / sev);
  const size_t ss = (size_t)sev * (kb + 1) * sizeof(T);
  if (assign)
    scan_kernel<T, true><<<grid, SCAN_WARPS * 32, ss, s>>>(
        lpt, static_cast<T*>(logz), labels, n, kb, sev);
  else
    scan_kernel<T, false><<<grid, SCAN_WARPS * 32, ss, s>>>(
        lpt, static_cast<T*>(logz), labels, n, kb, sev);
  return cudaGetLastError();
}

}  // namespace

// Launches S1 on `stream` (two kernels); returns cudaGetLastError(), or
// cudaErrorInvalidValue for a geometry the kernels do not take. Shapes: x
// [n, d], a [t + d, kb] (t = d(d+1)/2, or d in diag mode), g [kb], lp
// [n, kb] (w itself with assign = 0; scratch with assign = 1), logz [n],
// labels [n] int32 with assign = 1 (unused otherwise). centered: 1 for the
// centered form (a's last d rows hold mu, g holds constant + ln pi), 0 for
// the expanded one. is_double: 1 for float64 operands, 0 for float32. The
// geometry (ops/kernels/score.py's ``score_geometry``): a tile x tile
// register tile per thread (one of TILES; the widest in the expanded form
// with a full covariance only), ev events and kt slots per logp CTA, rows
// A_ext rows per ring stage, stages, smem bytes of its dynamic shared
// memory; sev events per scan CTA.
extern "C" int gmm_score(const void* x, const void* a, const void* g,
                         void* lp, void* logz, int* labels, int n, int d,
                         int kb, int diag, int assign, int centered,
                         int is_double, int tile, int ev, int kt, int rows,
                         int stages, int smem, int sev, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return (int)cudaGetLastError();
  if (ev < 1 || ev > MAX_EV || kt < 1 || kt > MAX_KT || rows < 1 ||
      rows > RING_ROWS || stages < 2 || stages > STAGES || smem > SMEM_MAX ||
      sev < 1 || sev > SCAN_EV || kb < 1 || d < 1)
    return (int)cudaErrorInvalidValue;
  return (int)(is_double
                   ? launch_t<double>(x, a, g, lp, logz, labels, n, d, kb,
                                      diag, assign, centered, tile, ev, kt,
                                      rows, stages, smem, sev, s)
                   : launch_t<float>(x, a, g, lp, logz, labels, n, d, kb,
                                     diag, assign, centered, tile, ev, kt,
                                     rows, stages, smem, sev, s));
}
