// K1: fused E-step + M-step sufficient statistics, float32, for sm_90a.
//
// Replaces the TPU kernel `_fused_stats_kernel`
// (cuda_gmm_mpi_tpu/ops/pallas/fused_stats.py, launched by
// `_fused_stats_call`). For every event tile it builds the outer-product
// features on the fly from the tile of events held in shared memory, forms
//   logp = -0.5 * (x2 . A - 2 x . h) + g,
// a max-shifted log-sum-exp over all K, w = e/s * wt, and accumulates
//   ll = sum logz,  Nk = sum w,  M1 = w^T x,  M2 = w^T x2.
// Neither the [N, F] features nor the [N, K] posteriors reach device memory.
//
// What bounds it on an H100: operations. The function needs
// 2*N*K*(T+D) flops for logp plus 2*N*K*(T+D+1) for the accumulation, with
// T = D(D+1)/2 symmetric feature columns (T = D in diag mode): 1.3e11 flops
// at N=1M, K=100, D=24, against ~100 MB of event data.
// matmul_precision='highest' rules out TF32, so the roof is the 67 TFLOP/s
// fp32 (non-tensor) peak. The design cuts the operations and keeps the
// FMA units fed:
//  * x2 is symmetric, so only its upper triangle is formed: T = D(D+1)/2
//    packed columns instead of D*D (300 vs 576 at D=24). The wrapper sums
//    A's mirrored entries into a packed A; the reduction writes each packed
//    M2 sum to both mirrored entries of the [K, D*D] output, so the
//    caller's layout (column j*D+i holds x_i*x_j) is unchanged.
//  * Both products use 128-wide macro tiles and an 8x8 (4x8 for 64-row
//    tiles) register tile per thread, fed from double-buffered 16-deep
//    shared-memory stages. A shared table maps each feature column to its
//    pair of event coordinates, so no integer division runs per feature.
//
// Determinism (no float atomics anywhere):
//  * A persistent grid of G CTAs (G = min(tiles, 132), fixed by the wrapper
//    from the shapes alone). CTA b walks event tiles b, b+G, ... in order.
//    Per tile it keeps the tile's [B_t, K_pad] logp/posteriors and the
//    [B_t, D+1] events in shared memory (B_t is lowered from pallas_block_b
//    until that fits the shared-memory budget).
//  * Phase 1 computes logp for all K (the LSE needs every cluster of an
//    event) as a [B_t, T+D] x [T+D, K_pad] product against A_ext = [A; -2h].
//  * Phase 2: one warp per event row: max, shifted sum (xor butterflies, so
//    every lane holds the same bits), w written back in place.
//  * Phase 3 accumulates [Nk | M1 | M2] as one [K_pad, B_t] x [B_t, T+D+1]
//    product against the augmented feature row [x2 | x | 1]. Each tile's
//    sums start from zero in registers and are then added to this CTA's own
//    slice of a partial buffer in device memory (no other CTA touches it):
//    a float32 chain runs over one tile's B_t events, not over every event
//    of the CTA.
//  * A second kernel sums the G slices in index order, in float64, as it
//    does the per-CTA logliks (which each warp accumulates in float64). The
//    same inputs give bit-identical statistics from run to run, on any card.
//  * The ragged last tile is masked here (rows past n skipped, weight 0),
//    so the caller passes its real events only: the EM path hands K1 the
//    first n_events rows of its chunk grid, and the zero-weight padding
//    rows of that grid are never computed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int NT = 128;       // macro-tile width
constexpr int KC = 16;        // depth of one shared-memory stage
constexpr float NEG_LARGE = -1e30f;

// Column c of the augmented feature row [x2 packed | x | 1] is
// xa[ia] * xa[ib] with xa = [x_0, ..., x_{D-1}, 1]; pairs[c] = ia | ib << 8,
// or -1 for padding columns (feature 0).
template <bool DIAG>
__device__ void build_pairs(int* pairs, int d, int fe, int fe_pad) {
  const int t = DIAG ? d : d * (d + 1) / 2;
  for (int c = threadIdx.x; c < fe_pad; c += THREADS) {
    int ia = -1, ib = -1;
    if (c < t) {
      if (DIAG) {
        ia = ib = c;
      } else {  // upper-triangle row-major order: (0,0), (0,1), ..., (1,1), ...
        int i = 0, rem = c;
        while (rem >= d - i) rem -= d - i++;
        ia = i;
        ib = i + rem;
      }
    } else if (c < t + d) {
      ia = c - t;
      ib = d;
    } else if (c < fe) {
      ia = ib = d;
    }
    pairs[c] = ia < 0 ? -1 : (ia | (ib << 8));
  }
}

__device__ __forceinline__ float feature(const float* xrow, int pair) {
  return pair < 0 ? 0.f : xrow[pair & 255] * xrow[pair >> 8];
}

__device__ __forceinline__ float warp_max(float v) {
  for (int m = 16; m > 0; m >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// Rows (or columns) owned by a thread inside a macro tile: two groups of
// four, 64 apart, so the float4 shared-memory reads of a warp never
// conflict.
__device__ __forceinline__ int own(int t, int i) { return (i >> 2) * 64 + t * 4 + (i & 3); }

// acc[i][j] += a[i] * b[j] over one stage; a from a [KC][MR] block (MR rows
// of the output), b from a [KC][NT] block.
template <int MR>
__device__ __forceinline__ void fma_stage(float (&acc)[MR / 16][8],
                                          const float* a_blk, int a_stride,
                                          const float* b_blk, int tx, int ty) {
#pragma unroll
  for (int r = 0; r < KC; ++r) {
    float a[MR / 16], b[8];
    const float4* ar = reinterpret_cast<const float4*>(a_blk + r * a_stride);
    const float4* br = reinterpret_cast<const float4*>(b_blk + r * NT);
#pragma unroll
    for (int h = 0; h < MR / 64; ++h) {
      const float4 v = ar[h * 16 + ty];
      a[h * 4] = v.x; a[h * 4 + 1] = v.y; a[h * 4 + 2] = v.z; a[h * 4 + 3] = v.w;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 v = br[h * 16 + tx];
      b[h * 4] = v.x; b[h * 4 + 1] = v.y; b[h * 4 + 2] = v.z; b[h * 4 + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < MR / 16; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * b[j];
  }
}

template <bool DIAG, int MR>
__global__ void __launch_bounds__(THREADS, 1)
fused_stats_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                   const float* __restrict__ a_ext, const float* __restrict__ g,
                   float* __restrict__ partial, double* __restrict__ ll_part,
                   int n, int d, int kp, int bt, int xstride) {
  const int t = DIAG ? d : d * (d + 1) / 2;
  const int fd = t + d;                      // rows of A_ext
  const int fe = fd + 1;                     // columns of [x2 | x | 1]
  const int fe_pad = (fe + NT - 1) / NT * NT;

  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [bt][kp] logp, then w
  float* as = ws + (size_t)bt * kp;             // [2][KC][NT] A_ext stages
  float* fs = as + 2 * KC * NT;                 // [2][KC][NT] feature stages
  float* xs = fs + 2 * KC * NT;                 // [bt][xstride], col d = 1
  int* pairs = reinterpret_cast<int*>(xs + (size_t)bt * xstride);  // [fe_pad]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int num_tiles = (n + bt - 1) / bt;
  float* my_partial = partial + (size_t)blockIdx.x * kp * fe;
  double warp_ll = 0.0;
  bool first = true;

  build_pairs<DIAG>(pairs, d, fe, fe_pad);

  for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int64_t base = (int64_t)tile * bt;
    const int64_t left = n - base;
    const int rows = left < bt ? (int)left : bt;
    const int rows_r = (rows + MR - 1) / MR * MR;

    // Events of the tile, plus the constant-1 column; rows past n are 0.
    for (int e = tid; e < rows_r * (d + 1); e += THREADS) {
      const int r = e / (d + 1), c = e % (d + 1);
      float v = 1.f;
      if (c < d) v = r < rows ? x[(base + r) * d + c] : 0.f;
      xs[r * xstride + c] = v;
    }
    __syncthreads();

    // Phase 1: logp[r][k] = -0.5 * sum_c feat[r][c] * A_ext[c][k] + g[k].
    constexpr int LA = KC * NT / THREADS, LF = KC * MR / THREADS;
    const int s1 = (fd + KC - 1) / KC;
    for (int n0 = 0; n0 < rows_r; n0 += MR) {
      for (int k0 = 0; k0 < kp; k0 += NT) {
        float acc[MR / 16][8] = {};
        float ra[LA], rf[LF];
        auto load = [&](int s) {
#pragma unroll
          for (int it = 0; it < LA; ++it) {
            const int e = tid + it * THREADS, c = s * KC + e / NT;
            ra[it] = c < fd ? a_ext[(size_t)c * kp + k0 + e % NT] : 0.f;
          }
#pragma unroll
          for (int it = 0; it < LF; ++it) {
            const int e = tid + it * THREADS, c = s * KC + e / MR;
            rf[it] = c < fd ? feature(xs + (n0 + e % MR) * xstride, pairs[c]) : 0.f;
          }
        };
        auto store = [&](int buf) {
#pragma unroll
          for (int it = 0; it < LA; ++it) as[buf * KC * NT + tid + it * THREADS] = ra[it];
#pragma unroll
          for (int it = 0; it < LF; ++it) fs[buf * KC * NT + tid + it * THREADS] = rf[it];
        };
        load(0);
        store(0);
        __syncthreads();
        for (int s = 0; s < s1; ++s) {
          if (s + 1 < s1) load(s + 1);
          fma_stage<MR>(acc, fs + (s & 1) * KC * NT, MR, as + (s & 1) * KC * NT, tx, ty);
          if (s + 1 < s1) store((s + 1) & 1);
          __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < MR / 16; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int k = k0 + own(tx, j);
            ws[(n0 + own(ty, i)) * kp + k] = -0.5f * acc[i][j] + g[k];
          }
      }
    }
    __syncthreads();

    // Phase 2: per-event log-sum-exp over all K; w = e/s * wt in place.
    for (int r = warp; r < rows_r; r += THREADS / 32) {
      float* row = ws + r * kp;
      if (r >= rows) {
        for (int k = lane; k < kp; k += 32) row[k] = 0.f;
        continue;
      }
      float m = NEG_LARGE;
      for (int k = lane; k < kp; k += 32) m = fmaxf(m, row[k]);
      m = warp_max(m);  // NEG_LARGE floor: the all-masked guard
      float s = 0.f;
      for (int k = lane; k < kp; k += 32) s += expf(row[k] - m);
      s = warp_sum(s);
      const float w_ev = wt[base + r];
      for (int k = lane; k < kp; k += 32) row[k] = (expf(row[k] - m) / s) * w_ev;
      warp_ll += (double)((m + logf(s)) * w_ev);
    }
    __syncthreads();

    // Phase 3: out[k][c] += sum_r w[r][k] * feat[r][c], this CTA's slice.
    constexpr int L3 = KC * NT / THREADS;
    const int s3 = (rows + KC - 1) / KC;
    for (int k0 = 0; k0 < kp; k0 += NT) {
      for (int c0 = 0; c0 < fe_pad; c0 += NT) {
        float acc[8][8] = {};
        float rf[L3];
        auto load = [&](int s) {
#pragma unroll
          for (int it = 0; it < L3; ++it) {
            const int e = tid + it * THREADS;
            rf[it] = feature(xs + (s * KC + e / NT) * xstride, pairs[c0 + e % NT]);
          }
        };
        auto store = [&](int buf) {
#pragma unroll
          for (int it = 0; it < L3; ++it) fs[buf * KC * NT + tid + it * THREADS] = rf[it];
        };
        load(0);
        store(0);
        __syncthreads();
        for (int s = 0; s < s3; ++s) {
          if (s + 1 < s3) load(s + 1);
          fma_stage<128>(acc, ws + (size_t)s * KC * kp + k0, kp,
                         fs + (s & 1) * KC * NT, tx, ty);
          if (s + 1 < s3) store((s + 1) & 1);
          __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int k = k0 + own(ty, i), c = c0 + own(tx, j);
            if (c < fe) {
              float* p = my_partial + (size_t)k * fe + c;
              *p = first ? acc[i][j] : *p + acc[i][j];
            }
          }
      }
    }
    first = false;
    __syncthreads();
  }

  // This CTA's loglik: the 8 warp sums, in warp order.
  __shared__ double red[THREADS / 32];
  if (lane == 0) red[warp] = warp_ll;
  __syncthreads();
  if (tid == 0) {
    double s = 0.0;
    for (int w = 0; w < THREADS / 32; ++w) s += red[w];
    ll_part[blockIdx.x] = s;
  }
}

// Sum the G per-CTA slices in index order, in float64, and split
// [Nk | M1 | M2]; each packed M2 sum goes to both mirrored entries of the
// [K, D*D] output.
__global__ void reduce_partials(const float* __restrict__ partial,
                                const double* __restrict__ ll_part, int grid,
                                int k, int kp, int d, int diag,
                                float* __restrict__ ll, float* __restrict__ nk,
                                float* __restrict__ m1, float* __restrict__ m2) {
  const int f = diag ? d : d * d;
  const int t = diag ? d : d * (d + 1) / 2;
  const int fe = t + d + 1;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx == 0) {
    double s = 0.0;
    for (int b = 0; b < grid; ++b) s += ll_part[b];
    *ll = (float)s;
  }
  if (idx >= (int64_t)k * (f + d + 1)) return;
  const int kk = (int)(idx / (f + d + 1)), c = (int)(idx % (f + d + 1));
  int src = t + (c - f);  // M1 and Nk columns
  if (c < f) {
    if (diag) {
      src = c;
    } else {
      const int a = c / d, b = c % d, i = a < b ? a : b, j = a < b ? b : a;
      src = i * d - i * (i - 1) / 2 + (j - i);
    }
  }
  double s = 0.0;
  for (int b = 0; b < grid; ++b) s += partial[((size_t)b * kp + kk) * fe + src];
  if (c < f) m2[(size_t)kk * f + c] = (float)s;
  else if (c < f + d) m1[(size_t)kk * d + c - f] = (float)s;
  else nk[kk] = (float)s;
}

template <bool DIAG, int MR>
cudaError_t launch(const float* x, const float* wt, const float* a_ext,
                   const float* g, float* partial, double* ll_part, int n, int d,
                   int kp, int bt, int grid, size_t smem, int xstride,
                   cudaStream_t s) {
  auto kern = fused_stats_kernel<DIAG, MR>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, THREADS, smem, s>>>(x, wt, a_ext, g, partial, ll_part, n, d,
                                   kp, bt, xstride);
  return cudaGetLastError();
}

}  // namespace

// Launches K1 (both kernels) on `stream`; returns cudaGetLastError().
// Shapes: x [n, d], wt [n], a_ext [t+d, kp] (t = D(D+1)/2, or d in diag
// mode), g [kp], partial [grid, kp, t+d+1], ll_part [grid] (float64),
// ll [1], nk [k], m1 [k, d], m2 [k, f] with f = diag ? d : d*d. kp is a
// multiple of 128;
// bt a multiple of 128, or 64 (then the 64-row tiles are used).
extern "C" int gmm_fused_stats(const float* x, const float* wt, const float* a_ext,
                               const float* g, float* partial, double* ll_part,
                               float* ll, float* nk, float* m1, float* m2, int n,
                               int d, int k, int kp, int diag, int bt, int grid,
                               void* stream) {
  const int xstride = (d + 1) | 1;  // odd row stride: no bank conflicts
  const int t = diag ? d : d * (d + 1) / 2;
  const int fe_pad = (t + d + 1 + NT - 1) / NT * NT;
  const size_t smem = ((size_t)bt * kp + 4 * KC * NT + (size_t)bt * xstride) *
                          sizeof(float) + fe_pad * sizeof(int);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bt % 128 == 0)
    err = diag ? launch<true, 128>(x, wt, a_ext, g, partial, ll_part, n, d, kp, bt, grid, smem, xstride, s)
               : launch<false, 128>(x, wt, a_ext, g, partial, ll_part, n, d, kp, bt, grid, smem, xstride, s);
  else
    err = diag ? launch<true, 64>(x, wt, a_ext, g, partial, ll_part, n, d, kp, bt, grid, smem, xstride, s)
               : launch<false, 64>(x, wt, a_ext, g, partial, ll_part, n, d, kp, bt, grid, smem, xstride, s);
  if (err != cudaSuccess) return (int)err;
  const int f = diag ? d : d * d;
  const int64_t outs = (int64_t)k * (f + d + 1);
  reduce_partials<<<(unsigned)((outs + 255) / 256), 256, 0, s>>>(
      partial, ll_part, grid, k, kp, d, diag, ll, nk, m1, m2);
  return (int)cudaGetLastError();
}
