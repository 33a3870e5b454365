// K1, K3, K5 and K6: fused E-step + M-step sufficient statistics, float32,
// for sm_90a.
//
// K1 replaces the TPU kernel `_fused_stats_kernel`
// (cuda_gmm_mpi_tpu/ops/pallas/fused_stats.py, launched by
// `_fused_stats_call`); K3 replaces `_fused_stats_batched_kernel` (launched
// by `_fused_stats_batched_call`), the same statistics for R restarts at
// once. Both run the one kernel below: K1 is K3 with R = 1 and no lane
// mask. For every event tile it builds the outer-product
// features on the fly from the tile of events held in shared memory, forms
//   logp = -0.5 * (x2 . A - 2 x . h) + g,
// a max-shifted log-sum-exp over all K, w = e/s * wt, and accumulates
//   ll = sum logz,  Nk = sum w,  M1 = w^T x,  M2 = w^T x2.
// Neither the [N, F] features nor the [N, K] posteriors reach device memory.
//
// What bounds it on an H100: operations. The function needs
// 2*N*K*(T+D) flops for logp plus 2*N*K*(T+D+1) for the accumulation, with
// T = D(D+1)/2 symmetric feature columns (T = D in diag mode): 1.3e11 flops
// at N=1M, K=100, D=24, against ~100 MB of event data. The precision (the
// PREC template parameter, the TPU kernel's static `precision`, which it
// runs through `_kdot`) picks the units:
//  * PREC = HIGHEST ('highest', fp32's error class). Phase 3, the
//    accumulation, runs on the tensor cores: warp-level mma.sync m16n8k8
//    with TF32 inputs, in three passes (3xTF32). Each operand value v is
//    split as it is loaded into a fragment, big = tf32(v) (round to nearest,
//    10 mantissa bits) and small = tf32(v - big); each 8-deep step issues
//    small_a*big_b, big_a*small_b, then big_a*big_b into a partial that
//    starts from zero, and the partial is added to the fp32 accumulator on
//    the FMA units. The tensor cores truncate their fp32 sums toward zero
//    (after aligning the terms with 2 guard bits), so a sum kept inside them
//    drifts; rounded to nearest outside, phase 3's error stays under the
//    float32 floor (tests/test_torch_tf32_split.py emulates this
//    arithmetic). Phase 1, logp, stays on the fp32 FMA units: the expanded
//    quadratic form cancels terms far larger than logp, and there 3xTF32
//    (operands kept to ~22 of fp32's 24 bits, sums truncated) lands several
//    times further from float64 than the plain version does, against a bar
//    of twice (PERF.md, section 6).
//  * PREC = HIGH ('high', bf16_3x) and DEFAULT ('default', one bf16 pass):
//    both products run on the tensor cores, mma.sync m16n8k16 with bf16
//    inputs and fp32 accumulators, one 16-deep step per shared-memory
//    stage. Each operand value is split as it enters a fragment, big =
//    bf16_rn(v), small = bf16_rn(v - big) (the TPU kernel's split); HIGH
//    issues small_a*big_b, big_a*small_b, big_a*big_b (al*bl dropped, as in
//    `_kdot`), DEFAULT big_a*big_b. The products of bf16 values are exact
//    in fp32; each step's partial starts from zero and is added outside the
//    tensor cores, as above, so their truncated sums act on 48 (or 16)
//    terms only, far under the bf16 split's error. Nk is the fp32 sum of
//    the posteriors in every mode, as the TPU kernel's `jnp.sum(w)`: the
//    warps that hold the Nk column add the w values of their A fragments on
//    the FMA units and put that sum in place of the tensor cores'. The
//    fragments hold bf16 pairs along the depth, so their stage rows are
//    padded to strides of 4 (mod 32) floats, where 3xTF32's are 8.
//  * x2 is symmetric, so only its upper triangle is formed: T = D(D+1)/2
//    packed columns instead of D*D (300 vs 576 at D=24). The wrapper sums
//    A's mirrored entries into a packed A; the reduction writes each packed
//    M2 sum to both mirrored entries of the [K, D*D] output, so the
//    caller's layout (column j*D+i holds x_i*x_j) is unchanged.
//  * Both products use 128-wide macro tiles fed from double-buffered
//    16-deep shared-memory stages. Phase 1 gives each thread an 8x8 (4x8
//    for 64-row tiles) register tile; its A_ext stages arrive by 16-byte
//    cp.async, its feature stages are computed from the event tile (a
//    shared table maps each feature column to its pair of event
//    coordinates, so no integer division runs per feature) and staged
//    through registers; the tile's events arrive by 4-byte cp.async.
//    Phase 3 splits the 128 x 128 tile over the 8 warps as 2 x 4 warp
//    tiles of 64 x 32 outputs (4 x 4 m16n8 tiles, 64 accumulators per
//    thread) and reads its operands depth-major: w^T in place from the
//    posteriors, the features from their stage. Every
//    posterior row and phase-3 stage row is padded to a stride of 8
//    (mod 32) floats, so the 32 lanes of a fragment load (row lane/4 +
//    0..7, depth lane%4) hit 32 distinct banks.
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
//
// K3, the restart axis: the grid is (G, R). Lane r = blockIdx.y reads its
// own A_ext/g (per-restart parameters), writes its own slice of a
// [R, G, K_pad, T+D+1] partial buffer, and the reduction sums each lane's
// G slices in the same index order. G and B_t come from N, K and D only,
// never from R, so lane r of K3 is bit-identical to K1 on lane r's
// operands. The lane mask is read here, on the device, and folded into
// the event weight as the TPU kernel does; a lane whose mask is 0 skips
// its tiles and the reduction writes exact zeros for it (what the folded
// weight gives). K3 is bound by operations like K1 (1.3e11 flops per lane
// at the north star against ~100 MB of events), so each lane's CTAs
// re-read the event tiles from device memory (the L2 serves most of it);
// sharing one tile across lanes in shared memory is later work.
//
// K3's per-lane-events form (a fleet of tenants, tenancy/ in the package):
// lane r reads its own events, x + r * x_lane [n_r, d] and wt + r * wt_lane,
// where n_r = lane_n[r] is read on the device. Lane r takes K1's grid on
// its own rows, G_r = min(ceil(n_r / bt), grid_cap) on the tile bt (which
// depends on K and D only): its CTAs with blockIdx.x >= G_r exit at once,
// the others stride its tiles by G_r, and the reduction sums its first G_r
// slices of the [R, G, K_pad, T+D+1] partial buffer in index order. So
// lane r is bit-identical to K1 on lane r's first n_r rows. With lane_n
// null (every restart launch) the strides are 0 and nothing changes.
//
// The narrow route: K1, K3 and K3's per-lane form at PREC = HIGHEST with
// K <= 64 (a fleet's tenants, a BIC search, a sweep's low Ks, small-K
// restarts) run this kernel on a W-column tile, W = 16, 32 or 64, the
// smallest >= K (K_pad = W, from K and the precision alone: `stats_tile` in
// ops/kernels/fused_stats.py), where the 128-wide route computes 128
// columns of which K are real:
//  * The tile's weights are copied beside its events (4-byte cp.async)
//    and phase 2 reads them from shared memory. The 128-wide route reads
//    them from device memory: another bt floats of its shared memory
//    would change which shapes its tile fits. The asynchronous loads
//    (the events' on both routes) take 11-35 % off K1 at K = 16 to 64 on
//    1M x 24 events, and 5 % (full) and 9 % (diag) off K1 at K = 100,
//    against loads through registers (stats_ab.py; PERF.md section 6).
//  * Phase 1 moves its thread layout from columns to rows (Fma1): 4 x 4
//    outputs per thread at W = 16 (256-row passes over 8-deep stages) and
//    32 (128-row passes), 8 x 4 at 64, so each float4 of rows and of
//    columns still feeds 16-32 FMAs.
//  * Phase 2 reads the event weights from shared memory; at W = 16 each
//    warp takes two of its rows at once, one per half-warp, which halves
//    its serial chain of shuffles: K1 at K = 16 takes 17 % (full) and 34 %
//    (diag) less time than through the general loop with lanes 16-31 idle
//    (stats_ab.py).
//  * Phase 3 takes the shard kernel's layout: every warp holds all W rows
//    (W / 16 m16 tiles), the 8 warps side by side across the 128-wide
//    feature tile. Each feature of the tile is then one lane's B element,
//    so the lane forms it from the event tile in its registers: no feature
//    stage and no barrier in phase 3.
//  * The partial buffer is [R, G, W, T+D+1], so each tile's
//    read-modify-write and the reduction's reads shrink by 128 / W; the
//    posteriors take bt x (W + 8) floats instead of bt x 136, the A_ext
//    stages KC x W. The instances are compiled for W16_CTAS / W32_CTAS /
//    W64_CTAS CTAs per SM, which their shared memory at D = 24 fits, so
//    the (G, R) grid of K3 and its per-lane form fills the SMs; K1 alone
//    keeps its G = 132 CTAs (the bits fix G).
// What bounds it at W: operations, 2 N K (T+D) flops on the FMA units and
// 3 x 2 N K (T+D+1) on the tensor cores, against ~4 N (D+2) bytes of
// events (K the real clusters; 0.16 ms on the FMA units at N = 1M, K = 16,
// D = 24). Why its outputs are the 128-wide route's bit for bit on the
// same operands: it keeps K1's event tile (the tile at K_pad 128), grid,
// tile walk, per-CTA partial slices and float64 index-order reduction, and
// every per-element chain: phase 1's over the depth (a thread layout or a
// stage depth changes which thread adds, not what or in which order; the
// zero rows past the depth add exact zeros),
// phase 3's over the events in KC stages of 8-deep 3xTF32 steps with each
// partial added on the FMA units (an m16n8k8 output depends on its own row
// and column only; each feature is the same product of two event
// coordinates, formed in a register or in a stage), and phase 2's tree:
// lane l holds columns l and l + 32, then warp_max / warp_sum (at W = 16
// the half-warp's, whose bits are the same), and warp_ll adds each warp's
// rows in order; the 128-wide route adds exact zeros for its other columns
// (g = NEG_LARGE: exp(NEG_LARGE - m) = 0, and the max never moves). The one exception is an event for which every cluster of the
// lane is inactive (m = NEG_LARGE): each route then divides by its own
// K_pad (the plain version by K); an EM state always has a live cluster.
//
// K5 and K6, the cluster-sharded pair: they replace `_local_lse_kernel` and
// `_stats_logz_kernel` (launched by `_local_lse_call` and `_stats_logz_call`)
// of the same file. A rank of a (data, cluster) mesh holds K_s = K / C
// clusters, so the log-sum-exp over all K spans ranks:
//  * K5 (MODE_LOCAL_LSE) writes each event's max m over this shard's K_s
//    clusters and the shifted sum s = sum exp(logp - m) to two float32 [N]
//    outputs. The K_pad - K_s padding columns are left out of both, so an
//    all-masked shard gives m = NEG_LARGE and s = K_s, as the TPU kernel
//    (which has no padding columns) and the plain version do; the
//    combination outside scales s by exp(m - M) = 0 then.
//  * The caller combines the shards with an all_reduce MAX of m (M) and an
//    all_reduce SUM of exp(m - M) * s (S): logZ = M + log(S).
//  * K6 (MODE_STATS_LOGZ) reads logZ [N] in place of its own max and sum:
//    w = exp(logp - logZ) * wt, and adds logZ * wt to a float64 loglik.
//    Its statistics and their index-order float64 reduction are K1's, so
//    K6 is deterministic from launch to launch too. K6 recomputes K5's
//    phase 1, as the TPU kernel does.
// Bounds: K5 does 2 N K_s (T+D) flops on the FMA units, K6 that plus
// 2 N K_s (T+D+1) three times on the tensor cores, against ~4 N (D+2)
// bytes: operations, like K1. A shard of the mesh cell is small (K_s = 50
// at K = 100, C = 2), so two routes, chosen by the shard's width:
//  * K_s <= 64: `shard_kernel`, its own design for the shard (below): a
//    64-wide cluster tile, the row reduction taken in phase 1's registers
//    (no logp buffer, no phase-2 pass), and 3 (K5) or 2 (K6) CTAs per SM
//    on a persistent grid of 132 times that.
//  * K_s > 64 (e.g. 65 or 130 clusters): K1's kernel in the K5/K6 mode, on
//    K1's tile and grid: 128-wide column tiles, phase 2 a pass over the
//    logp buffer in shared memory, one CTA per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // phase 1: 16 x 16 threads; phase 3: 2 x 4 warps
constexpr int NT = 128;       // macro-tile width
constexpr int KC = 16;        // depth of one shared-memory stage
constexpr int PAD = 8;        // row padding for TF32 fragment loads: strides of 8 (mod 32)
constexpr int BPAD = 4;       // for bf16 fragment loads (pairs along the depth): 4 (mod 32)
constexpr int SROW = NT + PAD;    // row stride of a phase-3 stage
constexpr int STAGE = KC * SROW;  // floats of one stage buffer
constexpr float NEG_LARGE = -1e30f;
// The narrow route (K1/K3 at 'highest', K <= 64): K_pad = W, the column
// tile, 16, 32 or 64; and the CTAs per SM each W's instances are compiled
// for (__launch_bounds__), which their shared memory at D = 24 fits.
constexpr int W16_CTAS = 3, W32_CTAS = 2, W64_CTAS = 1;
constexpr int stats_ctas(int w) {
  return w == 16 ? W16_CTAS : w == 32 ? W32_CTAS : w == 64 ? W64_CTAS : 1;
}

enum { MODE_STATS = 0, MODE_LOCAL_LSE = 1, MODE_STATS_LOGZ = 2 };
// matmul_precision: 'highest', 'high' (bf16_3x), 'default' (one bf16 pass).
enum { P_HIGHEST = 0, P_HIGH = 1, P_DEFAULT = 2 };

#ifdef GMM_PHASE_CLOCKS
// A build with -DGMM_PHASE_CLOCKS (chip_smoke.py makes one) times the
// phases: each thread reads clock64() at the barriers that end them, and
// thread 0 of each CTA of restart lane 0 adds its cycles to phase_cycles
// at the end: the tile's events, phase 1, phase 2 (on the shard kernel the
// reduction in phase 1's registers), phase 3's products, phase 3's
// read-modify-write of the partial buffer.
constexpr int PHASES = 5;
__device__ unsigned long long phase_cycles[PHASES];
#define PHASE_CLOCK_START \
  unsigned long long phase_t = clock64(), phase_sum[PHASES] = {};
#define PHASE_CLOCK(i)                          \
  {                                             \
    const unsigned long long now = clock64();   \
    phase_sum[i] += now - phase_t;              \
    phase_t = now;                              \
  }
#define PHASE_CLOCK_END                                         \
  if (threadIdx.x == 0 && blockIdx.y == 0)                      \
    for (int i = 0; i < PHASES; ++i) atomicAdd(&phase_cycles[i], phase_sum[i]);
#else
#define PHASE_CLOCK_START
#define PHASE_CLOCK(i)
#define PHASE_CLOCK_END
#endif

// Operands of one launch. Pointers a mode does not use are null: K1/K3 have
// no logz/m/s, K5 no wt/lanes/partial/ll_part, K1/K5/K6 no lanes. kp is a
// multiple of 128 on K1's kernel (16, 32 or 64 on its narrow route) and 64
// on the shard kernel (K5/K6 with k <= 64), whose bt is 128.
struct Params {
  const float* x;      // [n, d] events
  const float* wt;     // [n] event weights
  const float* lanes;  // [r] restart lane mask (K3)
  const float* logz;   // [n] global per-event evidence (K6)
  const float* a_ext;  // [r, t+d, kp]
  const float* g;      // [r, kp]
  float* m_out;        // [n] local max (K5)
  float* s_out;        // [n] local shifted sum (K5)
  float* partial;      // [r, grid, kp, t+d+1]
  double* ll_part;     // [r, grid]
  const int* lane_n;   // [r] per-lane real events (K3's per-lane form)
  int64_t x_lane, wt_lane;  // lane strides of x and wt, in floats (0: shared)
  int n, d, k, kp, bt, xstride;
  int grid_cap;        // the per-lane grid's bound (K1's grid), lane_n set
};

// The grid lane r of the per-lane form takes: K1's grid on its n rows.
__device__ __forceinline__ int lane_grid(int n, int bt, int cap) {
  const int g = (n + bt - 1) / bt;
  return g < cap ? g : cap;
}

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

// The same inside each half-warp (lanes 0-15 and 16-31).
__device__ __forceinline__ float half_max(float v) {
  for (int m = 8; m > 0; m >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}

__device__ __forceinline__ float half_sum(float v) {
  for (int m = 8; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// v = big + small, both TF32 (round to nearest, ties away from zero).
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(v));
  const float rest = v - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) : "f"(rest));
}

// c += a * b on one m16n8k8 tile: TF32 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes global -> shared, asynchronously; zero-filled where !valid.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared, asynchronously; zero-filled where !valid.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows (or columns) owned by thread t of a group of TN threads in phase 1's
// SIMT product inside a macro tile: groups of four, 4 TN apart (64 in K1's
// 16 x 16 layout), so the float4 shared-memory reads of a warp never
// conflict.
template <int TN = 16>
__device__ __forceinline__ int own(int t, int i) {
  return (i >> 2) * (TN * 4) + t * 4 + (i & 3);
}

// Phase 1's thread layout for an MR-row, W-column pass: TX x TY threads,
// each with MR / TY rows (own<TY>) and NC columns (own<TX>), over stages
// DEPTH deep. K1's 128-wide tile:
// 16 x 16 threads of 8 x 8 (4 x 8 for 64-row passes), 16 deep. The narrow
// route holds more rows and fewer columns, so each shared-memory read
// still feeds several FMAs: 4 x 4 at W = 16 (256-row passes, 8-deep
// stages, so that the feature stage keeps its size), 4 x 4 at 32 and 8 x 4
// at 64 (128-row passes).
template <int MR, int W>
struct Fma1 {
  static constexpr int OUT = MR * W / THREADS;  // outputs per thread
  static constexpr int NC = W == NT ? 8 : 4;
  static constexpr int TX = W / NC, TY = THREADS / TX;
  static constexpr int DEPTH = MR > 128 ? KC / 2 : KC;
  static_assert(TX * TY == THREADS && MR % (4 * TY) == 0 && DEPTH * MR <= STAGE,
                "phase 1 layout");
};

// The rows of a narrow route's phase-1 pass at W (MR of its instances).
constexpr int stats_rows(int w) { return w == 16 ? 256 : 128; }

// Phase 1: acc[i][j] += a[i] * b[j] over one stage on the fp32 FMA units;
// a from a [KC][MR] block (MR rows of the output), b from a [KC][TX NC]
// block: NC = 8 columns per thread in a 128-wide tile (K1's), 4 in the
// 64-wide shard tile and on the narrow route (columns tx*4 .. tx*4+3);
// TY threads share the rows (own<TY>).
template <int MR, int NC = 8, int TY = 16, int DEPTH = KC>
__device__ __forceinline__ void fma_stage(float (&acc)[MR / TY][NC],
                                          const float* a_blk, const float* b_blk,
                                          int tx, int ty) {
  constexpr int TX = THREADS / TY;
#pragma unroll
  for (int r = 0; r < DEPTH; ++r) {
    float a[MR / TY], b[NC];
    const float4* ar = reinterpret_cast<const float4*>(a_blk + r * MR);
    const float4* br = reinterpret_cast<const float4*>(b_blk + r * (TX * NC));
#pragma unroll
    for (int h = 0; h < MR / (4 * TY); ++h) {
      const float4 v = ar[h * TY + ty];
      a[h * 4] = v.x; a[h * 4 + 1] = v.y; a[h * 4 + 2] = v.z; a[h * 4 + 3] = v.w;
    }
#pragma unroll
    for (int h = 0; h < NC / 4; ++h) {
      const float4 v = br[h * TX + tx];
      b[h * 4] = v.x; b[h * 4 + 1] = v.y; b[h * 4 + 2] = v.z; b[h * 4 + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < MR / TY; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] += a[i] * b[j];
  }
}

// Phase 3: acc += A * B over one KC-deep stage on the tensor cores, in
// three TF32 passes. Both operands are depth-major blocks: a_blk[depth *
// a_stride + row] holds this warp's 16 MI output rows (64 in K1's and the
// shard kernel's; W on the narrow route), b_blk[depth * b_stride
// + col] its 8 NJ output columns (32 in K1's 2 x 4 warp layout, 16 in the
// shard kernel's and the narrow route's 1 x 8). Lane (g = lane / 4, t = lane % 4) loads
// fragment elements (row g (+8), depth t (+4)) of A and (depth t (+4),
// column g) of B: with strides of 8 (mod 32) floats the warp's 32 loads hit
// 32 banks. The tensor cores truncate their fp32 sums (toward zero, after
// aligning the terms with 2 guard bits), so each 8-deep step's three
// passes go into a partial that starts from zero, and the partials are
// added to acc on the FMA units, rounding to nearest: the truncation then
// never acts on the running sum.
//
// mma_core takes B as b_at(depth, j) = B[depth][j * 8 + g], g = lane / 4:
// mma_stage reads it from a shared-memory block, the narrow route's phase
// 3 forms each feature where its fragment needs it.
template <int NJ, int MI, class BAt>
__device__ __forceinline__ void mma_core(float (&acc)[MI][NJ][4],
                                         const float* a_blk, int a_stride,
                                         BAt b_at, int lane) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t b_big[2][NJ][2], b_small[2][NJ][2];
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      split_tf32(b_at(k * 8 + t, j), b_big[k][j][0], b_small[k][j][0]);
      split_tf32(b_at(k * 8 + t + 4, j), b_big[k][j][1], b_small[k][j][1]);
    }
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    uint32_t a_big[2][4], a_small[2][4];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float* q = a_blk + (k * 8 + t) * a_stride + i * 16 + g;
      split_tf32(q[0], a_big[k][0], a_small[k][0]);
      split_tf32(q[8], a_big[k][1], a_small[k][1]);
      split_tf32(q[4 * a_stride], a_big[k][2], a_small[k][2]);
      split_tf32(q[4 * a_stride + 8], a_big[k][3], a_small[k][3]);
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      float part[NJ][4] = {};
      // The small terms first, the big product last.
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma_tf32(part[j], a_small[k], b_big[k][j]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma_tf32(part[j], a_big[k], b_small[k][j]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma_tf32(part[j], a_big[k], b_big[k][j]);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int h = 0; h < 4; ++h) acc[i][j][h] += part[j][h];
    }
  }
}

template <int NJ = 4, int MI = 4>
__device__ __forceinline__ void mma_stage(float (&acc)[MI][NJ][4],
                                          const float* a_blk, int a_stride,
                                          const float* b_blk, int b_stride,
                                          int lane) {
  const float* b = b_blk + (lane >> 2);
  mma_core<NJ, MI>(acc, a_blk, a_stride,
                   [=](int depth, int j) { return b[depth * b_stride + j * 8]; }, lane);
}

// (v0, v1) = big + small as packed bf16 pairs (round to nearest even;
// v0 in the low half): the TPU kernel's split xh = bf16(x), xl = bf16(x - xh).
// v - bf16(v) is exact in fp32.
__device__ __forceinline__ void split_bf16x2(float v0, float v1, uint32_t& big,
                                             uint32_t& small) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(v0, v1);
  const float2 bf = __bfloat1622float2(b);
  const __nv_bfloat162 r = __floats2bfloat162_rn(v0 - bf.x, v1 - bf.y);
  big = *reinterpret_cast<const uint32_t*>(&b);
  small = *reinterpret_cast<const uint32_t*>(&r);
}

// c += a * b on one m16n8k16 tile: bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += A * B over one KC-deep stage on the tensor cores in bf16: three
// passes (PREC = HIGH: small_a*big_b, big_a*small_b, big_a*big_b) or one
// (DEFAULT), into a partial that starts from zero and is added to acc
// outside the tensor cores. Operands depth-major as in mma_stage; lane
// (g = lane / 4, t = lane % 4) loads A elements (row g (+8), depth 2t, 2t+1
// (+8)) and B elements (depth 2t, 2t+1 (+8), column g), each pair along the
// depth packed into one register. With strides of 4 (mod 32) floats the 32
// loads of a warp hit 32 banks. With nk_on, nk[i][h] also sums the A
// values of rows g (h = 0) and g + 8 (h = 1) of m16 tile i over this
// lane's depths, in fp32 on the FMA units.
template <int NJ, int PREC>
__device__ __forceinline__ void mma_stage_bf16(float (&acc)[4][NJ][4],
                                               const float* a_blk, int a_stride,
                                               const float* b_blk, int b_stride,
                                               int lane, bool nk_on,
                                               float (&nk)[4][2]) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t b_big[NJ][2], b_small[NJ][2];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const float* q = b_blk + 2 * t * b_stride + j * 8 + g;
    split_bf16x2(q[0], q[b_stride], b_big[j][0], b_small[j][0]);
    split_bf16x2(q[8 * b_stride], q[9 * b_stride], b_big[j][1], b_small[j][1]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* q = a_blk + 2 * t * a_stride + i * 16 + g;
    const float v[8] = {q[0],              q[a_stride],          q[8],
                        q[a_stride + 8],   q[8 * a_stride],      q[9 * a_stride],
                        q[8 * a_stride + 8], q[9 * a_stride + 8]};
    uint32_t a_big[4], a_small[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) split_bf16x2(v[2 * r], v[2 * r + 1], a_big[r], a_small[r]);
    if (nk_on) {
      nk[i][0] += (v[0] + v[1]) + (v[4] + v[5]);
      nk[i][1] += (v[2] + v[3]) + (v[6] + v[7]);
    }
    float part[NJ][4] = {};
    if (PREC == P_HIGH) {
      // The small terms first, the big product last.
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma_bf16(part[j], a_small, b_big[j]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma_bf16(part[j], a_big, b_small[j]);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma_bf16(part[j], a_big, b_big[j]);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int h = 0; h < 4; ++h) acc[i][j][h] += part[j][h];
  }
}

// The Nk column of a bf16 phase-3 tile: each lane's fp32 sums (see
// mma_stage_bf16) summed over the four lanes of its row group (xor
// butterflies, so all four hold the same bits), then written over the
// tensor cores' value of column `col` (0..7) of m8 tile `jn`.
template <int NJ>
__device__ __forceinline__ void put_nk(float (&acc)[4][NJ][4], float (&nk)[4][2],
                                       int jn, int col, int lane) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      nk[i][h] += __shfl_xor_sync(0xffffffffu, nk[i][h], 1);
      nk[i][h] += __shfl_xor_sync(0xffffffffu, nk[i][h], 2);
    }
  if (2 * (lane & 3) != (col & 6)) return;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (j == jn) {
        acc[i][j][col & 1] = nk[i][0];
        acc[i][j][2 + (col & 1)] = nk[i][1];
      }
}

// W is the column tile: NT (K_pad a multiple of 128, every mode and
// precision) or the narrow route's 16, 32 or 64 (K_pad = W; MODE_STATS at
// 'highest' only).
template <int MODE, bool DIAG, int MR, int PREC, int W = NT>
__global__ void __launch_bounds__(THREADS, stats_ctas(W))
fused_stats_kernel(const Params p) {
  constexpr bool NARROW = W < NT;
  static_assert(!NARROW || (MODE == MODE_STATS && PREC == P_HIGHEST),
                "the narrow route is K1/K3 at 'highest'");
  const int d = p.d, kp = NARROW ? W : p.kp, bt = p.bt, xstride = p.xstride;
  const int t = DIAG ? d : d * (d + 1) / 2;
  const int fd = t + d;                      // rows of A_ext
  const int fe = fd + 1;                     // columns of [x2 | x | 1]
  const int fe_pad = (fe + NT - 1) / NT * NT;
  constexpr bool BF = PREC != P_HIGHEST;     // bf16 passes on the tensor cores
  constexpr int RP = BF ? BPAD : PAD;        // fragment-row padding
  const int kps = kp + RP;                   // posterior row stride
  constexpr int AST = NARROW ? KC * W : STAGE;  // floats of one A_ext stage

  // Restart lane: its parameters and its slices of the partial buffers.
  const int lane_r = blockIdx.y;
  const float lane_w = p.lanes ? p.lanes[lane_r] : 1.f;
  if (lane_w == 0.f) return;  // frozen lane: the reduction writes zeros
  // The per-lane form: this lane's events and its own grid (K1's on them).
  const int n = p.lane_n ? p.lane_n[lane_r] : p.n;
  const int grid = p.lane_n ? lane_grid(n, bt, p.grid_cap) : (int)gridDim.x;
  if ((int)blockIdx.x >= grid) return;
  const float* __restrict__ x = p.x + lane_r * p.x_lane;
  const float* __restrict__ wt = p.wt ? p.wt + lane_r * p.wt_lane : nullptr;
  const float* __restrict__ a_ext = p.a_ext + (size_t)lane_r * fd * kp;
  const float* __restrict__ g = p.g + (size_t)lane_r * kp;

  // The narrow route runs MR-row passes only: a smaller event tile takes
  // one, its last rows padding.
  const int brows = NARROW && bt < MR ? MR : bt;  // rows of ws and xs
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [brows][kps] logp, then w
  float* as = ws + (size_t)brows * kps;         // [2][AST] A_ext stages [KC][AR]
  float* fs = as + 2 * AST;                     // [2][STAGE] feature stages:
                                                // [KC][FR] (phase 1), [KC][SR3] (3)
  float* xs = fs + 2 * STAGE;                   // [brows][xstride], col d = 1
  float* wts = xs + (size_t)brows * xstride;    // [bt] event weights (narrow)
  int* pairs = reinterpret_cast<int*>(wts + (NARROW ? bt : 0));  // [fe_pad]

  using L1 = Fma1<MR, W>;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tx = tid % L1::TX, ty = tid / L1::TX;  // phase 1: 16 x 16 threads (K1)
  const int wr = warp >> 2, wc = warp & 3;    // phase 3: this warp's tile
  const int lr = lane >> 2, lc = 2 * (lane & 3);  // its accumulators' row, column
  const int num_tiles = (n + bt - 1) / bt;
  float* my_partial = nullptr;
  if (MODE != MODE_LOCAL_LSE)
    my_partial = p.partial + ((size_t)lane_r * gridDim.x + blockIdx.x) * kp * fe;
  double warp_ll = 0.0;
  bool first = true;

  build_pairs<DIAG>(pairs, d, fe, fe_pad);
  PHASE_CLOCK_START

  for (int tile = blockIdx.x; tile < num_tiles; tile += grid) {
    const int64_t base = (int64_t)tile * bt;
    const int64_t left = n - base;
    const int rows = left < bt ? (int)left : bt;
    const int rows_r = (rows + MR - 1) / MR * MR;

    // Events of the tile, plus the constant-1 column; rows past n are 0.
    // They arrive asynchronously, all in flight at once; the narrow route
    // copies the weights too (its phase 2 reads them from shared memory).
    for (int e = tid; e < rows_r * d; e += THREADS) {
      const int r = e / d, c = e - r * d;
      cp_async4(xs + r * xstride + c, x + (base + (r < rows ? r : 0)) * d + c, r < rows);
    }
    if constexpr (NARROW)
      for (int r = tid; r < rows; r += THREADS) cp_async4(wts + r, wt + base + r, true);
    cp_async_commit();
    for (int r = tid; r < rows_r; r += THREADS) xs[r * xstride + d] = 1.f;
    cp_async_wait_all();
    __syncthreads();
    PHASE_CLOCK(0)

    // Phase 1: logp[r][k] = -0.5 * sum_c feat[r][c] * A_ext[c][k] + g[k].
    // HIGHEST: on the FMA units (8 x 8 outputs per thread, 4 x 8 for 64-row
    // tiles; the narrow route's layout is Fma1's). HIGH/DEFAULT: on the
    // tensor cores in bf16 (phase 3's 2 x 4 warp tiles of 64 x 32 outputs;
    // 1 x 8 of 64 x 16 for 64-row tiles). The A_ext stage [KC][W] arrives
    // by 16-byte cp.async; the feature stage [KC][MR] is computed from the
    // event tile, through registers.
    constexpr int DP = L1::DEPTH;            // rows of an A_ext and a feature stage
    constexpr int AQ = DP * W / 4;           // 16-byte copies of an A_ext stage
    constexpr int LA = (AQ + THREADS - 1) / THREADS, LF = DP * MR / THREADS;
    constexpr int AR = BF ? NT + BPAD : W;   // A_ext stage row stride
    constexpr int FR = BF ? MR + BPAD : MR;  // feature stage row stride
    constexpr int NJ1 = MR == 128 ? 4 : 2;   // bf16: m8 column tiles per warp
    const int s1 = (fd + DP - 1) / DP;
    for (int n0 = 0; n0 < rows_r; n0 += MR) {
      for (int k0 = 0; k0 < kp; k0 += NT) {
        float acc[MR / L1::TY][L1::NC] = {};  // FMA route
        float acc1[4][NJ1][4] = {};       // tensor-core route
        float no_nk[4][2] = {};           // phase 1 has no Nk column
        float rf[LF];
        // A_ext rows s*DP.. of columns k0.. into stage buf, 16 bytes per
        // copy; rows past fd are zero-filled.
        auto copy_a = [&](int s, int buf) {
#pragma unroll
          for (int it = 0; it < LA; ++it) {
            const int e = tid + it * THREADS, r = e / (W / 4), q = e % (W / 4);
            const int c = s * DP + r;
            if (AQ % THREADS == 0 || e < AQ)
              cp_async16(as + buf * AST + r * AR + q * 4,
                         a_ext + (size_t)(c < fd ? c : 0) * kp + k0 + q * 4, c < fd);
          }
          cp_async_commit();
        };
        auto load_f = [&](int s) {
#pragma unroll
          for (int it = 0; it < LF; ++it) {
            const int e = tid + it * THREADS, c = s * DP + e / MR;
            rf[it] = c < fd ? feature(xs + (n0 + e % MR) * xstride, pairs[c]) : 0.f;
          }
        };
        auto store_f = [&](int buf) {
#pragma unroll
          for (int it = 0; it < LF; ++it) {
            const int e = tid + it * THREADS;
            fs[buf * STAGE + (e / MR) * FR + e % MR] = rf[it];
          }
        };
        copy_a(0, 0);
        load_f(0);
        store_f(0);
        cp_async_wait_all();
        __syncthreads();
        for (int s = 0; s < s1; ++s) {
          const int buf = s & 1;
          if (s + 1 < s1) {
            copy_a(s + 1, buf ^ 1);
            load_f(s + 1);
          }
          if constexpr (!BF)
            fma_stage<MR, L1::NC, L1::TY, DP>(acc, fs + buf * STAGE, as + buf * AST, tx, ty);
          else if constexpr (MR == 128)
            mma_stage_bf16<NJ1, PREC>(acc1, fs + buf * STAGE + wr * 64, FR,
                                      as + buf * AST + wc * 32, AR, lane, false, no_nk);
          else
            mma_stage_bf16<NJ1, PREC>(acc1, fs + buf * STAGE, FR,
                                      as + buf * AST + warp * 16, AR, lane, false, no_nk);
          if (s + 1 < s1) store_f(buf ^ 1);
          cp_async_wait_all();
          __syncthreads();
        }
        if constexpr (BF) {
          // Accumulator h of tile (i, j): row lr (+8 for h >= 2), column
          // lc (+1 for odd h).
          const int r0 = n0 + (MR == 128 ? wr * 64 : 0) + lr;
          const int c1 = k0 + (MR == 128 ? wc * 32 : warp * 16) + lc;
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < NJ1; ++j)
#pragma unroll
              for (int h = 0; h < 4; ++h) {
                const int k = c1 + j * 8 + (h & 1);
                ws[(size_t)(r0 + i * 16 + (h >> 1) * 8) * kps + k] =
                    -0.5f * acc1[i][j][h] + g[k];
              }
        } else {
#pragma unroll
          for (int i = 0; i < MR / L1::TY; ++i)
#pragma unroll
            for (int j = 0; j < L1::NC; ++j) {
              const int k = k0 + own<L1::TX>(tx, j);
              ws[(size_t)(n0 + own<L1::TY>(ty, i)) * kps + k] = -0.5f * acc[i][j] + g[k];
            }
        }
      }
    }
    __syncthreads();
    PHASE_CLOCK(1)

    // Phase 2, per event row (one warp each; xor butterflies, so every
    // lane holds the same bits). K1/K3: log-sum-exp over all K, w = e/s *
    // wt in place. K5: this shard's max and shifted sum over its k real
    // columns, written out. K6: w = exp(logp - logZ) * wt in place.
    // At W = 16 a warp takes two of its rows at once, r0 and r0 + 8, one
    // per half-warp (lane l holds column l % 16): the warp's tree over 16
    // columns first adds the idle half's exact zeros (its max: NEG_LARGE),
    // so the half-warp's tree gives the same bits, and warp_ll still adds
    // the warp's rows in order.
    if constexpr (W == 16) {
      const int half = lane >> 4, hl = lane & 15;
      for (int r0 = warp; r0 < rows_r; r0 += 2 * (THREADS / 32)) {
        const int r = r0 + 8 * half;
        float* row = ws + (size_t)r * kps;
        const float v = row[hl];
        const float m = half_max(fmaxf(NEG_LARGE, v));
        const float e = expf(v - m);
        const float s = half_sum(0.f + e);
        const float w_ev = (r < rows ? wts[r] : 0.f) * lane_w;
        row[hl] = r < rows ? (e / s) * w_ev : 0.f;
        const float ll = (m + logf(s)) * w_ev;
        const float ll0 = __shfl_sync(0xffffffffu, ll, 0);
        const float ll1 = __shfl_sync(0xffffffffu, ll, 16);
        if (r0 < rows) warp_ll += (double)ll0;
        if (r0 + 8 < rows) warp_ll += (double)ll1;
      }
    } else
    for (int r = warp; r < rows_r; r += THREADS / 32) {
      float* row = ws + (size_t)r * kps;
      if (r >= rows) {
        if (MODE != MODE_LOCAL_LSE)
          for (int k = lane; k < kp; k += 32) row[k] = 0.f;
        continue;
      }
      if (MODE == MODE_LOCAL_LSE) {
        float m = __int_as_float(0xff800000);  // -inf
        for (int k = lane; k < p.k; k += 32) m = fmaxf(m, row[k]);
        m = warp_max(m);
        float s = 0.f;
        for (int k = lane; k < p.k; k += 32) s += expf(row[k] - m);
        s = warp_sum(s);
        if (lane == 0) {
          p.m_out[base + r] = m;
          p.s_out[base + r] = s;
        }
      } else if (MODE == MODE_STATS_LOGZ) {
        const float lz = p.logz[base + r];
        const float w_ev = wt[base + r];
        for (int k = lane; k < kp; k += 32) row[k] = expf(row[k] - lz) * w_ev;
        warp_ll += (double)(lz * w_ev);
      } else {
        float m = NEG_LARGE;
        for (int k = lane; k < kp; k += 32) m = fmaxf(m, row[k]);
        m = warp_max(m);  // NEG_LARGE floor: the all-masked guard
        float s = 0.f;
        for (int k = lane; k < kp; k += 32) s += expf(row[k] - m);
        s = warp_sum(s);
        const float w_ev = (NARROW ? wts[r] : wt[base + r]) * lane_w;
        for (int k = lane; k < kp; k += 32) row[k] = (expf(row[k] - m) / s) * w_ev;
        warp_ll += (double)((m + logf(s)) * w_ev);
      }
    }
    __syncthreads();
    PHASE_CLOCK(2)
    if (MODE == MODE_LOCAL_LSE) continue;  // K5 ends here

    // Phase 3: out[k][c] += sum_r w[r][k] * feat[r][c], this CTA's slice.
    // A = w^T, read in place from the posteriors [B_t][kps] (depth =
    // event), B = the feature stage [KC][SR3] (column = feature); a warp
    // owns 64 x 32 outputs (2 x 4 warps), on the narrow route W x 16 (1 x
    // 8, the shard kernel's layout: MI3 m16 tiles of W rows). In bf16 the
    // Nk column (fe - 1) is the fp32 sum of the w values, taken by the
    // warps that hold it.
    constexpr int L3 = KC * NT / THREADS;
    constexpr int SR3 = BF ? NT + BPAD : SROW;
    constexpr int MI3 = NARROW ? W / 16 : 4, NJ3 = NARROW ? 2 : 4;
    const int row3 = NARROW ? 0 : wr * 64, col3 = NARROW ? warp * 16 : wc * 32;
    const int s3 = (rows + KC - 1) / KC;
    const int nk_c = fe - 1;
    for (int k0 = 0; k0 < kp; k0 += NT) {
      for (int c0 = 0; c0 < fe_pad; c0 += NT) {
        float acc[MI3][NJ3][4] = {};
        float nk[4][2] = {};
        const bool nk_on = BF && c0 == nk_c / NT * NT && wc == nk_c % NT / 32;
        if constexpr (NARROW) {
          // Each feature of the tile is one lane's B element: the lane forms
          // it from the event tile where its fragment needs it (no stage,
          // no barrier).
          const int pr0 = pairs[c0 + col3 + lr], pr1 = pairs[c0 + col3 + 8 + lr];
          for (int s = 0; s < s3; ++s) {
            const float* xrow = xs + (size_t)s * KC * xstride;
            mma_core<NJ3, MI3>(acc, ws + (size_t)s * KC * kps, kps,
                               [=](int depth, int j) {
                                 return feature(xrow + depth * xstride, j ? pr1 : pr0);
                               },
                               lane);
          }
        } else {
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
            for (int it = 0; it < L3; ++it) {
              const int e = tid + it * THREADS;
              fs[buf * STAGE + (e / NT) * SR3 + e % NT] = rf[it];
            }
          };
          load(0);
          store(0);
          __syncthreads();
          for (int s = 0; s < s3; ++s) {
            if (s + 1 < s3) load(s + 1);
            if constexpr (BF)
              mma_stage_bf16<4, PREC>(acc, ws + (size_t)s * KC * kps + k0 + wr * 64, kps,
                                      fs + (s & 1) * STAGE + wc * 32, SR3, lane, nk_on, nk);
            else
              mma_stage<NJ3, MI3>(acc, ws + (size_t)s * KC * kps + k0 + row3, kps,
                                  fs + (s & 1) * STAGE + col3, SROW, lane);
            if (s + 1 < s3) store((s + 1) & 1);
            __syncthreads();
          }
        }
        if constexpr (BF)
          if (nk_on) put_nk(acc, nk, nk_c % 32 / 8, nk_c % 8, lane);
        PHASE_CLOCK(3)
        // Accumulator h of tile (i, j): row lr (+8 for h >= 2), column
        // lc (+1 for odd h). All of this thread's earlier sums are read
        // before any is written, so the loads overlap.
        if (!first) {
#pragma unroll
          for (int i = 0; i < MI3; ++i)
#pragma unroll
            for (int j = 0; j < NJ3; ++j)
#pragma unroll
              for (int h = 0; h < 4; ++h) {
                const int k = k0 + row3 + i * 16 + lr + (h >> 1) * 8;
                const int c = c0 + col3 + j * 8 + lc + (h & 1);
                if (c < fe) acc[i][j][h] += my_partial[(size_t)k * fe + c];
              }
        }
#pragma unroll
        for (int i = 0; i < MI3; ++i)
#pragma unroll
          for (int j = 0; j < NJ3; ++j)
#pragma unroll
            for (int h = 0; h < 4; ++h) {
              const int k = k0 + row3 + i * 16 + lr + (h >> 1) * 8;
              const int c = c0 + col3 + j * 8 + lc + (h & 1);
              if (c < fe) my_partial[(size_t)k * fe + c] = acc[i][j][h];
            }
        PHASE_CLOCK(4)
      }
    }
    first = false;
    __syncthreads();
    PHASE_CLOCK(4)
  }
  PHASE_CLOCK_END
  if (MODE == MODE_LOCAL_LSE) return;

  // This CTA's loglik: the 8 warp sums, in warp order.
  __shared__ double red[THREADS / 32];
  if (lane == 0) red[warp] = warp_ll;
  __syncthreads();
  if (tid == 0) {
    double s = 0.0;
    for (int w = 0; w < THREADS / 32; ++w) s += red[w];
    p.ll_part[(size_t)lane_r * gridDim.x + blockIdx.x] = s;
  }
}

// Sum each lane's G per-CTA slices in index order, in float64, and split
// [Nk | M1 | M2]; each packed M2 sum goes to both mirrored entries of the
// [K, D*D] output. blockIdx.y is the restart lane; a frozen lane gets zeros.
__global__ void reduce_partials(const float* __restrict__ partial,
                                const double* __restrict__ ll_part,
                                const float* __restrict__ lanes,
                                const int* __restrict__ lane_n, int bt,
                                int grid_cap, int grid, int k, int kp, int d,
                                int diag,
                                float* __restrict__ ll, float* __restrict__ nk,
                                float* __restrict__ m1, float* __restrict__ m2) {
  const int f = diag ? d : d * d;
  const int t = diag ? d : d * (d + 1) / 2;
  const int fe = t + d + 1;
  const int lane_r = blockIdx.y;
  const bool frozen = lanes && lanes[lane_r] == 0.f;
  partial += (size_t)lane_r * grid * kp * fe;
  ll_part += (size_t)lane_r * grid;
  // The slices lane r wrote: its own grid in the per-lane form.
  const int used = lane_n ? lane_grid(lane_n[lane_r], bt, grid_cap) : grid;
  ll += lane_r;
  nk += (size_t)lane_r * k;
  m1 += (size_t)lane_r * k * d;
  m2 += (size_t)lane_r * k * f;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx == 0) {
    double s = 0.0;
    if (!frozen)
      for (int b = 0; b < used; ++b) s += ll_part[b];
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
  if (!frozen)
    for (int b = 0; b < used; ++b) s += partial[((size_t)b * kp + kk) * fe + src];
  if (c < f) m2[(size_t)kk * f + c] = (float)s;
  else if (c < f + d) m1[(size_t)kk * d + c - f] = (float)s;
  else nk[kk] = (float)s;
}

// K5 and K6 on a shard of at most NS clusters: one NS-wide column tile,
// SR-event tiles. Phase 1 is K1's SIMT product at this width: thread
// (tx, ty) holds rows own(ty, i), i < 8, and columns tx*4 + j, j < 4, so
// the NS columns of a row sit in the 16 threads of one half-warp. The
// per-row reduction (phase 2 of K1's kernel) is done in phase 1's
// registers: 4-step xor shuffles inside the half-warp, no logp buffer, no
// second pass over shared memory.
//  * K5: m = max over the real columns (< k) and s = sum exp(logp - m)
//    over the same; lane tx = i of the half-warp writes row own(ty, i).
//  * K6: w = exp(logp - logZ) * wt into the [SR][KPS] posterior buffer
//    (0 for padding columns and rows past n, with no expf), logZ * wt
//    into the float64 loglik of lane tx = 0, row by row; then phase 3 at
//    this width, K_pad = 64 rows of statistics against 128-wide feature
//    tiles, its 8 warps side by side (1 x 8 warp tiles of 64 x 16 outputs).
// Shared memory: the A_ext and feature stages and the event tile; K6 adds
// the posterior buffer. The kernels are compiled for K5_CTAS / K6_CTAS
// CTAs per SM (the registers each thread may use follow from that).
constexpr int NS = 64;            // shard tile width: K_pad of a shard of <= 64
constexpr int SR = 128;           // events per tile (B_t)
constexpr int KPS = NS + PAD;     // posterior row stride: 72 = 8 (mod 32)
constexpr int K5_CTAS = 3, K6_CTAS = 2;

template <int MODE, bool DIAG>
__global__ void __launch_bounds__(THREADS, MODE == MODE_LOCAL_LSE ? K5_CTAS : K6_CTAS)
shard_kernel(const Params p) {
  constexpr bool STATS = MODE == MODE_STATS_LOGZ;
  const int n = p.n, d = p.d, k = p.k, xstride = p.xstride;
  const float* __restrict__ x = p.x;
  const float* __restrict__ a_ext = p.a_ext;
  const int t = DIAG ? d : d * (d + 1) / 2;
  const int fd = t + d;                      // rows of A_ext
  const int fe = fd + 1;                     // columns of [x2 | x | 1]
  const int fe_pad = (fe + NT - 1) / NT * NT;

  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // K6: [SR][KPS] posteriors
  float* as = ws + (STATS ? SR * KPS : 0);      // [2][KC][NS] A_ext stages
  float* fs = as + 2 * KC * NS;                 // [2][STAGE] feature stages:
                                                // [KC][SR] (phase 1), [KC][SROW] (3)
  float* xs = fs + 2 * STAGE;                   // [SR][xstride], col d = 1
  int* pairs = reinterpret_cast<int*>(xs + SR * xstride);  // [fe_pad]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;     // phase 1: 16 x 16 threads
  const int lr = lane >> 2, lc = 2 * (lane & 3);  // phase 3 accumulators' row, column
  const int num_tiles = (n + SR - 1) / SR;
  float* my_partial = STATS ? p.partial + (size_t)blockIdx.x * NS * fe : nullptr;
  // K6's loglik: slot ty is lane tx = 0's running float64 sum of its rows.
  __shared__ double red[THREADS / 16];
  if (tid < THREADS / 16) red[tid] = 0.0;
  bool first = true;

  build_pairs<DIAG>(pairs, d, fe, fe_pad);
  PHASE_CLOCK_START

  for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int64_t base = (int64_t)tile * SR;
    const int64_t left = n - base;
    const int rows = left < SR ? (int)left : SR;

    // Events of the tile, plus the constant-1 column; rows past n are 0.
    for (int e = tid; e < SR * (d + 1); e += THREADS) {
      const int r = e / (d + 1), c = e % (d + 1);
      float v = 1.f;
      if (c < d) v = r < rows ? x[(base + r) * d + c] : 0.f;
      xs[r * xstride + c] = v;
    }
    __syncthreads();
    PHASE_CLOCK(0)

    // Phase 1: logp[r][k] = -0.5 * sum_c feat[r][c] * A_ext[c][k] + g[k],
    // 8 x 4 outputs per thread. One 16-byte cp.async per thread brings an
    // A_ext stage [KC][NS]; the feature stage [KC][SR] is computed from
    // the event tile, through registers.
    constexpr int LF = KC * SR / THREADS;
    static_assert(KC * NS / 4 == THREADS, "one A_ext copy per thread and stage");
    const int s1 = (fd + KC - 1) / KC;
    float acc[SR / 16][4] = {};
    float rf[LF];
    auto copy_a = [&](int s, int buf) {
      const int r = tid / (NS / 4), q = tid % (NS / 4);
      const int c = s * KC + r;
      cp_async16(as + buf * KC * NS + r * NS + q * 4,
                 a_ext + (size_t)(c < fd ? c : 0) * NS + q * 4, c < fd);
      cp_async_commit();
    };
    auto load_f = [&](int s) {
#pragma unroll
      for (int it = 0; it < LF; ++it) {
        const int e = tid + it * THREADS, c = s * KC + e / SR;
        rf[it] = c < fd ? feature(xs + (e % SR) * xstride, pairs[c]) : 0.f;
      }
    };
    auto store_f = [&](int buf) {
#pragma unroll
      for (int it = 0; it < LF; ++it) fs[buf * STAGE + tid + it * THREADS] = rf[it];
    };
    copy_a(0, 0);
    load_f(0);
    store_f(0);
    cp_async_wait_all();
    __syncthreads();
    for (int s = 0; s < s1; ++s) {
      const int buf = s & 1;
      if (s + 1 < s1) {
        copy_a(s + 1, buf ^ 1);
        load_f(s + 1);
      }
      fma_stage<SR, 4>(acc, fs + buf * STAGE, as + buf * KC * NS, tx, ty);
      if (s + 1 < s1) store_f(buf ^ 1);
      cp_async_wait_all();
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float gk = p.g[tx * 4 + j];  // NEG_LARGE on padding columns
#pragma unroll
      for (int i = 0; i < SR / 16; ++i) acc[i][j] = -0.5f * acc[i][j] + gk;
    }
    PHASE_CLOCK(1)

    if constexpr (!STATS) {
      // Phase 2 in registers: this shard's max and shifted sum over its k
      // real columns; all 16 lanes of the half-warp end with the same bits.
      float my_m = 0.f, my_s = 0.f;
#pragma unroll
      for (int i = 0; i < SR / 16; ++i) {
        float m = __int_as_float(0xff800000);  // -inf
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (tx * 4 + j < k) m = fmaxf(m, acc[i][j]);
        m = half_max(m);
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (tx * 4 + j < k) s += expf(acc[i][j] - m);
        s = half_sum(s);
        if (i == tx) {
          my_m = m;
          my_s = s;
        }
      }
      if (tx < SR / 16) {
        const int r = own(ty, tx);
        if (r < rows) {
          p.m_out[base + r] = my_m;
          p.s_out[base + r] = my_s;
        }
      }
      PHASE_CLOCK(2)  // K5 ends here
    } else {
      // Phase 2 in registers (K6): w = exp(logp - logZ) * wt into the
      // posterior buffer; lane tx = 0 adds logZ * wt of its rows, in order.
#pragma unroll
      for (int i = 0; i < SR / 16; ++i) {
        const int r = own(ty, i);
        const bool real = r < rows;
        const float lz = real ? p.logz[base + r] : 0.f;
        const float w_ev = real ? p.wt[base + r] : 0.f;
        float w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          w[j] = real && tx * 4 + j < k ? expf(acc[i][j] - lz) * w_ev : 0.f;
        *reinterpret_cast<float4*>(ws + r * KPS + tx * 4) = make_float4(w[0], w[1], w[2], w[3]);
        if (tx == 0 && real) red[ty] += (double)(lz * w_ev);
      }
      __syncthreads();
      PHASE_CLOCK(2)

      // Phase 3: out[k][c] += sum_r w[r][k] * feat[r][c], this CTA's slice;
      // A = w^T in place from the posteriors (all NS rows in every warp),
      // B = the feature stage [KC][SROW]; warp w owns columns w*16 .. +15.
      constexpr int L3 = KC * NT / THREADS;
      const int s3 = (rows + KC - 1) / KC;
      for (int c0 = 0; c0 < fe_pad; c0 += NT) {
        float acc3[4][2][4] = {};
        float rf3[L3];
        auto load = [&](int s) {
#pragma unroll
          for (int it = 0; it < L3; ++it) {
            const int e = tid + it * THREADS;
            rf3[it] = feature(xs + (s * KC + e / NT) * xstride, pairs[c0 + e % NT]);
          }
        };
        auto store = [&](int buf) {
#pragma unroll
          for (int it = 0; it < L3; ++it) {
            const int e = tid + it * THREADS;
            fs[buf * STAGE + (e / NT) * SROW + e % NT] = rf3[it];
          }
        };
        load(0);
        store(0);
        __syncthreads();
        for (int s = 0; s < s3; ++s) {
          if (s + 1 < s3) load(s + 1);
          mma_stage<2>(acc3, ws + (size_t)s * KC * KPS, KPS,
                       fs + (s & 1) * STAGE + warp * 16, SROW, lane);
          if (s + 1 < s3) store((s + 1) & 1);
          __syncthreads();
        }
        PHASE_CLOCK(3)
        // Accumulator h of tile (i, j): row lr (+8 for h >= 2), column
        // lc (+1 for odd h).
        if (!first) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int h = 0; h < 4; ++h) {
                const int kk = i * 16 + lr + (h >> 1) * 8;
                const int c = c0 + warp * 16 + j * 8 + lc + (h & 1);
                if (c < fe) acc3[i][j][h] += my_partial[(size_t)kk * fe + c];
              }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int h = 0; h < 4; ++h) {
              const int kk = i * 16 + lr + (h >> 1) * 8;
              const int c = c0 + warp * 16 + j * 8 + lc + (h & 1);
              if (c < fe) my_partial[(size_t)kk * fe + c] = acc3[i][j][h];
            }
        PHASE_CLOCK(4)
      }
      first = false;
      __syncthreads();
      PHASE_CLOCK(4)
    }
  }
  PHASE_CLOCK_END
  if (!STATS) return;

  // This CTA's loglik: the 16 row-owning lanes' sums, in ty order.
  __syncthreads();
  if (tid == 0) {
    double s = 0.0;
    for (int i = 0; i < THREADS / 16; ++i) s += red[i];
    p.ll_part[blockIdx.x] = s;
  }
}

// Launches fused_stats_kernel, or (ctas != null) only reports how many of
// its CTAs fit on one SM from its registers and shared memory. The narrow
// route asks for the largest shared-memory carveout, so that its CTAs per
// SM fit.
template <int MODE, bool DIAG, int MR, int PREC, int W = NT>
cudaError_t launch(const Params& p, int grid, int r, size_t smem, cudaStream_t s,
                   int* ctas = nullptr) {
  auto kern = fused_stats_kernel<MODE, DIAG, MR, PREC, W>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && W < NT)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  if (ctas) return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kern, THREADS, smem);
  kern<<<dim3(grid, r), THREADS, smem, s>>>(p);
  return cudaGetLastError();
}

template <int MODE, int PREC = P_HIGHEST>
cudaError_t launch_mode(const Params& p, int diag, int grid, int r, size_t smem,
                        cudaStream_t s) {
  if (p.bt % 128 == 0)
    return diag ? launch<MODE, true, 128, PREC>(p, grid, r, smem, s)
                : launch<MODE, false, 128, PREC>(p, grid, r, smem, s);
  return diag ? launch<MODE, true, 64, PREC>(p, grid, r, smem, s)
              : launch<MODE, false, 64, PREC>(p, grid, r, smem, s);
}

// K1/K3 on the narrow route, at K_pad = W, on stats_rows(W)-row passes for
// every bt.
template <int W>
cudaError_t launch_narrow(const Params& p, int diag, int grid, int r, size_t smem,
                          cudaStream_t s, int* ctas) {
  constexpr int MR = stats_rows(W);
  return diag ? launch<MODE_STATS, true, MR, P_HIGHEST, W>(p, grid, r, smem, s, ctas)
              : launch<MODE_STATS, false, MR, P_HIGHEST, W>(p, grid, r, smem, s, ctas);
}

cudaError_t launch_width(const Params& p, int diag, int grid, int r, size_t smem,
                         cudaStream_t s, int* ctas = nullptr) {
  return p.kp == 16   ? launch_narrow<16>(p, diag, grid, r, smem, s, ctas)
         : p.kp == 32 ? launch_narrow<32>(p, diag, grid, r, smem, s, ctas)
                      : launch_narrow<64>(p, diag, grid, r, smem, s, ctas);
}

// Whether kp selects the narrow route: 16, 32 or 64.
bool narrow_kp(int kp) { return kp == 16 || kp == 32 || kp == 64; }

// Dynamic shared memory of K1's kernel: the [bt][kp + PAD] posteriors, two
// A_ext stages ([KC][kp] on the narrow route), two feature stages, the
// event tile (on the narrow route with its [bt] weights, and at least a
// phase-1 pass of rows in both) and the pair table.
size_t stats_smem(int kp, int bt, int d, int diag) {
  const int t = diag ? d : d * (d + 1) / 2;
  const int fe_pad = (t + d + 1 + NT - 1) / NT * NT;
  const bool narrow = narrow_kp(kp);
  const size_t ast = narrow ? (size_t)KC * kp : STAGE;
  const size_t rows = narrow && bt < stats_rows(kp) ? stats_rows(kp) : bt;
  return (rows * (kp + PAD) + 2 * ast + 2 * STAGE + rows * ((d + 1) | 1) +
          (narrow ? bt : 0)) * sizeof(float) + fe_pad * sizeof(int);
}

// The reduction of the r lanes' per-CTA partials into ll/nk/m1/m2.
int launch_reduce(const Params& p, float* ll, float* nk, float* m1, float* m2,
                  int diag, int grid, int r, cudaStream_t s) {
  const int d = p.d;
  const int f = diag ? d : d * d;
  const int64_t outs = (int64_t)p.k * (f + d + 1);
  reduce_partials<<<dim3((unsigned)((outs + 255) / 256), r), 256, 0, s>>>(
      p.partial, p.ll_part, p.lanes, p.lane_n, p.bt, p.grid_cap, grid, p.k, p.kp,
      d, diag, ll, nk, m1, m2);
  return (int)cudaGetLastError();
}

// The statistics kernel of `mode` on `s`, then (K1/K3/K6) the reduction.
// Every mode takes every precision: K1/K3 (MODE_STATS), and K5/K6 on this
// kernel, which is their route at 'high' and 'default' for any shard width
// (the shard kernel is 'highest' only).
template <int MODE>
cudaError_t launch_prec(const Params& p, int diag, int grid, int r, size_t smem,
                        cudaStream_t s, int prec) {
  return prec == P_HIGH      ? launch_mode<MODE, P_HIGH>(p, diag, grid, r, smem, s)
         : prec == P_DEFAULT ? launch_mode<MODE, P_DEFAULT>(p, diag, grid, r, smem, s)
                             : launch_mode<MODE>(p, diag, grid, r, smem, s);
}

// kp a multiple of NT runs the 128-wide tiles (every mode and precision);
// kp = 16, 32 or 64 the narrow route (MODE_STATS at 'highest' only).
int run(int mode, Params p, float* ll, float* nk, float* m1, float* m2,
        int diag, int grid, int r, cudaStream_t s, int prec = P_HIGHEST) {
  const bool narrow = narrow_kp(p.kp);
  if (prec < P_HIGHEST || prec > P_DEFAULT ||
      (narrow ? mode != MODE_STATS || prec != P_HIGHEST || p.k > p.kp : p.kp % NT != 0))
    return (int)cudaErrorInvalidValue;
  p.xstride = (p.d + 1) | 1;  // odd row stride: no bank conflicts
  const size_t smem = stats_smem(p.kp, p.bt, p.d, diag);
  cudaError_t err =
      narrow                    ? launch_width(p, diag, grid, r, smem, s)
      : mode == MODE_LOCAL_LSE  ? launch_prec<MODE_LOCAL_LSE>(p, diag, grid, r, smem, s, prec)
      : mode == MODE_STATS_LOGZ ? launch_prec<MODE_STATS_LOGZ>(p, diag, grid, r, smem, s, prec)
                                : launch_prec<MODE_STATS>(p, diag, grid, r, smem, s, prec);
  if (err != cudaSuccess || mode == MODE_LOCAL_LSE) return (int)err;
  return launch_reduce(p, ll, nk, m1, m2, diag, grid, r, s);
}

// Dynamic shared memory of the shard kernel (K6 adds the posterior buffer).
size_t shard_smem(int mode, int d, int diag) {
  const int t = diag ? d : d * (d + 1) / 2;
  const int fe_pad = (t + d + 1 + NT - 1) / NT * NT;
  return ((mode == MODE_STATS_LOGZ ? (size_t)SR * KPS : 0) + 2 * KC * NS + 2 * STAGE +
          (size_t)SR * ((d + 1) | 1)) * sizeof(float) + fe_pad * sizeof(int);
}

// Launches the shard kernel, or (ctas != null) only reports how many of its
// CTAs fit on one SM from its registers and shared memory.
template <int MODE, bool DIAG>
cudaError_t launch_shard(const Params& p, int grid, size_t smem, cudaStream_t s,
                         int* ctas) {
  auto kern = shard_kernel<MODE, DIAG>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  if (ctas) return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kern, THREADS, smem);
  kern<<<grid, THREADS, smem, s>>>(p);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_shard_mode(const Params& p, int diag, int grid, size_t smem,
                              cudaStream_t s, int* ctas) {
  return diag ? launch_shard<MODE, true>(p, grid, smem, s, ctas)
              : launch_shard<MODE, false>(p, grid, smem, s, ctas);
}

// K5 or K6 on one cluster shard at precision `prec`. At 'highest' a shard
// of at most NS clusters (kp == NS) runs the shard kernel on SR-event
// tiles; a wider one (kp a multiple of NT, e.g. K_s = 65 or 130) runs K1's
// kernel in that mode, with phase 2 as a pass over the logp buffer in
// shared memory. At 'high' and 'default' every shard runs K1's kernel (kp a
// multiple of NT, K_s <= 64 included): its bf16 phase 1 is K1's. The
// caller picks the route: kp, bt and grid come from the wrapper's tile.
int run_shard(int mode, Params p, float* ll, float* nk, float* m1, float* m2,
              int diag, int grid, cudaStream_t s, int prec) {
  if (p.kp != NS || prec != P_HIGHEST)
    return run(mode, p, ll, nk, m1, m2, diag, grid, 1, s, prec);
  if (p.bt != SR || p.k > NS) return (int)cudaErrorInvalidValue;
  p.xstride = (p.d + 1) | 1;  // odd row stride: no bank conflicts
  const size_t smem = shard_smem(mode, p.d, diag);
  cudaError_t err =
      mode == MODE_LOCAL_LSE
          ? launch_shard_mode<MODE_LOCAL_LSE>(p, diag, grid, smem, s, nullptr)
          : launch_shard_mode<MODE_STATS_LOGZ>(p, diag, grid, smem, s, nullptr);
  if (err != cudaSuccess || mode == MODE_LOCAL_LSE) return (int)err;
  return launch_reduce(p, ll, nk, m1, m2, diag, grid, 1, s);
}

Params params(const float* x, const float* wt, const float* lanes,
              const float* logz, const float* a_ext, const float* g,
              float* m_out, float* s_out, float* partial, double* ll_part,
              int n, int d, int k, int kp, int bt) {
  Params p;
  p.x = x; p.wt = wt; p.lanes = lanes; p.logz = logz; p.a_ext = a_ext; p.g = g;
  p.m_out = m_out; p.s_out = s_out; p.partial = partial; p.ll_part = ll_part;
  p.n = n; p.d = d; p.k = k; p.kp = kp; p.bt = bt; p.xstride = 0;
  p.lane_n = nullptr; p.x_lane = 0; p.wt_lane = 0; p.grid_cap = 0;
  return p;
}

}  // namespace

// Launches K1 (both kernels) on `stream`; returns cudaGetLastError().
// Shapes: x [n, d], wt [n], a_ext [t+d, kp] (t = D(D+1)/2, or d in diag
// mode), g [kp], partial [grid, kp, t+d+1], ll_part [grid] (float64),
// ll [1], nk [k], m1 [k, d], m2 [k, f] with f = diag ? d : d*d. kp is a
// multiple of 128, or at prec 0 16, 32 or 64 (the narrow route, k <= kp);
// bt a multiple of 128, or 64 (then the 64-row tiles are used). prec: 0
// 'highest', 1 'high', 2 'default'.
extern "C" int gmm_fused_stats(const float* x, const float* wt, const float* a_ext,
                               const float* g, float* partial, double* ll_part,
                               float* ll, float* nk, float* m1, float* m2, int n,
                               int d, int k, int kp, int diag, int bt, int grid,
                               int prec, void* stream) {
  return run(MODE_STATS,
             params(x, wt, nullptr, nullptr, a_ext, g, nullptr, nullptr,
                    partial, ll_part, n, d, k, kp, bt),
             ll, nk, m1, m2, diag, grid, 1, static_cast<cudaStream_t>(stream), prec);
}

// Launches K3 (both kernels) on `stream`; returns cudaGetLastError().
// K1's shapes with a leading restart axis r on every per-lane array:
// lanes [r] (0 = frozen lane), a_ext [r, t+d, kp], g [r, kp],
// partial [r, grid, kp, t+d+1], ll_part [r, grid], ll [r], nk [r, k],
// m1 [r, k, d], m2 [r, k, f]. x and wt are shared by every lane; kp and
// prec as for K1.
extern "C" int gmm_fused_stats_batched(const float* x, const float* wt,
                                       const float* lanes, const float* a_ext,
                                       const float* g, float* partial,
                                       double* ll_part, float* ll, float* nk,
                                       float* m1, float* m2, int n, int d, int k,
                                       int kp, int diag, int bt, int grid, int r,
                                       int prec, void* stream) {
  return run(MODE_STATS,
             params(x, wt, lanes, nullptr, a_ext, g, nullptr, nullptr, partial,
                    ll_part, n, d, k, kp, bt),
             ll, nk, m1, m2, diag, grid, r, static_cast<cudaStream_t>(stream), prec);
}

// Launches K3's per-lane-events form (both kernels) on `stream`; returns
// cudaGetLastError(). K3's shapes, but lane r reads its own events:
// x [r, n_pad, d] and wt [r, n_pad] (lane r's flattened chunk grid), of
// which its first lane_n[r] rows (int32 [r], on the device, 1 <= n_r <=
// n_pad) are real. grid must be at least every lane's grid min(ceil(n_r /
// bt), grid_cap); partial [r, grid, kp, t+d+1], ll_part [r, grid]. grid_cap
// is K1's grid bound (132), so lane r reduces exactly as K1 on its n_r rows;
// kp and prec as for K1.
extern "C" int gmm_fused_stats_fleet(const float* x, const float* wt,
                                     const int* lane_n, const float* lanes,
                                     const float* a_ext, const float* g,
                                     float* partial, double* ll_part, float* ll,
                                     float* nk, float* m1, float* m2, int n_pad,
                                     int d, int k, int kp, int diag, int bt,
                                     int grid, int grid_cap, int r, int prec,
                                     void* stream) {
  if (grid_cap < 1 || grid < 1) return (int)cudaErrorInvalidValue;
  Params p = params(x, wt, lanes, nullptr, a_ext, g, nullptr, nullptr, partial,
                    ll_part, n_pad, d, k, kp, bt);
  p.lane_n = lane_n;
  p.x_lane = (int64_t)n_pad * d;
  p.wt_lane = n_pad;
  p.grid_cap = grid_cap;
  return run(MODE_STATS, p, ll, nk, m1, m2, diag, grid, r,
             static_cast<cudaStream_t>(stream), prec);
}

#ifdef GMM_PHASE_CLOCKS
// Copies the phase cycles summed since the last call into out[PHASES] and
// zeroes them; returns the CUDA error.
extern "C" int gmm_phase_cycles(unsigned long long* out) {
  static const unsigned long long zero[PHASES] = {};
  cudaError_t err = cudaMemcpyFromSymbol(out, phase_cycles, sizeof(phase_cycles));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(phase_cycles, zero, sizeof(zero));
  return (int)err;
}
#endif

// Launches K5 on `stream`; returns cudaGetLastError(). K1's x, a_ext and g
// for this shard's k clusters, padded to kp: at prec 0 ('highest') 64 (the
// shard kernel, bt = 128, grid up to 132 x K5_CTAS) when k <= 64, else a
// multiple of 128 (K1's kernel and tile); at prec 1 'high' / 2 'default'
// always a multiple of 128 (K1's kernel). m [n] and s [n] out.
extern "C" int gmm_local_lse(const float* x, const float* a_ext, const float* g,
                             float* m, float* s, int n, int d, int k, int kp,
                             int diag, int bt, int grid, int prec, void* stream) {
  return run_shard(MODE_LOCAL_LSE,
                   params(x, nullptr, nullptr, nullptr, a_ext, g, m, s, nullptr,
                          nullptr, n, d, k, kp, bt),
                   nullptr, nullptr, nullptr, nullptr, diag, grid,
                   static_cast<cudaStream_t>(stream), prec);
}

// Launches K6 (both kernels) on `stream`; returns cudaGetLastError(). K1's
// operands and outputs, plus logz [n], the global per-event evidence; kp,
// bt, grid (up to 132 x K6_CTAS on the shard kernel) and prec as for K5.
extern "C" int gmm_stats_logz(const float* x, const float* wt, const float* logz,
                              const float* a_ext, const float* g, float* partial,
                              double* ll_part, float* ll, float* nk, float* m1,
                              float* m2, int n, int d, int k, int kp, int diag,
                              int bt, int grid, int prec, void* stream) {
  return run_shard(MODE_STATS_LOGZ,
                   params(x, wt, nullptr, logz, a_ext, g, nullptr, nullptr, partial,
                          ll_part, n, d, k, kp, bt),
                   ll, nk, m1, m2, diag, grid, static_cast<cudaStream_t>(stream), prec);
}

// How many CTAs of the shard kernel of `mode` (1 = K5, 2 = K6) fit on one
// SM at dimension d, from its registers and shared memory (the card's own
// occupancy calculator), into *ctas; returns the CUDA error.
extern "C" int gmm_shard_occupancy(int mode, int d, int diag, int* ctas) {
  const Params p = params(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                          nullptr, nullptr, nullptr, nullptr, 0, d, 0, NS, SR);
  const size_t smem = shard_smem(mode, d, diag);
  return (int)(mode == MODE_LOCAL_LSE
                   ? launch_shard_mode<MODE_LOCAL_LSE>(p, diag, 0, smem, nullptr, ctas)
                   : launch_shard_mode<MODE_STATS_LOGZ>(p, diag, 0, smem, nullptr, ctas));
}

// How many CTAs of K1's kernel on the narrow route (kp = 16, 32 or 64, at
// 'highest') fit on one SM at dimension d and event tile bt, from its
// registers and shared memory (the card's own occupancy calculator), into
// *ctas; returns the CUDA error.
extern "C" int gmm_stats_occupancy(int kp, int d, int diag, int bt, int* ctas) {
  if (!narrow_kp(kp) || bt % 64 != 0) return (int)cudaErrorInvalidValue;
  const Params p = params(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                          nullptr, nullptr, nullptr, nullptr, 0, d, 0, kp, bt);
  return (int)launch_width(p, diag, 0, 1, stats_smem(kp, bt, d, diag), nullptr, ctas);
}
