// K13 as it was without the AM loop's carry step (K5 launched after it),
// for probes/k1am_k5_variants.py.
//
// K13: the AM sync block — sideband combine, reference bits, PIDS and
// partition training mults, sample-clock regression, interpolated
// equalizer and the QAM64/QAM16/QPSK Gray demaps, MA1 and MA3.
//
// Replaces the JAX device function
// nrsc5_tpu/pipeline/scan_chain_am_rc.py:143 sync_am_block_rc (with the
// tables and demaps of nrsc5_tpu/ops/sync_am.py:35-82, the interpolated
// equalizer AM_EQ_INTERP on), for all stations of a dispatch at once.
//
// spectra [S, 32, 256, 2] f32 (fftshifted, bin 128 the carrier) ->
//   codes [S, 4, 800] uint8 (pl, pu, s, t in (symbol, column) order),
//   pids [S, 32, 2] uint8, ref_bits [S, 32] uint8, samperr [S] int32.
// In order: the lower sideband (bins 128-81..128-1) negate-conjugated; in
// MA1 bins 128+1..128+53 add their mirror.  ref_bits = Im(bin 129) > 0.  A
// PIDS column's mult = 2*TRAIN_QAM16 / (row 8 + row 24) and a partition
// column's = 2*nominal / (row TRAIN1 + row TRAIN2), true divisions.
// samperr = round((sum wrap_half_pi(d arg pl) + sum wrap_half_pi(d arg pu))
// / 48 * 256 / 2pi), half to even.  Per partition the anchors lo = row
// min(TRAIN1, TRAIN2) and hi = 16 rows later give dphi = wrap_pi(arg lo -
// arg hi) and w = sqrt(|lo|^2 |hi|^2) + 1e-12; a w-weighted linear fit
// over the 25 columns gives fit(col), and symbol row r is equalized by
// mult * e^{i u fit}, u = (r - a_lo - 8) / 16, then demapped.  Every sum
// runs from the first column to the last, as the plain version's do; the
// build passes -fmad=false.
//
// Bound on the H100: device-memory bytes.  A block at 16 stations reads
// 1.05 MB of spectra and writes 53 KB (3200 codes, 64 PIDS codes, 32
// reference bits and a 4-byte samperr a station; about 0.00033 ms at 3.35
// TB/s); the arithmetic (~3200 equalized values a station, each a sincos
// and a few products) is far under the card's f32 rate, so the kernel is
// bound by its latency: a load, the fit's chain, then the codes.  Design: four
// CTAs a station, one a partition, each loading only the bins it reads
// (its partition's 25 columns, in MA1 with their mirrors) and the extras
// the host's plan (scan_chain_am_rc.sync_am_plan, passed by value) gives
// it: one PIDS column, the reference bin, or the other primary
// partition's training rows, whose mults the samperr CTA forms again
// itself (the same arithmetic, so the same bits) instead of reading them
// from a peer.  So the CTAs of a station share nothing and need no
// cluster.  In each (1024 threads): warps 2.. load the partition's values
// into shared memory; meanwhile, each from its own loads, warp 0 forms the
// 25 columns' anchors and the fit, a lane a column, its ordered sums over
// lanes 0 to 24 in turn through shared memory, warp 2 the mults, warp 3
// the PIDS codes and the reference bits; then, after one barrier of every
// warp but warp 1, a thread per output code.  Warp 1 of the samperr CTA
// forms samperr from its own loads beside all that, sharing no barrier.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FFT = 256;
constexpr int NSYM = 32;
constexpr int W = 25;
constexpr int C = FFT / 2;
constexpr int MAX_INDEX = 81;
constexpr int PIDS_OUTER = 53;
constexpr int THREADS = 1024;  // at least 128, a multiple of 32
constexpr float PI = 3.141592653589793f;
constexpr float TWO_PI = 6.283185307179586f;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

// a / b as mul_conj(a, b) / |b|^2
__device__ __forceinline__ float2 cdiv(float2 a, float2 b) {
  const float d = b.x * b.x + b.y * b.y;
  return make_float2((a.x * b.x + a.y * b.y) / d, (a.y * b.x - a.x * b.y) / d);
}

__device__ __forceinline__ float abs2(float2 a) { return a.x * a.x + a.y * a.y; }

__device__ __forceinline__ float wrap_half_pi(float d) {
  return d - PI * rintf(d / PI);
}

__device__ __forceinline__ float wrap_pi(float d) {
  return d - TWO_PI * rintf(d / TWO_PI);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Gray demap: QAM64 (levels 8), QAM16 (4) or the QPSK signs (2).  The
// Gray tables (0,4,6,2,3,7,5,1 and 0,2,3,1) are packed into integers so
// that no table lives in local memory
__device__ __forceinline__ uint8_t demap(float2 z, int levels) {
  if (levels == 2) return (uint8_t)((z.x >= 0.0f) | ((z.y >= 0.0f) << 1));
  const int half = levels / 2;
  const int re = clampi((int)floorf(z.x) + half, 0, levels - 1);
  const int im = clampi((int)floorf(z.y) + half, 0, levels - 1);
  if (levels == 8) {
    constexpr unsigned G8 = 0x15732640u;  // nibble i = GRAY8[i]
    return (uint8_t)(((G8 >> (4 * re)) & 7) | (((G8 >> (4 * im)) & 7) << 3));
  }
  constexpr unsigned G4 = 0x78u;  // 2-bit field i = GRAY4[i]
  return (uint8_t)(((G4 >> (2 * re)) & 3) | (((G4 >> (2 * im)) & 3) << 2));
}

// The plan of one station's four CTAs (one a partition, in output order
// pl, pu, s, t), PLAN_INTS ints each: the partition's first bin, bin step,
// levels and 2x its training point (re, im); the PIDS bin it demaps (-1:
// none) and that column's index k; whether it writes the reference bits;
// the other primary partition's first bin (-1: this CTA forms no samperr),
// step and 2x training point.
constexpr int PLAN_INTS = 12;
struct Plan {
  int v[4][PLAN_INTS];
};

// entry i of CTA p's row, by constant offsets into the parameter space
__device__ __forceinline__ int plan_at(const Plan& plan, int p, int i) {
  return p == 0 ? plan.v[0][i]
         : p == 1 ? plan.v[1][i]
         : p == 2 ? plan.v[2][i]
                  : plan.v[3][i];
}

// bin b of symbol row r as the sync block sees it: the lower sideband
// (bins 128-81..128-1) negate-conjugated, and in MA1 bins 128+1..128+53
// with their mirror added.  Both loads are issued at once (the mirror's
// bin lies in the block whichever b is read), so that a value costs one
// latency
__device__ __forceinline__ float2 bin_value(const float2* in, int r, int b,
                                            int ma3) {
  float2 v = in[r * FFT + b];
  float2 m = in[r * FFT + 2 * C - b];
  if (b >= C - MAX_INDEX && b <= C - 1) v.x = -v.x;  // -conj(v)
  if (!ma3 && b >= C + 1 && b <= C + PIDS_OUTER) {
    m.x = -m.x;
    v = cadd(v, m);
  }
  return v;
}

__device__ __forceinline__ float2 cis(float t) {
  return make_float2(cosf(t), sinf(t));
}

__device__ __forceinline__ int train1(int col) { return (5 + 11 * col) % 32; }
__device__ __forceinline__ int train2(int col) { return (21 + 11 * col) % 32; }

__global__ void __launch_bounds__(THREADS) sync_am_block_kernel(
    const float2* __restrict__ spectra, const __grid_constant__ Plan plan,
    uint8_t* __restrict__ codes, uint8_t* __restrict__ pids,
    uint8_t* __restrict__ ref_bits, int* __restrict__ samperr, int ma3) {
  constexpr int LOADERS = THREADS - 64;  // warps 2.. load the partition
  constexpr int CODERS = THREADS - 32;   // all but warp 1 demap
  constexpr int LOADS = (NSYM * W + LOADERS - 1) / LOADERS;
  __shared__ float2 col_s[NSYM][W];
  __shared__ float2 mult_s[W];
  __shared__ float fit_s[3];
  __shared__ float red_s[5][W];  // the fit's terms, by column
  __shared__ float sp_s[2][W];   // samperr's terms, by column
  const int p = blockIdx.x;
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int first = plan_at(plan, p, 0), step = plan_at(plan, p, 1);
  const float2* in = spectra + (long long)s * NSYM * FFT;
  // the column a lane of warps 0-2 stands for (lanes past the 25 columns
  // repeat the last one, and store nothing)
  const int col = lane < W ? lane : W - 1;
  const int bin = first + step * col;

  if (warp == 1) {
    // samperr, from the two primary partitions' mult angles (formed here
    // from their training rows): column c's phase step to c + 1 by
    // shuffles, the sums in column order.  This warp shares no barrier
    // with the others, and so runs beside the fit and the codes
    const int ofirst = plan_at(plan, p, 8);
    if (ofirst < 0) return;
    const int obin = ofirst + plan_at(plan, p, 9) * col;
    const float2 t1 = bin_value(in, train1(col), bin, ma3);
    const float2 t2 = bin_value(in, train2(col), bin, ma3);
    const float2 o1 = bin_value(in, train1(col), obin, ma3);
    const float2 o2 = bin_value(in, train2(col), obin, ma3);
    const float2 m = cdiv(make_float2((float)plan_at(plan, p, 3),
                                      (float)plan_at(plan, p, 4)),
                          cadd(t1, t2));
    const float2 mo = cdiv(make_float2((float)plan_at(plan, p, 10),
                                       (float)plan_at(plan, p, 11)),
                           cadd(o1, o2));
    const float a = atan2f(m.y, m.x), b = atan2f(mo.y, mo.x);
    const float an = __shfl_down_sync(0xffffffffu, a, 1);
    const float bn = __shfl_down_sync(0xffffffffu, b, 1);
    if (lane < W - 1) {
      sp_s[0][lane] = wrap_half_pi(an - a);
      sp_s[1][lane] = wrap_half_pi(bn - b);
    }
    __syncwarp();
    if (lane == 0) {
      float dp = sp_s[0][0], du = sp_s[1][0];
#pragma unroll
      for (int c = 1; c < W - 1; ++c) {
        dp = dp + sp_s[0][c];
        du = du + sp_s[1][c];
      }
      samperr[s] = (int)rintf((((dp + du) / 48.0f) * 256.0f) / TWO_PI);
    }
    return;
  }

  if (warp >= 2) {
    // the partition's 32 x 25 values into shared memory, every load of a
    // thread issued before its first store
    float2 v[LOADS];
#pragma unroll
    for (int k = 0; k < LOADS; ++k) {
      const int i = tid - 64 + k * LOADERS;
      if (i < NSYM * W)
        v[k] = bin_value(in, i / W, first + step * (i % W), ma3);
    }
#pragma unroll
    for (int k = 0; k < LOADS; ++k) {
      const int i = tid - 64 + k * LOADERS;
      if (i < NSYM * W) col_s[i / W][i % W] = v[k];
    }
  }

  // meanwhile, each from its own loads: warp 0 the anchors and the fit,
  // warp 2 the mults, warp 3 the PIDS codes and the reference bits
  if (warp == 0) {
    // the weighted linear fit: each sum's terms go to shared memory, and
    // every lane adds them from the first column to the last (the loads
    // issued together, the adds in turn)
    const int a_lo = min(train1(col), train2(col));
    const float2 lo = bin_value(in, a_lo, bin, ma3);
    const float2 hi = bin_value(in, a_lo + 16, bin, ma3);
    const float dph = wrap_pi(atan2f(lo.y, lo.x) - atan2f(hi.y, hi.x));
    const float wt = sqrtf(abs2(lo) * abs2(hi)) + 1e-12f;
    if (lane < W) {
      red_s[0][lane] = wt;
      red_s[1][lane] = wt * (float)col;
      red_s[2][lane] = wt * dph;
    }
    __syncwarp();
    float sw = red_s[0][0], swc = red_s[1][0], swd = red_s[2][0];
#pragma unroll
    for (int c = 1; c < W; ++c) {
      sw = sw + red_s[0][c];
      swc = swc + red_s[1][c];
      swd = swd + red_s[2][c];
    }
    const float cbar = swc / sw, dbar = swd / sw;
    const float xc = (float)col - cbar;
    if (lane < W) {
      red_s[3][lane] = wt * xc * (dph - dbar);
      red_s[4][lane] = wt * (xc * xc);
    }
    __syncwarp();
    if (lane == 0) {
      float sn = red_s[3][0], sq = red_s[4][0];
#pragma unroll
      for (int c = 1; c < W; ++c) {
        sn = sn + red_s[3][c];
        sq = sq + red_s[4][c];
      }
      fit_s[0] = cbar;
      fit_s[1] = dbar;
      fit_s[2] = sn / (sq + 1e-12f);
    }
  } else if (warp == 2) {
    const float2 t1 = bin_value(in, train1(col), bin, ma3);
    const float2 t2 = bin_value(in, train2(col), bin, ma3);
    const float2 m = cdiv(make_float2((float)plan_at(plan, p, 3),
                                      (float)plan_at(plan, p, 4)),
                          cadd(t1, t2));
    if (lane < W) mult_s[lane] = m;
  } else if (warp == 3) {
    const int pbin = plan_at(plan, p, 5);
    if (pbin >= 0) {
      // a lane a symbol row; the mult from rows 8 and 24 by shuffles
      const float2 x = bin_value(in, lane, pbin, ma3);
      const float2 sum = cadd(
          make_float2(__shfl_sync(0xffffffffu, x.x, 8),
                      __shfl_sync(0xffffffffu, x.y, 8)),
          make_float2(__shfl_sync(0xffffffffu, x.x, 24),
                      __shfl_sync(0xffffffffu, x.y, 24)));
      const float2 pm = cdiv(make_float2(3.0f, -1.0f), sum);
      pids[s * 2 * NSYM + lane * 2 + plan_at(plan, p, 6)] =
          demap(cmul(x, pm), 4);
    }
    if (plan_at(plan, p, 7))
      ref_bits[s * NSYM + lane] = bin_value(in, lane, C + 1, ma3).y > 0.0f;
  }
  // every warp but warp 1
  asm volatile("bar.sync 1, %0;" ::"r"(CODERS) : "memory");

  const int levels = plan_at(plan, p, 2);
  uint8_t* out = codes + ((long long)s * 4 + p) * NSYM * W;
  for (int i = tid < 32 ? tid : tid - 32; i < NSYM * W; i += CODERS) {
    const int r = i / W, c = i % W;
    const float xc = (float)c - fit_s[0];
    const float fit = fit_s[1] + fit_s[2] * xc;
    const int a_lo = min(train1(c), train2(c));
    const float u = (float)(r - a_lo - 8) / 16.0f;
    const float th = u * fit;
    const float2 m = cmul(mult_s[c], cis(th));
    out[i] = demap(cmul(col_s[r][c], m), levels);
  }
}

}  // namespace

// plan: the host's int32 [4, PLAN_INTS] plan of the mode (see Plan).
extern "C" int sync_am_block(const void* spectra, const void* plan,
                             void* codes, void* pids, void* ref_bits,
                             void* samperr, int n_stations, int ma3,
                             void* stream) {
  if (n_stations <= 0 || plan == nullptr) return (int)cudaErrorInvalidValue;
  Plan pl;
  for (int p = 0; p < 4; ++p)
    for (int i = 0; i < PLAN_INTS; ++i)
      pl.v[p][i] = ((const int*)plan)[p * PLAN_INTS + i];
  sync_am_block_kernel<<<dim3(4, n_stations), THREADS, 0,
                         (cudaStream_t)stream>>>(
      (const float2*)spectra, pl, (uint8_t*)codes, (uint8_t*)pids,
      (uint8_t*)ref_bits, (int*)samperr, ma3);
  return (int)cudaGetLastError();
}
