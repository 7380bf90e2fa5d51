// The AM sync block's kernel body, shared by K13 (sync_am_block.cu, the
// real-pair chain, kernel sync_am_block_kernel) and K20 (sync_am_c.cu, the
// complex chain, kernel sync_am_c_kernel): four CTAs a station, one a
// partition.  sync_am_block.cu describes the design.  The two kernels
// differ only in how a training mult divides (train_mult) and how an
// anchor pair's fit weight is formed (anchor_weight), each as its chain's
// plain version does, and K20 also sets the next block's symbol timing in
// its carry step.

#pragma once

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

// 1 / b as c10::complex<float> divides (Smith's method)
__device__ __forceinline__ float2 crecip(float2 b) {
  const float c = b.x, d = b.y;
  if (fabsf(c) >= fabsf(d)) {
    if (c == 0.0f && d == 0.0f)
      return make_float2(1.0f / fabsf(c), 0.0f / fabsf(d));
    const float rat = d / c, scl = 1.0f / (c + d * rat);
    return make_float2(scl, (-rat) * scl);
  }
  const float rat = c / d, scl = 1.0f / (d + c * rat);
  return make_float2(rat * scl, -scl);
}

// a training mult, nominal / sum: the real-pair chain's true division
// (K13), or as PyTorch divides a number by a complex tensor (K20: the
// reciprocal, then the product)
template <bool kComplex>
__device__ __forceinline__ float2 train_mult(float2 nominal, float2 sum) {
  return kComplex ? cmul(crecip(sum), nominal) : cdiv(nominal, sum);
}

// an anchor pair's fit weight before its 1e-12: sqrt(|lo|^2 |hi|^2) (K13),
// or |lo| |hi| as PyTorch's complex abs takes each (K20)
template <bool kComplex>
__device__ __forceinline__ float anchor_weight(float2 lo, float2 hi) {
  return kComplex ? hypotf(lo.x, lo.y) * hypotf(hi.x, hi.y)
                  : sqrtf(abs2(lo) * abs2(hi));
}

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

// The kernel's parameters, and their names to pass on: each of K13 and K20
// is a __global__ of its own name (SYNC_AM_KERNEL) around the body
#define SYNC_AM_PARAMS(PLAN)                                                 \
  const float2 *__restrict__ spectra, PLAN plan,                             \
      uint8_t *__restrict__ codes, uint8_t *__restrict__ pids,               \
      uint8_t *__restrict__ ref_bits, int *__restrict__ samperr, int ma3,    \
      const int *__restrict__ keep, int *__restrict__ offset,                \
      int *__restrict__ samperr_next, int window, int half_fftcp
#define SYNC_AM_ARGS                                                         \
  spectra, plan, codes, pids, ref_bits, samperr, ma3, keep, offset,          \
      samperr_next, window, half_fftcp
// the __global__ ``name``: the body with the arithmetic of kComplex
#define SYNC_AM_KERNEL(name, kComplex)                                       \
  __global__ void __launch_bounds__(THREADS)                                 \
      name(SYNC_AM_PARAMS(const __grid_constant__ Plan)) {                   \
    sync_am_body<kComplex>(SYNC_AM_ARGS);                                    \
  }

// kComplex: the training mults and fit weights in the complex chain's
// arithmetic (K20), else in the real-pair chain's (K13)
template <bool kComplex>
__device__ __forceinline__ void sync_am_body(SYNC_AM_PARAMS(const Plan&)) {
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

  // the loop's carry step for the next block
  if (offset != nullptr && p == 0 && tid == 0) offset[s] += window - keep[s];

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
    const float2 m = train_mult<kComplex>(
        make_float2((float)plan_at(plan, p, 3), (float)plan_at(plan, p, 4)),
        cadd(t1, t2));
    const float2 mo = train_mult<kComplex>(
        make_float2((float)plan_at(plan, p, 10), (float)plan_at(plan, p, 11)),
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
      const int se = (int)rintf((((dp + du) / 48.0f) * 256.0f) / TWO_PI);
      samperr[s] = se;
      // the next block's symbol timing (K20 in the complex chain's loop)
      if (samperr_next != nullptr) samperr_next[s] = half_fftcp + se;
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
    const float wt = anchor_weight<kComplex>(lo, hi) + 1e-12f;
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
    const float2 m = train_mult<kComplex>(
        make_float2((float)plan_at(plan, p, 3), (float)plan_at(plan, p, 4)),
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
      const float2 pm = train_mult<kComplex>(make_float2(3.0f, -1.0f), sum);
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
