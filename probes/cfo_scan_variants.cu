// The designs tried for K10 (the FM cold start's CFO scan, one kernel from
// the spectra to the needle counts), for probes/k10_k16b_variants.py, each
// equal to the plain scan.  A copy of nrsc5_tpu_torch/csrc/cfo_scan.cu
// (a CTA a station and CFO residue mod 19: 88 tracks over 28 distinct bins)
// with its choices as knobs:
//
//   -DV_THREADS=n      threads a CTA (128, 256, 512; the port's 256);
//   -DV_TRACK_ANGLES   every track takes its own 32 angles on its thread
//                      before its recursion, in place of each distinct
//                      bin's angles taken once in parallel beside the loads;
//   -DV_CHAIN_DEROT    the track's thread also derotates each step beside
//                      the recursion and packs the signs itself, in place
//                      of the phases in shared memory and a warp a track
//                      after it;
//   -DV_OVERLAP        the derotations overlap the recursion: the
//                      recursion's warps arrive at a named barrier after
//                      each group of 8 steps, and the other warps take that
//                      group's derotations (a lane a (track, step), 4
//                      tracks a ballot) while the recursion runs on;
//   -DV_FAST_WRAP      the recursion's two wraps a step by a product with
//                      the float32 reciprocal of 2 pi, taking the true
//                      quotient only where the product lies within 3e-7
//                      of its size from a half-integer (where the two
//                      could round to different integers): the same bits
//                      without two IEEE divides on the chain;
//   -DV_SINCOS         each derotation's cosine and sine by one sincosf
//                      (the values cosf and sinf give) in place of the two
//                      calls of costas.cuh's costas_derot;
//   -DCLOCK            the global timer at a CTA's entry, after the loads
//                      and angles, after the recursion, after the
//                      derotations and at exit, 8 int64 a CTA behind count
//                      (the caller leaves room).

#include <cuda_runtime.h>
#include <stdint.h>

#include "../nrsc5_tpu_torch/csrc/costas.cuh"

#ifndef V_THREADS
#define V_THREADS 256
#endif

namespace {

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// wrap_pi(x) = x - 2pi rint(x / 2pi) with the quotient's rounding decided
// from x * (1 / 2pi) where that cannot differ from the true quotient's
__device__ __forceinline__ float wrap_fast(float x, float two_pi,
                                           float inv) {
  const float y = x * inv;
  float r = rintf(y);
  if (0.5f - fabsf(y - r) <= 3.0e-7f * fabsf(y)) r = rintf(x / two_pi);
  return x - two_pi * r;
}

__device__ __forceinline__ void advance(float a, float& ph, float& fr,
                                        float cf, float alpha, float beta,
                                        float two_pi, float inv) {
#ifdef V_FAST_WRAP
  const float err = 0.5f * wrap_fast(a - 2.0f * ph, two_pi, inv);
  fr = fminf(fmaxf(fr + beta * err, -0.5f), 0.5f);
  ph = wrap_fast(ph + fr + cf + alpha * err, two_pi, inv);
#else
  nrsc5::costas_advance(a, ph, fr, cf, alpha, beta, two_pi);
#endif
}

// costas_derot's value, its cosine and sine by one sincosf
__device__ __forceinline__ float2 derot(float2 v, float ph) {
#ifdef V_SINCOS
  float s, c;
  sincosf(-ph, &s, &c);
  return make_float2(v.x * c - v.y * s, v.x * s + v.y * c);
#else
  return nrsc5::costas_derot(v, ph);
#endif
}

__device__ __forceinline__ long long gtimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

constexpr int NSYM = 32;      // steps of a track (symbols of a block)
constexpr int WIDTH = 19;     // CFO residues: a partition's width in bins
constexpr int NQ = 4;         // CFOs of a residue: 76 / 19
constexpr int NREF = 11;      // refs a sideband
constexpr int NB = NQ + NREF - 1;  // distinct bins a sideband and residue
constexpr int NTRACK = NQ * 2 * NREF;  // 88
constexpr int THREADS = V_THREADS;
constexpr int WARPS = THREADS / 32;
// staged values and angles lie [side][j][k], a bin's 32 symbols a row of
// RS (the derotations read a row, the recursion's threads a column of
// distinct rows: no bank conflicts), the upper sideband SIDE after the
// lower, 16 banks on
constexpr int RS = NSYM + 1;
constexpr int SIDE = NB * RS + 2;
static_assert(SIDE % 32 == 16, "sidebands 16 banks apart");

__global__ void __launch_bounds__(THREADS) cfo_scan_kernel(
    const float2* __restrict__ spectra, const float* __restrict__ cfo_freq,
    const unsigned* __restrict__ needle_vals,
    const unsigned* __restrict__ needle_known, int* __restrict__ count,
    int n_fft, int lb0, int ub0, float alpha, float beta, float two_pi) {
  __shared__ float2 sv[2 * SIDE];            // staged bins [side][j][k]
  __shared__ float ang[2 * SIDE];            // their angles, same layout
#ifdef V_OVERLAP
  __shared__ float phs[NTRACK][NSYM + 8];    // each track's phases
  __shared__ unsigned wbytes[NTRACK];        // each track's signs, by byte
#else
  __shared__ float phs[NTRACK][NSYM + 1];    // each track's phases
#endif
  __shared__ unsigned words[NTRACK];         // each track's 32 signs
  __shared__ unsigned vals[2 * NREF], known[2 * NREF];
  const int s = blockIdx.x / WIDTH;
  const int r = blockIdx.x - s * WIDTH;
  const int tid = threadIdx.x;
  const float2* spec = spectra + (long long)s * NSYM * n_fft;
  const float inv = 1.0f / two_pi;
#ifdef CLOCK
  long long* clk = reinterpret_cast<long long*>(
                       count + (long long)gridDim.x / WIDTH * NQ * WIDTH *
                                   NSYM) +
                   8 * (long long)blockIdx.x;
  if (tid == 0) clk[0] = gtimer();
#endif

  // 1. the 2 x 32 x 14 staged values, every load issued before any use,
  // and the angles of their squares
  constexpr int NV = 2 * NSYM * NB;  // 896
  constexpr int PER = (NV + THREADS - 1) / THREADS;
  float2 v[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = tid + u * THREADS;
    if (e < NV) {
      const int side = e / (NSYM * NB);
      const int rem = e - side * (NSYM * NB);
      const int j = rem / NSYM;
      const int k = rem - j * NSYM;
      const int bin = (side ? ub0 : lb0) + r + WIDTH * j;
      v[u] = spec[k * n_fft + bin];
    }
  }
  if (tid < 2 * NREF) {
    vals[tid] = needle_vals[tid];
    known[tid] = needle_known[tid];
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = tid + u * THREADS;
    if (e < NV) {
      const int side = e / (NSYM * NB);
      const int rem = e - side * (NSYM * NB);
      const int j = rem / NSYM;
      const int at = side * SIDE + j * RS + (rem - j * NSYM);
      sv[at] = v[u];
#ifndef V_TRACK_ANGLES
      ang[at] = nrsc5::costas_angle(v[u]);
#endif
    }
  }
  __syncthreads();
#ifdef CLOCK
  if (tid == 0) clk[1] = gtimer();
#endif

#ifdef V_OVERLAP
  // 2+3. the recursion's warps, each group of 8 steps behind a named
  // barrier; the other warps take each group's derotations
  {
    constexpr int GS = 8, NG = NSYM / GS;
    constexpr int NCHAIN = (NTRACK + 31) / 32 * 32;
    if (tid < NCHAIN) {
      int q = 0, side = 0, j = 0;
      float cf = 0.0f;
      if (tid < NTRACK) {
        q = tid / (2 * NREF);
        const int ref = tid - q * (2 * NREF);
        side = ref / NREF;
        const int i = ref - side * NREF;
        j = side ? q - i + NREF - 1 : q + i;
        cf = cfo_freq[r + WIDTH * q];
      }
      const float* a = ang + side * SIDE + j * RS;
      float ph = 0.0f, fr = 0.0f;
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        if (tid < NTRACK) {
          float av[GS];
#pragma unroll
          for (int kk = 0; kk < GS; ++kk) av[kk] = a[g * GS + kk];
#pragma unroll
          for (int kk = 0; kk < GS; ++kk) {
            phs[tid][g * GS + kk] = ph;
            advance(av[kk], ph, fr, cf, alpha, beta, two_pi, inv);
          }
        }
        __syncwarp();
        bar_arrive(1 + g, THREADS);
      }
    } else {
      const int lane = tid & 31;
      const int cw = (tid - NCHAIN) >> 5;
      constexpr int NCW = (THREADS - NCHAIN) / 32;
      const int ti = lane >> 3, kk = lane & 7;
      for (int g = 0; g < NG; ++g) {
        bar_sync(1 + g, THREADS);
        const int k = g * GS + kk;
        for (int q4 = cw; q4 < NTRACK / 4; q4 += NCW) {
          const int t = 4 * q4 + ti;
          const int q = t / (2 * NREF);
          const int ref = t - q * (2 * NREF);
          const int side = ref / NREF;
          const int i = ref - side * NREF;
          const int j = side ? q - i + NREF - 1 : q + i;
          const float2 d =
              derot(sv[side * SIDE + j * RS + k], phs[t][k]);
          const unsigned b = __ballot_sync(0xffffffffu, d.x > 0.0f);
          if (kk == 0)
            reinterpret_cast<unsigned char*>(wbytes)[4 * t + g] =
                (unsigned char)(b >> (8 * ti));
        }
      }
    }
  }
  __syncthreads();
#ifdef CLOCK
  if (tid == 0) clk[2] = clk[3] = gtimer();
#endif
  if (tid < NTRACK) words[tid] = wbytes[tid];
  __syncthreads();
#else
  // 2. the recursion, a thread a track: track t = q * 22 + ref, the
  // reference's order; ref i of the lower sideband reads bin j = q + i,
  // of the upper j = q - i + 10
  if (tid < NTRACK) {
    const int q = tid / (2 * NREF);
    const int ref = tid - q * (2 * NREF);
    const int side = ref / NREF;
    const int i = ref - side * NREF;
    const int j = side ? q - i + NREF - 1 : q + i;
    const float cf = cfo_freq[r + WIDTH * q];
    float av[NSYM];
#ifdef V_TRACK_ANGLES
    const float2* a = sv + side * SIDE + j * RS;
#pragma unroll
    for (int k = 0; k < NSYM; ++k) av[k] = nrsc5::costas_angle(a[k]);
#else
    const float* a = ang + side * SIDE + j * RS;
#pragma unroll
    for (int k = 0; k < NSYM; ++k) av[k] = a[k];
#endif
    float ph = 0.0f, fr = 0.0f;
#ifdef V_CHAIN_DEROT
    const float2* x = sv + side * SIDE + j * RS;
    unsigned word = 0;
#pragma unroll
    for (int k = 0; k < NSYM; ++k) {
      const float2 d = nrsc5::costas_derot(x[k], ph);
      word |= (unsigned)(d.x > 0.0f) << k;
      advance(av[k], ph, fr, cf, alpha, beta, two_pi, inv);
    }
    words[tid] = word;
#else
#pragma unroll
    for (int k = 0; k < NSYM; ++k) {
      phs[tid][k] = ph;
      advance(av[k], ph, fr, cf, alpha, beta, two_pi, inv);
    }
#endif
  }
  __syncthreads();
#ifdef CLOCK
  if (tid == 0) clk[2] = gtimer();
#endif

  // 3. the derotations' signs, a warp a track and a lane a symbol
#ifndef V_CHAIN_DEROT
  {
    const int k = tid & 31;
    for (int t = tid >> 5; t < NTRACK; t += WARPS) {
      const int q = t / (2 * NREF);
      const int ref = t - q * (2 * NREF);
      const int side = ref / NREF;
      const int i = ref - side * NREF;
      const int j = side ? q - i + NREF - 1 : q + i;
      const float2 d =
          derot(sv[side * SIDE + j * RS + k], phs[t][k]);
      const unsigned w = __ballot_sync(0xffffffffu, d.x > 0.0f);
      if (k == 0) words[t] = w;
    }
  }
  __syncthreads();
#endif
#ifdef CLOCK
  if (tid == 0) clk[3] = gtimer();
#endif

#endif
  // 4. the counts, a thread a (CFO, offset): bit n of the rotated word is
  // the sign of symbol (n + o) % 32
  if (tid < NQ * NSYM) {
    const int q = tid / NSYM;
    const int o = tid - q * NSYM;
    int n = 0;
#pragma unroll
    for (int ref = 0; ref < 2 * NREF; ++ref) {
      const unsigned w = words[q * 2 * NREF + ref];
      const unsigned rot = __funnelshift_r(w, w, o);
      const bool eq = ((rot ^ vals[ref]) & known[ref]) == 0u;
      const bool neq = ((rot ^ ~vals[ref]) & known[ref]) == 0u;
      n += (eq || neq) ? 1 : 0;
    }
    count[((long long)s * NQ * WIDTH + r + WIDTH * q) * NSYM + o] = n;
  }
#ifdef CLOCK
  __syncthreads();
  if (tid == 0) clk[4] = gtimer();
#endif
}

}  // namespace

extern "C" int cfo_scan_variant(const void* spectra, const void* cfo_freq,
                        const void* needle_vals, const void* needle_known,
                        void* count, int n_stations, int n_fft, int lb0,
                        int ub0, float alpha, float beta, float two_pi,
                        void* stream) {
  if (n_stations <= 0 || lb0 < 0 || ub0 < 0
      || lb0 + WIDTH * (NB + 1) > n_fft || ub0 + WIDTH * (NB + 1) > n_fft)
    return (int)cudaErrorInvalidValue;
  cfo_scan_kernel<<<n_stations * WIDTH, THREADS, 0, (cudaStream_t)stream>>>(
      (const float2*)spectra, (const float*)cfo_freq,
      (const unsigned*)needle_vals, (const unsigned*)needle_known,
      (int*)count, n_fft, lb0, ub0, alpha, beta, two_pi);
  return (int)cudaGetLastError();
}
