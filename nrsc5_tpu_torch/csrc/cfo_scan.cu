// K10: the FM cold start's integer-CFO x block-offset scan, one kernel from
// the spectra to the needle counts.
//
// Replaces the JAX device function
// nrsc5_tpu/ops/acquire_rc.py:detect_cfo_scan_rc (lines 122-157) with the
// Costas PLL it reaches, nrsc5_tpu/pipeline/scan_chain_rc.py:costas_track_rc
// (lines 107-125, through acquire_rc.py:114-119's costas_track_cfo_rc).
// Per station s, CFO c (cfo = c - 38, c < 76) and reference r < 22 (refs
// 0-10 on the lower sideband at bin 478 + cfo + 19 i, refs 11-21 on the
// upper at bin 1570 + cfo - 19 i), a 32-step Costas track from phase and
// frequency 0 with the static frequency cfo_freq[c] (the host's float32
// table) gives the signs of Re derot; count[s, c, o] is the number of refs
// whose signs, shifted cyclically by o, equal the ref's needle, or its
// complement, at every known position.
//
// spectra f32 [S, 32, 2048, 2], cfo_freq f32 [76], needle_vals and
// needle_known u32 [22] (bit k = symbol k) -> count i32 [S, 76, 32].
//
// Bound on the H100: device-memory bytes, the 532 distinct bins a station
// reads (32 x 532 x 8 = 136 KB) and the count (9.7 KB), ~0.0007 ms for 16
// stations; what sets the time is each track's 32-step chain (an IEEE
// divide and a rint twice a step) behind the loads, and the derotations'
// cosines and sines.  Design: CFO c and c + 19 read the same bins one
// reference apart, so a CTA takes a station and a CFO residue r < 19, the
// 4 CFOs r + 19 q and their 88 tracks, which read 14 distinct bins a
// sideband (28 in all): every bin a station reads is loaded by one CTA
// once, and its 32 angles (atan2 of the square) are taken once, in
// parallel, beside the loads.  Only costas_advance's recursion runs on a
// track's thread (the first three warps), 32 steps from angles in shared
// memory, its phases kept there; after each group of 8 steps those warps
// arrive at a named barrier, and the other 13 warps take that group's
// derotations while the recursion runs on, a lane a (track, step), one
// ballot packing 8 signs of 4 tracks.  The counts come from the packed
// words in shared memory, a warp a CFO and a lane a reference (a funnel
// shift and one ballot per offset, as the reference's needle match).
// Nothing but the count reaches device memory.  costas.cuh's steps in the reference's order, as
// K4 runs them (-fmad=false, the constants as float arguments), with each
// derotation's cosine and sine by one sincosf, which gives the values
// cosf and sinf give: the same bits as the plain scan.

#include <cuda_runtime.h>
#include <stdint.h>

#include "costas.cuh"

namespace {

constexpr int NSYM = 32;      // steps of a track (symbols of a block)
constexpr int WIDTH = 19;     // CFO residues: a partition's width in bins
constexpr int NQ = 4;         // CFOs of a residue: 76 / 19
constexpr int NREF = 11;      // refs a sideband
constexpr int NB = NQ + NREF - 1;  // distinct bins a sideband and residue
constexpr int NTRACK = NQ * 2 * NREF;  // 88
constexpr int THREADS = 512;
constexpr int NCHAIN = (NTRACK + 31) / 32 * 32;  // the recursion's warps
constexpr int NDEROT = (THREADS - NCHAIN) / 32;  // the derotations' warps
constexpr int GS = 8;                            // steps a group
constexpr int NG = NSYM / GS;
// staged values and angles lie [side][j][k], a bin's 32 symbols a row of
// RS (a track's recursion reads a row, and its warp's threads distinct
// rows: no bank conflicts), the upper sideband SIDE after the lower, 16
// banks on
constexpr int RS = NSYM + 1;
constexpr int SIDE = NB * RS + 2;
static_assert(SIDE % 32 == 16, "sidebands 16 banks apart");
// a track's phases a row of PS: the derotations' lanes (4 tracks x 8
// steps) on 32 distinct banks
constexpr int PS = NSYM + 8;

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(THREADS) : "memory");
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(THREADS) : "memory");
}

// track t = q * 22 + ref (the reference's order): ref i of the lower
// sideband reads staged bin j = q + i, of the upper j = q - i + 10
__device__ __forceinline__ int track_at(int t) {
  const int q = t / (2 * NREF);
  const int ref = t - q * (2 * NREF);
  const int side = ref / NREF;
  const int i = ref - side * NREF;
  return side * SIDE + (side ? q - i + NREF - 1 : q + i) * RS;
}

__global__ void __launch_bounds__(THREADS) cfo_scan_kernel(
    const float2* __restrict__ spectra, const float* __restrict__ cfo_freq,
    const unsigned* __restrict__ needle_vals,
    const unsigned* __restrict__ needle_known, int* __restrict__ count,
    int n_fft, int lb0, int ub0, float alpha, float beta, float two_pi) {
  __shared__ float2 sv[2 * SIDE];            // staged bins [side][j][k]
  __shared__ float ang[2 * SIDE];            // their angles, same layout
  __shared__ float phs[NTRACK][PS];          // each track's phases
  __shared__ unsigned words[NTRACK];         // each track's 32 signs
  __shared__ unsigned vals[2 * NREF], known[2 * NREF];
  const int s = blockIdx.x / WIDTH;
  const int r = blockIdx.x - s * WIDTH;
  const int tid = threadIdx.x;
  const float2* spec = spectra + (long long)s * NSYM * n_fft;

  // 1. the 2 x 14 x 32 staged values, every load issued before any use,
  // and the angles of their squares
  constexpr int NV = 2 * NB * NSYM;  // 896
  constexpr int PER = (NV + THREADS - 1) / THREADS;
  float2 v[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = tid + u * THREADS;
    if (e < NV) {
      const int side = e / (NB * NSYM);
      const int rem = e - side * (NB * NSYM);
      const int j = rem / NSYM;
      const int k = rem - j * NSYM;
      v[u] = spec[k * n_fft + (side ? ub0 : lb0) + r + WIDTH * j];
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
      const int side = e / (NB * NSYM);
      const int rem = e - side * (NB * NSYM);
      const int j = rem / NSYM;
      const int at = side * SIDE + j * RS + (rem - j * NSYM);
      sv[at] = v[u];
      ang[at] = nrsc5::costas_angle(v[u]);
    }
  }
  __syncthreads();

  if (tid < NCHAIN) {
    // 2. the recursion, a thread a track, arriving at barrier 1 + g after
    // its group g of steps
    float cf = 0.0f;
    const float* a = ang;
    if (tid < NTRACK) {
      cf = cfo_freq[r + WIDTH * (tid / (2 * NREF))];
      a = ang + track_at(tid);
    }
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
          nrsc5::costas_advance(av[kk], ph, fr, cf, alpha, beta, two_pi);
        }
      }
      __syncwarp();
      bar_arrive(1 + g);
    }
  } else {
    // 3. each group's derotations once its phases are in: lane (ti, kk)
    // takes track 4 q4 + ti at step 8 g + kk, and one ballot gives the
    // 8 signs of each of the 4 tracks
    const int lane = tid & 31;
    const int dw = (tid - NCHAIN) >> 5;
    const int ti = lane >> 3, kk = lane & 7;
    for (int g = 0; g < NG; ++g) {
      bar_sync(1 + g);
      const int k = g * GS + kk;
      for (int q4 = dw; q4 < NTRACK / 4; q4 += NDEROT) {
        const int t = 4 * q4 + ti;
        const float2 x = sv[track_at(t) + k];
        float sn, cs;
        sincosf(-phs[t][k], &sn, &cs);  // costas_derot's cosf and sinf
        const float re = x.x * cs - x.y * sn;
        const unsigned b = __ballot_sync(0xffffffffu, re > 0.0f);
        if (kk == 0)
          reinterpret_cast<unsigned char*>(words)[4 * t + g] =
              (unsigned char)(b >> (8 * ti));
      }
    }
  }
  __syncthreads();

  // 4. the counts, a warp a CFO as the reference's needle match: lane
  // ref < 22 holds its track's word, and for each offset o (bit n of the
  // rotated word is the sign of symbol (n + o) % 32) the warp counts its
  // matching lanes by one ballot
  if (tid < NQ * 32) {
    const int q = tid >> 5, lane = tid & 31;
    const bool live = lane < 2 * NREF;
    const unsigned w = live ? words[q * 2 * NREF + lane] : 0u;
    const unsigned vl = live ? vals[lane] : 0u;
    const unsigned kn = live ? known[lane] : 0u;
    int mine = 0;
#pragma unroll
    for (int o = 0; o < NSYM; ++o) {
      const unsigned rot = __funnelshift_r(w, w, o);
      const bool eq = ((rot ^ vl) & kn) == 0u;
      const bool neq = ((rot ^ ~vl) & kn) == 0u;
      const int n = __popc(__ballot_sync(0xffffffffu, live && (eq || neq)));
      if (lane == o) mine = n;
    }
    count[((long long)s * NQ * WIDTH + r + WIDTH * q) * NSYM + lane] = mine;
  }
}

}  // namespace

extern "C" int cfo_scan(const void* spectra, const void* cfo_freq,
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
