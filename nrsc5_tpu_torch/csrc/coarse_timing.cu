// K9: coarse symbol timing by cyclic-prefix correlation, for all stations
// of a cold start: the CP products over a grid of (station, part), then the
// window sum and argmax over a thread-block cluster of 8 CTAs a station.
//
// Replaces the JAX device function
// nrsc5_tpu/ops/acquire_rc.py:coarse_timing_rc (lines 43-70).  Per station,
// on the first 71280 samples x of its conjugated rc buffer:
//   f[0] = 0,  f[n] = sum_o taps[o] * x[n-1-o]      (32-tap band filter)
//   sums[t] = sum_k f[k*2160 + t] * conj(f[2048 + k*2160 + t])
//                                   (t < 2160, k < 32: the CP product)
//   v[i] = sum_j w[j] * sums[(i + j) mod 2160]     (j < 112, circular)
//   i_max = first argmax |v[i]|^2,  samperr = (i_max + 2160 - delay) % 2160
//   max_v = v[i_max]
//
// Bound on the H100: about 10 Mflop and 570 KB of samples a station, so
// neither bound reaches 3 us for 16 stations.  Without FMA contraction
// (-fmad=false, for the plain version's rounding) the filter alone is
// 2 x 2160 outputs x 32 symbols x 128 float32 instructions a station, about
// 9 us of issue on the whole card for 16 stations.  Design:
//   * The products (coarse_timing_sums_kernel): CTA (s, h) owns timings
//     [135h, 135h + 135) of station s, 16 parts a station (256 CTAs for 16
//     stations, two an SM: a cluster of 8 CTAs a station at one an SM, its
//     155 KB of samples each, left the 16th station's cluster to a second
//     wave, the card not holding 16 such clusters at once).  Each symbol's
//     two sample runs, from [k*2160 + 135h - 32] and [2048 + k*2160 + 135h
//     - 32] (the 32-sample history ahead of the first timing, zero before the
//     window's start), 168 samples from an even index, come into shared
//     memory all at the start: one bulk copy a run by the tensor memory
//     accelerator (bulk_copy.cuh), 16 symbols a stage and an mbarrier a
//     stage, so that the first stage's filter waits only for its own runs
//     (cp.async 8 bytes a thread where the station's samples are not
//     16-byte aligned).
//   * A thread takes 9 consecutive timings of one symbol (240 of the 256
//     threads: 16 symbols x 15 blocks of 9 a stage) and filters each of
//     their 18 samples once: its 40-sample window of each run is read from
//     shared memory once, newest sample first, and each sample is added
//     into the (up to 9) outputs whose taps it meets, so every output's sum
//     still runs o = 0..31 in order from 0.0, and the 36 sums of a thread
//     interleave.  Taps and window kernel are kernel parameters: constant
//     bank operands at compile-time offsets.  The 9 CP products go to
//     shared memory; each timing's owner thread adds the stage's 16 into a
//     register in symbol order, so its sum runs k = 0..31 in order, and
//     writes it to the sums scratch.  Where the window starts (k = 0, h =
//     0, n < 32) the missing history is zero, and adding tap x 0 to a sum
//     that started at +0.0 changes no bit, so f[n] is the plain version's
//     masked sum.
//   * The window and argmax (coarse_timing_window_kernel): CTA c of a
//     station's cluster reads sums [270c, 270c + 381) (circularly) from
//     the scratch, and 90 threads take 3 consecutive v[i] each, j = 0..111
//     in order.  The first index of the largest |v|^2 a thread, a warp, a
//     CTA; each CTA's (|v|^2, index, v) goes into rank 0's shared memory
//     by distributed shared memory (after a cluster barrier that every CTA
//     arrives at when it starts), and after a second one rank 0
//     takes the largest, the lower index on ties (jnp.argmax's rule), and
//     writes samperr and max_v.
// Every sum runs in the plain version's order, so with -fmad=false the
// kernels and the plain version agree bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int FFT = 2048;
constexpr int CP = 112;
constexpr int FFTCP = FFT + CP;
constexpr int NSYM = 32;
constexpr int NTAPS = 32;
constexpr int WINDOW = FFTCP * (NSYM + 1);   // samples read a station
// the products
constexpr int PARTS = 16;                    // CTAs a station
constexpr int PART = FFTCP / PARTS;          // timings a CTA: 135
constexpr int R = 9;                         // timings a thread
constexpr int BLOCKS = PART / R;             // timing blocks a symbol: 15
constexpr int WIN = R + NTAPS - 1;           // samples a thread's window
constexpr int RUN = 168;                     // samples a run, from even n
constexpr int S = 16;                        // symbols a stage
constexpr int STAGES = NSYM / S;
constexpr int THREADS = 256;
constexpr int ITEMS = S * BLOCKS;            // 240 items a stage
constexpr int STAGE_SAMPLES = S * 2 * RUN;
// the window
constexpr int CLUSTER = 8;                   // CTAs a station
constexpr int SLICE = FFTCP / CLUSTER;       // timings a CTA: 270
constexpr int EXT = SLICE + CP - 1;          // the slice's sums and 111 more
constexpr int VR = 3;                        // window outputs a thread
constexpr int VTHREADS = SLICE / VR;         // 90
constexpr int WTHREADS = 128;
static_assert(PART * PARTS == FFTCP && BLOCKS * R == PART, "products");
static_assert(RUN >= PART + NTAPS && RUN % 2 == 0, "a run from even n");
static_assert(ITEMS <= THREADS && NSYM % S == 0 && STAGES == 2, "stages");
static_assert(SLICE * CLUSTER == FFTCP && SLICE >= CP - 1, "the window");
static_assert(VTHREADS * VR == SLICE && VTHREADS <= WTHREADS, "window");

struct Tables {
  float taps[NTAPS];
  float w[CP];
};

struct SumsSmem {
  float2 run[STAGES][STAGE_SAMPLES];  // every stage's sample runs
  float2 prod[S][PART];               // a stage's CP products
  uint64_t bar[STAGES];               // a stage's bulk copies
};

// a sample from src to dst, or zero (!valid)
__device__ __forceinline__ void cp_async8(float2* dst, const float2* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 8 : 0;  // 0: zero fill
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}

__global__ void __launch_bounds__(THREADS, 2) coarse_timing_sums_kernel(
    const float2* __restrict__ samples, long long n_samples, const Tables tb,
    float2* __restrict__ sums) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SumsSmem& sm = *reinterpret_cast<SumsSmem*>(smem_raw);
  const int s = blockIdx.x / PARTS, h = blockIdx.x % PARTS;
  const int tid = threadIdx.x;
  const float2* x = samples + static_cast<long long>(s) * n_samples;
  // run q = 2 ks + r of stage g (symbol 16 g + ks, r = 0: a, 1: b) holds
  // samples from the even index k*2160 + (r ? 2048 : 0) + 135h - 32 -
  // shift, shift = 135h mod 2 (the same for every run of the CTA)
  const int shift = (PART * h) & 1;
  auto first = [&](int g, int q) {
    return static_cast<long long>(g * S + (q >> 1)) * FFTCP
           + ((q & 1) ? FFT : 0) + PART * h - NTAPS - shift;
  };

  const bool bulk_ok = ((reinterpret_cast<uintptr_t>(x) & 15) == 0);
  if (bulk_ok) {
    if (tid == 0)
      for (int g = 0; g < STAGES; ++g) bulk::init(&sm.bar[g]);
    // the history before the window's start: zero (part 0, symbol 0's a run)
    if (h == 0 && tid < NTAPS) sm.run[0][tid] = make_float2(0.0f, 0.0f);
    __syncthreads();
    if (tid == 0) {
      for (int g = 0; g < STAGES; ++g) {
        const int lead = g == 0 && h == 0 ? NTAPS : 0;
        bulk::expect(&sm.bar[g], (STAGE_SAMPLES - lead) * 8);
        for (int q = 0; q < 2 * S; ++q) {
          const long long n = first(g, q);
          const int skip = n < 0 ? static_cast<int>(-n) : 0;
          bulk::copy(sm.run[g] + q * RUN + skip, x + n + skip,
                     (RUN - skip) * 8, &sm.bar[g]);
        }
      }
    }
  } else {
    for (int g = 0; g < STAGES; ++g) {
      for (int e = tid; e < STAGE_SAMPLES; e += THREADS) {
        const int q = e / RUN;
        const long long n = first(g, q) + (e - q * RUN);
        cp_async8(sm.run[g] + e, x + (n >= 0 ? n : 0), n >= 0);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
  }

  float2 acc = make_float2(0.0f, 0.0f);  // timing tid's sum
  for (int g = 0; g < STAGES; ++g) {
    if (bulk_ok)
      bulk::wait(&sm.bar[g]);
    else if (g == 0)
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    else
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    if (tid < ITEMS) {
      const int ks = tid / BLOCKS, blk = tid - ks * BLOCKS;
      const float2* ra = sm.run[g] + 2 * ks * RUN + shift + R * blk;
      const float2* rb = ra + RUN;
      float2 fa[R], fb[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        fa[r] = make_float2(0.0f, 0.0f);
        fb[r] = make_float2(0.0f, 0.0f);
      }
      // window sample jj is x[n_r - 1 - o] for output r at o = r + 31 - jj:
      // newest first, so each output takes o = 0, 1, ... in order
#pragma unroll
      for (int jj = WIN - 1; jj >= 0; --jj) {
        const float2 a = ra[jj], b = rb[jj];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int o = r + NTAPS - 1 - jj;
          if (o >= 0 && o < NTAPS) {
            fa[r].x = fa[r].x + tb.taps[o] * a.x;
            fa[r].y = fa[r].y + tb.taps[o] * a.y;
            fb[r].x = fb[r].x + tb.taps[o] * b.x;
            fb[r].y = fb[r].y + tb.taps[o] * b.y;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        sm.prod[ks][R * blk + r] =
            make_float2(fa[r].x * fb[r].x + fa[r].y * fb[r].y,
                        fa[r].y * fb[r].x - fa[r].x * fb[r].y);
    }
    __syncthreads();
    if (tid < PART) {
#pragma unroll
      for (int ks = 0; ks < S; ++ks) {
        acc.x = acc.x + sm.prod[ks][tid].x;
        acc.y = acc.y + sm.prod[ks][tid].y;
      }
    }
  }
  if (tid < PART)
    sums[static_cast<long long>(s) * FFTCP + PART * h + tid] = acc;
}

// the first of the larger (p, i): the lower index wins ties
__device__ __forceinline__ bool better(float p, int i, float bp, int bi) {
  return p > bp || (p == bp && i < bi);
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(WTHREADS)
    coarse_timing_window_kernel(const float2* __restrict__ sums,
                                const Tables tb, int filter_delay,
                                int* __restrict__ samperr,
                                float2* __restrict__ max_v) {
  __shared__ float2 ext[EXT];
  __shared__ float2 v_s[SLICE];
  __shared__ float warp_p[WTHREADS / 32];
  __shared__ int warp_i[WTHREADS / 32];
  __shared__ float cand_p[CLUSTER];  // rank 0: each CTA's best
  __shared__ int cand_i[CLUSTER];
  __shared__ float2 cand_v[CLUSTER];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const int s = blockIdx.x / CLUSTER;
  const int tid = threadIdx.x;
  const float2* st = sums + static_cast<long long>(s) * FFTCP;
  // every CTA of the cluster must have started before one writes into
  // another's shared memory: arrive now, wait before the stores below
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  for (int i = tid; i < EXT; i += WTHREADS) {
    int m = SLICE * c + i;
    if (m >= FFTCP) m -= FFTCP;  // rank 7 reads rank 0's: the wrap
    ext[i] = st[m];
  }
  __syncthreads();

  // v[i] for 3 consecutive i a thread, j = 0..111 in order
  float best = -1.0f;
  int at = 0x7fffffff;
  if (tid < VTHREADS) {
    const int i0 = VR * tid;
    float2 v[VR];
#pragma unroll
    for (int r = 0; r < VR; ++r) v[r] = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int m = 0; m < CP + VR - 1; ++m) {
      const float2 e = ext[i0 + m];
#pragma unroll
      for (int r = 0; r < VR; ++r) {
        const int j = m - r;
        if (j >= 0 && j < CP) {
          v[r].x = v[r].x + tb.w[j] * e.x;
          v[r].y = v[r].y + tb.w[j] * e.y;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < VR; ++r) {
      v_s[i0 + r] = v[r];
      const float p = v[r].x * v[r].x + v[r].y * v[r].y;
      if (p > best) {  // i rises within a thread: the first index wins ties
        best = p;
        at = i0 + r;
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, at, o);
    if (better(ob, oi, best, at)) {
      best = ob;
      at = oi;
    }
  }
  if ((tid & 31) == 0) {
    warp_p[tid >> 5] = best;
    warp_i[tid >> 5] = at;
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (tid == 0) {
    for (int w = 1; w < WTHREADS / 32; ++w)
      if (better(warp_p[w], warp_i[w], best, at)) {
        best = warp_p[w];
        at = warp_i[w];
      }
    at = at < SLICE ? at : 0;
    *cluster.map_shared_rank(&cand_p[c], 0) = best;
    *cluster.map_shared_rank(&cand_i[c], 0) = SLICE * c + at;
    *cluster.map_shared_rank(&cand_v[c], 0) = v_s[at];
  }
  cluster.sync();
  if (c == 0 && tid == 0) {
    best = cand_p[0];
    at = cand_i[0];
    float2 bv = cand_v[0];
    for (int q = 1; q < CLUSTER; ++q)
      if (better(cand_p[q], cand_i[q], best, at)) {
        best = cand_p[q];
        at = cand_i[q];
        bv = cand_v[q];
      }
    samperr[s] = (at + FFTCP - filter_delay) % FFTCP;
    max_v[s] = bv;
  }
}

}  // namespace

// taps [32] and shape_kernel [112] are host float32 arrays: they go into
// the launches' parameters; sums is a device scratch of n_stations x 2160
// float2
extern "C" int coarse_timing(const void* samples, long long n_samples,
                             const void* taps, const void* shape_kernel,
                             int filter_delay, void* sums, void* samperr,
                             void* max_v, int n_stations, void* stream) {
  if (n_stations <= 0 || n_samples < WINDOW)
    return (int)cudaErrorInvalidValue;
  Tables tb;
  for (int o = 0; o < NTAPS; ++o) tb.taps[o] = ((const float*)taps)[o];
  for (int j = 0; j < CP; ++j) tb.w[j] = ((const float*)shape_kernel)[j];
  const size_t smem = sizeof(SumsSmem);
  cudaError_t err = cudaFuncSetAttribute(
      coarse_timing_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  coarse_timing_sums_kernel<<<n_stations * PARTS, THREADS, smem, st>>>(
      (const float2*)samples, n_samples, tb, (float2*)sums);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  coarse_timing_window_kernel<<<n_stations * CLUSTER, WTHREADS, 0, st>>>(
      (const float2*)sums, tb, filter_delay, (int*)samperr, (float2*)max_v);
  return (int)cudaGetLastError();
}
