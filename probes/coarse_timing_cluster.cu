// A design tried for K9 (nrsc5_tpu_torch/csrc/coarse_timing.cu), kept so
// that probes/k6_k9_variants.py can time it against the kernels the port
// runs: the whole of K9 in one launch, one thread-block cluster of 8 CTAs a
// station (one CTA an SM: ~155 KB of shared memory each).
//
// Per station, on the first 71280 samples x of its conjugated rc buffer
// (nrsc5_tpu/ops/acquire_rc.py:coarse_timing_rc, lines 43-70):
//   f[0] = 0,  f[n] = sum_o taps[o] * x[n-1-o]      (32-tap band filter)
//   sums[t] = sum_k f[k*2160 + t] * conj(f[2048 + k*2160 + t])
//   v[i] = sum_j w[j] * sums[(i + j) mod 2160]     (j < 112, circular)
//   i_max = first argmax |v[i]|^2,  samperr = (i_max + 2160 - delay) % 2160
//   max_v = v[i_max]
// Design:
//   * CTA c of a station's cluster owns timings [270c, 270c + 270).  The
//     symbols go in 4 stages of 8; each stage's two sample runs a symbol,
//     [k*2160 + 270c - 32, +302) and [2048 + k*2160 + 270c - 32, +302)
//     (zero before the window's start), come into shared memory by
//     cp.async, a stage ahead of their use.
//   * A thread takes 9 consecutive timings of one symbol and filters each
//     of their 18 samples once, newest sample first, so every output's sum
//     runs o = 0..31 in order from 0.0.  Each timing's owner thread adds
//     the stage's 8 CP products into a register in symbol order.
//   * After a cluster barrier each CTA copies the 111 sums past its slice
//     from the next rank (rank 7 from rank 0) by distributed shared memory,
//     and 90 threads take 3 consecutive v[i] each, j = 0..111 in order.
//   * The argmax: the first index of the largest |v|^2 a thread, a warp, a
//     CTA; each CTA's candidate goes into rank 0's shared memory, and after
//     a second cluster barrier rank 0 takes the largest, the lower index on
//     ties, and writes samperr and max_v.
// Every sum runs in the plain version's order, so with -fmad=false the
// kernel and its plain version agree bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int FFT = 2048;
constexpr int CP = 112;
constexpr int FFTCP = FFT + CP;
constexpr int NSYM = 32;
constexpr int NTAPS = 32;
constexpr int CLUSTER = 8;                 // CTAs a station
constexpr int SLICE = FFTCP / CLUSTER;     // timings a CTA: 270
constexpr int R = 9;                       // timings a thread
constexpr int BLOCKS = SLICE / R;          // timing blocks a symbol: 30
constexpr int WIN = R + NTAPS - 1;         // samples a thread's window: 40
constexpr int RUN = SLICE + NTAPS;         // samples a run (history + 270)
constexpr int S = 8;                       // symbols a stage
constexpr int STAGES = NSYM / S;
constexpr int THREADS = 256;
constexpr int ITEMS = S * BLOCKS;          // 240 items a stage
constexpr int STAGE_SAMPLES = S * 2 * RUN;
constexpr int EXT = SLICE + CP - 1;        // the slice's sums and 111 more
constexpr int VR = 3;                      // window outputs a thread
constexpr int VTHREADS = SLICE / VR;       // 90
static_assert(SLICE * CLUSTER == FFTCP && BLOCKS * R == SLICE, "tiling");
static_assert(ITEMS <= THREADS && NSYM % S == 0, "one item a thread");
static_assert(SLICE >= CP - 1, "the window reaches the next rank only");
static_assert(VTHREADS * VR == SLICE && VTHREADS <= THREADS, "window");

struct Tables {
  float taps[NTAPS];
  float w[CP];
};

struct Smem {
  float2 run[2][STAGE_SAMPLES];  // two stages of sample runs
  float2 prod[S][SLICE];         // a stage's CP products
  float2 sum[EXT];               // the slice's sums, then the next rank's
  float2 v[SLICE];
  float cand_p[CLUSTER];         // rank 0: each CTA's best
  int cand_i[CLUSTER];
  float2 cand_v[CLUSTER];
  float warp_p[THREADS / 32];
  int warp_i[THREADS / 32];
};

__device__ __forceinline__ void cp_async8(float2* dst, const float2* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 8 : 0;  // 0: zero fill
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// the first of the larger (p, i): the lower index wins ties
__device__ __forceinline__ bool better(float p, int i, float bp, int bi) {
  return p > bp || (p == bp && i < bi);
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 1)
    coarse_timing_kernel(const float2* __restrict__ samples,
                         long long n_samples, const Tables tb,
                         int filter_delay, int* __restrict__ samperr,
                         float2* __restrict__ max_v) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const int s = blockIdx.x / CLUSTER;
  const int tid = threadIdx.x;
  const float2* x = samples + static_cast<long long>(s) * n_samples;

  // stage g's runs: run q = 2 ks + r of symbol 8g + ks, r = 0 (a) or 1 (b)
  auto load_stage = [&](int g) {
    float2* dst = sm.run[g & 1];
    for (int e = tid; e < STAGE_SAMPLES; e += THREADS) {
      const int q = e / RUN, j = e - q * RUN;
      const int k = g * S + (q >> 1);
      const long long n = static_cast<long long>(k) * FFTCP
                          + ((q & 1) ? FFT : 0) + SLICE * c - NTAPS + j;
      cp_async8(dst + e, x + (n >= 0 ? n : 0), n >= 0);
    }
    cp_async_commit();
  };

  float2 acc_sum[2] = {make_float2(0.0f, 0.0f), make_float2(0.0f, 0.0f)};
  load_stage(0);
  load_stage(1);
  for (int g = 0; g < STAGES; ++g) {
    cp_async_wait_one();
    __syncthreads();
    if (tid < ITEMS) {
      const int ks = tid / BLOCKS, blk = tid - ks * BLOCKS;
      const float2* ra = sm.run[g & 1] + 2 * ks * RUN + R * blk;
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
    if (g + 2 < STAGES) load_stage(g + 2);
    else cp_async_commit();  // an empty group keeps wait_group 1 exact
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int t = tid + u * THREADS;
      if (t < SLICE) {
#pragma unroll
        for (int ks = 0; ks < S; ++ks) {
          acc_sum[u].x = acc_sum[u].x + sm.prod[ks][t].x;
          acc_sum[u].y = acc_sum[u].y + sm.prod[ks][t].y;
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < 2; ++u)
    if (tid + u * THREADS < SLICE) sm.sum[tid + u * THREADS] = acc_sum[u];

  // the 111 sums past the slice, from the next rank (7 wraps to 0)
  cluster.sync();
  if (tid < CP - 1) {
    const float2* nxt = cluster.map_shared_rank(sm.sum, (c + 1) % CLUSTER);
    sm.sum[SLICE + tid] = nxt[tid];
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
      const float2 e = sm.sum[i0 + m];
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
      sm.v[i0 + r] = v[r];
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
    sm.warp_p[tid >> 5] = best;
    sm.warp_i[tid >> 5] = at;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < THREADS / 32; ++w)
      if (better(sm.warp_p[w], sm.warp_i[w], best, at)) {
        best = sm.warp_p[w];
        at = sm.warp_i[w];
      }
    Smem* r0 = cluster.map_shared_rank(&sm, 0);
    r0->cand_p[c] = best;
    r0->cand_i[c] = SLICE * c + at;
    r0->cand_v[c] = sm.v[at < SLICE ? at : 0];
  }
  cluster.sync();
  if (c == 0 && tid == 0) {
    best = sm.cand_p[0];
    at = sm.cand_i[0];
    float2 bv = sm.cand_v[0];
    for (int q = 1; q < CLUSTER; ++q)
      if (better(sm.cand_p[q], sm.cand_i[q], best, at)) {
        best = sm.cand_p[q];
        at = sm.cand_i[q];
        bv = sm.cand_v[q];
      }
    samperr[s] = (at + FFTCP - filter_delay) % FFTCP;
    max_v[s] = bv;
  }
}

}  // namespace

// taps [32] and shape_kernel [112] are host float32 arrays: they go into
// the launch's parameters
extern "C" int coarse_timing_cluster(const void* samples,
                                     long long n_samples, const void* taps,
                                     const void* shape_kernel,
                                     int filter_delay, void* samperr,
                                     void* max_v, int n_stations,
                                     void* stream) {
  if (n_stations <= 0 || n_samples < (long long)FFTCP * (NSYM + 1))
    return (int)cudaErrorInvalidValue;
  Tables tb;
  for (int o = 0; o < NTAPS; ++o) tb.taps[o] = ((const float*)taps)[o];
  for (int j = 0; j < CP; ++j) tb.w[j] = ((const float*)shape_kernel)[j];
  const size_t smem = sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      coarse_timing_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  coarse_timing_kernel<<<n_stations * CLUSTER, THREADS, smem,
                         (cudaStream_t)stream>>>(
      (const float2*)samples, n_samples, tb, filter_delay, (int*)samperr,
      (float2*)max_v);
  return (int)cudaGetLastError();
}
