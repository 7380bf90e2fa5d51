// The designs tried for K1's AM cascade (csrc/am_decimate_cu8.cu), as
// knobs on a copy of the port's kernel, for probes/k1am_k5_variants.py:
//   -DV_TABLE=1      each byte converted through a 256-entry shared table
//                    of the exact converted values, not by arithmetic;
//   -DV_RECONVERT=1  stage 1's 10 pairs past a thread's own read and
//                    converted by every lane itself, not taken from the
//                    next lane by shuffles;
//   -DV_MINB=n       __launch_bounds__' least CTAs an SM (default 2);
//   -DV_R2/R3/R4=r   outputs a thread in stages 2, 3 and 4 (odd; default
//                    9, 5, 3);
//   -DV_TILE=t       outputs a CTA and its threads (default 256; 512 with
//                    stage 1's 17 outputs a thread still in one pass);
//   -DV_PIPE=k       a persistent grid of k waves of resident CTAs, each
//                    walking tiles with the next tile's bytes brought in
//                    by cp.async while it computes the current one;
//   -DV_CLOCK=1      thread 0 of each CTA stamps the global timer at entry,
//                    after the loads and after each stage, and its SM, into
//                    k1am_clock (read by k1am_clock_read).
// With no knob it is the port's kernel.  The entry point and its arguments
// are the port's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#ifndef V_TILE
#define V_TILE 256
#endif
#ifndef V_CLOCK
#define V_CLOCK 0
#endif
constexpr int TILE = V_TILE;
constexpr int THREADS = V_TILE;
constexpr int CLOCK_CTAS = 16 * 1024;
__device__ long long k1am_clock[CLOCK_CTAS * 8];

__device__ __forceinline__ void stamp(int i) {
  if (V_CLOCK && threadIdx.x == 0) {
    const int cta = blockIdx.y * gridDim.x + blockIdx.x;
    if (cta < CLOCK_CTAS) {
      long long t;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      k1am_clock[cta * 8 + i] = t;
      if (i == 0) {
        int sm;
        asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
        k1am_clock[cta * 8 + 7] = sm;
      }
    }
  }
}
constexpr int HIST = 14;             // each stage's overlap
constexpr int N4 = 2 * TILE + HIST;  // stage-4 outputs a CTA needs
constexpr int N3 = 2 * N4 + HIST;
constexpr int N2 = 2 * N3 + HIST;
constexpr int N1 = 2 * N2 + HIST;
constexpr int N0 = 2 * N1 + HIST;  // wire pairs: 32 TILE + 434
// outputs a thread makes in stage 1 and in stages 2-5
#ifndef V_TABLE
#define V_TABLE 0
#endif
#ifndef V_RECONVERT
#define V_RECONVERT 0
#endif
#ifndef V_MINB
#define V_MINB 2
#endif
#ifndef V_R2
#define V_R2 9
#endif
#ifndef V_R3
#define V_R3 5
#endif
#ifndef V_R4
#define V_R4 3
#endif
constexpr int R1 = 17, R2 = V_R2, R3 = V_R3, R4 = V_R4, R5 = 1;
static_assert(N1 <= R1 * THREADS, "stage 1 in one pass of the CTA");
// 16-byte blocks of wire a CTA loads (the boundary below adds one)
constexpr int CHUNKS = (2 * N0 + 15) / 16 + 1;
constexpr int LOADS = (CHUNKS + THREADS - 1) / THREADS;
// float2 entries a stage of n outputs, R a thread, reads of its input
constexpr int reach(int n, int r) { return 2 * (((n + r - 1) / r) * r + 7); }
constexpr int cmax(int a, int b) { return a > b ? a : b; }
// the bytes' words: stage 1 reads up to 3 (alignment) + 17 * 256 + 8
constexpr int RAW_WORDS = R1 * THREADS + 16;
static_assert(RAW_WORDS * 4 >= CHUNKS * 16 && 3 + R1 * THREADS + 8 <= RAW_WORDS,
              "the byte buffer holds the loads and stage 1's reads");
// y1: stage 1's and stage 3's outputs; y2 (over the bytes): stage 2's and 4's
constexpr int Y1_LEN = cmax(R1 * THREADS, cmax(reach(N2, R2), reach(N4, R4)));
constexpr int Y2_LEN = cmax(N2, cmax(reach(N3, R3), reach(TILE, R5)));
static_assert(Y2_LEN * 8 <= RAW_WORDS * 4, "y2 fits over the bytes");
constexpr int SMEM_BYTES = Y1_LEN * 8 + RAW_WORDS * 4;

// byte b of word w, (u - 127) * scale16: 2^23 + u exactly by a byte
// permute, less 2^23 + 127 exactly, times scale / 16
__device__ __forceinline__ float cvt_arith(uint32_t w, int b, float scale16) {
  const float f =
      __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540u | b)) - 8388735.0f;
  return f * scale16;
}
#if V_TABLE
#define cvt(w, b, scale16) (tab[__byte_perm((w), 0u, 0x4440u | (b))])
#else
#define cvt(w, b, scale16) cvt_arith((w), (b), (scale16))
#endif

// word i of the CTA's bytes; HALF: they start 2 bytes into a word
template <bool HALF>
__device__ __forceinline__ uint32_t word(const uint32_t* rw, int i) {
  if (HALF) return __funnelshift_r(rw[i], rw[i + 1], 16);
  return rw[i];
}

// Stage 1 from the bytes: thread t makes outputs 17 t .. 17 t + 16.
template <bool HALF>
__device__ __forceinline__ void stage1(const uint32_t* rw, float2* y, int n,
                                       const float* he, float h7,
                                       float scale16, const float* tab) {
  const int lane = threadIdx.x & 31;
  const int w0 = threadIdx.x * R1;
  // its pairs 0..33, then 34..46 (of which 34, 35, 36, 37, 38, 39, 40, 42,
  // 44 and 46 are read): lane + 1's pairs 0..12
  float2 p[2 * R1 + 13];
#pragma unroll
  for (int k = 0; k < R1; ++k) {
    const uint32_t w = word<HALF>(rw, w0 + k);
    p[2 * k] = make_float2(cvt(w, 0, scale16), cvt(w, 1, scale16));
    p[2 * k + 1] = make_float2(cvt(w, 2, scale16), cvt(w, 3, scale16));
  }
#if !V_RECONVERT
#pragma unroll
  for (int e = 0; e < 13; ++e) {
    if (e % 2 == 0 || e < 6) {
      p[2 * R1 + e].x = __shfl_down_sync(0xffffffffu, p[e].x, 1);
      p[2 * R1 + e].y = __shfl_down_sync(0xffffffffu, p[e].y, 1);
    }
  }
  if (lane == 31)
#endif
  {
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      const uint32_t w = word<HALF>(rw, w0 + R1 + k);
      p[2 * R1 + 2 * k] = make_float2(cvt(w, 0, scale16), cvt(w, 1, scale16));
      if (k < 3)
        p[2 * R1 + 2 * k + 1] =
            make_float2(cvt(w, 2, scale16), cvt(w, 3, scale16));
    }
  }
#pragma unroll
  for (int r = 0; r < R1; ++r) {
    const float2 c = p[2 * r + 7];
    float yi = h7 * c.x, yq = h7 * c.y;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      yi = yi + he[j] * p[2 * r + 2 * j].x;
      yq = yq + he[j] * p[2 * r + 2 * j].y;
    }
    if (w0 + r < n) y[w0 + r] = make_float2(yi, yq);
  }
}

// One halfband stage from shared float2 x into y[0..n): a thread R
// consecutive outputs from x4[q0 .. q0 + R + 6] (x4[k] = x[2k], x[2k+1]).
template <int R>
__device__ __forceinline__ void stage(const float2* x, float2* y, int n,
                                      const float* he, float h7) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const int items = (n + R - 1) / R;
  for (int it = threadIdx.x; it < items; it += THREADS) {
    const int q0 = it * R;
    float4 w[R + 7];
#pragma unroll
    for (int k = 0; k < R + 7; ++k) w[k] = x4[q0 + k];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float yi = h7 * w[r + 3].z, yq = h7 * w[r + 3].w;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        yi = yi + he[j] * w[r + j].x;
        yq = yq + he[j] * w[r + j].y;
      }
      if (q0 + r < n) y[q0 + r] = make_float2(yi, yq);
    }
  }
}

__global__ void __launch_bounds__(THREADS, V_MINB) am_decimate_cu8_kernel(
    const uint8_t* __restrict__ wire, float2* __restrict__ out,
    const float* __restrict__ taps, float scale16, long long n_in_pairs,
    int n_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float tab[V_TABLE ? 256 : 1];
  if (V_TABLE) tab[threadIdx.x] = cvt_arith(threadIdx.x, 0, scale16);
  float2* y1 = reinterpret_cast<float2*>(smem);
  uint32_t* raw = reinterpret_cast<uint32_t*>(smem + Y1_LEN * 8);
  float2* y2 = reinterpret_cast<float2*>(raw);

  stamp(0);
  const int s = blockIdx.y;
  const long long o0 = (long long)blockIdx.x * TILE;
  const int tn = (int)min((long long)TILE, (long long)n_out - o0);
  // the sizes of this CTA's stages (the last CTA of a station may be short)
  const int n4 = 2 * tn + HIST, n3 = 2 * n4 + HIST, n2 = 2 * n3 + HIST;
  const int n1 = 2 * n2 + HIST, n0 = 2 * n1 + HIST;

  // the CTA's bytes, from the 16-byte boundary below them
  const uint8_t* g = wire + ((long long)s * n_in_pairs + 32 * o0) * 2;
  const uintptr_t base = (uintptr_t)g & ~(uintptr_t)15;
  const int delta = (int)((uintptr_t)g - base);  // even: the wrapper checks
  const int chunks = (delta + 2 * n0 + 15) >> 4;
  const uint4* src = reinterpret_cast<const uint4*>(base);
  uint4* dst = reinterpret_cast<uint4*>(raw);
  uint4 v[LOADS];
#pragma unroll
  for (int k = 0; k < LOADS; ++k) {
    const int c = threadIdx.x + k * THREADS;
    if (c < chunks) v[k] = __ldg(src + c);
  }
  float he[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) he[j] = __ldg(taps + j);
  const float h7 = __ldg(taps + 8);
#pragma unroll
  for (int k = 0; k < LOADS; ++k) {
    const int c = threadIdx.x + k * THREADS;
    if (c < chunks) dst[c] = v[k];
  }
  __syncthreads();
  stamp(1);

  if (delta & 2)
    stage1<true>(raw + (delta >> 2), y1, n1, he, h7, scale16, tab);
  else
    stage1<false>(raw + (delta >> 2), y1, n1, he, h7, scale16, tab);
  __syncthreads();
  stamp(2);
  stage<R2>(y1, y2, n2, he, h7);
  __syncthreads();
  stamp(3);
  stage<R3>(y2, y1, n3, he, h7);
  __syncthreads();
  stamp(4);
  stage<R4>(y1, y2, n4, he, h7);
  __syncthreads();
  stamp(5);
  stage<R5>(y2, out + (long long)s * n_out + o0, tn, he, h7);
  if (V_CLOCK) __syncthreads();
  stamp(6);
}

#ifndef V_PIPE
#define V_PIPE 0
#endif

// V_PIPE: a persistent CTA walks tiles (tile = blockIdx.x, then + gridDim.x)
// and brings the next tile's bytes in by cp.async into a second byte buffer
// while it computes the current one (y2 over the current one's bytes).
__device__ __forceinline__ void prefetch(const uint8_t* wire, long long tile,
                                         int tiles_a_station,
                                         long long n_in_pairs, int n_out,
                                         uint32_t* raw) {
  const int s = (int)(tile / tiles_a_station);
  const long long o0 = (tile % tiles_a_station) * (long long)TILE;
  const int tn = (int)min((long long)TILE, (long long)n_out - o0);
  const int n0 = 2 * (2 * (2 * (2 * (2 * tn + HIST) + HIST) + HIST) + HIST)
                 + HIST;
  const uint8_t* g = wire + ((long long)s * n_in_pairs + 32 * o0) * 2;
  const uintptr_t base = (uintptr_t)g & ~(uintptr_t)15;
  const int chunks = ((int)((uintptr_t)g - base) + 2 * n0 + 15) >> 4;
  const uint32_t dst0 = (uint32_t)__cvta_generic_to_shared(raw);
  for (int c = threadIdx.x; c < chunks; c += THREADS)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     dst0 + 16 * c),
                 "l"(base + 16 * (uintptr_t)c)
                 : "memory");
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__global__ void __launch_bounds__(THREADS, V_MINB) am_decimate_cu8_pipe_kernel(
    const uint8_t* __restrict__ wire, float2* __restrict__ out,
    const float* __restrict__ taps, float scale16, long long n_in_pairs,
    int n_out, int tiles_a_station, long long tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float tab[V_TABLE ? 256 : 1];
  if (V_TABLE) tab[threadIdx.x] = cvt_arith(threadIdx.x, 0, scale16);
  float2* y1 = reinterpret_cast<float2*>(smem);
  uint32_t* raws[2] = {reinterpret_cast<uint32_t*>(smem + Y1_LEN * 8),
                       reinterpret_cast<uint32_t*>(smem + Y1_LEN * 8
                                                   + RAW_WORDS * 4)};
  float he[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) he[j] = __ldg(taps + j);
  const float h7 = __ldg(taps + 8);
  long long tile = blockIdx.x;
  int buf = 0;
  if (tile < tiles)
    prefetch(wire, tile, tiles_a_station, n_in_pairs, n_out, raws[0]);
  for (; tile < tiles; tile += gridDim.x, buf ^= 1) {
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
    const long long next = tile + gridDim.x;
    if (next < tiles)
      prefetch(wire, next, tiles_a_station, n_in_pairs, n_out,
               raws[buf ^ 1]);
    uint32_t* raw = raws[buf];
    float2* y2 = reinterpret_cast<float2*>(raw);
    const int s = (int)(tile / tiles_a_station);
    const long long o0 = (tile % tiles_a_station) * (long long)TILE;
    const int tn = (int)min((long long)TILE, (long long)n_out - o0);
    const int n4 = 2 * tn + HIST, n3 = 2 * n4 + HIST, n2 = 2 * n3 + HIST;
    const int n1 = 2 * n2 + HIST;
    const uint8_t* g = wire + ((long long)s * n_in_pairs + 32 * o0) * 2;
    const int delta = (int)((uintptr_t)g & 15);
    if (delta & 2)
      stage1<true>(raw + (delta >> 2), y1, n1, he, h7, scale16, tab);
    else
      stage1<false>(raw + (delta >> 2), y1, n1, he, h7, scale16, tab);
    __syncthreads();
    stage<R2>(y1, y2, n2, he, h7);
    __syncthreads();
    stage<R3>(y2, y1, n3, he, h7);
    __syncthreads();
    stage<R4>(y1, y2, n4, he, h7);
    __syncthreads();
    stage<R5>(y2, out + (long long)s * n_out + o0, tn, he, h7);
  }
}

}  // namespace

// taps: 9 float32 on the device, the 8 even-phase taps then the centre tap;
// n_in_pairs = 434 + 32 n_out; the wire's address even (whole pairs).
extern "C" int am_decimate_cu8(const void* wire, void* out, const void* taps,
                               float scale, long long n_in_pairs, int n_out,
                               int n_stations, void* stream) {
  if (n_stations <= 0 || n_out <= 0 ||
      n_in_pairs != N0 - 32LL * TILE + 32LL * n_out || ((uintptr_t)wire & 1))
    return (int)cudaErrorInvalidValue;
#if V_PIPE
  {
    constexpr int PIPE_SMEM = SMEM_BYTES + RAW_WORDS * 4;
    cudaError_t err = cudaFuncSetAttribute(
        am_decimate_cu8_pipe_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, PIPE_SMEM);
    int dev = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, am_decimate_cu8_pipe_kernel, THREADS, PIPE_SMEM);
    if (err != cudaSuccess) return (int)err;
    const int tps = (n_out + TILE - 1) / TILE;
    const long long tiles = (long long)tps * n_stations;
    const long long cap = (long long)sms * per_sm * V_PIPE;
    const int grid = (int)(tiles < cap ? tiles : cap);
    am_decimate_cu8_pipe_kernel<<<grid, THREADS, PIPE_SMEM,
                                  (cudaStream_t)stream>>>(
        (const uint8_t*)wire, (float2*)out, (const float*)taps,
        scale * 0.0625f, n_in_pairs, n_out, tps, tiles);
    return (int)cudaGetLastError();
  }
#endif
  cudaError_t err = cudaFuncSetAttribute(
      am_decimate_cu8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n_out + TILE - 1) / TILE, n_stations);
  am_decimate_cu8_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const uint8_t*)wire, (float2*)out, (const float*)taps,
      scale * 0.0625f, n_in_pairs, n_out);
  return (int)cudaGetLastError();
}

// the clock of the last launch: n CTAs x 8 int64 (entry, loads, stages 1-4,
// exit, SM)
extern "C" int k1am_clock_read(void* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, k1am_clock,
                                   sizeof(long long) * 8 * (size_t)n);
}
