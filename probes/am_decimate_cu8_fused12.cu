// A design tried for K1's AM cascade (csrc/am_decimate_cu8.cu), for
// probes/k1am_k5_variants.py: stages 1 and 2 fused in registers.  A thread
// makes 18 consecutive stage-1 outputs from its own 18 words (the 10 pairs
// past them from the next lane by shuffles, lane 31 converting its own),
// then 9 stage-2 outputs from them and from the next lane's first 13
// stage-1 outputs (shuffles; lane 31 from the next warp's lane 0, through
// shared memory behind one barrier), so stage 1's outputs never reach
// shared memory.  Stages 3-5 as the port's.  -DV_MINB=n: __launch_bounds__'
// least CTAs an SM (default 2).  The entry point and its arguments are the
// port's.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef V_MINB
#define V_MINB 2
#endif

namespace {

constexpr int TILE = 256;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int HIST = 14;
constexpr int N4 = 2 * TILE + HIST;
constexpr int N3 = 2 * N4 + HIST;
constexpr int N2 = 2 * N3 + HIST;
constexpr int N1 = 2 * N2 + HIST;
constexpr int N0 = 2 * N1 + HIST;
constexpr int R1 = 18, R12 = R1 / 2, R3 = 5, R4 = 3, R5 = 1;
static_assert(N1 <= R1 * THREADS && N2 <= R12 * THREADS, "one pass");
constexpr int CHUNKS = (2 * N0 + 15) / 16 + 1;
constexpr int LOADS = (CHUNKS + THREADS - 1) / THREADS;
constexpr int reach(int n, int r) { return 2 * (((n + r - 1) / r) * r + 7); }
constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int RAW_WORDS = R1 * THREADS + 16;
static_assert(RAW_WORDS * 4 >= CHUNKS * 16 && 3 + R1 * THREADS + 8 <= RAW_WORDS,
              "the byte buffer holds the loads and stage 1's reads");
// y2 (over the bytes): stage 2's and stage 4's outputs; y3 stage 3's
constexpr int Y2_LEN = cmax(N2, cmax(reach(N3, R3), reach(TILE, R5)));
static_assert(Y2_LEN * 8 <= RAW_WORDS * 4, "y2 fits over the bytes");
constexpr int Y3_LEN = cmax(N3, reach(N4, R4));
constexpr int EDGE = 13;  // stage-1 outputs a lane 0 hands the warp before
constexpr int SMEM_BYTES = RAW_WORDS * 4 + Y3_LEN * 8 + WARPS * EDGE * 8;

__device__ __forceinline__ float cvt(uint32_t w, int b, float scale16) {
  const float f =
      __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540u | b)) - 8388735.0f;
  return f * scale16;
}

template <bool HALF>
__device__ __forceinline__ uint32_t word(const uint32_t* rw, int i) {
  if (HALF) return __funnelshift_r(rw[i], rw[i + 1], 16);
  return rw[i];
}

__device__ __forceinline__ float2 shfl_down(float2 v) {
  return make_float2(__shfl_down_sync(0xffffffffu, v.x, 1),
                     __shfl_down_sync(0xffffffffu, v.y, 1));
}

// Stages 1 and 2: thread t makes stage-1 outputs 18 t .. 18 t + 17 in
// registers and stage-2 outputs 9 t .. 9 t + 8 into y2.
template <bool HALF>
__device__ __forceinline__ void stage12(const uint32_t* rw, float2* edge,
                                        float2* y2, int n2, const float* he,
                                        float h7, float scale16) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int w0 = threadIdx.x * R1;
  float2 p[2 * R1 + 13];
#pragma unroll
  for (int k = 0; k < R1; ++k) {
    const uint32_t w = word<HALF>(rw, w0 + k);
    p[2 * k] = make_float2(cvt(w, 0, scale16), cvt(w, 1, scale16));
    p[2 * k + 1] = make_float2(cvt(w, 2, scale16), cvt(w, 3, scale16));
  }
#pragma unroll
  for (int e = 0; e < 13; ++e)
    if (e % 2 == 0 || e < 6) p[2 * R1 + e] = shfl_down(p[e]);
  if (lane == 31) {
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      const uint32_t w = word<HALF>(rw, w0 + R1 + k);
      p[2 * R1 + 2 * k] = make_float2(cvt(w, 0, scale16), cvt(w, 1, scale16));
      if (k < 3)
        p[2 * R1 + 2 * k + 1] =
            make_float2(cvt(w, 2, scale16), cvt(w, 3, scale16));
    }
  }
  // stage 1 in registers, then the 13 after them (of which the evens and
  // 1, 3, 5 are read) from the next lane
  float2 y[R1 + EDGE];
#pragma unroll
  for (int r = 0; r < R1; ++r) {
    const float2 c = p[2 * r + 7];
    float yi = h7 * c.x, yq = h7 * c.y;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      yi = yi + he[j] * p[2 * r + 2 * j].x;
      yq = yq + he[j] * p[2 * r + 2 * j].y;
    }
    y[r] = make_float2(yi, yq);
  }
  if (lane == 0) {
#pragma unroll
    for (int e = 0; e < EDGE; ++e) edge[warp * EDGE + e] = y[e];
  }
#pragma unroll
  for (int e = 0; e < EDGE; ++e)
    if (e % 2 == 0 || e < 6) y[R1 + e] = shfl_down(y[e]);
  __syncthreads();  // every lane 0's edge, and every read of the bytes
  if (lane == 31 && warp + 1 < WARPS) {
#pragma unroll
    for (int e = 0; e < EDGE; ++e)
      if (e % 2 == 0 || e < 6) y[R1 + e] = edge[(warp + 1) * EDGE + e];
  }
  const int q0 = threadIdx.x * R12;
#pragma unroll
  for (int k = 0; k < R12; ++k) {
    const float2 c = y[2 * k + 7];
    float yi = h7 * c.x, yq = h7 * c.y;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      yi = yi + he[j] * y[2 * k + 2 * j].x;
      yq = yq + he[j] * y[2 * k + 2 * j].y;
    }
    if (q0 + k < n2) y2[q0 + k] = make_float2(yi, yq);
  }
}

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
  uint32_t* raw = reinterpret_cast<uint32_t*>(smem);
  float2* y2 = reinterpret_cast<float2*>(smem);
  float2* y3 = reinterpret_cast<float2*>(smem + RAW_WORDS * 4);
  float2* edge = y3 + Y3_LEN;

  const int s = blockIdx.y;
  const long long o0 = (long long)blockIdx.x * TILE;
  const int tn = (int)min((long long)TILE, (long long)n_out - o0);
  const int n4 = 2 * tn + HIST, n3 = 2 * n4 + HIST, n2 = 2 * n3 + HIST;
  const int n1 = 2 * n2 + HIST, n0 = 2 * n1 + HIST;

  const uint8_t* g = wire + ((long long)s * n_in_pairs + 32 * o0) * 2;
  const uintptr_t base = (uintptr_t)g & ~(uintptr_t)15;
  const int delta = (int)((uintptr_t)g - base);
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

  if (delta & 2)
    stage12<true>(raw + (delta >> 2), edge, y2, n2, he, h7, scale16);
  else
    stage12<false>(raw + (delta >> 2), edge, y2, n2, he, h7, scale16);
  __syncthreads();
  stage<R3>(y2, y3, n3, he, h7);
  __syncthreads();
  stage<R4>(y3, y2, n4, he, h7);
  __syncthreads();
  stage<R5>(y2, out + (long long)s * n_out + o0, tn, he, h7);
}

}  // namespace

extern "C" int am_decimate_cu8(const void* wire, void* out, const void* taps,
                               float scale, long long n_in_pairs, int n_out,
                               int n_stations, void* stream) {
  if (n_stations <= 0 || n_out <= 0 ||
      n_in_pairs != N0 - 32LL * TILE + 32LL * n_out || ((uintptr_t)wire & 1))
    return (int)cudaErrorInvalidValue;
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
