// K1's AM cascade: cu8 wire -> AM chain input, the ingest scale, the
// reference's 1/16 and five ÷2 halfband stages fused in one pass.
//
// Replaces the JAX device functions nrsc5_tpu/serve.py:314-323 (the cu8
// ingest, (u - 127) * 64/32767, Q not negated, then x 1/16) and
// nrsc5_tpu/ops/frontend.py:154 decimate_overlap_rc(., 5) with :120
// halfband_rc (five stateless overlap-save stages, 434 input pairs of
// history), for all stations at once.
//
// wire [S, 434 + 32 N, 2] uint8 -> out [S, N, 2] float32.  Each stage,
// per I and Q:  y[m] = h7 * x[2m+7], then y += he[j] * x[2m+2j] for
// j = 0..7 in that order (frontend.py:138-141), so with -fmad=false the
// result is bit-identical to the plain PyTorch version.
//
// Bound on the H100: a 2-frame dispatch of 16 stations reads 142.1 MB of
// wire and writes 17.8 MB (0.048 ms at 3.35 TB/s), but the stages issue
// 31 N outputs x 34 separate float operations a station (no FMA, so that
// the bits stay the plain version's): 2.3 G, ~0.07 ms on 132 SMs x 128
// float32 lanes at 1.98 GHz.  So the design spends its issue slots on the
// arithmetic and little else.  One CTA of 256 threads makes TILE = 256
// outputs of a station (434 pairs of halo for 8192 pairs of its own):
//   - the CTA's wire bytes come in by 16-byte loads from the 16-byte
//     boundary below them (station rows lie 868 + 64 N bytes apart, so
//     they are 4-byte aligned only; a 16-byte block that holds a byte of
//     an allocation lies inside it) into shared memory, as bytes;
//   - stage 1 runs from registers: a thread makes 17 consecutive outputs
//     from its own 17 words (34 pairs), each byte converted once, by
//     arithmetic: (float)u - 127 as the float 2^23 + u less 2^23 + 127
//     (both exact), times scale/16 (exact: a power of two) -- the same
//     bits as ((u - 127) * scale) / 16; the 10 pairs past its own that
//     its last outputs read come from the next lane by shuffles (lane 31
//     converts them itself).  17 is odd, so the word loads of a warp fall
//     on 32 banks and its float2 stores on 16 bank pairs;
//   - stages 2-5 run from shared float2, a thread R consecutive outputs
//     from a register window of R + 7 16-byte loads (an even sample and
//     the odd one after it), R = 9, 5, 3, 1 so that each stage keeps most
//     of the 256 threads busy; R odd keeps the windows' loads off each
//     other's banks.  Stage 2 writes over the bytes, which stage 1 has
//     consumed: 52 KB of dynamic shared memory a CTA;
//   - four CTAs an SM (64 registers a thread): the loads and the short
//     late stages of one CTA leave the SM's issue slots to the others.
// On the H100 80GB HBM3 (700 W) it takes ~0.145 ms at 16 stations x 2
// frames, against a no-FMA issue floor of ~0.078 ms at 1980 MHz
// (chip_smoke.py's am_decimate_cu8 line; the designs tried beside it in
// probes/k1am_k5_variants.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 256;
constexpr int THREADS = 256;
constexpr int HIST = 14;             // each stage's overlap
constexpr int N4 = 2 * TILE + HIST;  // stage-4 outputs a CTA needs
constexpr int N3 = 2 * N4 + HIST;
constexpr int N2 = 2 * N3 + HIST;
constexpr int N1 = 2 * N2 + HIST;
constexpr int N0 = 2 * N1 + HIST;  // wire pairs: 32 TILE + 434
// outputs a thread makes in stage 1 and in stages 2-5
constexpr int R1 = 17, R2 = 9, R3 = 5, R4 = 3, R5 = 1;
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
__device__ __forceinline__ float cvt(uint32_t w, int b, float scale16) {
  const float f =
      __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540u | b)) - 8388735.0f;
  return f * scale16;
}

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
                                       float scale16) {
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
#pragma unroll
  for (int e = 0; e < 13; ++e) {
    if (e % 2 == 0 || e < 6) {
      p[2 * R1 + e].x = __shfl_down_sync(0xffffffffu, p[e].x, 1);
      p[2 * R1 + e].y = __shfl_down_sync(0xffffffffu, p[e].y, 1);
    }
  }
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

__global__ void __launch_bounds__(THREADS, 4) am_decimate_cu8_kernel(
    const uint8_t* __restrict__ wire, float2* __restrict__ out,
    const float* __restrict__ taps, float scale16, long long n_in_pairs,
    int n_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* y1 = reinterpret_cast<float2*>(smem);
  uint32_t* raw = reinterpret_cast<uint32_t*>(smem + Y1_LEN * 8);
  float2* y2 = reinterpret_cast<float2*>(raw);

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

  if (delta & 2)
    stage1<true>(raw + (delta >> 2), y1, n1, he, h7, scale16);
  else
    stage1<false>(raw + (delta >> 2), y1, n1, he, h7, scale16);
  __syncthreads();
  stage<R2>(y1, y2, n2, he, h7);
  __syncthreads();
  stage<R3>(y2, y1, n3, he, h7);
  __syncthreads();
  stage<R4>(y1, y2, n4, he, h7);
  __syncthreads();
  stage<R5>(y2, out + (long long)s * n_out + o0, tn, he, h7);
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
