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
// Bound on the H100: device-memory bytes.  A 2-frame dispatch of 16
// stations reads 142.1 MB of wire and writes 17.8 MB (0.048 ms at 3.35
// TB/s) for ~0.3 Gflop.  Design: one CTA per TILE outputs of a station.
// The CTA reads its 32 TILE + 434 wire pairs once into shared memory as
// bytes, then runs the five stages there: stage k of TILE' = TILE << (5 -
// k) outputs reads 2 TILE' + 14 samples of the stage before, so the
// intermediate stages stay in shared memory and never touch device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;
constexpr int THREADS = 256;
constexpr int HIST = 14;            // each stage's overlap
constexpr int N4 = 2 * TILE + HIST;  // stage-4 outputs a CTA needs
constexpr int N3 = 2 * N4 + HIST;
constexpr int N2 = 2 * N3 + HIST;
constexpr int N1 = 2 * N2 + HIST;
constexpr int N0 = 2 * N1 + HIST;    // wire pairs: 32 TILE + 434

// One halfband stage over shared memory: y[0..n) from x[0..2n + 14).
__device__ __forceinline__ void stage(const float2* x, float2* y, int n,
                                      const float* he, float h7) {
  for (int m = threadIdx.x; m < n; m += THREADS) {
    const float2 c = x[2 * m + 7];
    float yi = h7 * c.x, yq = h7 * c.y;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 e = x[2 * m + 2 * j];
      yi = yi + he[j] * e.x;
      yq = yq + he[j] * e.y;
    }
    y[m] = make_float2(yi, yq);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS) am_decimate_cu8_kernel(
    const uint8_t* __restrict__ wire, float2* __restrict__ out,
    const float* __restrict__ taps, float scale, long long n_in_pairs,
    int n_out) {
  __shared__ uint8_t raw[2 * N0];
  __shared__ float2 a[N1];
  __shared__ float2 b[N2];
  __shared__ float he[8];
  __shared__ float h7;

  const int s = blockIdx.y;
  const long long o0 = (long long)blockIdx.x * TILE;
  const int tn = (int)min((long long)TILE, (long long)n_out - o0);
  // the sizes of this CTA's stages (the last CTA of a station may be short)
  const int n4 = 2 * tn + HIST, n3 = 2 * n4 + HIST, n2 = 2 * n3 + HIST;
  const int n1 = 2 * n2 + HIST, n0 = 2 * n1 + HIST;
  if (threadIdx.x < 8) he[threadIdx.x] = taps[threadIdx.x];
  if (threadIdx.x == 8) h7 = taps[8];

  const uint8_t* src = wire + ((long long)s * n_in_pairs + 32 * o0) * 2;
  for (int i = threadIdx.x; i < 2 * n0; i += THREADS) raw[i] = src[i];
  __syncthreads();

  // stage 1 straight from the bytes: x = ((u - 127) * scale) * (1/16)
  auto in = [&](int p, int c) {
    return (((float)raw[2 * p + c] - 127.0f) * scale) * 0.0625f;
  };
  for (int m = threadIdx.x; m < n1; m += THREADS) {
    float yi = h7 * in(2 * m + 7, 0), yq = h7 * in(2 * m + 7, 1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      yi = yi + he[j] * in(2 * m + 2 * j, 0);
      yq = yq + he[j] * in(2 * m + 2 * j, 1);
    }
    a[m] = make_float2(yi, yq);
  }
  __syncthreads();
  stage(a, b, n2, he, h7);
  stage(b, a, n3, he, h7);
  stage(a, b, n4, he, h7);

  float2* dst = out + (long long)s * n_out + o0;
  for (int m = threadIdx.x; m < tn; m += THREADS) {
    const float2 c = b[2 * m + 7];
    float yi = h7 * c.x, yq = h7 * c.y;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 e = b[2 * m + 2 * j];
      yi = yi + he[j] * e.x;
      yq = yq + he[j] * e.y;
    }
    dst[m] = make_float2(yi, yq);
  }
}

}  // namespace

// taps: 9 float32 on the device, the 8 even-phase taps then the centre tap;
// n_in_pairs = 434 + 32 n_out.
extern "C" int am_decimate_cu8(const void* wire, void* out, const void* taps,
                               float scale, long long n_in_pairs, int n_out,
                               int n_stations, void* stream) {
  if (n_stations <= 0 || n_out <= 0 || n_in_pairs != N0 - 32LL * TILE + 32LL * n_out)
    return (int)cudaErrorInvalidValue;
  dim3 grid((n_out + TILE - 1) / TILE, n_stations);
  am_decimate_cu8_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)wire, (float2*)out, (const float*)taps, scale,
      n_in_pairs, n_out);
  return (int)cudaGetLastError();
}
