// K16d as it was before its redesign (nrsc5_tpu_torch/csrc/qmf_synthesis.cu
// at the parent commit), for probes/k16cd_variants.py, with knobs: -DCUT=1
// writes each output without its taps (the stores and the history copy
// alone), -DCUT=2 loads and sums every output but stores none (the loads
// alone, kept live by a store that never happens); -DCLOCK makes thread 0
// of each CTA write the global timer at entry and exit, two int64 behind
// the new history.
//
// The parent's own notes:
//
// K16d: the 64-band QMF synthesis fold and the int16 output, for every lane
// and slot of a batch.
//
// Replaces the end of stage 5 of the JAX device function
// nrsc5_tpu/audio/batch.py:164 _make_device_fn -> fn (:484-503), after the
// synthesis modulation V = Xr SMr - Xi SMi (two matrix products and a
// subtraction, torch.matmul): out[s, i] = sum_d Vx[s + 9 - d, cidx[d, i]]
// W[d, i] over the 10 taps d in order, from Vx = [syn_hist (9 slots) | V
// (S slots)] of 128 values a slot; then round half to even and clip to
// int16.  The new history is the last 9 slots of V.
//
// Layout: v f32 [N, S, 128], syn_hist f32 [N, 9, 128], cidx int32 [10,
// 64], w f32 [10, 64].  Out: pcm int16 [N, 64 S], new syn_hist.
//
// Bound on the H100: device-memory bytes.  At N = 128 and S = 256 it reads
// 16.8 MB of V and writes 4.2 MB of PCM (0.0063 ms at 3.35 TB/s); 20
// operations an output.  Design: one thread per output sample, grid-stride,
// consecutive threads on consecutive i (the V reads of a tap are 64
// consecutive or 64 consecutive-from-64 floats of one slot row, and stay
// in L1 and L2 across the 10 taps and the 10 neighbouring slots); the tap
// tables (5 KB) are read through the read-only cache.  The history copy
// rides on the same grid.  -fmad=false keeps each product and sum rounded
// apart, as the plain version; rintf rounds half to even, as torch.round.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int HIST = 9;
constexpr int TAPS = 10;
#ifndef CUT
#define CUT 0
#endif

__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void __launch_bounds__(THREADS) qmf_synthesis_kernel(
    const float* __restrict__ v, const float* __restrict__ syn_hist,
    const int* __restrict__ cidx, const float* __restrict__ w,
    int16_t* __restrict__ pcm, float* __restrict__ new_hist, int n_slots,
    long long n_out, long long total) {
#ifdef CLOCK
  const unsigned long long t0 = gtime();
#endif
  for (long long e = blockIdx.x * (long long)THREADS + threadIdx.x; e < total;
       e += (long long)gridDim.x * THREADS) {
    if (e < n_out) {
      const long long ns = e >> 6;  // lane * S + slot
      const int i = (int)(e & 63);
      const long long n = ns / n_slots;
      const int s = (int)(ns - n * n_slots);
      float acc = 0.0f;
#if CUT == 1
      acc = (float)(i - 32);
#else
      for (int d = 0; d < TAPS; ++d) {
        const int row = s + HIST - d;  // row of [syn_hist | V]
        const int c = __ldg(cidx + d * 64 + i);
        const float x = row < HIST
                            ? syn_hist[(n * HIST + row) * 128 + c]
                            : v[(n * n_slots + row - HIST) * 128 + c];
        acc = acc + x * __ldg(w + d * 64 + i);
      }
#endif
      float r = rintf(acc);
      r = fminf(fmaxf(r, -32768.0f), 32767.0f);
#if CUT == 2
      if (acc == 1234567.0f) pcm[e] = (int16_t)r;
#else
      pcm[e] = (int16_t)r;
#endif
    } else {
      const long long r = e - n_out;  // [N, 9, 128]
      const long long n = r / (HIST * 128);
      const int j = (int)(r - n * HIST * 128);
      new_hist[r] = v[(n * n_slots + n_slots - HIST) * 128 + j];
    }
  }
#ifdef CLOCK
  if (threadIdx.x == 0) {
    long long* out = reinterpret_cast<long long*>(
        new_hist + (total - n_out)) + 2LL * blockIdx.x;
    out[0] = (long long)t0;
    out[1] = (long long)gtime();
  }
#endif
}

}  // namespace

extern "C" int qmf_synthesis_parent(const void* v, const void* syn_hist,
                             const void* cidx, const void* w, void* pcm,
                             void* new_hist, int n_lanes, int n_slots,
                             void* stream) {
  if (n_lanes <= 0 || n_slots < HIST) return (int)cudaErrorInvalidValue;
  const long long n_out = (long long)n_lanes * n_slots * 64;
  const long long total = n_out + (long long)n_lanes * HIST * 128;
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 132 * 32) blocks = 132 * 32;
  qmf_synthesis_kernel<<<(int)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)v, (const float*)syn_hist, (const int*)cidx,
      (const float*)w, (int16_t*)pcm, (float*)new_hist, n_slots, n_out,
      total);
  return (int)cudaGetLastError();
}
