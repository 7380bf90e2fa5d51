// K11 as it was before its redesign (the parent of the port's
// csrc/px_deinterleave.cu), kept for probes/k11_k15_variants.py: one thread
// per float32 output element, grid-stride, 64-bit index arithmetic, each
// output behind a chain of map loads (k7_map, then read_idx and hazard),
// the soft bits gathered from L2; the state rewrite a byte a thread and the
// phases by a loop on thread 0.
//
// Cuts for timing its parts (nvcc -D):
//   CUT=1  the stores alone: every output and state byte written 0 (the
//          index arithmetic kept, no map or data load);
//   CUT=2  the map loads and stores: each output written from its map
//          chain, no data gather; the state from its index arithmetic;
//   CUT=3  the K7 input alone (the state CTAs return at once);
//   CLOCK  the global timer at each CTA's entry and exit into clock[2 b],
//          clock[2 b + 1] (ns).
// The entry point takes the clock pointer last before the stream (null
// unless CLOCK).

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef CUT
#define CUT 0
#endif

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ int pmod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

__global__ void __launch_bounds__(THREADS) px_deinterleave_kernel(
    const int8_t* __restrict__ llr, const int8_t* __restrict__ internal,
    const int* __restrict__ phase, const int* __restrict__ read_idx,
    const uint8_t* __restrict__ hazard, const int* __restrict__ k7_map,
    float* __restrict__ ext, int8_t* __restrict__ new_internal,
    int* __restrict__ new_phase, int n_stations, int pairs, int frame_len,
    int state_len, int calls, int map_len, int ext_blocks,
    unsigned long long* clock) {
  const int call_len = 2 * frame_len;
#ifdef CLOCK
  unsigned long long t0, t1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
#endif
  if ((int)blockIdx.x < ext_blocks) {
    const long long total = (long long)n_stations * pairs * map_len;
    for (long long e = blockIdx.x * (long long)THREADS + threadIdx.x;
         e < total; e += (long long)ext_blocks * THREADS) {
      const long long b = e / map_len;  // s * pairs + p
      const int m = (int)(e - b * map_len);
      const int s = (int)(b / pairs), p = (int)(b - (long long)s * pairs);
#if CUT == 1
      ext[e] = (float)(s + p + m) * 0.0f;
      continue;
#endif
      const int i = k7_map[m];
      float v = 0.0f;
#if CUT == 2
      if (i >= 0) {
        const int ph = pmod(phase[s] + p, calls);
        const int c = ph * call_len + i;
        v = (float)(read_idx[c] + hazard[c]);
      }
      ext[e] = v;
      continue;
#endif
      if (i >= 0) {
        const int ph = pmod(phase[s] + p, calls);
        const int c = ph * call_len + i;
        const int r = read_idx[c];
        const int8_t* sl = llr + (long long)s * pairs * call_len;
        int8_t x;
        if (hazard[c]) {
          x = sl[(long long)p * call_len + (r - ph * call_len)];
        } else {
          const int q = r / call_len;
          int d = pmod(ph - q, calls);
          if (d == 0) d = calls;
          const int pp = p - d;
          x = pp >= 0 ? sl[(long long)pp * call_len + (r - q * call_len)]
                      : internal[(long long)s * state_len + r];
        }
        v = (float)x;
      }
      ext[e] = v;
    }
#ifdef CLOCK
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
    if (threadIdx.x == 0) {
      clock[2 * blockIdx.x] = t0;
      clock[2 * blockIdx.x + 1] = t1;
    }
#endif
    return;
  }
#if CUT == 3
  return;
#endif
  const int sb = blockIdx.x - ext_blocks, state_blocks = gridDim.x - ext_blocks;
  if (sb == 0 && threadIdx.x == 0)
    for (int s = 0; s < n_stations; ++s)
      new_phase[s] = pmod(phase[s] + pairs, calls);
  const long long total = (long long)n_stations * state_len;
  for (long long e = sb * (long long)THREADS + threadIdx.x; e < total;
       e += (long long)state_blocks * THREADS) {
    const int s = (int)(e / state_len);
    const int r = (int)(e - (long long)s * state_len);
    const int q = r / call_len;
    const int k = pmod(q - phase[s], calls);  // first pair at phase q
    int8_t x;
#if CUT == 1
    x = (int8_t)(r + k);
#elif CUT == 2
    x = (int8_t)(k + q);
#else
    if (k < pairs) {
      const int pp = k + calls * ((pairs - 1 - k) / calls);  // the newest
      x = llr[((long long)s * pairs + pp) * call_len + (r - q * call_len)];
    } else {
      x = internal[e];
    }
#endif
    new_internal[e] = x;
  }
#ifdef CLOCK
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
  if (threadIdx.x == 0) {
    clock[2 * blockIdx.x] = t0;
    clock[2 * blockIdx.x + 1] = t1;
  }
#endif
}

}  // namespace

extern "C" int px_deinterleave_parent(const void* llr, const void* internal,
                               const void* phase, const void* read_idx,
                               const void* hazard, const void* k7_map,
                               void* ext, void* new_internal, void* new_phase,
                               int n_stations, int pairs, int frame_len,
                               int state_len, int calls, int map_len,
                               void* clock, void* stream) {
  if (n_stations <= 0 || pairs <= 0 || calls <= 0 ||
      state_len != calls * 2 * frame_len)
    return (int)cudaErrorInvalidValue;
  const long long ext_total = (long long)n_stations * pairs * map_len;
  const long long state_total = (long long)n_stations * state_len;
  long long eb = (ext_total + THREADS - 1) / THREADS;
  long long sb = (state_total + THREADS - 1) / THREADS;
  if (eb > 132 * 24) eb = 132 * 24;
  if (sb > 132 * 8) sb = 132 * 8;
  px_deinterleave_kernel<<<(int)(eb + sb), THREADS, 0,
                           (cudaStream_t)stream>>>(
      (const int8_t*)llr, (const int8_t*)internal, (const int*)phase,
      (const int*)read_idx, (const uint8_t*)hazard, (const int*)k7_map,
      (float*)ext, (int8_t*)new_internal, (int*)new_phase, n_stations, pairs,
      frame_len, state_len, calls, map_len, (int)eb,
      (unsigned long long*)clock);
  return (int)cudaGetLastError();
}
