// K15 as it was before its redesign (the parent of the port's
// csrc/am_gather.cu), kept for probes/k11_k15_variants.py: one thread per
// float32 output element over the four outputs' concatenated index range,
// grid-stride, 64-bit index arithmetic, two int32 maps (src, dly) an
// output, the code bytes gathered from L2.
//
// Cuts for timing its parts (nvcc -D):
//   CUT=1  the stores alone: every output element written 0 (the index
//          arithmetic kept, no map or data load);
//   CUT=2  the map loads and stores: each output written from its map
//          entries, no data gather;
//   CUT=3  everything but the new lines (the grid covers P1, P3, PIDS);
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
constexpr int SEG = 18000;         // bits of a delayed stream a frame
constexpr int LINE = 3 * SEG;      // 54000-bit diversity delay line
constexpr int LINES = 4;           // ml, mu, eml, emu
constexpr int FRAME_CODES = 25600; // 8 blocks x 4 partitions x 800 codes
constexpr int PIDS_CODES = 64;     // a block's [32, 2] QAM16 codes

__device__ __forceinline__ int code_bit(const uint8_t* codes, long long sf,
                                        int src) {
  return (codes[sf * FRAME_CODES + (src >> 3)] >> (src & 7)) & 1;
}

__device__ __forceinline__ float channel_value(
    const uint8_t* __restrict__ codes, const uint8_t* __restrict__ lines,
    int src, int dly, long long s, int f, int n_frames) {
  if (src < 0) return 0.0f;
  int bit;
  const long long sf = s * n_frames + f;
  if (dly < 0) {
    bit = code_bit(codes, sf, src);
  } else if (f >= 3) {
    bit = code_bit(codes, sf - 3, src);
  } else {
    bit = lines[(s * LINES + dly / SEG) * LINE + (long long)SEG * f +
                dly % SEG];
  }
  return bit ? 1.0f : -1.0f;
}

__global__ void __launch_bounds__(THREADS) am_gather_kernel(
    const uint8_t* __restrict__ codes, const uint8_t* __restrict__ pids,
    const uint8_t* __restrict__ lines, const int* __restrict__ p1_src,
    const int* __restrict__ p1_dly, const int* __restrict__ p3_src,
    const int* __restrict__ p3_dly, const int* __restrict__ pids_src,
    const int* __restrict__ line_src, float* __restrict__ p1_out,
    float* __restrict__ p3_out, float* __restrict__ pids_out,
    uint8_t* __restrict__ lines_out, int n_frames, int p1_len, int p3_len,
    int pids_len, int n_delayed, long long n_p1, long long n_p3,
    long long n_pids, long long total, unsigned long long* clock) {
#ifdef CLOCK
  unsigned long long t0;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
#endif
#if CUT == 3
  total = n_p1 + n_p3 + n_pids;
#endif
  for (long long e = blockIdx.x * (long long)THREADS + threadIdx.x; e < total;
       e += (long long)gridDim.x * THREADS) {
    if (e < n_p1) {
      const long long sf = e / p1_len;
      const int m = (int)(e - sf * p1_len);
#if CUT == 1
      p1_out[e] = (float)(sf / n_frames + sf % n_frames + m) * 0.0f;
#elif CUT == 2
      p1_out[e] = (float)(p1_src[m] + p1_dly[m] + (int)(sf % n_frames));
#else
      p1_out[e] = channel_value(codes, lines, p1_src[m], p1_dly[m],
                                sf / n_frames, (int)(sf % n_frames),
                                n_frames);
#endif
      continue;
    }
    long long r = e - n_p1;
    if (r < n_p3) {
      const long long sf = r / p3_len;
      const int m = (int)(r - sf * p3_len);
#if CUT == 1
      p3_out[r] = (float)(sf / n_frames + sf % n_frames + m) * 0.0f;
#elif CUT == 2
      p3_out[r] = (float)(p3_src[m] + p3_dly[m] + (int)(sf % n_frames));
#else
      p3_out[r] = channel_value(codes, lines, p3_src[m], p3_dly[m],
                                sf / n_frames, (int)(sf % n_frames),
                                n_frames);
#endif
      continue;
    }
    r -= n_p3;
    if (r < n_pids) {
      const long long b = r / pids_len;
#if CUT == 1
      pids_out[r] = (float)(b + r) * 0.0f;
#elif CUT == 2
      pids_out[r] = (float)pids_src[(int)(r - b * pids_len)];
#else
      const int src = pids_src[(int)(r - b * pids_len)];
      const int bit = (pids[b * PIDS_CODES + (src >> 3)] >> (src & 7)) & 1;
      pids_out[r] = bit ? 1.0f : -1.0f;
#endif
      continue;
    }
    r -= n_pids;  // new lines: [S, 4, 54000]
    const long long sd = r / LINE;
    const int p = (int)(r - sd * LINE);
    const int d = (int)(sd % LINES);
    const long long s = sd / LINES;
    const int g = SEG * n_frames + p;  // position in concat(line, fresh...)
    uint8_t v;
#if CUT == 1
    v = (uint8_t)(g + d);
#elif CUT == 2
    v = (uint8_t)line_src[d * SEG + p % SEG];
#else
    if (d >= n_delayed || g < LINE) {
      v = lines[sd * LINE + (d >= n_delayed ? p : g)];
    } else {
      const int fr = (g - LINE) / SEG;
      const int src = line_src[d * SEG + (g - LINE) % SEG];
      v = (uint8_t)code_bit(codes, s * n_frames + fr, src);
    }
#endif
    lines_out[r] = v;
  }
#ifdef CLOCK
  unsigned long long t1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
  if (threadIdx.x == 0) {
    clock[2 * blockIdx.x] = t0;
    clock[2 * blockIdx.x + 1] = t1;
  }
#endif
}

}  // namespace

extern "C" int am_gather_parent(const void* codes, const void* pids,
                         const void* lines, const void* p1_src,
                         const void* p1_dly, const void* p3_src,
                         const void* p3_dly, const void* pids_src,
                         const void* line_src, void* p1_out, void* p3_out,
                         void* pids_out, void* lines_out, int n_stations,
                         int n_frames, int p1_len, int p3_len, int pids_len,
                         int n_delayed, void* clock, void* stream) {
  if (n_stations <= 0 || n_frames <= 0 || p1_len <= 0 || p3_len <= 0 ||
      pids_len <= 0 || n_delayed < 0 || n_delayed > LINES)
    return (int)cudaErrorInvalidValue;
  const long long sf = (long long)n_stations * n_frames;
  const long long n_p1 = sf * p1_len;
  const long long n_p3 = sf * p3_len;
  const long long n_pids = sf * 8 * pids_len;  // 8 blocks a frame
  const long long total =
      n_p1 + n_p3 + n_pids + (long long)n_stations * LINES * LINE;
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 132 * 32) blocks = 132 * 32;
  am_gather_kernel<<<(int)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const uint8_t*)pids, (const uint8_t*)lines,
      (const int*)p1_src, (const int*)p1_dly, (const int*)p3_src,
      (const int*)p3_dly, (const int*)pids_src, (const int*)line_src,
      (float*)p1_out, (float*)p3_out, (float*)pids_out, (uint8_t*)lines_out,
      n_frames, p1_len, p3_len, pids_len, n_delayed, n_p1, n_p3, n_pids,
      total, (unsigned long long*)clock);
  return (int)cudaGetLastError();
}
