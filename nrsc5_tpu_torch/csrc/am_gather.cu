// K15: the AM logical channels' deinterleave, diversity delay, 12/6-phase
// reassembly and depuncture, written straight into K7's input, for every
// station and frame of a dispatch; the PIDS gather and delay scatter; the
// new diversity delay lines.
//
// Replaces the JAX device functions nrsc5_tpu/ops/decode_am.py:86
// am_frame_gather (the bit-plane gathers, the 54000-bit delay, the phase
// select and the E1/E2 depuncture), the segment gather of
// nrsc5_tpu/ops/convolutional.py:viterbi_decode_chunked at AM's chunk plan
// (1024, overlap 160) inside decode_am.py:148 am_frame_fec, and the gather
// and scatter of decode_am.py:199 am_pids_decode with viterbi_decode's wrap.
//
// The bit maps, the phase tables, the puncture patterns and the segment
// plan are static, so the host composes them into one map per channel
// (ops/decode_am.py:gather_maps).  K7 input element m of frame f reads
// src[m] = (byte offset in a frame's [8 blocks, 4 partitions, 800] codes)
// * 8 + bit plane, or is 0.0 where src[m] < 0 (punctured).  Where dly[m] >=
// 0 the stream is a delayed one (line dly / 18000, index dly % 18000): the
// bit then comes from frame f - 3's codes when f >= 3 in this dispatch, else
// from the carried line at 18000 f + index.  So one launch serves every
// frame with no loop over frames, and the only carried state, the lines,
// is rewritten in the same launch: new line position p holds concat(line,
// fresh_0, ..., fresh_{F-1})[18000 F + p].  Each element is 2*bit - 1 or
// 0.0, so K7's path metrics stay exact integers.
//
// Bound on the H100: device-memory bytes.  At 16 stations x 2 frames (MA1)
// the function writes 15.5 MB of P1 and 12.2 MB of P3 segments and 0.44 MB
// of PIDS, reads 0.8 MB of codes and the 1.9 MB maps, and reads and
// rewrites the 1.7 MB of the ml and mu lines (about 0.0102 ms at 3.35
// TB/s).  The kernel also copies the eml and emu lines, which only MA3
// delays, so that the carry keeps one shape (in MA1 1.7 MB more read and
// 1.7 MB more written).  Design: one thread per output element over the
// four outputs' concatenated index range, grid-stride, consecutive threads
// on consecutive outputs (coalesced stores); the code reads are gathers
// that stay in L2.

#include <cuda_runtime.h>
#include <stdint.h>

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
    long long n_pids, long long total) {
  for (long long e = blockIdx.x * (long long)THREADS + threadIdx.x; e < total;
       e += (long long)gridDim.x * THREADS) {
    if (e < n_p1) {
      const long long sf = e / p1_len;
      const int m = (int)(e - sf * p1_len);
      p1_out[e] = channel_value(codes, lines, p1_src[m], p1_dly[m],
                                sf / n_frames, (int)(sf % n_frames),
                                n_frames);
      continue;
    }
    long long r = e - n_p1;
    if (r < n_p3) {
      const long long sf = r / p3_len;
      const int m = (int)(r - sf * p3_len);
      p3_out[r] = channel_value(codes, lines, p3_src[m], p3_dly[m],
                                sf / n_frames, (int)(sf % n_frames),
                                n_frames);
      continue;
    }
    r -= n_p3;
    if (r < n_pids) {
      const long long b = r / pids_len;
      const int src = pids_src[(int)(r - b * pids_len)];
      const int bit = (pids[b * PIDS_CODES + (src >> 3)] >> (src & 7)) & 1;
      pids_out[r] = bit ? 1.0f : -1.0f;
      continue;
    }
    r -= n_pids;  // new lines: [S, 4, 54000]
    const long long sd = r / LINE;
    const int p = (int)(r - sd * LINE);
    const int d = (int)(sd % LINES);
    const long long s = sd / LINES;
    const int g = SEG * n_frames + p;  // position in concat(line, fresh...)
    uint8_t v;
    if (d >= n_delayed || g < LINE) {
      v = lines[sd * LINE + (d >= n_delayed ? p : g)];
    } else {
      const int fr = (g - LINE) / SEG;
      const int src = line_src[d * SEG + (g - LINE) % SEG];
      v = (uint8_t)code_bit(codes, s * n_frames + fr, src);
    }
    lines_out[r] = v;
  }
}

}  // namespace

extern "C" int am_gather(const void* codes, const void* pids,
                         const void* lines, const void* p1_src,
                         const void* p1_dly, const void* p3_src,
                         const void* p3_dly, const void* pids_src,
                         const void* line_src, void* p1_out, void* p3_out,
                         void* pids_out, void* lines_out, int n_stations,
                         int n_frames, int p1_len, int p3_len, int pids_len,
                         int n_delayed, void* stream) {
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
      total);
  return (int)cudaGetLastError();
}
