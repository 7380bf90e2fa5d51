// K6: the FM P1 / PIDS deinterleave and depuncture, written straight into
// K7's input.
//
// Replaces the JAX device functions nrsc5_tpu/ops/decode_fm.py:p1_decode
// and pids_decode up to the Viterbi (lines 64-66 and 98-100: the int8
// gather through p1_fm_table / pids_fm_table, the float cast and
// depuncture), together with the segment gather of
// nrsc5_tpu/ops/convolutional.py:viterbi_decode_chunked (P1) and the
// tail-biting wrap extension of viterbi_decode (PIDS).
//
// The interleaver table, the puncture pattern and the segment plan (or the
// wrap) are static, so the host composes them into one index map per
// channel (ops/decode_fm.py:channel_tables, k7_map): K7 input element e of
// a frame reads soft bit k7_map[e] of that frame's PM rows, or is 0.0 where
// k7_map[e] < 0 (a punctured site).  Every value written is exactly
// float(int8) or 0.0, so K7's integer path metrics stay exact.
//
// pm is [G, F, frame] int8 with a dense last axis and strides (group,
// frame): a P1 frame is 16 consecutive blocks of one station's
// [n_blocks, 23040] rows, read in place.  out is [G*F, map_len] f32.
//
// Bound on the H100: device-memory bytes.  P1 at 16 stations x 2 frames
// reads 11.8 MB of pm and writes 65.5 MB of segments (0.023 ms at 3.35
// TB/s); the map is 6.1 MB, read once per frame but L2-resident.  Design:
// one thread per output element, grid-stride, consecutive threads on
// consecutive outputs (coalesced f32 stores); the pm reads are a gather.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) fec_gather_kernel(
    const int8_t* __restrict__ pm, const int* __restrict__ k7_map,
    float* __restrict__ out, int frames_per_group, long long group_stride,
    long long frame_stride, int map_len, long long total) {
  for (long long e = blockIdx.x * (long long)THREADS + threadIdx.x; e < total;
       e += (long long)gridDim.x * THREADS) {
    const long long b = e / map_len;
    const int m = (int)(e - b * map_len);
    const int src = k7_map[m];
    float v = 0.0f;
    if (src >= 0) {
      const long long g = b / frames_per_group;
      const long long f = b - g * frames_per_group;
      v = (float)pm[g * group_stride + f * frame_stride + src];
    }
    out[e] = v;
  }
}

}  // namespace

extern "C" int fec_gather(const void* pm, const void* k7_map, void* out,
                          int n_groups, int frames_per_group,
                          long long group_stride, long long frame_stride,
                          int map_len, void* stream) {
  if (n_groups <= 0 || frames_per_group <= 0 || map_len <= 0)
    return (int)cudaErrorInvalidValue;
  const long long total =
      (long long)n_groups * frames_per_group * (long long)map_len;
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 132 * 32) blocks = 132 * 32;
  fec_gather_kernel<<<(int)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)pm, (const int*)k7_map, (float*)out, frames_per_group,
      group_stride, frame_stride, map_len, total);
  return (int)cudaGetLastError();
}
