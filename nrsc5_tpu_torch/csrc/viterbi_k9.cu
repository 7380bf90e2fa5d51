// K7 at K=9: K=9 rate-1/3 Viterbi over free-start segments — ACS +
// traceback, the AM decoder's trellis (256 states).
//
// Replaces the JAX device function
// nrsc5_tpu/ops/convolutional.py:_acs_traceback (lines 154-251) at k=9, the
// core of the AM P1 and P3 chunked Viterbis and of the AM PIDS Viterbi
// (nrsc5_tpu/ops/decode_am.py:148 am_frame_fec, :199 am_pids_decode).  The
// K=7 kernel (viterbi_k7.cu) is unchanged beside it.
//
// ext [n_seg, n_steps, 3] f32 LLRs (positive = bit 1) ->
//   bits [n_seg, n_steps] uint8, margin [n_seg] f32 = top1 - top2 of the
//   final path metrics.  Uniform (zero) start metrics; traceback from the
//   FIRST maximal final state.
//   For next state s' (8 bits, newest input at the MSB): input b = s' >> 7,
//   predecessors p0 = (s' << 1) & 255 and p1 = p0 | 1, branch sign
//   out[s', p, j] = 2*parity((p_p | b << 8) & G_j) - 1,
//   c_p = pm[p_p] + sum_j llr_j*out[s', p, j], dec = c1 > c0 (a tie takes
//   p0), pm'[s'] = dec ? c1 : c0.
//
// Exactness: on the AM chain every LLR is -1, 0 or +1, so every branch and
// path metric is an integer below 2^24 and exact in f32 in any summation
// order; bits and margins then equal the plain version's bit for bit.
//
// Bound on the H100: neither bytes (P1 at 16 stations x 2 frames reads
// 15.5 MB) nor operations — each segment is a chain of ~1300 dependent ACS
// steps, so the kernel is latency-bound and needs many segments in flight.
// Design: one warp per segment, eight states per lane, lane l holding
// s' = 8l + j (j = 0..7).  Then the predecessors of j < 4 are the eight
// states of lane (2l) & 31 and those of j >= 4 the eight of lane
// (2l + 1) & 31, so a step takes sixteen uniform shuffles and no select.  A
// step's 256 decisions are one byte a lane (bit j = state 8l + j), 32
// bytes in shared memory (42 KB for 1320 steps), and the traceback runs in
// the same kernel on lane 0.  LLRs are staged 32 steps at a time through
// shared memory with coalesced loads.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 2;   // segments per block
constexpr int STAGE = 32;  // steps of LLRs staged at a time
constexpr int NS = 256;    // states

__device__ __forceinline__ float branch(float l0, float l1, float l2,
                                        int full, int g0, int g1, int g2) {
  // sum_j llr_j * (2*parity(full & G_j) - 1)
  const float a = (__popc(full & g0) & 1) ? l0 : -l0;
  const float b = (__popc(full & g1) & 1) ? l1 : -l1;
  const float c = (__popc(full & g2) & 1) ? l2 : -l2;
  return a + b + c;
}

__host__ __device__ constexpr size_t per_warp_bytes(int n_steps) {
  return (size_t)n_steps * 32 + (STAGE * 3 + NS) * 4;
}

__global__ void viterbi_k9_kernel(const float* __restrict__ ext,
                                  uint8_t* __restrict__ bits,
                                  float* __restrict__ margin, int n_seg,
                                  int n_steps, int g0, int g1, int g2) {
  extern __shared__ unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int seg = blockIdx.x * WARPS + warp;
  if (seg >= n_seg) return;  // whole warps only: no block-level sync below

  // per-warp shared memory: decisions [n_steps] x 32 bytes, then the LLR
  // stage [STAGE * 3] floats, then the 256 final metrics
  uint8_t* dec = smem + per_warp_bytes(n_steps) * warp;
  float* stage = (float*)(dec + (size_t)n_steps * 32);
  float* fin = stage + STAGE * 3;

  const int src_a = (2 * lane) & 31;      // predecessors of j < 4
  const int src_b = (2 * lane + 1) & 31;  // predecessors of j >= 4
  const int bin = (lane >> 4) << 8;       // input bit b = s' >> 7, at bit 8
  // predecessor p0 of state 8l + j: (16l + 2j) & 255
  int fa[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) fa[j] = ((16 * lane + 2 * j) & 255) | bin;

  float pm[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) pm[j] = 0.0f;
  const float* seg_ext = ext + (long long)seg * n_steps * 3;

  for (int t0 = 0; t0 < n_steps; t0 += STAGE) {
    const int n = min(STAGE, n_steps - t0);
    __syncwarp();
    for (int k = lane; k < n * 3; k += 32) stage[k] = seg_ext[t0 * 3 + k];
    __syncwarp();
    for (int i = 0; i < n; ++i) {
      const float l0 = stage[3 * i], l1 = stage[3 * i + 1],
                  l2 = stage[3 * i + 2];
      float a[8], b[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        a[j] = __shfl_sync(0xffffffffu, pm[j], src_a);
        b[j] = __shfl_sync(0xffffffffu, pm[j], src_b);
      }
      unsigned byte = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // predecessors' metrics: slots 2j', 2j'+1 of lane A (j < 4) or B
        const float ev = j < 4 ? a[2 * j] : b[2 * (j - 4)];
        const float od = j < 4 ? a[2 * j + 1] : b[2 * (j - 4) + 1];
        const float c0 = ev + branch(l0, l1, l2, fa[j], g0, g1, g2);
        const float c1 = od + branch(l0, l1, l2, fa[j] | 1, g0, g1, g2);
        const bool d = c1 > c0;
        pm[j] = d ? c1 : c0;
        byte |= (unsigned)d << j;
      }
      dec[(size_t)(t0 + i) * 32 + lane] = (uint8_t)byte;
    }
  }

#pragma unroll
  for (int j = 0; j < 8; ++j) fin[8 * lane + j] = pm[j];
  __syncwarp();
  if (lane != 0) return;

  // top-2 of the final metrics (counting ties) and the first argmax
  float m1 = -CUDART_INF_F, m2 = -CUDART_INF_F;
  int state = 0;
  for (int s = 0; s < NS; ++s) {
    const float v = fin[s];
    if (v > m1) {
      m2 = m1;
      m1 = v;
      state = s;
    } else if (v > m2) {
      m2 = v;
    }
  }
  margin[seg] = m1 - m2;

  uint8_t* out = bits + (long long)seg * n_steps;
  for (int t = n_steps - 1; t >= 0; --t) {
    const int p = (dec[(size_t)t * 32 + (state >> 3)] >> (state & 7)) & 1;
    out[t] = (uint8_t)(state >> 7);
    state = ((state << 1) & (NS - 1)) | p;
  }
}

}  // namespace

extern "C" int viterbi_k9(const void* ext, void* bits, void* margin,
                          int n_seg, int n_steps, int g0, int g1, int g2,
                          void* stream) {
  if (n_seg <= 0 || n_steps <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = per_warp_bytes(n_steps) * WARPS;
  // above 48 KB of dynamic shared memory the kernel must opt in; the
  // attribute belongs to the current device, so it is set on every such
  // launch (a host-side call, no stream work)
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        viterbi_k9_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 block(32 * WARPS);
  dim3 grid((n_seg + WARPS - 1) / WARPS);
  viterbi_k9_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const float*)ext, (uint8_t*)bits, (float*)margin, n_seg, n_steps, g0,
      g1, g2);
  return (int)cudaGetLastError();
}
