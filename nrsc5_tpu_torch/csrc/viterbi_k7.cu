// K7: K=7 rate-1/3 Viterbi over free-start segments — ACS + traceback.
//
// Replaces the JAX device function
// nrsc5_tpu/ops/convolutional.py:_acs_traceback (lines 154-251) at k=7, the
// core of viterbi_decode (P1 chunk segments and PIDS frames alike).  The
// segment plan, tail-biting wrap extension and keep-middle gather stay in
// PyTorch around the kernel (ops/convolutional.py).
//
// ext [n_seg, n_steps, 3] f32 LLRs (positive = bit 1) ->
//   bits [n_seg, n_steps] uint8, margin [n_seg] f32 = top1 - top2 of the
//   final path metrics.  Uniform (zero) start metrics; traceback from the
//   FIRST maximal final state.
//   For next state s' (6 bits, newest input at the MSB): input b = s' >> 5,
//   predecessors p0 = (s' << 1) & 63 and p1 = p0 | 1, branch sign
//   out[s', p, j] = 2*parity((p_p | b << 6) & G_j) - 1,
//   c_p = pm[p_p] + sum_j llr_j*out[s', p, j], dec = c1 > c0 (a tie takes
//   p0), pm'[s'] = dec ? c1 : c0.
//
// Exactness: on the chain every LLR is an int8 value, so every branch and
// path metric is an integer below 2^24 and exact in f32 in any summation
// order; bits and margins then equal the plain version's bit for bit.
//
// Bound on the H100: neither bytes (P1 at 16 stations x 2 frames reads 65 MB)
// nor operations (~1 GOP of adds and compares) — each segment is a chain of
// ~1344 dependent ACS steps, so the kernel is latency-bound and needs many
// segments in flight.  Design: one warp per segment, two states per lane
// (s' = lane and lane + 32 share their predecessors 2*lane and 2*lane+1,
// fetched with four shuffles).  A step's 64 decisions are two ballots,
// stored as 8 bytes in shared memory (10.7 KB for 1343 steps), and the
// traceback runs in the same kernel on lane 0.  LLRs are staged 32 steps at
// a time through shared memory with coalesced loads.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;   // segments per block
constexpr int STAGE = 32;  // steps of LLRs staged at a time

__device__ __forceinline__ float branch(float l0, float l1, float l2,
                                        int full, int g0, int g1, int g2) {
  // sum_j llr_j * (2*parity(full & G_j) - 1)
  const float a = (__popc(full & g0) & 1) ? l0 : -l0;
  const float b = (__popc(full & g1) & 1) ? l1 : -l1;
  const float c = (__popc(full & g2) & 1) ? l2 : -l2;
  return a + b + c;
}

__global__ void viterbi_k7_kernel(const float* __restrict__ ext,
                                  uint8_t* __restrict__ bits,
                                  float* __restrict__ margin, int n_seg,
                                  int n_steps, int g0, int g1, int g2) {
  extern __shared__ unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int seg = blockIdx.x * WARPS + warp;
  if (seg >= n_seg) return;  // whole warps only: no block-level sync below

  // per-warp shared memory: decisions [n_steps] x 2 words, then the LLR
  // stage [STAGE * 3] floats, then the 64 final metrics
  const size_t per_warp = (size_t)n_steps * 8 + (STAGE * 3 + 64) * 4;
  uint2* dec = (uint2*)(smem + per_warp * warp);
  float* stage = (float*)(dec + n_steps);
  float* fin = stage + STAGE * 3;

  // predecessors of s' = lane (input 0) and s' = lane + 32 (input 1)
  const int p0 = (lane << 1) & 63;
  const int p1 = p0 | 1;
  const int fa0 = p0, fa1 = p1;                      // b = 0
  const int fb0 = p0 | (1 << 6), fb1 = p1 | (1 << 6);  // b = 1
  const int src0 = p0 & 31, src1 = p1 & 31;
  const bool low = lane < 16;  // predecessors below 32 live in pa

  float pa = 0.0f, pb = 0.0f;  // pm[lane], pm[lane + 32]
  const float* seg_ext = ext + (long long)seg * n_steps * 3;

  for (int t0 = 0; t0 < n_steps; t0 += STAGE) {
    const int n = min(STAGE, n_steps - t0);
    __syncwarp();
    for (int k = lane; k < n * 3; k += 32) stage[k] = seg_ext[t0 * 3 + k];
    __syncwarp();
    for (int i = 0; i < n; ++i) {
      const float l0 = stage[3 * i], l1 = stage[3 * i + 1],
                  l2 = stage[3 * i + 2];
      const float a0 = __shfl_sync(0xffffffffu, pa, src0);
      const float b0 = __shfl_sync(0xffffffffu, pb, src0);
      const float a1 = __shfl_sync(0xffffffffu, pa, src1);
      const float b1 = __shfl_sync(0xffffffffu, pb, src1);
      const float ev = low ? a0 : b0;  // pm[p0]
      const float od = low ? a1 : b1;  // pm[p1]
      const float ca0 = ev + branch(l0, l1, l2, fa0, g0, g1, g2);
      const float ca1 = od + branch(l0, l1, l2, fa1, g0, g1, g2);
      const float cb0 = ev + branch(l0, l1, l2, fb0, g0, g1, g2);
      const float cb1 = od + branch(l0, l1, l2, fb1, g0, g1, g2);
      const bool da = ca1 > ca0, db = cb1 > cb0;
      pa = da ? ca1 : ca0;
      pb = db ? cb1 : cb0;
      const unsigned wa = __ballot_sync(0xffffffffu, da);
      const unsigned wb = __ballot_sync(0xffffffffu, db);
      if (lane == 0) dec[t0 + i] = make_uint2(wa, wb);
    }
  }

  fin[lane] = pa;
  fin[lane + 32] = pb;
  __syncwarp();
  if (lane != 0) return;

  // top-2 of the final metrics (counting ties) and the first argmax
  float m1 = -CUDART_INF_F, m2 = -CUDART_INF_F;
  int state = 0;
  for (int s = 0; s < 64; ++s) {
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
    const uint2 w = dec[t];
    const unsigned word = state < 32 ? w.x : w.y;
    const int p = (word >> (state & 31)) & 1;
    out[t] = (uint8_t)(state >> 5);
    state = ((state << 1) & 63) | p;
  }
}

}  // namespace

extern "C" int viterbi_k7(const void* ext, void* bits, void* margin,
                          int n_seg, int n_steps, int g0, int g1, int g2,
                          void* stream) {
  const size_t per_warp = (size_t)n_steps * 8 + (STAGE * 3 + 64) * 4;
  const size_t smem = per_warp * WARPS;
  // above 48 KB of dynamic shared memory the kernel must opt in.  The
  // attribute belongs to the current device, so it is set on every such
  // launch (a host-side call, no stream work) rather than remembered once
  // per process
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        viterbi_k7_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 block(32 * WARPS);
  dim3 grid((n_seg + WARPS - 1) / WARPS);
  viterbi_k7_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const float*)ext, (uint8_t*)bits, (float*)margin, n_seg, n_steps, g0,
      g1, g2);
  return (int)cudaGetLastError();
}
