// K5: the carry step of the sequential block loops, between one block's
// kernels and the next block's.
//
// Replaces the carry of the JAX device functions
// nrsc5_tpu/pipeline/scan_chain_rc.py:frontend_scan_rc (lines 274-303, the
// lax.scan step at 280-294) and nrsc5_tpu/pipeline/scan_chain_am_rc.py:
// _am_frontend_gather_scan (lines 259-292).  XLA compiles each scan into one
// device while-loop; the port's loop (pipeline/scan_chain_rc.py and
// scan_chain_am_rc.py) launches K2, the DFT kernel and K4 (FM) or K12, the
// DFT, K12 and K13 (AM) once a block, each writing its block's outputs
// straight into slot b of block-major buffers, and this kernel carries the
// per-station scalars from one block to the next.  The whole loop is
// captured as one CUDA graph (pipeline/block_graph.py), so a dispatch
// replays every block with no host work between them.
//
// block_carry (FM), per station i, after block b's K4 (first = 0):
//   offset      += WINDOW_FM - keep          (the samples the block used)
//   prev_angle   = angle                     (the angle block b ran with)
//   samperr_fb   = k4_samperr, angle_fb = k4_angle
// and then, for block b + 1 (or block 0 when first = 1, from the carry):
//   samperr      = FFTCP_FM / 2 + samperr_fb     (K2's symbol start)
//   angle        = prev_angle - angle_fb         (K2's ramp angle)
//   timing_adj   = FFTCP_FM / 2 - samperr        (K4's Costas phase shift)
// block_carry_am (AM), after block b's K13: offset += WINDOW_AM - keep
// (K12 pass 2 hands phase and prev_angle on, K13 the samperr feedback).
//
// Inside the loops these steps are fused into the block's last kernel:
// K4 (sync_block.cu) takes block_carry's step after each FM block and K13
// (sync_am_block.cu) block_carry_am's after each AM block, so that a
// dispatch launches block_carry once (first = 1, block 0's inputs from the
// carry) and block_carry_am never.  Both kernels stay, with their plain
// versions, for that first step and as the step the fused kernels are
// held to.
//
// Bound on the H100: a handful of int32/f32 per station, so neither bytes
// nor operations: the launch itself.  Its point is that the loop body holds
// no host work and no allocation, which lets the graph replay it.  One
// thread per station; the float subtraction is the reference's single
// rounding (the build passes -fmad=false; nothing here could contract).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void block_carry_kernel(const int* __restrict__ keep,
                                   const int* __restrict__ k4_samperr,
                                   const float* __restrict__ k4_angle,
                                   int* offset, float* prev_angle,
                                   int* samperr_fb, float* angle_fb,
                                   int* samperr, float* angle,
                                   int* timing_adj, int n_stations,
                                   int first, int window, int half_fftcp) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_stations) return;
  int fb;
  float pa, afb;
  if (first) {
    pa = prev_angle[i];
    fb = samperr_fb[i];
    afb = angle_fb[i];
  } else {
    offset[i] += window - keep[i];
    pa = angle[i];
    fb = k4_samperr[i];
    afb = k4_angle[i];
    prev_angle[i] = pa;
    samperr_fb[i] = fb;
    angle_fb[i] = afb;
  }
  int se = half_fftcp + fb;
  samperr[i] = se;
  angle[i] = pa - afb;
  timing_adj[i] = half_fftcp - se;
}

__global__ void block_carry_am_kernel(const int* __restrict__ keep,
                                      int* offset, int n_stations,
                                      int window) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_stations) offset[i] += window - keep[i];
}

}  // namespace

extern "C" int block_carry(const void* keep, const void* k4_samperr,
                           const void* k4_angle, void* offset,
                           void* prev_angle, void* samperr_fb,
                           void* angle_fb, void* samperr, void* angle,
                           void* timing_adj, int n_stations, int first,
                           int window, int half_fftcp, void* stream) {
  block_carry_kernel<<<(n_stations + 127) / 128, 128, 0,
                       (cudaStream_t)stream>>>(
      (const int*)keep, (const int*)k4_samperr, (const float*)k4_angle,
      (int*)offset, (float*)prev_angle, (int*)samperr_fb, (float*)angle_fb,
      (int*)samperr, (float*)angle, (int*)timing_adj, n_stations, first,
      window, half_fftcp);
  return (int)cudaGetLastError();
}

extern "C" int block_carry_am(const void* keep, void* offset, int n_stations,
                              int window, void* stream) {
  block_carry_am_kernel<<<(n_stations + 127) / 128, 128, 0,
                          (cudaStream_t)stream>>>(
      (const int*)keep, (int*)offset, n_stations, window);
  return (int)cudaGetLastError();
}
