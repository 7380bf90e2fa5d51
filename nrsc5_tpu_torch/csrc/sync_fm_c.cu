// K18: the complex chain's FM sync block of one L1 block, fused, for all
// stations of a dispatch at once; one thread-block cluster of 8 CTAs per
// station.
//
// Replaces the JAX device function nrsc5_tpu/ops/sync_fm.py:130
// sync_fm_block (inside the lax.scan of
// nrsc5_tpu/pipeline/scan_chain.py:149-184): the timing-adjusted Costas PLL
// over the 2R reference bins, the pi flip, the control words (ref_ok, bc,
// psmi), the linear-interpolated equalizer, samperr and angle, the MER
// sums, the MMSE weights and the int8 demaps of PM, PX1 and PX2 (MP2's
// narrower px1; MP11's px2 with the lower sideband's MER multiplier on
// both sidebands, as the reference does).
//
// spectra [S, 32, 2048] complex64 (the fftshifted spectra of the
// conjugated samples, K17's output, read as float2), costas_phase and
// costas_freq [S, 2048] f32, timing_adj [S] int32 -> the outputs of
// sync_fm_block for every station (pm [S, 23040] int8, ref_ok, ref_bc,
// ref_psmi [S, 2R], samperr, angle, error_lb, error_ub [S], px1/px2) and
// whole new Costas rows.  With the block loop's carry pointers, CTA 0's
// thread 0 then takes the carry step for the next block, as K4 does: the
// sample offset from K17's keep, prev_angle from the angle K17 ran with,
// the samperr and angle feedback, the next K17's samperr and angle and the
// next K18's timing_adj (ping-ponged), so the block loop reads nothing back
// to the host.
//
// The kernel is K4's body (sync_block.cuh; its design, bound and sum
// orders are described in sync_block.cu) under a name of its own,
// sync_fm_c_kernel, with the complex chain's phase detector: err = 0.5 angle(v^2 e^{-2i ph}) (costas.cuh costas_advance_c),
// the cosine, sine and atan2 taken inside the 32-step recursion, where K4
// takes atan2(v^2) for all steps in parallel before it.  The two are equal
// up to float32 rounding; the rest of the arithmetic is the same.  The
// plain version, sync_fm_block, sums with PyTorch's reductions and
// multiplies complex values in PyTorch's complex kernels, so against it the
// integer outputs match where no value sits on a rounding edge (a soft bit
// may move by one) and the floats agree to float32 rounding.
//
// Bound on the H100: device-memory bytes, as K4's: 382 of 2048 bins of the
// spectra, the two Costas rows in and out and 23 KB of pm, about 154 KB a
// station and 2.46 MB for 16 stations: 0.0007 ms at 3.35 TB/s.

#include "sync_block.cuh"

namespace {
SYNC_BLOCK_KERNEL(sync_fm_c_kernel, true)
}  // namespace

extern "C" int sync_fm_c(const void* spectra, const void* costas_phase,
                         const void* costas_freq, const void* timing_adj,
                         const void* sync_signs, const void* needle_vals,
                         const void* needle_known, void* pm, void* ref_ok,
                         void* ref_bc, void* ref_psmi, void* samperr,
                         void* angle, void* error_lb, void* error_ub,
                         void* new_phase, void* new_freq, void* px1,
                         void* px2, const void* px_cols, int n_px1,
                         int n_px2, int n_stations, int ppb, float alpha,
                         float beta, float two_pi, float pi,
                         float two_pi_over_fft, const void* keep,
                         void* offset, void* prev_angle, void* samperr_fb,
                         void* angle_fb, void* samperr_next,
                         void* angle_next, void* timing_adj_next,
                         int window, int half_fftcp, void* stream) {
  if (ppb < PMP || 2 * (ppb + 1) > MAX_R2 || (n_px1 > 0) != (px1 != nullptr)
      || (n_px2 > 0) != (px2 != nullptr))
    return (int)cudaErrorInvalidValue;
  const Carry carry = {(const int*)keep,     (int*)offset,
                       (float*)prev_angle,   (int*)samperr_fb,
                       (float*)angle_fb,     (int*)samperr_next,
                       (float*)angle_next,   (int*)timing_adj_next,
                       window,               half_fftcp};
  if (offset != nullptr &&
      (keep == nullptr || prev_angle == nullptr || samperr_fb == nullptr ||
       angle_fb == nullptr || samperr_next == nullptr ||
       angle_next == nullptr || timing_adj_next == nullptr ||
       timing_adj_next == timing_adj))
    return (int)cudaErrorInvalidValue;
  sync_fm_c_kernel<<<n_stations * CLUSTER, THREADS, 0,
                     (cudaStream_t)stream>>>(
      (const float2*)spectra, (const float*)costas_phase,
      (const float*)costas_freq, (const int*)timing_adj,
      (const float*)sync_signs, (const unsigned*)needle_vals,
      (const unsigned*)needle_known, (int8_t*)pm, (uint8_t*)ref_ok,
      (int*)ref_bc, (int*)ref_psmi, (int*)samperr, (float*)angle,
      (float*)error_lb, (float*)error_ub, (float*)new_phase,
      (float*)new_freq, (int8_t*)px1, (int8_t*)px2, (const int*)px_cols,
      n_px1, n_px2, ppb, alpha, beta, two_pi, pi, two_pi_over_fft, carry);
  return (int)cudaGetLastError();
}
