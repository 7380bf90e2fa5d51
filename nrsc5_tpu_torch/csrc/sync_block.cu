// K4: the FM sync block of one L1 block, fused, one thread-block cluster of
// 8 CTAs per station.
//
// Replaces the JAX device function
// nrsc5_tpu/pipeline/scan_chain_rc.py:sync_block_rc (lines 128-267) for
// every FM service mode (ppb = 10, 11, 12 or 14 partitions per band,
// 2R = 2*(ppb+1) reference subcarriers), for all stations of a dispatch in
// one launch.  Per station, on spectra [32, 2048, 2]:
//   1. the Costas PLL (costas.cuh, shared with K10) on the 2R reference
//      bins from costas_phase[bin] - timing_adj*k_rel*2pi/2048 and
//      costas_freq[bin];
//   2. the pi-ambiguity flip from the sync-sign score, the DBPSK needles
//      (ref_ok), the block count and service mode words (ref_bc,
//      ref_psmi), and smag = mean |Re derot|;
//   3. samperr from symbol 0's phase steps and the frequency regression,
//      angle = mean fr;
//   4. the linear-interpolated equalizer of every data bin, the MER error
//      sums of each sideband, and the MMSE weights' per-symbol means;
//   5. the int8 soft demap of the 2x10 PM partitions (upper ones in
//      reversed partition order) with mult = clip(sig/err*10, 1, 127),
//      then of the PX1/PX2 columns the host lists (lines 240-263: a
//      partition, its side, and which sideband's mult it takes — MP11's
//      px2 takes the lower one's on both sides, as the reference does);
//   6. whole new Costas rows: the old row, with wrap_pi(ph) and fr - angle
//      at the reference bins.
//
// Bound on the H100: device-memory bytes (382 of 2048 bins of the spectra,
// the two Costas rows in and out, 23 KB of pm), about 154 KB a station
// and 2.46 MB for 16, 0.0007 ms; the work is a few hundred flops a data
// bin.  What sets the time is the latency of the per-track chains, so the
// design spreads a station over a cluster of 8 CTAs (16 stations, 128 CTAs
// on 132 SMs) and keeps on one thread only what is a recursion:
//   - every CTA runs the whole Costas chain itself (the same arithmetic,
//     so the same bits in each), after loading the 32 x 2R reference
//     values and taking atan2 of their squares in parallel; a track's
//     lane of warp 0 then runs only the phase and frequency recursion
//     (costas_advance: 32 dependent steps, the floor of this design), and
//     the derotations are taken in parallel after it; the flip, needles
//     and words stay a 32-step loop per track, on values held in
//     registers;
//   - CTA c equalizes, sums and demaps symbols 4c .. 4c + 3, from data
//     bins the other warps load while the recursion runs: one warp per
//     (symbol, sideband) sum, so the MMSE means are local; the MER sums of
//     all 32 symbols meet through distributed shared memory after a
//     cluster barrier, and every CTA adds them in symbol order (the same
//     bits everywhere); a data bin's MMSE weight is taken once for its re
//     and im soft bits, written as a pair;
//   - CTA 0 writes the per-station outputs and the Costas rows; its warp 0
//     takes the timing regression (the terms in parallel, their four sums
//     in index order on one lane) while the other warps demap.
// In the FM block loop K4 also takes the carry step that K5's block_carry
// kernel made after it: once the cluster's last barrier has passed, thread
// 0 of CTA 0 (which formed samperr and angle) folds block b in and sets
// block b + 1's inputs, for its station:
//   offset += WINDOW_FM - keep (K2's), prev_angle = angle (the angle K2
//   ran with), samperr_fb = samperr, angle_fb = angle (this kernel's);
//   samperr = FFTCP_FM / 2 + samperr_fb and angle = prev_angle - angle_fb
//   (K2's), timing_adj = FFTCP_FM / 2 - samperr (the next K4's).
// The step's inputs (keep, offset, angle) are read at the kernel's start,
// beside its other loads, so that the step adds only stores to its tail.
// The loop ping-pongs timing_adj, so the one this block's CTAs read is
// never the one CTA 0 writes.  K2 of this block has read offset, samperr
// and angle before the DFT and K4 start.  Outside the loop (the FM cold
// start's probe 2) the carry pointers are null and the step is off.
// Each thread starts its loads, and a lane its equalizer divisions, all at
// once before their first use, so that their latencies overlap.
// Every sum runs in the order the plain version reproduces: the short sums
// (22-30 tracks, 20-28 phase steps, 32 symbols) in index order on one
// thread, the 180-252-term sideband sums over a warp in a butterfly (pm
// may move by one from PyTorch's reductions where a product sits on a .5
// rounding edge).  f32 in the reference's operation order (-fmad=false,
// constants as float arguments); 44 KB of static shared memory a CTA.

#include "sync_block.cuh"

namespace {
SYNC_BLOCK_KERNEL(sync_block_kernel, false)
}  // namespace

extern "C" int sync_block(const void* spectra, const void* costas_phase,
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
  sync_block_kernel<<<n_stations * CLUSTER, THREADS, 0,
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
