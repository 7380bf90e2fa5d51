// K20: the complex chain's AM sync block — sideband combine, reference
// bits, PIDS and partition training mults, sample-clock regression,
// interpolated equalizer and the QAM64/QAM16/QPSK Gray demaps, MA1 and
// MA3.
//
// Replaces the JAX device function nrsc5_tpu/ops/sync_am.py:84
// sync_am_block (inside the lax.scan of
// nrsc5_tpu/pipeline/scan_chain_am.py:48-49; the interpolated equalizer,
// AM_EQ_INTERP, on), for all stations of a dispatch at once.
//
// spectra [S, 32, 256] complex64 (fftshifted, bin 128 the carrier; K19's
// output) -> codes [S, 4, 800] uint8 (pl, pu, s, t in (symbol, column)
// order), pids [S, 32, 2] uint8, ref_bits [S, 32] uint8, samperr [S]
// int32, as sync_am_block computes them: the lower sideband (bins
// 128-81..128-1) negate-conjugated; in MA1 bins 128+1..128+53 add their
// mirror; ref_bits = Im(bin 129) > 0; a PIDS column's mult =
// 2 TRAIN_QAM16 / (row 8 + row 24) and a partition column's = 2 nominal /
// (row TRAIN1 + row TRAIN2), each as PyTorch divides a number by a tensor
// (the reciprocal, by Smith's method as c10::complex divides, times the
// number); samperr = round((sum wrap_half_pi(d arg pl) + sum
// wrap_half_pi(d arg pu)) / 48 * 256 / 2pi), half to even; per partition
// the anchors lo = row min(TRAIN1, TRAIN2) and hi = 16 rows later give
// dphi = wrap_pi(arg lo - arg hi) and w = |lo| |hi| + 1e-12, a w-weighted
// linear fit over the 25 columns gives fit(col), and symbol row r is
// equalized by mult e^{i u fit}, u = (r - a_lo - 8) / 16, then demapped.
// The sums run from the first column to the last.  float32, -fmad=false.
//
// The kernel is K13's body (sync_am_block.cuh; its design and bound are
// described in sync_am_block.cu) under a name of its own,
// sync_am_c_kernel, with the complex chain's arithmetic where the two
// chains' plain versions differ: the training mults as a reciprocal times
// the nominal point (K13 divides), and the fit weights as |lo| |hi| by two
// hypots (K13 takes sqrt(|lo|^2 |hi|^2)).  Everything else, the sum orders
// too, is K13's: four CTAs a station, one a partition, each reading the
// bins the host's plan (ops/sync_am.py sync_am_plan, the same for both
// chains: their partitions, PIDS bins and reference bin are the same)
// gives it.
//
// In the AM block loop K20 also takes the loop's carry step: thread 0 of
// a station's first CTA adds WINDOW_AM - keep (K19's) to the station's
// offset, and the lane that forms samperr sets the next K19's samperr,
// FFTCP_AM / 2 + samperr.  K19 of this block has read both before K20
// starts; outside the loop (the per-block receiver) the pointers are null
// and the step is off.
//
// Bound on the H100: device-memory bytes, as K13's.  A block at 16
// stations reads 1.05 MB of spectra and writes 53 KB of codes: 0.00033 ms
// at 3.35 TB/s; the arithmetic (3200 equalized values a station, a sincos
// and a few products each) is far under the float32 rate, so the kernel is
// bound by its latency: a load, the fit's chain, then the codes.

#include "sync_am_block.cuh"

namespace {
SYNC_AM_KERNEL(sync_am_c_kernel, true)
}  // namespace

// plan: the host's int32 [4, PLAN_INTS] plan of the mode (see Plan).
// keep, offset, samperr_next: the carry step's int32 [S] (all null: no
// step).
extern "C" int sync_am_c(const void* spectra, const void* plan, void* codes,
                         void* pids, void* ref_bits, void* samperr,
                         int n_stations, int ma3, const void* keep,
                         void* offset, void* samperr_next, int window,
                         int half_fftcp, void* stream) {
  if (n_stations <= 0 || plan == nullptr ||
      (offset == nullptr) != (keep == nullptr) ||
      (offset == nullptr) != (samperr_next == nullptr))
    return (int)cudaErrorInvalidValue;
  Plan pl;
  for (int p = 0; p < 4; ++p)
    for (int i = 0; i < PLAN_INTS; ++i)
      pl.v[p][i] = ((const int*)plan)[p * PLAN_INTS + i];
  sync_am_c_kernel<<<dim3(4, n_stations), THREADS, 0,
                     (cudaStream_t)stream>>>(
      (const float2*)spectra, pl, (uint8_t*)codes, (uint8_t*)pids,
      (uint8_t*)ref_bits, (int*)samperr, ma3, (const int*)keep, (int*)offset,
      (int*)samperr_next, window, half_fftcp);
  return (int)cudaGetLastError();
}
