// K13: the AM sync block — sideband combine, reference bits, PIDS and
// partition training mults, sample-clock regression, interpolated
// equalizer and the QAM64/QAM16/QPSK Gray demaps, MA1 and MA3.
//
// Replaces the JAX device function
// nrsc5_tpu/pipeline/scan_chain_am_rc.py:143 sync_am_block_rc (with the
// tables and demaps of nrsc5_tpu/ops/sync_am.py:35-82, the interpolated
// equalizer AM_EQ_INTERP on), for all stations of a dispatch at once.
//
// spectra [S, 32, 256, 2] f32 (fftshifted, bin 128 the carrier) ->
//   codes [S, 4, 800] uint8 (pl, pu, s, t in (symbol, column) order),
//   pids [S, 32, 2] uint8, ref_bits [S, 32] uint8, samperr [S] int32.
// In order: the lower sideband (bins 128-81..128-1) negate-conjugated; in
// MA1 bins 128+1..128+53 add their mirror.  ref_bits = Im(bin 129) > 0.  A
// PIDS column's mult = 2*TRAIN_QAM16 / (row 8 + row 24) and a partition
// column's = 2*nominal / (row TRAIN1 + row TRAIN2), true divisions.
// samperr = round((sum wrap_half_pi(d arg pl) + sum wrap_half_pi(d arg pu))
// / 48 * 256 / 2pi), half to even.  Per partition the anchors lo = row
// min(TRAIN1, TRAIN2) and hi = 16 rows later give dphi = wrap_pi(arg lo -
// arg hi) and w = sqrt(|lo|^2 |hi|^2) + 1e-12; a w-weighted linear fit
// over the 25 columns gives fit(col), and symbol row r is equalized by
// mult * e^{i u fit}, u = (r - a_lo - 8) / 16, then demapped.  Every sum
// runs from the first column to the last, as the plain version's do; the
// build passes -fmad=false.
//
// Bound on the H100: device-memory bytes.  A block at 16 stations reads
// 1.05 MB of spectra and writes 53 KB (3200 codes, 64 PIDS codes, 32
// reference bits and a 4-byte samperr a station; about 0.00033 ms at 3.35
// TB/s); the arithmetic (~3200 equalized values a station, each a sincos
// and a few products) is far under the card's f32 rate, so the kernel is
// bound by its latency: a load, the fit's chain, then the codes.  Design: four
// CTAs a station, one a partition, each loading only the bins it reads
// (its partition's 25 columns, in MA1 with their mirrors) and the extras
// the host's plan (ops/sync_am.py sync_am_plan, passed by value) gives
// it: one PIDS column, the reference bin, or the other primary
// partition's training rows, whose mults the samperr CTA forms again
// itself (the same arithmetic, so the same bits) instead of reading them
// from a peer.  So the CTAs of a station share nothing and need no
// cluster.  In each (1024 threads): warps 2.. load the partition's values
// into shared memory; meanwhile, each from its own loads, warp 0 forms the
// 25 columns' anchors and the fit, a lane a column, its ordered sums over
// lanes 0 to 24 in turn through shared memory, warp 2 the mults, warp 3
// the PIDS codes and the reference bits; then, after one barrier of every
// warp but warp 1, a thread per output code.  Warp 1 of the samperr CTA
// forms samperr from its own loads beside all that, sharing no barrier.
//
// In the AM block loop K13 also takes the carry step that K5's
// block_carry_am kernel made after it: thread 0 of a station's first CTA
// adds WINDOW_AM - keep (K12 pass 2's) to the station's offset.  Nothing
// of K13 reads offset, and both K12 passes of the block have read it
// before K13 starts, so the step needs no launch of its own.  Outside the
// loop (the AM cold start's probe block) offset is null and the step off.

#include "sync_am_block.cuh"

namespace {
SYNC_AM_KERNEL(sync_am_block_kernel, false)
}  // namespace

// plan: the host's int32 [4, PLAN_INTS] plan of the mode (see Plan).
// keep, offset: the carry step's int32 [S] (both null: no step).
extern "C" int sync_am_block(const void* spectra, const void* plan,
                             void* codes, void* pids, void* ref_bits,
                             void* samperr, int n_stations, int ma3,
                             const void* keep, void* offset, int window,
                             void* stream) {
  if (n_stations <= 0 || plan == nullptr ||
      (keep == nullptr) != (offset == nullptr))
    return (int)cudaErrorInvalidValue;
  Plan pl;
  for (int p = 0; p < 4; ++p)
    for (int i = 0; i < PLAN_INTS; ++i)
      pl.v[p][i] = ((const int*)plan)[p * PLAN_INTS + i];
  sync_am_block_kernel<<<dim3(4, n_stations), THREADS, 0,
                         (cudaStream_t)stream>>>(
      (const float2*)spectra, pl, (uint8_t*)codes, (uint8_t*)pids,
      (uint8_t*)ref_bits, (int*)samperr, ma3, (const int*)keep, (int*)offset,
      nullptr, window, 0);
  return (int)cudaGetLastError();
}
