// K7 at K=9: K=9 rate-1/3 Viterbi over free-start segments — ACS +
// traceback, the AM decoder's trellis (256 states): P1 and P3 chunk
// segments and PIDS frames.
//
// Replaces the JAX device function
// nrsc5_tpu/ops/convolutional.py:_acs_traceback (lines 154-251) at k=9,
// radix 1, the core of the AM P1 and P3 chunked Viterbis and of the AM PIDS
// Viterbi (nrsc5_tpu/ops/decode_am.py:148 am_frame_fec, :199
// am_pids_decode).
//
// The kernel is viterbi.cuh's template at m = 8, eight states a thread
// (three trellis steps between exchanges), one segment a warp, with AM's two
// generator sets as compile-time constants: E1 (0561, 0657, 0711; P1, P3
// MA3) and E2/E3 (0561, 0753, 0711; P3 MA1, PIDS).  Decisions: eight ballot
// words a step (32 bytes) in a scratch the wrapper allocates at the size
// viterbi_k9_scratch_bytes gives; for any other generator set that query
// returns -1 and the launch cudaErrorInvalidValue.
//
// Input contract: integer LLRs in [-127, 127]: K15's int8 segments (-1, 0
// or +1), read as int8, or the same values in float32; bits and margins
// then equal the plain version's exactly, and int8 input gives the bits
// and margins of the same values in float32.
//
// Bound on the H100: neither bytes (P1 at 16 stations x 2 frames reads
// 3.9 MB of int8 LLRs and writes and reads 41.2 MB of decisions) nor
// operations (P1's 1.0 G adds and compares, 3 a state a step, 0.015 ms at
// 67 TFLOP/s):
// each segment is a chain of ~1300 dependent ACS steps and as many
// traceback steps.  Its chain floor is a lone segment's time: about 180
// cycles a step on an H100 SXM at 1980 MHz (chip_smoke.py's
// chain_cycles_a_step); P1's 1024 and P3's 768-960 warps (2 a scheduler)
// take ~1.4 times that.

#include "viterbi.cuh"

// fn(the trellis) for the two generator sets K7 holds at K=9, else -1
template <class Fn>
static long long with_trellis(int g0, int g1, int g2, Fn fn) {
  if (g0 == 0561 && g1 == 0657 && g2 == 0711)
    return fn(viterbi::Trellis<8, 3, 0561, 0657, 0711>{});
  if (g0 == 0561 && g1 == 0753 && g2 == 0711)
    return fn(viterbi::Trellis<8, 3, 0561, 0753, 0711>{});
  return -1;
}

extern "C" long long viterbi_k9_scratch_bytes(int n_seg, int n_steps, int g0,
                                              int g1, int g2) {
  if (n_seg <= 0 || n_steps <= 0) return -1;
  return with_trellis(g0, g1, g2, [&](auto t) {
    return viterbi::scratch_bytes(t, n_seg, n_steps);
  });
}

// ext: int8 LLRs if llr_int8 (K15's P1, P3 and PIDS segments), else
// float32
extern "C" int viterbi_k9(const void* ext, void* bits, void* margin,
                          void* scratch, long long scratch_bytes, int n_seg,
                          int n_steps, int g0, int g1, int g2, int llr_int8,
                          void* stream) {
  if (n_seg <= 0 || n_steps <= 0) return (int)cudaErrorInvalidValue;
  const long long err = with_trellis(g0, g1, g2, [&](auto t) {
    return (long long)(llr_int8
        ? viterbi::launch<int8_t>(t, ext, bits, margin, scratch,
                                  scratch_bytes, n_seg, n_steps, stream)
        : viterbi::launch<float>(t, ext, bits, margin, scratch,
                                 scratch_bytes, n_seg, n_steps, stream));
  });
  return err < 0 ? (int)cudaErrorInvalidValue : (int)err;
}
