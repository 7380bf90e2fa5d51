// K7: K=7 rate-1/3 Viterbi over free-start segments — ACS + traceback, the
// FM decoder's trellis (64 states): P1 chunk segments, PIDS and PX frames.
//
// Replaces the JAX device function
// nrsc5_tpu/ops/convolutional.py:_acs_traceback (lines 154-251) at k=7,
// radix 1, the core of viterbi_decode and viterbi_decode_chunked.  The
// segment plan, tail-biting wrap and keep-middle gather stay in PyTorch and
// K6/K11/K8 around the kernel (ops/convolutional.py, ops/decode_fm.py).
//
// The kernel is viterbi.cuh's template at m = 6, four states a thread (two
// trellis steps between exchanges), sixteen threads a segment and two
// segments a warp, with FM's generators (0133, 0171, 0165) as compile-time
// constants.  Decisions: four ballot words a step a warp (16 bytes) in a
// scratch the wrapper allocates at the size viterbi_k7_scratch_bytes
// gives; for any other generator set that query returns -1 and the launch
// cudaErrorInvalidValue.
//
// Input contract: integer LLRs in [-127, 127]: K6's int8 segments (P1,
// PIDS) and K11's int8 frames (PX), read as int8, or the same values in
// float32; bits and margins then equal the plain version's exactly, and
// int8 input gives the bits and margins of the same values in float32.
//
// Bound on the H100: neither bytes (P1 at 16 stations x 2 frames reads
// 16.4 MB of int8 LLRs and writes 5.5 MB of bits, 0.0065 ms at 3.35 TB/s,
// and writes and reads 43.7 MB of decisions) nor operations: each segment is a chain of ~1343 (PX1: 4672)
// dependent ACS steps and as many traceback steps.  Its chain floor is a
// lone segment's time: about 125 cycles a step on an H100 SXM at 1980 MHz
// (chip_smoke.py's chain_cycles_a_step); so PX1 (256 frames, 128 warps,
// one an SM) takes 4672 such steps, ~0.29 ms, and P1 (4064 segments, 2032
// warps, 4 a scheduler) is bound by issue.

#include "viterbi.cuh"

// fn(the trellis) for the one generator set K7 holds at K=7, else -1
template <class Fn>
static long long with_trellis(int g0, int g1, int g2, Fn fn) {
  if (g0 == 0133 && g1 == 0171 && g2 == 0165)
    return fn(viterbi::Trellis<6, 2, 0133, 0171, 0165>{});
  return -1;
}

extern "C" long long viterbi_k7_scratch_bytes(int n_seg, int n_steps, int g0,
                                              int g1, int g2) {
  if (n_seg <= 0 || n_steps <= 0) return -1;
  return with_trellis(g0, g1, g2, [&](auto t) {
    return viterbi::scratch_bytes(t, n_seg, n_steps);
  });
}

// ext: int8 LLRs if llr_int8 (K6's P1 and PIDS segments, K11's PX
// frames), else float32
extern "C" int viterbi_k7(const void* ext, void* bits, void* margin,
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
