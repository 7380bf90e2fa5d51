// K8: the FEC epilogue of the FM logical channels — kept bits, re-encode
// bit errors, descramble, pack.
//
// Replaces the JAX device functions after the Viterbi:
// nrsc5_tpu/ops/convolutional.py:viterbi_decode_chunked's keep-middle
// gather (line 489) and viterbi_decode's wrap drop, reencode_bit_errors
// (line 511; the reference's src/decode.c:234-277), decode_fm.py
// _descramble_dev (line 22) and ops/bits.py:pack_bits (line 22), for P1,
// PIDS and PX alike.
//
// Per frame b: bit t = bits[b, keep[t]] (K7's output, before descrambling);
// with pm (P1), the tail-biting re-encode of those bits — the register at
// t holds bits t-6..t mod T, newest at the MSB, output j = parity(reg & G_j)
// — is compared at every unpunctured mother-code site (code_map[3t+j] >= 0)
// with the hard decision pm[code_map[3t+j]] > 0, and the mismatches are
// counted; the output bit is bit t ^ keystream[t], as uint8, or packed 8 to
// a byte little-endian (bit k of byte q = output bit 8q+k).  Integer work
// only: bit-exact against the plain version.
//
// Bound on the H100: device-memory bytes.  P1 at 32 frames reads 5.5 MB of
// K7 bits and 11.8 MB of pm and writes 4.7 MB of bits (0.0065 ms at 3.35
// TB/s).  Design: one CTA per frame, one thread per output byte (14 kept
// bits gathered per byte: its 8 and the 6 before them), the frame's error
// count summed over the CTA by warp shuffles and shared memory, so no
// atomics and no second pass.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS) fec_epilogue_kernel(
    const uint8_t* __restrict__ bits, const int* __restrict__ keep,
    int bits_per_frame, const int8_t* __restrict__ pm,
    const int* __restrict__ code_map, int frames_per_group,
    long long group_stride, long long frame_stride,
    const uint8_t* __restrict__ keystream, uint8_t* __restrict__ out,
    int* __restrict__ errors, int frame_len, int packed, int g0, int g1,
    int g2) {
  __shared__ int warp_err[WARPS];
  const int b = blockIdx.x;
  const uint8_t* fb = bits + (long long)b * bits_per_frame;
  const int8_t* fpm = nullptr;
  if (pm != nullptr) {
    const long long g = b / frames_per_group;
    fpm = pm + g * group_stride + (b - g * frames_per_group) * frame_stride;
  }
  const int gens[3] = {g0, g1, g2};
  int err = 0;
  for (int q = threadIdx.x; q < frame_len / 8; q += THREADS) {
    const int t0 = 8 * q;
    int win = 0;  // bit i = kept bit (t0 - 6 + i) mod T, i = 0..13
    for (int i = 0; i < 14; ++i) {
      int p = t0 - 6 + i;
      if (p < 0) p += frame_len;
      if (p >= frame_len) p -= frame_len;
      win |= (fb[keep[p]] & 1) << i;
    }
    unsigned byte = 0;
    for (int k = 0; k < 8; ++k) {
      const int t = t0 + k;
      const int bit = (win >> (6 + k)) & 1;
      const int o = bit ^ keystream[t];
      if (packed) {
        byte |= (unsigned)o << k;
      } else {
        out[(long long)b * frame_len + t] = (uint8_t)o;
      }
      if (fpm != nullptr) {
        int reg = 0;  // bits t-6..t, newest (t) at bit 6
        for (int d = 0; d < 7; ++d) reg |= ((win >> (6 + k - d)) & 1) << (6 - d);
        for (int j = 0; j < 3; ++j) {
          const int src = code_map[3 * t + j];
          if (src >= 0) {
            const int hard = fpm[src] > 0;
            const int enc = __popc(reg & gens[j]) & 1;
            err += hard != enc;
          }
        }
      }
    }
    if (packed) out[(long long)b * (frame_len / 8) + q] = (uint8_t)byte;
  }
  if (errors == nullptr) return;
  for (int o = 16; o > 0; o >>= 1) err += __shfl_xor_sync(0xffffffffu, err, o);
  if ((threadIdx.x & 31) == 0) warp_err[threadIdx.x >> 5] = err;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < WARPS; ++w) total += warp_err[w];
    errors[b] = total;
  }
}

}  // namespace

extern "C" int fec_epilogue(const void* bits, const void* keep,
                            int bits_per_frame, const void* pm,
                            const void* code_map, int frames_per_group,
                            long long group_stride, long long frame_stride,
                            const void* keystream, void* out, void* errors,
                            int n_frames, int frame_len, int packed, int g0,
                            int g1, int g2, void* stream) {
  if (n_frames <= 0 || frame_len <= 0 || frame_len % 8 ||
      frames_per_group <= 0 || (pm != nullptr) != (errors != nullptr))
    return (int)cudaErrorInvalidValue;
  fec_epilogue_kernel<<<n_frames, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bits, (const int*)keep, bits_per_frame,
      (const int8_t*)pm, (const int*)code_map, frames_per_group, group_stride,
      frame_stride, (const uint8_t*)keystream, (uint8_t*)out, (int*)errors,
      frame_len, packed, g0, g1, g2);
  return (int)cudaGetLastError();
}
