// K15: the AM logical channels' deinterleave, diversity delay, 12/6-phase
// reassembly and depuncture, written straight into K7's input, for every
// station and frame of a dispatch; the PIDS gather and delay scatter; the
// new diversity delay lines.
//
// Replaces the JAX device functions nrsc5_tpu/ops/decode_am.py:86
// am_frame_gather (the bit-plane gathers, the 54000-bit delay, the phase
// select and the E1/E2 depuncture), the segment gather of
// nrsc5_tpu/ops/convolutional.py:viterbi_decode_chunked at AM's chunk plan
// (1024, overlap 160) inside decode_am.py:148 am_frame_fec, and the gather
// and scatter of decode_am.py:199 am_pids_decode with viterbi_decode's wrap.
//
// Every output of a frame reads one bit of a small set of bytes, which a
// CTA stages in shared memory by bulk copies: the frame's 25600 codes ([8
// blocks, 4 partitions, 800]), its 8 blocks' 64 PIDS codes, and one
// 18000-byte slice a delayed line (ml, mu; in MA3 also eml, emu) holding
// the delayed bits this frame reads: for f < 3 in the dispatch, bytes
// [18000 f, 18000 (f + 1)) of the carried line; for f >= 3, frame f - 3's
// bits of that stream, gathered here through the map's line entries.  The
// bit maps, phase tables, puncture patterns, segment plan and PIDS scatter
// are static, so the host composes them into one map over a frame's
// outputs (ops/decode_am.py:gather_maps): P1's segments, P3's segments, the
// 8 PIDS blocks' wrap-extended trellises, then the fresh bits of the
// delayed lines.  Entry e is the bit address (byte * 8 + plane) of its bit
// in the staged bytes, or -1 where punctured (0); the kernel reads it
// packed in 3 bytes as e + 1 (ops/decode_am.py:packed_map, packed3.cuh).
// A K7 input is 2 * bit - 1 or 0 as int8, which K7 reads as it is; a line
// byte is the bit.
//
// The new lines (only the delayed ones; the others are not written): new
// position p holds concat(line, fresh_0, ..., fresh_{F-1})[18000 F + p].
// The fresh part of frame f (F - f <= 3) comes from its staged codes
// through the map's line entries; the copied part (F < 3) is a 16-byte
// vector copy by the CTAs of frame 0.
//
// Bound on the H100: device-memory bytes.  At 16 stations x 2 frames (MA1)
// the function writes 3.9 MB of P1 and 3.0 MB of P3 segments and 0.11 MB
// of PIDS in int8, reads 0.8 MB of codes and the 0.77 MB packed map, and
// reads and rewrites the 1.7 MB of the ml and mu lines (about 0.0036 ms at
// 3.35 TB/s; 0.0100 with float32 outputs).  What costs is L2: every CTA
// reads its share of the map (4 CTAs a frame: 24.5 MB over the dispatch)
// and stages its frame (8 MB), and the shared-memory byte gathers (about
// 2.6 wavefronts a warp's load).  Design (probes/k11_k15_variants.py): a
// grid of (4 CTAs, S x F frames) of 1024 threads, one CTA an SM; each CTA
// stages its frame by bulk copies, then takes blocks of 1024 16-output
// chunks in turn with the frame's other CTAs: a thread loads a chunk's 16
// map entries in three 16-byte loads (its first while the copies land, the
// next while it gathers), gathers 16 bits from shared memory and writes 16
// bytes.  The frame and CTA come from the grid's
// coordinates: no 64-bit division.
//
// am_gather_pids, the PIDS-only launch: the per-block AM receiver decodes
// each block's PIDS as the block arrives, before its frame is complete, and
// MA1 with rdbi set zeroes the lower stream (decode_am.py:199's
// pids1_disabled).  A CTA a block stages the block's 64 QAM16 codes in
// shared memory and a thread an output of the block's 432 K7 inputs reads
// its bit through the one-block map (ops/decode_am.py:pids_block_map, an
// int16 bit address an entry); the lower stream's bits lie in the even
// bytes, written 0 under the flag.  Bound: bytes, 64 in and 432 out a
// block, far below a launch's cost at the receiver's one block a call.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"
#include "packed3.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int TILES = 4;           // CTAs a (station, frame)
constexpr int VEC = 16;            // outputs a thread step
constexpr int SEG = 18000;         // bits of a delayed stream a frame
constexpr int LINE = 3 * SEG;      // 54000-bit diversity delay line
constexpr int LINES = 4;           // ml, mu, eml, emu
constexpr int FRAME_CODES = 25600; // 8 blocks x 4 partitions x 800 codes
constexpr int PIDS_BYTES = 512;    // 8 blocks x [32, 2] QAM16 codes
constexpr int LINE_BASE = FRAME_CODES + PIDS_BYTES;  // the line slices

struct Lines {
  const uint8_t* old[LINES];
  uint8_t* out[LINES];  // null for a line this mode does not delay
};

// line d's pointers by selects, so that the parameter struct is never
// indexed at run time (which would copy it to local memory)
__device__ __forceinline__ const uint8_t* old_line(const Lines& l, int d) {
  return d == 0 ? l.old[0] : d == 1 ? l.old[1] : d == 2 ? l.old[2]
                                                         : l.old[3];
}
__device__ __forceinline__ uint8_t* new_line(const Lines& l, int d) {
  return d == 0 ? l.out[0] : d == 1 ? l.out[1] : d == 2 ? l.out[2]
                                                         : l.out[3];
}

__global__ void __launch_bounds__(THREADS) am_gather_kernel(
    const uint8_t* __restrict__ codes, const uint8_t* __restrict__ pids,
    const uint8_t* __restrict__ map3, Lines lines,
    int8_t* __restrict__ p1_out, int8_t* __restrict__ p3_out,
    int8_t* __restrict__ pids_out, int n_frames, int m1, int m3, int mp,
    int n_delayed) {
  extern __shared__ __align__(16) uint8_t sm[];
  __shared__ uint64_t bar;
  const int tile = blockIdx.x, sf = blockIdx.y;  // sf = s * F + f
  const int s = sf / n_frames, f = sf - s * n_frames;
  const int tid = threadIdx.x;
  const int line_len = n_delayed * SEG;
  const bool staged_lines = f < 3;
  if (tid == 0) bulk::init(&bar);
  __syncthreads();
  if (tid == 0) {
    bulk::expect(&bar, LINE_BASE + (staged_lines ? line_len : 0));
    bulk::copy(sm, codes + (size_t)sf * FRAME_CODES, FRAME_CODES, &bar);
    bulk::copy(sm + FRAME_CODES, pids + (size_t)sf * PIDS_BYTES, PIDS_BYTES,
               &bar);
    if (staged_lines)
      for (int d = 0; d < n_delayed; ++d)
        bulk::copy(sm + LINE_BASE + d * SEG,
                   old_line(lines, d) + (size_t)s * LINE + SEG * f, SEG,
                   &bar);
  }
  const int lines_at = m1 + m3 + mp;  // the map's line entries
  if (!staged_lines) {
    // frame f - 3's bits of each delayed stream, as the carried line
    // would hold them
    const uint8_t* prev = codes + (size_t)(sf - 3) * FRAME_CODES;
    for (int i = tid; i < line_len; i += THREADS) {
      const int e = packed3::entry(map3, lines_at + i);
      sm[LINE_BASE + i] = (__ldg(prev + (e >> 3)) >> (e & 7)) & 1;
    }
  }
  // the copied part of the new lines, by frame 0's CTAs
  const int keep = LINE - SEG * n_frames;
  if (f == 0 && keep > 0) {
    const int per = keep / 16;
    for (int i = tile * THREADS + tid; i < n_delayed * per;
         i += TILES * THREADS) {
      const int d = i / per, v = i - d * per;
      const size_t at = (size_t)s * LINE + 16 * v;
      *reinterpret_cast<uint4*>(new_line(lines, d) + at) =
          __ldg(reinterpret_cast<const uint4*>(old_line(lines, d) + at +
                                               SEG * n_frames));
    }
  }
  // the frame's chunks of 16 outputs (the line part only where the
  // frame's fresh bits stay on the line), in blocks of THREADS chunks
  // taken by the frame's CTAs in turn
  const int total = lines_at + (n_frames - f <= 3 ? line_len : 0);
  const int chunks = total / VEC;
  // each thread's first map entries load while the copies land
  int c = tile * THREADS + tid;
  int e[VEC];
  if (c < chunks) packed3::load(map3, c, e);
  bulk::wait(&bar);
  if (!staged_lines) __syncthreads();
  for (; c < chunks; c += TILES * THREADS) {
    int nxt[VEC];
    if (c + TILES * THREADS < chunks)
      packed3::load(map3, c + TILES * THREADS, nxt);
    const int m = c * VEC;
    uint8_t* dst;
    uint32_t one = 1u, zero = 0xffu;  // K7 input: +1 / -1 as int8
    if (m < m1) {
      dst = reinterpret_cast<uint8_t*>(p1_out) + (size_t)sf * m1 + m;
    } else if (m < m1 + m3) {
      dst = reinterpret_cast<uint8_t*>(p3_out) + (size_t)sf * m3 + (m - m1);
    } else if (m < lines_at) {
      dst = reinterpret_cast<uint8_t*>(pids_out) + (size_t)sf * mp +
            (m - m1 - m3);
    } else {
      const int i = m - lines_at;
      const int d = i / SEG;
      dst = new_line(lines, d) + (size_t)s * LINE + LINE -
            SEG * (n_frames - f) + (i - d * SEG);
      zero = 0u;  // a line byte is the bit
    }
    uint32_t w[VEC / 4];
#pragma unroll
    for (int k = 0; k < VEC / 4; ++k) {
      uint32_t x = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int a = e[4 * k + j] < 0 ? 0 : e[4 * k + j];
        const uint32_t bit = (sm[a >> 3] >> (a & 7)) & 1u;
        x |= (e[4 * k + j] < 0 ? 0u : (bit ? one : zero)) << (8 * j);
      }
      w[k] = x;
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
#pragma unroll
    for (int j = 0; j < VEC; ++j) e[j] = nxt[j];
  }
}

constexpr int PIDS_OUT = (80 + 64) * 3;  // a block's wrap-extended trellis
constexpr int PIDS_THREADS = 448;

__global__ void __launch_bounds__(PIDS_THREADS) am_gather_pids_kernel(
    const uint8_t* __restrict__ pids, const int16_t* __restrict__ map,
    int8_t* __restrict__ out, int disabled) {
  __shared__ uint8_t codes[64];
  const int b = blockIdx.x, tid = threadIdx.x;
  if (tid < 64) codes[tid] = pids[(size_t)b * 64 + tid];
  __syncthreads();
  for (int i = tid; i < PIDS_OUT; i += PIDS_THREADS) {
    const int a = map[i];
    const int byte = a >> 3;
    const int bit = (codes[byte] >> (a & 7)) & 1;
    out[(size_t)b * PIDS_OUT + i] =
        (disabled && !(byte & 1)) ? 0 : (bit ? 1 : -1);
  }
}

}  // namespace

// pids: [B, 32, 2] uint8 QAM16 codes; map: int16 [432] bit addresses into
// a block's 64 bytes; out: int8 [B, 144, 3]; disabled: zero the lower
// stream (MA1 with rdbi set).
extern "C" int am_gather_pids(const void* pids, const void* map, void* out,
                              int n_blocks, int disabled, void* stream) {
  if (n_blocks <= 0 || n_blocks > 0x7fffffff / PIDS_OUT)
    return (int)cudaErrorInvalidValue;
  am_gather_pids_kernel<<<n_blocks, PIDS_THREADS, 0,
                          (cudaStream_t)stream>>>(
      (const uint8_t*)pids, (const int16_t*)map, (int8_t*)out, disabled);
  return (int)cudaGetLastError();
}

// map3: the packed map; lines: ml, mu, eml, emu, [S, 54000] uint8 each;
// only the first n_delayed are read and written (the outputs may be null
// for the others).  Every pointer 16-byte aligned.
extern "C" int am_gather(const void* codes, const void* pids,
                         const void* map3, const void* ml, const void* mu,
                         const void* eml, const void* emu, void* p1_out,
                         void* p3_out, void* pids_out, void* ml_out,
                         void* mu_out, void* eml_out, void* emu_out,
                         int n_stations, int n_frames, int m1, int m3,
                         int mp, int n_delayed, void* stream) {
  if (n_stations <= 0 || n_frames <= 0 || m1 <= 0 || m3 <= 0 || mp <= 0 ||
      m1 % VEC || m3 % VEC || mp % VEC || n_delayed < 1 ||
      n_delayed > LINES || n_stations * n_frames > 65535)
    return (int)cudaErrorInvalidValue;
  Lines lines = {{(const uint8_t*)ml, (const uint8_t*)mu,
                  (const uint8_t*)eml, (const uint8_t*)emu},
                 {(uint8_t*)ml_out, (uint8_t*)mu_out, (uint8_t*)eml_out,
                  (uint8_t*)emu_out}};
  for (int d = 0; d < n_delayed; ++d)
    if (!lines.old[d] || !lines.out[d]) return (int)cudaErrorInvalidValue;
  const int smem = LINE_BASE + n_delayed * SEG;
  cudaError_t err = cudaFuncSetAttribute(
      am_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  am_gather_kernel<<<dim3(TILES, n_stations * n_frames), THREADS, smem,
                     (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const uint8_t*)pids, (const uint8_t*)map3,
      lines, (int8_t*)p1_out, (int8_t*)p3_out, (int8_t*)pids_out, n_frames,
      m1, m3, mp, n_delayed);
  return (int)cudaGetLastError();
}
