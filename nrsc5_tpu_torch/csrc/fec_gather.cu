// K6: the FM P1 / PIDS deinterleave and depuncture, written straight into
// K7's input as int8.
//
// Replaces the JAX device functions nrsc5_tpu/ops/decode_fm.py:p1_decode
// and pids_decode up to the Viterbi (lines 64-66 and 98-100: the int8
// gather through p1_fm_table / pids_fm_table, the float cast and
// depuncture), together with the segment gather of
// nrsc5_tpu/ops/convolutional.py:viterbi_decode_chunked (P1) and the
// tail-biting wrap extension of viterbi_decode (PIDS).
//
// K7 input element e of a frame is soft bit k7_map[e] of that frame's pm
// rows, or 0 where k7_map[e] < 0 (a punctured site): k7_map composes the
// interleaver table, the puncture pattern and the segment plan (or the
// wrap) (ops/decode_fm.py:channel_tables).  The output is int8: every value
// is a soft bit or 0, which K7's int8 load path takes as it is.
//
// pm is [G, F, frame] int8 with a dense last axis and strides (group,
// frame): a P1 frame is 16 consecutive blocks of one station's
// [n_blocks, 23040] rows, read in place.  out is [G*F, map_len] int8,
// dense, 16-byte aligned.
//
// Bound on the H100: device-memory bytes.  P1 at 16 stations x 2 frames
// reads 11.8 MB of pm and writes 16.4 MB of segments, about 0.0085 ms at
// 3.35 TB/s.  The P1 interleaver sends neighbouring outputs all over the
// frame (a warp's 32 outputs touch ~27 distinct 32-byte sectors of pm), so
// a gather straight from pm moves ~37x the bytes it uses.  But its table
// has a structure (ops/decode_fm.py:gather_tables checks it): punctured
// stream position i = 320 k + q reads pm[beta(q)][row(k)][V[q % 20]]
// [col(k)] (block, row of 32, partition of 20, column of 36), so the 320
// positions of group k all lie in one row of every block, and which of
// them q takes depends on q alone.  So P1 runs in two passes:
//   * the deinterleave (fec_deinterleave_kernel): a CTA a (frame, row),
//     320 threads.  The row's 16 runs of 720 bytes (one a block) come into
//     shared memory by bulk copies (bulk_copy.cuh); thread q then takes
//     byte q of each of the row's ~36 groups k from offset qoff[q] + col(k)
//     (two-way bank conflicts at most) and writes the deinterleaved stream
//     d[320 k + q] to a scratch, a coalesced 32 bytes a warp a group;
//   * the depuncture and segments (fec_segments_kernel): a warp a tile of
//     512 outputs at an aligned address, a lane a 16-byte group.  Output
//     m of a frame is (segment s, step, j); its mother-code site c = 3
//     ((start[s] + step) mod t) + j is punctured (0) or reads d at 5 (c /
//     6) + rank[c % 6].  Within a segment c rises by one an output, so a
//     tile inside one segment reads one run of ~430 bytes of d, which the
//     warp brings into shared memory in one 16-byte load a lane, and each
//     lane divides once and then counts; a tile across a segment's or a
//     frame's end, or the frame bits' wrap, has each lane walk its 16
//     outputs through global memory.
//   * PIDS (no scratch): a warp a block.  The channel reads 200 of a
//     block's 23040 soft bits (scattered over 200 sectors), so the warp
//     gathers just those (the host's sorted src list) into shared memory
//     and writes the block's 432 outputs as 27 16-byte stores, each byte
//     through the host's idx map (position in src, 255 where punctured).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace {

// P1's frame, interleaver and segment plan (ops/decode_fm.py:gather_tables
// holds the host to these)
constexpr int BLOCKS = 16;          // L1 blocks a frame
constexpr int ROWS = 32;            // rows of a block
constexpr int ROW_BYTES = 720;      // soft bits a row of a block
constexpr int BLOCK_BYTES = ROWS * ROW_BYTES;
constexpr int GROUP = 320;          // punctured positions a group k
constexpr int MAX_K = 36;           // groups a row, at most
constexpr int ENCODED = 365440;     // punctured positions a frame
constexpr int SEGMENTS = 127;       // chunk segments a frame
constexpr int STEPS = 1343;         // trellis steps a segment
constexpr int SITES = 146176;       // frame bits t
constexpr int PERIOD = 6;           // puncture pattern: sites a period
constexpr int KEPT = 5;             // of which kept
constexpr int MAP_LEN = SEGMENTS * STEPS * 3;
// aux (int32 words) for P1: row_k [ROWS][MAX_K] (k | col(k) << 16, -1
// past a row's groups), start [SEGMENTS], qoff [GROUP], rank [PERIOD]
constexpr int AUX_ROW_K = 0;
constexpr int AUX_START = AUX_ROW_K + ROWS * MAX_K;
constexpr int AUX_QOFF = AUX_START + SEGMENTS;
constexpr int AUX_RANK = AUX_QOFF + GROUP;
constexpr int AUX_P1 = AUX_RANK + PERIOD;
constexpr int SEG_THREADS = 256;
constexpr int SEG_TILE = 512;  // outputs a warp a step: 16 a lane
// scratch: n_frames x ENCODED bytes and SCRATCH_PAD more, so that a tile's
// 512-byte window of d may run past the last frame's end
constexpr int SCRATCH_PAD = SEG_TILE;
constexpr int COMPACT_THREADS = 128;
constexpr int MAX_SRC = 255;  // idx 255 marks a punctured site

struct Args {
  const int8_t* pm;
  const void* map;     // PIDS: uint8 idx
  const int* aux;      // P1: the tables above; PIDS: the soft bits read
  int8_t* out;
  int8_t* scratch;     // P1: the deinterleaved streams [frames][ENCODED]
  long long group_stride, frame_stride;
  int frames_per_group, n_frames, pm_len, map_len, aux_len;
};

__device__ __forceinline__ const int8_t* frame_pm(const Args& a, int b) {
  const int g = b / a.frames_per_group;
  return a.pm + g * a.group_stride
         + (long long)(b - g * a.frames_per_group) * a.frame_stride;
}

// 16 bytes of the frame's output at out + pos (16-byte aligned), little-
// endian in w: one store where all lie inside [lo, hi), else byte stores of
// those that do
__device__ __forceinline__ void store16(int8_t* out, long long pos,
                                        long long lo, long long hi,
                                        const uint4& w) {
  if (pos >= lo && pos + 16 <= hi) {
    *reinterpret_cast<uint4*>(out + pos) = w;
  } else {
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int e = 0; e < 16; ++e)
      if (pos + e >= lo && pos + e < hi)
        out[pos + e] = (int8_t)(ws[e >> 2] >> (8 * (e & 3)));
  }
}

// P1, pass 1: CTA (frame, row r) writes groups k of row r of the frame's
// deinterleaved stream d, d[320 k + q] = slab[qoff[q] + col(k)], where the
// slab holds the row of every block, block b at 720 b
__global__ void __launch_bounds__(GROUP) fec_deinterleave_kernel(Args a) {
  __shared__ __align__(16) int8_t slab[BLOCKS * ROW_BYTES];
  __shared__ int row_k[MAX_K];
  __shared__ uint64_t bar;
  const int b = blockIdx.x / ROWS, r = blockIdx.x % ROWS;
  const int q = threadIdx.x;
  const int8_t* src = frame_pm(a, b) + r * ROW_BYTES;
  const bool bulk_ok = ((uintptr_t)src & 15) == 0;
  if (q == 0 && bulk_ok) bulk::init(&bar);
  if (q < MAX_K) row_k[q] = __ldg(a.aux + AUX_ROW_K + MAX_K * r + q);
  const int qoff = __ldg(a.aux + AUX_QOFF + q);
  __syncthreads();
  if (bulk_ok) {
    if (q == 0) {
      bulk::expect(&bar, BLOCKS * ROW_BYTES);
      for (int blk = 0; blk < BLOCKS; ++blk)
        bulk::copy(slab + blk * ROW_BYTES, src + blk * BLOCK_BYTES,
                   ROW_BYTES, &bar);
    }
    bulk::wait(&bar);
  } else {
    for (int e = q; e < BLOCKS * ROW_BYTES; e += GROUP)
      slab[e] = src[(e / ROW_BYTES) * BLOCK_BYTES + e % ROW_BYTES];
    __syncthreads();
  }
  int8_t* d = a.scratch + (long long)b * ENCODED;
  for (int i = 0; i < MAX_K; ++i) {
    const int kc = row_k[i];
    if (kc < 0) break;
    d[GROUP * (kc & 0xffff) + q] = slab[qoff + (kc >> 16)];
  }
}

// P1, pass 2: a warp a tile of 512 outputs at an aligned address of out
// [frames][MAP_LEN], a lane a 16-byte group of it (a tile may hold the end
// of one frame and the start of the next).  Output m = (segment s, step,
// j) reads mother-code site c = 3 ((start[s] + step) mod t) + j, which
// rises by one an output within a segment (3t wraps to 0, a whole number
// of periods): c = PERIOD cq + cr, the byte of d at KEPT cq + rank[cr]
__global__ void __launch_bounds__(SEG_THREADS) fec_segments_kernel(Args a) {
  __shared__ int start[SEGMENTS];
  __shared__ int rank[PERIOD];
  __shared__ __align__(16) int8_t win[SEG_THREADS / 32][SEG_TILE];
  for (int i = threadIdx.x; i < SEGMENTS; i += SEG_THREADS)
    start[i] = __ldg(a.aux + AUX_START + i);
  if (threadIdx.x < PERIOD)
    rank[threadIdx.x] = __ldg(a.aux + AUX_RANK + threadIdx.x);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long total = (long long)a.n_frames * MAP_LEN;
  const long long tiles = (total + SEG_TILE - 1) / SEG_TILE;
  // frame, segment and site of output position p
  auto locate = [&](long long p, int& b, int& s, int& off, int& c) {
    b = (int)(p / MAP_LEN);
    const int m = (int)(p - (long long)b * MAP_LEN);
    s = m / (3 * STEPS);
    off = m - s * 3 * STEPS;
    c = 3 * start[s] + off;
    if (c >= 3 * SITES) c -= 3 * SITES;
  };
  for (long long tile = blockIdx.x * (long long)(SEG_THREADS / 32) + warp;
       tile < tiles; tile += (long long)gridDim.x * (SEG_THREADS / 32)) {
    const long long p0 = SEG_TILE * tile;
    const long long pos = p0 + 16 * lane;
    int b0, s0, off0, c0, b1, s1, off1, c1;
    locate(p0, b0, s0, off0, c0);
    locate(min(p0 + SEG_TILE, total) - 1, b1, s1, off1, c1);
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (b0 == b1 && s0 == s1 && c1 >= c0) {
      // one frame and segment, no wrap: the tile reads one run of d, which
      // the warp brings into shared memory, 16 bytes a lane
      const long long first = (long long)b0 * ENCODED + KEPT * (c0 / PERIOD);
      const long long base = first & ~15LL;
      reinterpret_cast<int4*>(win[warp])[lane] =
          __ldg(reinterpret_cast<const int4*>(a.scratch + base) + lane);
      __syncwarp();
      const int c = c0 + 16 * lane;
      int cq = c / PERIOD, cr = c - PERIOD * cq;
      int at = (int)((long long)b0 * ENCODED + KEPT * cq - base);
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int rk = rank[cr];
        if (rk >= 0) w[e >> 2] |= (uint32_t)(uint8_t)win[warp][at + rk]
                                  << (8 * (e & 3));
        if (++cr == PERIOD) {
          cr = 0;
          at += KEPT;
        }
      }
      __syncwarp();
    } else if (pos < total) {
      // the lane walks its 16 outputs across segments, frames and the wrap
      int b, s, off, c;
      locate(pos, b, s, off, c);
      int left = 3 * STEPS - off;  // outputs left in segment s
      int cq = c / PERIOD, cr = c - PERIOD * cq;
      const int8_t* d = a.scratch + (long long)b * ENCODED + KEPT * cq;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int rk = rank[cr];
        if (rk >= 0 && pos + e < total)
          w[e >> 2] |= (uint32_t)(uint8_t)d[rk] << (8 * (e & 3));
        if (--left == 0) {  // the next segment, or frame
          left = 3 * STEPS;
          if (++s == SEGMENTS) {
            s = 0;
            ++b;
          }
          c = 3 * start[s];
          cq = c / PERIOD;
          cr = c - PERIOD * cq;
          d = a.scratch + (long long)b * ENCODED + KEPT * cq;
        } else if (++cr == PERIOD) {
          cr = 0;
          d += KEPT;
          if (++cq == 3 * SITES / PERIOD) {  // the frame bits' wrap
            cq = 0;
            d -= KEPT * (3 * SITES / PERIOD);
          }
        }
      }
    }
    if (pos < total)
      store16(a.out, pos, 0, total, make_uint4(w[0], w[1], w[2], w[3]));
  }
}

__global__ void __launch_bounds__(COMPACT_THREADS) fec_gather_compact_kernel(
    Args a) {
  __shared__ __align__(16) int8_t vals[COMPACT_THREADS / 32][MAX_SRC + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (COMPACT_THREADS / 32) + warp;
  if (b >= a.n_frames) return;  // the whole warp
  const uint8_t* idx = static_cast<const uint8_t*>(a.map);
  const long long lo = (long long)b * a.map_len, hi = lo + a.map_len;
  const long long a0 = lo & ~15LL;
  const int groups = (int)((((hi + 15) & ~15LL) - a0) / 16);
  // this lane's first group's idx bytes and its soft-bit offsets first:
  // neither waits on the other
  const long long pos = a0 + 16LL * lane;
  const long long m0 = pos - lo;
  const bool fast = lane < groups && m0 >= 0 && m0 + 16 <= a.map_len
                    && (m0 & 15) == 0;
  __align__(16) uint8_t ix[16];
  if (fast)
    *reinterpret_cast<int4*>(ix) =
        __ldg(reinterpret_cast<const int4*>(idx + m0));
  constexpr int PER = (MAX_SRC + 32) / 32;
  int off[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = lane + 32 * k;
    off[k] = i < a.aux_len ? __ldg(a.aux + i) : 0;
  }
  const int8_t* fpm = frame_pm(a, b);
  int8_t* v = vals[warp];
#pragma unroll
  for (int k = 0; k < PER; ++k)
    if (lane + 32 * k < a.aux_len) v[lane + 32 * k] = fpm[off[k]];
  __syncwarp();
  for (int q = lane; q < groups; q += 32) {
    const long long p = a0 + 16LL * q;
    const long long m = p - lo;
    if (q != lane || !fast) {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        ix[e] = (m + e >= 0 && m + e < a.map_len) ? idx[m + e] : MAX_SRC;
    }
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < 16; ++e)
      w[e >> 2] |= (ix[e] == MAX_SRC ? 0u : (uint32_t)(uint8_t)v[ix[e]])
                   << (8 * (e & 3));
    store16(a.out, p, lo, hi, make_uint4(w[0], w[1], w[2], w[3]));
  }
}

}  // namespace

// scratch non-null: P1's two passes (aux: the P1 tables, AUX_P1 int32
// words; scratch: n_frames x 365440 + 512 bytes; map unused); scratch null: the
// warp-a-frame kernel (map: idx; aux: the aux_len soft bits it reads)
extern "C" int fec_gather(const void* pm, const void* map, const void* aux,
                          void* out, int n_groups, int frames_per_group,
                          long long group_stride, long long frame_stride,
                          int pm_len, int map_len, int aux_len,
                          void* scratch, void* stream) {
  if (n_groups <= 0 || frames_per_group <= 0 || map_len <= 0 || pm_len <= 0
      || aux == nullptr || aux_len <= 0 || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  const long long frames = (long long)n_groups * frames_per_group;
  if (frames > (1 << 24)) return (int)cudaErrorInvalidValue;
  Args a;
  a.pm = (const int8_t*)pm;
  a.map = map;
  a.aux = (const int*)aux;
  a.out = (int8_t*)out;
  a.scratch = (int8_t*)scratch;
  a.group_stride = group_stride;
  a.frame_stride = frame_stride;
  a.frames_per_group = frames_per_group;
  a.n_frames = (int)frames;
  a.pm_len = pm_len;
  a.map_len = map_len;
  a.aux_len = aux_len;
  cudaStream_t st = (cudaStream_t)stream;
  if (scratch == nullptr) {
    if (map == nullptr || aux_len > MAX_SRC)
      return (int)cudaErrorInvalidValue;
    const int per = COMPACT_THREADS / 32;
    fec_gather_compact_kernel<<<(a.n_frames + per - 1) / per,
                                 COMPACT_THREADS, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  if (pm_len != BLOCKS * BLOCK_BYTES || map_len != MAP_LEN
      || aux_len != AUX_P1)
    return (int)cudaErrorInvalidValue;
  fec_deinterleave_kernel<<<a.n_frames * ROWS, GROUP, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (frames * MAP_LEN + SEG_TILE - 1) / SEG_TILE;
  long long blocks = (tiles + SEG_THREADS / 32 - 1) / (SEG_THREADS / 32);
  if (blocks > 132 * 16) blocks = 132 * 16;
  fec_segments_kernel<<<(unsigned)blocks, SEG_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}
