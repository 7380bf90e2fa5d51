// K7's Viterbi kernel: ACS forward recursion and traceback over free-start
// segments of a rate-1/3 code, for K=7 (viterbi_k7.cu, 64 states) and K=9
// (viterbi_k9.cu, 256 states).  Both sources instantiate this template with
// their generators as compile-time constants.
//
// Replaces nrsc5_tpu/ops/convolutional.py:_acs_traceback (lines 154-251) at
// radix 1.  ext [n_seg, n_steps, 3] LLRs (positive = bit 1), int8 (K6's,
// K11's and K15's outputs) or float32 (the same values) ->
//   bits [n_seg, n_steps] uint8, margin [n_seg] f32 = top1 - top2 of the
//   final path metrics (ties counting).  Uniform (zero) start metrics; a tie
//   takes predecessor p0; the traceback starts from the FIRST maximal state.
//
// Input contract: every LLR an integer in [-127, 127] (K6, K11 and K15
// produce nothing else).  The kernel converts them to int as it stages
// them (a float32 by rounding, an int8 as it is) and keeps integer path
// metrics (|pm| <= 381 n_steps < 2^24), so bits and margins equal the
// plain version's float arithmetic exactly, and an int8 input gives the
// same bits and margins as the same values in float32.
//
// Arithmetic.  Every generator has taps at both ends (static_assert), so the
// four branches of the butterfly (p0 = 2u, p1 = 2u + 1) -> (u, u + ns/2)
// carry one metric W(u) with signs + - - +:
//   pm'[u]        = max(pm[2u] + W, pm[2u+1] - W), dec = second > first
//   pm'[u + ns/2] = max(pm[2u] - W, pm[2u+1] + W), dec likewise
// and W(u) = sum_k (parity(2u & G_k) ? l_k : -l_k).
//
// Forward.  A segment is TPS = ns / R threads of R states each (K=7: R = 4,
// 16 threads, two segments a warp; K=9: R = 8, one warp).  At the start of
// a period thread i holds states i*R .. i*R + R - 1; the r = log2(R)
// butterfly levels of the period stay inside the thread (slot q of level j
// holds state ((q >> (r-j)) << (m-j)) | (i << (r-j)) | (q & (2^(r-j) - 1)),
// m = K - 1; butterfly q takes slots 2q, 2q+1 to q, q + R/2), and one
// exchange through shared memory a period restores the start layout.  W's
// signs split into the thread's part (three flips a level, fixed before the
// loop) and a compile-time part a slot.  A level's decisions are R ballots
// (bit = lane); lane 0 keeps a stage's in shared memory and the warp copies
// them out to a global scratch the wrapper allocates, so decisions do not
// cap the segments in flight.  LLRs come a stage ahead into registers and a
// period ahead out of shared memory.
//
// Traceback.  Every lane of a segment walks the same path (no broadcast).
// Chunks of decision words come into a ring of three in shared memory by
// cp.async two chunks ahead; a period's words come into registers a period
// ahead (their address needs no state); each step chooses both successors'
// words by a select tree on the state's older bits, looks both decisions up
// before the newest one is known, and takes one of them by a single lop3,
// the chain's only instruction a step.  bits[t] is the decision of step
// t + m; the last m bits are the final state's.
//
// Bound on the H100: neither bytes nor operations.  Each segment is a chain
// of n_steps dependent ACS steps and as many traceback steps; a warp issues
// both for its segments.  The chains' segment counts fill the card in one
// round, so a call costs about its instructions a step (P1 and P3, several
// warps a scheduler) or one warp's cycles a step (PX1's 256 frames and the
// PIDS blocks, a warp or two an SM).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace viterbi {

constexpr int STAGE_PERIODS = 16;  // periods of LLRs staged at a time
constexpr int CHUNK_PERIODS = 32;  // periods of decisions a traceback chunk

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// one of 2 or 4 traceback candidate words by the state's newest bits
template <int N>
__device__ __forceinline__ uint32_t pick(const uint32_t (&w)[N], unsigned g);
template <>
__device__ __forceinline__ uint32_t pick<2>(const uint32_t (&w)[2],
                                            unsigned g) {
  return (g & 1) ? w[1] : w[0];
}
template <>
__device__ __forceinline__ uint32_t pick<4>(const uint32_t (&w)[4],
                                            unsigned g) {
  const uint32_t lo = (g & 1) ? w[1] : w[0];
  const uint32_t hi = (g & 1) ? w[3] : w[2];
  return (g & 2) ? hi : lo;
}

// a ? b : c for bits (lop3 0xCA), opaque to the compiler so that the chain
// of the traceback stays one instruction a step
__device__ __forceinline__ unsigned mux(unsigned a, unsigned b, unsigned c) {
  unsigned r;
  asm("lop3.b32 %0, %1, %2, %3, 0xCA;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

template <int M, int RL, unsigned G0, unsigned G1, unsigned G2>
struct Trellis {
  static constexpr int NS = 1 << M;     // states
  static constexpr int R = 1 << RL;     // states a thread
  static constexpr int HALF = R / 2;    // butterflies a thread a level
  static constexpr int TPS = NS / R;    // threads a segment
  static constexpr int SPW = 32 / TPS;  // segments a warp
  static constexpr int STAGE = STAGE_PERIODS * RL;  // LLR steps staged
  static constexpr int CHUNK = CHUNK_PERIODS * RL;  // traceback chunk steps
  // exchange stride: the groups of a warp start 16 banks apart
  static constexpr int XS = SPW > 1 ? NS + 16 : NS;
  static_assert(TPS <= 32 && 32 % TPS == 0, "a segment within a warp");
  static_assert(R % 4 == 0, "a step's ballots in whole 16-byte units");
  // decision words a warp
  static __host__ __device__ constexpr long long stride(int n_steps) {
    return static_cast<long long>(n_steps) * R;
  }
  static_assert(((G0 & G1 & G2) & 1u) && (((G0 & G1 & G2) >> M) & 1u),
                "the butterfly needs taps at both ends of every generator");
  static_assert(M > RL, "a word's top bits lie above the newest bit");

  struct Fwd {
    int4 llr[SPW][STAGE];      // (l0, l1, l2, -) a step
    int xch[2][SPW][XS];       // the period's exchange, double-buffered
    __align__(16) uint32_t bal[STAGE * R];  // the stage's ballots
  };
  struct Tb {
    uint32_t ring[3][CHUNK * R];      // decision words, three chunks
    uint8_t out[SPW][CHUNK_PERIODS];  // a period's output bits a byte
  };
  union Smem {
    Fwd f;
    Tb t;
  };

  // compile-time half of W's signs: parity((h << (m-j)) | (g' << 1)) & G_k)
  // for butterfly q of level j (h = q >> (r-j-1), g' = its low bits)
  static __device__ __forceinline__ int branch(int j, int q, int l0, int l1,
                                               int l2) {
    const int gb = RL - j - 1;
    const unsigned h = static_cast<unsigned>(q) >> gb;
    const unsigned g = static_cast<unsigned>(q) & ((1u << gb) - 1u);
    const unsigned full = (h << (M - j)) | (g << 1);
    const int a = (__popc(full & G0) & 1) ? l0 : -l0;
    const int b = (__popc(full & G1) & 1) ? l1 : -l1;
    const int c = (__popc(full & G2) & 1) ? l2 : -l2;
    return a + b + c;
  }

  // the state of slot q at level j in thread i
  static __device__ __forceinline__ unsigned state_of(int q, int j, int i) {
    const int low = RL - j;
    return ((static_cast<unsigned>(q) >> low) << (M - j)) |
           (static_cast<unsigned>(i) << low) |
           (static_cast<unsigned>(q) & ((1u << low) - 1u));
  }
};

__device__ __forceinline__ int llr_int(float v) { return __float2int_rn(v); }
__device__ __forceinline__ int llr_int(int8_t v) { return v; }

template <int M, int RL, unsigned G0, unsigned G1, unsigned G2, class TL>
__global__ void __launch_bounds__(32)
    acs_traceback_kernel(const TL* __restrict__ ext,
                         uint8_t* __restrict__ bits,
                         float* __restrict__ margin,
                         uint32_t* __restrict__ scratch, int n_seg,
                         int n_steps) {
  using T = Trellis<M, RL, G0, G1, G2>;
  constexpr int NS = T::NS, R = T::R, HALF = T::HALF, TPS = T::TPS,
                SPW = T::SPW, STAGE = T::STAGE, CHUNK = T::CHUNK;
  __shared__ __align__(16) typename T::Smem sm;

  const int lane = threadIdx.x;
  const int grp = lane / TPS;
  const int ti = lane % TPS;
  const int seg_raw = blockIdx.x * SPW + grp;
  const bool real = seg_raw < n_seg;
  // a group past the last segment walks the last segment again, writing
  // nothing, so every lane of the warp takes part in every ballot
  const int seg = real ? seg_raw : n_seg - 1;
  uint32_t* dec = scratch + blockIdx.x * T::stride(n_steps);

  // the thread's half of W's signs: level j flips l_k where
  // parity((i << (r-j)) & G_k) is 1
  int fl[RL][3];
#pragma unroll
  for (int j = 0; j < RL; ++j) {
    const unsigned v = static_cast<unsigned>(ti) << (RL - j);
    fl[j][0] = (__popc(v & G0) & 1) ? -1 : 1;
    fl[j][1] = (__popc(v & G1) & 1) ? -1 : 1;
    fl[j][2] = (__popc(v & G2) & 1) ? -1 : 1;
  }

  // ---- forward: integer ACS, r levels a period, one exchange a period
  int pm[R];
#pragma unroll
  for (int q = 0; q < R; ++q) pm[q] = 0;
  int jf = 0;  // the level the final metrics are at (0: after an exchange)
  int xpar = 0;
  const TL* src = ext + static_cast<size_t>(seg) * n_steps * 3;
  int* stage = reinterpret_cast<int*>(sm.f.llr[grp]);
  // each stage's LLRs are loaded into registers a stage ahead
  constexpr int PRE = (STAGE * 3 + TPS - 1) / TPS;
  TL pre[PRE];
  auto load_stage = [&](int t0) {
    const int n3 = min(STAGE, n_steps - t0) * 3;
    const TL* p = src + static_cast<size_t>(t0) * 3;
#pragma unroll
    for (int v = 0; v < PRE; ++v) {
      const int k = ti + v * TPS;
      pre[v] = k < n3 ? __ldg(p + k) : TL(0);
    }
  };
  load_stage(0);
  for (int t0 = 0; t0 < n_steps; t0 += STAGE) {
    const int n = min(STAGE, n_steps - t0);
    __syncwarp();
#pragma unroll
    for (int v = 0; v < PRE; ++v) {
      const int k = ti + v * TPS;
      if (k < n * 3) {
        const int step = k / 3;
        stage[step * 4 + (k - step * 3)] = llr_int(pre[v]);
      }
    }
    __syncwarp();
    if (t0 + STAGE < n_steps) load_stage(t0 + STAGE);
    // one trellis step at level j with the LLRs l: the butterflies, the
    // ballots of their decisions (lane 0 keeps them for the stage)
    auto level = [&](auto jc, int t, const int4& l) {
      constexpr int J = decltype(jc)::value;
      const int l0 = fl[J][0] * l.x, l1 = fl[J][1] * l.y, l2 = fl[J][2] * l.z;
      int nw[R];
      unsigned bal[R];
#pragma unroll
      for (int q = 0; q < HALF; ++q) {
        const int w = T::branch(J, q, l0, l1, l2);
        const int a = pm[2 * q], b = pm[2 * q + 1];
        // the max with its compare's predicate, e0 = (c00 >= c01): a tie
        // takes p0 (sm_90 compiles it to a compare and a select); the
        // ballots hold p0's choices, inverted at the flush
        bool e0, e1;
        nw[q] = __vibmax_s32(a + w, b - w, &e0);
        nw[q + HALF] = __vibmax_s32(a - w, b + w, &e1);
        bal[q] = __ballot_sync(0xffffffffu, e0);
        bal[q + HALF] = __ballot_sync(0xffffffffu, e1);
      }
      if (lane == 0) {
        uint4* o = reinterpret_cast<uint4*>(sm.f.bal + t * R);
#pragma unroll
        for (int v = 0; v < R / 4; ++v)
          o[v] = make_uint4(bal[4 * v], bal[4 * v + 1], bal[4 * v + 2],
                            bal[4 * v + 3]);
      }
#pragma unroll
      for (int q = 0; q < R; ++q) pm[q] = nw[q];
    };
    auto period = [&](int p, const int4 (&l)[RL]) {
      level(std::integral_constant<int, 0>{}, p, l[0]);
      level(std::integral_constant<int, 1>{}, p + 1, l[1]);
      if constexpr (RL == 3) level(std::integral_constant<int, 2>{}, p + 2, l[2]);
    };
    // whole periods: a period's LLRs are read a period ahead, off the
    // metrics' chain; level r (slot h = state h * TPS + i) goes back to
    // level 0 (states i*R + q) through shared memory
    const int nfull = n / RL * RL;
    int4 lc[RL];
#pragma unroll
    for (int j = 0; j < RL; ++j) lc[j] = sm.f.llr[grp][j];
    for (int p = 0; p < nfull; p += RL) {
      int4 ln[RL];
      const int pn = min(p + RL, STAGE - RL);
#pragma unroll
      for (int j = 0; j < RL; ++j) ln[j] = sm.f.llr[grp][pn + j];
      period(p, lc);
      int* xb = sm.f.xch[xpar][grp];
#pragma unroll
      for (int h = 0; h < R; ++h) xb[h * TPS + ti] = pm[h];
      __syncwarp();
#pragma unroll
      for (int v = 0; v < R / 4; ++v) {
        const int4 x = reinterpret_cast<const int4*>(xb + ti * R)[v];
        pm[4 * v] = x.x;
        pm[4 * v + 1] = x.y;
        pm[4 * v + 2] = x.z;
        pm[4 * v + 3] = x.w;
      }
      xpar ^= 1;
#pragma unroll
      for (int j = 0; j < RL; ++j) lc[j] = ln[j];
    }
    // the segment's last period, when it ends early: the metrics stay at
    // level n - nfull
    if (nfull < n) {
      jf = n - nfull;
      level(std::integral_constant<int, 0>{}, nfull, lc[0]);
      if constexpr (RL == 3)
        if (jf == 2) level(std::integral_constant<int, 1>{}, nfull + 1, lc[1]);
    }
    // the stage's decisions (the ballots inverted: bit = p1 chosen) out
    // to the scratch, coalesced
    __syncwarp();
    uint4* o = reinterpret_cast<uint4*>(dec + static_cast<size_t>(t0) * R);
    const uint4* b = reinterpret_cast<const uint4*>(sm.f.bal);
    for (int k = lane; k < n * (R / 4); k += 32) {
      const uint4 v = b[k];
      o[k] = make_uint4(~v.x, ~v.y, ~v.z, ~v.w);
    }
  }

  // ---- top-2 (ties counting) and first argmax across the group
  int top1 = pm[0], top2 = INT_MIN;
  unsigned best = T::state_of(0, jf, ti);
#pragma unroll
  for (int q = 1; q < R; ++q) {
    const int v = pm[q];
    const unsigned s = T::state_of(q, jf, ti);
    if (v > top1) {
      top2 = top1;
      top1 = v;
      best = s;
    } else if (v == top1) {
      top2 = v;
      best = min(best, s);
    } else if (v > top2) {
      top2 = v;
    }
  }
#pragma unroll
  for (int off = 1; off < TPS; off <<= 1) {
    const int o1 = __shfl_xor_sync(0xffffffffu, top1, off);
    const int o2 = __shfl_xor_sync(0xffffffffu, top2, off);
    const unsigned ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int n2 = max(min(top1, o1), max(top2, o2));
    best = o1 > top1 ? ob : (top1 > o1 ? best : min(best, ob));
    top1 = max(top1, o1);
    top2 = n2;
  }
  uint8_t* out = bits + static_cast<size_t>(seg) * n_steps;
  if (real && ti == 0) margin[seg] = static_cast<float>(top1 - top2);
  // bits[t] for the last m steps: the final state's bits, newest at the top
  for (int k = ti; k < min(M, n_steps); k += TPS)
    if (real) out[n_steps - 1 - k] = (best >> (M - 1 - k)) & 1u;
  if (n_steps <= M) return;

  // ---- traceback: bits[t - m] = d_t for t = n_steps - 1 .. m
  __threadfence_block();  // lane 0's decision stores, before cp.async reads
  __syncwarp();
  const int p_top = (n_steps - 1) / RL, p_bot = M / RL;
  const int c_top = (n_steps - 1) / CHUNK, c_bot = M / CHUNK;
  auto load_chunk = [&](int c) {
    const int first = c * CHUNK, cnt = min(CHUNK, n_steps - first);
    const uint4* g =
        reinterpret_cast<const uint4*>(dec + static_cast<size_t>(first) * R);
    uint4* s = reinterpret_cast<uint4*>(sm.t.ring[c % 3]);
    for (int k = lane; k < cnt * (R / 4); k += 32) cp_async16(s + k, g + k);
    cp_async_commit();
  };
  // a period's decision words (R a step) come into registers a period
  // ahead of their walk; their address needs no state
  struct Words {
    uint32_t w[RL][R];
  };
  auto words_of = [&](int P) -> const uint32_t* {
    return sm.t.ring[(P / CHUNK_PERIODS) % 3] + (P % CHUNK_PERIODS) * RL * R;
  };
  auto load_period = [&](const uint32_t* at) {
    Words x;
    const uint4* src = reinterpret_cast<const uint4*>(at);
#pragma unroll
    for (int k = 0; k < RL * R / 4; ++k) {
      const uint4 v = src[k];
      x.w[(4 * k) / R][(4 * k) % R] = v.x;
      x.w[(4 * k) / R][(4 * k) % R + 1] = v.y;
      x.w[(4 * k) / R][(4 * k) % R + 2] = v.z;
      x.w[(4 * k) / R][(4 * k) % R + 3] = v.w;
    }
    return x;
  };
  // the candidate ballot words of step t (level j) for the successors of
  // s: the word of slot (top j+1 bits, newest r-j-1 bits); the top bits
  // are the same for both successors and choose by a select tree
  const int lane0 = grp * TPS;
  auto candidates = [&](auto jc, const Words& x, unsigned top, auto& c) {
    constexpr int J = decltype(jc)::value;
    constexpr int GB = RL - J - 1;
#pragma unroll
    for (int g = 0; g < (1 << GB); ++g) {
      uint32_t v[1 << (J + 1)];
#pragma unroll
      for (int h = 0; h < (1 << (J + 1)); ++h) v[h] = x.w[J][(h << GB) | g];
#pragma unroll
      for (int b = 0; b <= J; ++b) {
        const bool hi = (top >> b) & 1u;
#pragma unroll
        for (int h = 0; h < (1 << (J - b)); ++h)
          v[h] = hi ? v[2 * h + 1] : v[2 * h];
      }
      c[g] = v[0];
    }
  };
  uint8_t* obuf = sm.t.out[grp];
  unsigned s = best >> 1, d = best & 1u;  // s_{t+1} and d_{t+1} of step t
  // the steps of period P from the top: both successors looked up, then
  // one mux a step; a period's bits kept in a byte.  Only the top period
  // holds steps past n_steps - 1; steps below m are walked and not written
  auto walk = [&](auto guard, int P, const Words& x) {
    unsigned ob = 0;
    auto step = [&](auto jc) {
      constexpr int J = decltype(jc)::value;
      if (!decltype(guard)::value || P * RL + J <= n_steps - 1) {
        constexpr int GB = RL - J - 1;
        const unsigned base = (s << 1) & (NS - 2);
        uint32_t c[1 << GB];
        candidates(jc, x, base >> (M - J - 1), c);
        const unsigned sh = lane0 + ((base >> GB) & (TPS - 1));
        unsigned b0, b1;
        if constexpr (GB == 0) {  // the newest bit picks the lane
          b0 = (c[0] >> sh) & 1u;
          b1 = (c[0] >> (sh + 1)) & 1u;
        } else {  // the newest bit picks the word
          b0 = (pick(c, base & ((1u << GB) - 1u)) >> sh) & 1u;
          b1 = (pick(c, (base | 1u) & ((1u << GB) - 1u)) >> sh) & 1u;
        }
        s = base | d;
        d = mux(d, b1, b0);
        ob |= d << J;
      }
    };
    if constexpr (RL == 3) step(std::integral_constant<int, 2>{});
    step(std::integral_constant<int, 1>{});
    step(std::integral_constant<int, 0>{});
    obuf[P % CHUNK_PERIODS] = static_cast<uint8_t>(ob);
  };
  // chunk c walked: its bits out
  auto flush = [&](int c) {
    __syncwarp();
    const int lo = max(c * CHUNK, M) - M;
    const int hi = min((c + 1) * CHUNK, n_steps) - M;
    for (int pos = lo + ti; pos < hi; pos += TPS) {
      const int t = pos + M;
      if (real) out[pos] = (obuf[(t / RL) % CHUNK_PERIODS] >> (t % RL)) & 1u;
    }
    __syncwarp();
  };

  load_chunk(c_top);
  if (c_top - 1 >= c_bot) load_chunk(c_top - 1);
  cp_async_wait_all();
  __syncwarp();
  if (c_top - 2 >= c_bot) load_chunk(c_top - 2);
  Words cur = load_period(words_of(p_top - 1));
  walk(std::true_type{}, p_top, load_period(words_of(p_top)));
  if (p_top % CHUNK_PERIODS == 0) flush(c_top);
  for (int c = (p_top - 1) / CHUNK_PERIODS; c >= c_bot; --c) {
    if (c != c_top) {  // entering chunk c: chunk c - 1 arrives, c - 2 starts
      cp_async_wait_all();
      __syncwarp();
      if (c - 2 >= c_bot) load_chunk(c - 2);
    }
    const int p_hi = min(p_top - 1, (c + 1) * CHUNK_PERIODS - 1);
    const int p_lo = max(p_bot, c * CHUNK_PERIODS);
    // the words of period P - 1: down the chunk's slot, then the top of
    // chunk c - 1's
    const uint32_t* at = words_of(p_hi - 1);
    const uint32_t* below = c > 0 ? words_of(c * CHUNK_PERIODS - 1) : at;
    for (int P = p_hi; P >= p_lo; --P) {
      const Words nxt = load_period(at);
      at = P - 1 == c * CHUNK_PERIODS ? below : at - RL * R;
      walk(std::false_type{}, P, cur);
      cur = nxt;
    }
    flush(c);
  }
}

// bytes of decision scratch for n_seg segments of n_steps steps: one warp
// (SPW segments) a block, stride(n_steps) words a warp
template <int M, int RL, unsigned G0, unsigned G1, unsigned G2>
long long scratch_bytes(Trellis<M, RL, G0, G1, G2>, int n_seg, int n_steps) {
  using T = Trellis<M, RL, G0, G1, G2>;
  return (n_seg + T::SPW - 1LL) / T::SPW * T::stride(n_steps) * 4LL;
}

// launch one warp (SPW segments) a block on a scratch of at least
// scratch_bytes(...) bytes, on LLRs of type TL (int8_t or float)
template <class TL, int M, int RL, unsigned G0, unsigned G1, unsigned G2>
int launch(Trellis<M, RL, G0, G1, G2> t, const void* ext, void* bits,
           void* margin, void* scratch, long long scratch_bytes_given,
           int n_seg, int n_steps, void* stream) {
  using T = Trellis<M, RL, G0, G1, G2>;
  if (scratch_bytes_given < scratch_bytes(t, n_seg, n_steps))
    return static_cast<int>(cudaErrorInvalidValue);
  acs_traceback_kernel<M, RL, G0, G1, G2, TL>
      <<<static_cast<unsigned>((n_seg + T::SPW - 1) / T::SPW), 32, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const TL*>(ext), static_cast<uint8_t*>(bits),
          static_cast<float*>(margin), static_cast<uint32_t*>(scratch), n_seg,
          n_steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace viterbi
