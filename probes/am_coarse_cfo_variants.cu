// The designs tried for K14's am_coarse and am_cfo_step, for
// probes/k14_coarse_cfo_variants.py.  The file includes the port's
// csrc/am_coldstart.cu for its helpers and for am_tone's first two kernels,
// and adds copies of the redesigned kernels with their choices as
// compile-time knobs; the defaults are the port's choices.
//
//   am_coarse_variant: the tone-subtracted CP timing split by timing lane
//     over a cluster of V_CTAS CTAs a station (1: one CTA a station, no
//     cluster; 16: a non-portable cluster), V_T threads a CTA, launched
//     with programmatic dependent launch where V_PDL is 1.  Choices, each
//     on its own: -DV_PLAIN_LOADS, f and amp read after the wait by plain
//     loads, which the compiler may hoist above it; -DV_TRIG=1, cosf and
//     sinf in place of one sincosf (=2: __cosf and __sinf, wrong past a
//     few radians: the trigonometry's share of the time, not exact); -DV_SYNC_SEND=1, the lane sums stored
//     into the leader's shared memory behind a cluster barrier in place
//     of st.async to its mbarrier; -DV_SEPARATE_PRODUCTS=1, the products
//     in a phase of their own behind a barrier; -DV_ARGMAX=1, the argmax
//     by shuffles (one barrier), =2 the three-barrier block argmax, in
//     place of warp reductions; -DV_ROT=1, prev_angle's rotation on
//     thread 0 after its sums, in place of a warp the sums leave idle;
//     -DV_LATE_WAIT=1, the cluster barrier waited for after the tone
//     loop in place of under the loads of f and amp; -DV_TONE_UNROLL=1,
//     the tone loop not unrolled (the window staged in shared memory);
//     -DV_TRIGGER=1, the kernel lets its own dependents start once its
//     CTAs run; -DV_BULK=1, each period's run brought into shared memory by
//     a bulk copy from its 16-byte aligned start (one float2 more at either
//     end where the run is not aligned) in place of loads into registers.  Phase cuts (V_STOP=1: return after the tone subtraction;
//     2: after the lane sums reach the leader; 3: after the window and the
//     argmax; a cut kernel writes one value of its last phase into
//     v_max), a clock (-DV_CLOCK: thread 0 of each CTA writes the global
//     timer, ns, at its entry, after its wait, after the tone subtraction,
//     after its sums are sent (the leader: received), after the argmax and
//     at its exit, into clock[8 (V_CTAS s + rank) + k]) and a cycle clock
//     (-DV_CLOCK64: the SM's cycle counter at the points ctick numbers,
//     into clock[16 (V_CTAS s + rank) + k]).
//   am_tone_coarse_fused: am_tone (the port's first two kernels) with its
//     tail and am_coarse as one kernel: the tail's cluster of 8 CTAs a
//     station goes on, once the amplitude is known, to the coarse timing
//     of the same split, its window runs loaded at the kernel's start.
//     One launch fewer a probe block.  am_tone_variant: am_tone with that
//     kernel cut after the amplitude, as the parent's tail (whose
//     dependent starts only when it ends).
//   am_cfo_step_variant: VC_SPLIT threads a bin (1, 2 or 4), each loading
//     32 / VC_SPLIT symbols into registers at once, the first summing the
//     others' magnitudes after its own through shared memory; VC_MODE 1
//     (VC_SPLIT 1) brings the 16-byte aligned band (bins 74..181, 864
//     bytes a row) into shared memory by 32 bulk copies; VC_CTAS > 1
//     (VC_SPLIT 1) splits the 107 bins over a cluster, the leader taking
//     the first argmax of the CTAs' maxima by distributed shared memory;
//     VC_PDL as V_PDL; VC_ARGMAX=2 the three-barrier block argmax;
//     VC_TRIGGER=1 as V_TRIGGER.

#include "../nrsc5_tpu_torch/csrc/am_coldstart.cu"

#ifndef V_CTAS
#define V_CTAS 8
#endif
#ifndef V_T
#define V_T 288
#endif
#ifndef V_PDL
#define V_PDL 1
#endif
#ifndef V_STOP
#define V_STOP 4
#endif
#ifndef V_TRIG
#define V_TRIG 0
#endif
#ifndef V_SYNC_SEND
#define V_SYNC_SEND 0
#endif
#ifndef V_SEPARATE_PRODUCTS
#define V_SEPARATE_PRODUCTS 0
#endif
#ifndef V_ARGMAX
#define V_ARGMAX 0
#endif
#ifndef V_ROT
#define V_ROT 0
#endif
#ifndef V_LATE_WAIT
#define V_LATE_WAIT 0
#endif
#ifndef V_TONE_UNROLL
#define V_TONE_UNROLL 0
#endif
#ifndef V_TRIGGER
#define V_TRIGGER 0
#endif
#ifndef V_BULK
#define V_BULK 0
#endif
#ifndef VC_MODE
#define VC_MODE 0
#endif
#ifndef VC_CTAS
#define VC_CTAS 1
#endif
#ifndef VC_PDL
#define VC_PDL 1
#endif
#ifndef VC_SPLIT
#define VC_SPLIT 4
#endif
#ifndef VC_ARGMAX
#define VC_ARGMAX 0
#endif
#ifndef VC_TRIGGER
#define VC_TRIGGER 0
#endif

namespace {

template <int CTAS, int THREADS>
struct Split {
  static constexpr int LANES_MAX = (FFTCP + CTAS - 1) / CTAS;
  static constexpr int W = LANES_MAX + CP;
  static constexpr int ITEMS = (PERIODS * W + THREADS - 1) / THREADS;
  static constexpr int PITEMS = (NSYM * LANES_MAX + THREADS - 1) / THREADS;
  static constexpr int SMEM = (PERIODS * W + NSYM * LANES_MAX) * 8;
  // V_BULK's staging rows: a run and a float2 on each side, 16-byte rows
  static constexpr int RW = (W + 3) & ~1;
  static constexpr int STAGE = V_BULK ? PERIODS * RW * 8 : 0;
};

__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

__device__ __forceinline__ float2 trig(float t) {
  if (V_TRIG == 2) return make_float2(__cosf(t), __sinf(t));  // timing only
  return V_TRIG == 1 ? make_float2(cosf(t), sinf(t)) : cis(t);
}

// the port's first argmax, or the shuffle (1) or block (2) argmax
__device__ __forceinline__ int argmax(int how, float best, int at,
                                      unsigned* bk, int* bi) {
  if (how == 2) return block_argmax(best, at, reinterpret_cast<float*>(bk), bi);
  if (how == 0) return first_argmax(best, at, bk, bi);
  float* bp = reinterpret_cast<float*>(bk);
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, at, o);
    if (ob > best || (ob == best && oi < at)) {
      best = ob;
      at = oi;
    }
  }
  const int lane = threadIdx.x & 31, warps = blockDim.x / 32;
  if (lane == 0) {
    bp[threadIdx.x >> 5] = best;
    bi[threadIdx.x >> 5] = at;
  }
  __syncthreads();
  if (threadIdx.x >= 32) return -1;
  best = lane < warps ? bp[lane] : -1.0f;
  at = lane < warps ? bi[lane] : 0x7fffffff;
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, at, o);
    if (ob > best || (ob == best && oi < at)) {
      best = ob;
      at = oi;
    }
  }
  return at;
}

__device__ __forceinline__ void vtick(long long* clock, int slot, int k) {
#ifdef V_CLOCK
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    clock[8 * slot + k] = (long long)t;
  }
#endif
}

// -DV_CLOCK64: 0 entry, 1 loads issued, 2 past the wait, 3 the loads of f
// and amp issued, 4 the tone loop done, 5 past its barrier, 6 the
// cluster's start waited for, 7 the sums sent; the leader: 8 the rotation
// thread's loads issued (or thread 0's rotation formed), 9 every sum
// received, 10 the window formed, 11 the argmax known, 12 the outputs
// written; 13 f and amp arrived (after 3, and after the cluster wait)
__device__ __forceinline__ void ctick(long long* clock, int slot, int k) {
#ifdef V_CLOCK64
  if (threadIdx.x == 0) clock[16 * slot + k] = clock64();
#endif
}

// this CTA's run items, the loads only (before any wait): into registers,
// and with STAGE also into the runs in shared memory
template <int CTAS, int THREADS, bool STAGE = false>
__device__ __forceinline__ void coarse_loads(
    const float2* w, int lo, int lanes,
    float2 (&wv)[Split<CTAS, THREADS>::ITEMS], float2* run = nullptr) {
  using S = Split<CTAS, THREADS>;
#pragma unroll
  for (int k = 0; k < S::ITEMS; ++k) {
    const int i = threadIdx.x + k * THREADS;
    const int p = i / S::W, j = i % S::W;
    wv[k] = make_float2(0.0f, 0.0f);
    if (p < PERIODS && coarse_item_read(p, j, lanes))
      wv[k] = w[FFTCP * p + lo - CP + j];
  }
  if (STAGE) {
#pragma unroll
    for (int k = 0; k < S::ITEMS; ++k) {
      const int i = threadIdx.x + k * THREADS;
      if (i < PERIODS * S::W) run[i] = wv[k];
    }
  }
}

// the rest of the coarse timing on CTA r of the station's cluster, from f
// and amp on: the tone subtraction, the products and lane sums into the
// leader's `sums` (float [270][2], counted on the leader's mbarrier `mb`
// unless V_SYNC_SEND), and on the leader the window, the argmax and the
// scalar tail.  WAIT_START: the cluster barrier the kernel arrived at on
// its start is still to be waited for, before the first write into the
// leader.
template <int CTAS, int THREADS, bool WAIT_START, int STOP>
__device__ __forceinline__ void coarse_rest(
    const float2 (&wv)[Split<CTAS, THREADS>::ITEMS], int lo, int lanes,
    int r, int s, float c, float2 amp, float2* run, float2* prod,
    float2* sums, float2* v_s, const float* kern, unsigned* bk, int* bi,
    uint64_t* mb, float4* rot_s, const float* prev_angle,
    const int* coarse_override, int* measured, int* samperr,
    float* prev_angle_out, float2* v_max, long long* clock,
    const float2* stage = nullptr, int q = 0, uint64_t* wbar = nullptr) {
  using S = Split<CTAS, THREADS>;
  const int tid = threadIdx.x;
  const int slot = CTAS * s + r;
  constexpr int ROT_THREAD = THREADS - 32;
  if (CTAS > 1 && WAIT_START && !V_LATE_WAIT)
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
#ifdef V_CLOCK64
  // a branch on f and amp: the tick waits for their loads
  if (__float_as_uint(c) == 0x7fbadbadu && amp.x == 0.0f) v_max[s] = amp;
  ctick(clock, slot, 13);
#endif
  if (V_BULK && stage) bulk::wait(wbar);
#if V_TONE_UNROLL == 1
#pragma unroll 1
#else
#pragma unroll
#endif
  for (int k = 0; k < S::ITEMS; ++k) {
    const int i = tid + k * THREADS;
    const int p = i / S::W, j = i % S::W;
    if (p < PERIODS && coarse_item_read(p, j, lanes)) {
      const int n = FFTCP * p + lo - CP + j;
      const float2 e = trig(c * ((float)n - HALF_SPAN));
      const float2 tone = cmul(amp, make_float2(e.x, -e.y));
      // staged in the runs where the loop is not unrolled, or by bulk copy
      const float2 wk = V_BULK && stage ? stage[p * S::RW + j + q]
                        : V_TONE_UNROLL != 0 ? run[i] : wv[k];
      run[p * S::W + j] = make_float2(wk.x - tone.x, wk.y - tone.y);
    }
  }
  ctick(clock, slot, 4);
  __syncthreads();
  ctick(clock, slot, 5);
  vtick(clock, slot, 2);
  if (STOP == 1) {
    if (CTAS > 1 && WAIT_START && V_LATE_WAIT)
      asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    if (tid == 0 && r == 0) v_max[s] = run[S::W * 2];
    return;
  }
  if (V_SEPARATE_PRODUCTS) {
#pragma unroll
    for (int k = 0; k < S::PITEMS; ++k) {
      const int i = tid + k * THREADS;
      const int sym = i / S::LANES_MAX, l = i % S::LANES_MAX;
      if (sym < NSYM && l < lanes)
        prod[sym * S::LANES_MAX + l] =
            cmul_conj(run[sym * S::W + l + CP], run[(sym + 1) * S::W + l]);
    }
    __syncthreads();
  }
  if (CTAS > 1 && WAIT_START && V_LATE_WAIT)
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  ctick(clock, slot, 6);
  for (int q = tid; q < 2 * lanes; q += THREADS) {
    const int l = q >> 1, im = q & 1;
    float terms[NSYM];
#pragma unroll
    for (int k = 0; k < NSYM; ++k) {
      if (V_SEPARATE_PRODUCTS) {
        const float2 pr = prod[k * S::LANES_MAX + l];
        terms[k] = im ? pr.y : pr.x;
      } else {
        const float2 a = run[k * S::W + l + CP], b = run[(k + 1) * S::W + l];
        terms[k] = im ? a.y * b.x - a.x * b.y : a.x * b.x + a.y * b.y;
      }
    }
    float acc = terms[0];
#pragma unroll
    for (int k = 1; k < NSYM; ++k) acc = acc + terms[k];
    float* dst = reinterpret_cast<float*>(&sums[lo + l]) + im;
    if (CTAS == 1)
      *dst = acc;
    else if (V_SYNC_SEND)
      *cg::this_cluster().map_shared_rank(dst, 0) = acc;
    else
      send(peer(dst, 0), acc, peer(mb, 0));
  }
  ctick(clock, slot, 7);
  if (!V_ROT && r == 0 && tid == ROT_THREAD) {
    const float pa = prev_angle[s];
    const float2 rot = trig(-pa);
    *rot_s = make_float4(rot.x, rot.y, pa, __int_as_float(coarse_override[s]));
  }
  if (CTAS == 1)
    __syncthreads();
  else if (V_SYNC_SEND)
    cg::this_cluster().sync();
  if (r != 0) {
    vtick(clock, slot, 3);
    return;
  }
  if (V_ROT && tid == 0) {
    const float pa = prev_angle[s];
    const float2 rot = trig(-pa);
    *rot_s = make_float4(rot.x, rot.y, pa, __int_as_float(coarse_override[s]));
  }
  ctick(clock, slot, 8);
  if (CTAS > 1 && !V_SYNC_SEND) wait_phase(mb, 0);
  ctick(clock, slot, 9);
  vtick(clock, slot, 3);
  if (STOP == 2) {
    if (tid == 0) v_max[s] = sums[s % FFTCP];
    return;
  }

  float best = -1.0f;
  int at = 0x7fffffff;
  for (int i = tid; i < FFTCP; i += THREADS) {
    float2 v = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int j = 0; j < CP; ++j) {
      int m = i + j;
      if (m >= FFTCP) m -= FFTCP;
      const float2 t = make_float2(sums[m].x * kern[j], sums[m].y * kern[j]);
      v = j ? make_float2(v.x + t.x, v.y + t.y) : t;
    }
    v_s[i] = v;
    const float p = v.x * v.x + v.y * v.y;
    if (p > best) {  // a thread's indices rise: the first wins ties
      best = p;
      at = i;
    }
  }
  ctick(clock, slot, 10);
  const int i_max = argmax(V_ARGMAX, best, at, bk, bi);  // its barrier: rot_s
  ctick(clock, slot, 11);
  vtick(clock, slot, 4);
  if (STOP == 3) {
    if (tid == 0) v_max[s] = v_s[i_max];
    return;
  }
  if (tid == 0) {
    const float4 rp = *rot_s;
    const float2 v = v_s[i_max];
    const float2 q = cmul(v, make_float2(rp.x, rp.y));
    const float diff = atan2f(q.y, q.x);
    const int ov = __float_as_int(rp.w);
    measured[s] = i_max;
    samperr[s] = ov >= 0 ? ov % FFTCP : i_max;
    prev_angle_out[s] = rp.z + diff * (rp.z != 0.0f ? 0.25f : 1.0f);
    v_max[s] = v;
  }
  ctick(clock, slot, 12);
  vtick(clock, slot, 5);
}

template <int CTAS, int THREADS, bool PDL>
__global__ void __launch_bounds__(THREADS) am_coarse_variant_kernel(
    const float2* __restrict__ samples, long long n_samples,
    const int* __restrict__ offset, const float* __restrict__ f_in,
    const float2* __restrict__ amp_in, const float* __restrict__ prev_angle,
    const int* __restrict__ coarse_override,
    const float* __restrict__ shape_kernel, int* __restrict__ measured,
    int* __restrict__ samperr, float* __restrict__ prev_angle_out,
    float2* __restrict__ v_max, long long* __restrict__ clock) {
  using S = Split<CTAS, THREADS>;
  extern __shared__ __align__(16) float2 dyn[];
  __shared__ float2 sums[FFTCP];
  __shared__ float2 v_s[FFTCP];
  __shared__ float kern[CP];
  __shared__ unsigned bk[THREADS / 32];
  __shared__ int bi[THREADS / 32];
  __shared__ float4 rot_s;
  __shared__ __align__(8) uint64_t mb;
  const int r = CTAS > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const int s = blockIdx.y;
  const int lo = r * FFTCP / CTAS;
  const int lanes = (r + 1) * FFTCP / CTAS - lo;
  vtick(clock, CTAS * s + r, 0);
  ctick(clock, CTAS * s + r, 0);
  if (V_TRIGGER) let_dependents_start();
  const int off = offset[s];
  if (CTAS > 1 && !V_SYNC_SEND && r == 0 && threadIdx.x == 0) {
    bulk::init(&mb);
    bulk::expect(&mb, FFTCP * 2 * sizeof(float));
  }
  const long long base = (long long)s * n_samples + dynamic_start(off, n_samples, WINDOW);
  const float2* w = samples + base;
  float2 wv[S::ITEMS];
  __shared__ __align__(8) uint64_t wbar;
  float2* stage = dyn + S::SMEM / 8;
  // V_BULK: the runs by 33 bulk copies from 16-byte aligned sources, item
  // j of period p at stage[p RW + j + q]
  const int q = (int)((base + lo - CP) & 1);
  if (V_BULK) {
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        bulk::init(&wbar);
        const int ends = (lanes + q + 1) & ~1, mid = (lanes + CP + q + 1) & ~1;
        bulk::expect(&wbar, (uint32_t)(2 * ends + (NSYM - 1) * mid) * 8u);
      }
      __syncwarp();
      for (int pp = lane; pp < PERIODS; pp += 32) {
        const int j0 = pp == 0 ? CP : 0;
        const int jl = pp == NSYM ? lanes - 1 : lanes + CP - 1;
        const int first = j0 - q;
        const int count = (jl - first + 2) & ~1;
        bulk::copy(stage + pp * S::RW + j0, w + (lo - CP) + FFTCP * pp + first,
                   count * 8, &wbar);
      }
    }
    __syncthreads();  // the mbarrier's init, to every warp
  } else {
    coarse_loads<CTAS, THREADS, V_TONE_UNROLL != 0>(w, lo, lanes, wv, dyn);
  }
  if (r == 0 && threadIdx.x < CP) kern[threadIdx.x] = shape_kernel[threadIdx.x];
  if (CTAS > 1)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  ctick(clock, CTAS * s + r, 1);
  if (PDL) wait_for_prerequisite();
  ctick(clock, CTAS * s + r, 2);
  vtick(clock, CTAS * s + r, 1);
#ifdef V_PLAIN_LOADS
  const float f_s = f_in[s];  // may be hoisted above the wait
  const float2 amp_s = amp_in[s];
#else
  const float f_s = load_after_wait(f_in + s);
  const float2 amp_s = load_after_wait(amp_in + s);
#endif
  ctick(clock, CTAS * s + r, 3);
  coarse_rest<CTAS, THREADS, true, V_STOP>(
      wv, lo, lanes, r, s, NEG_TWO_PI * f_s, amp_s, dyn,
      dyn + PERIODS * S::W, sums, v_s, kern, bk, bi, &mb, &rot_s,
      prev_angle, coarse_override, measured, samperr, prev_angle_out, v_max,
      clock, V_BULK ? stage : nullptr, q, &wbar);
}

// am_tone's tail (the port's am_tone_tail_kernel, unchanged up to the
// amplitude) with the coarse timing after it on the same cluster: CTA 0
// sends f and amp to every CTA, the tail's terms buffer becomes the
// coarse runs.
template <bool COARSE>
__global__ void __cluster_dims__(TAIL_CTAS, 1, 1) __launch_bounds__(TAIL_T)
am_tone_coarse_fused_kernel(
    const float2* __restrict__ samples, long long n_samples,
    const int* __restrict__ offset, const float* __restrict__ grid_u,
    const float2* __restrict__ part, const int* __restrict__ k0_in,
    float* __restrict__ f_out, float2* __restrict__ amp_out,
    const float* __restrict__ prev_angle,
    const int* __restrict__ coarse_override,
    const float* __restrict__ shape_kernel, int* __restrict__ measured,
    int* __restrict__ samperr, float* __restrict__ prev_angle_out,
    float2* __restrict__ v_max) {
  using CS = Split<TAIL_CTAS, TAIL_T>;
  constexpr uint32_t PASS_BYTES = 6 * TAIL_CTAS * LANES * sizeof(float);
  constexpr int ITEMS = (ROWS * LANES + TAIL_T - 1) / TAIL_T;
  constexpr uint32_t AMP_BYTES = 2 * TAIL_CTAS * LANES * sizeof(float);
  static_assert(CS::SMEM <= ROWS * 6 * LANES * 4, "runs fit in terms");
  __shared__ __align__(16) float terms[ROWS][6][LANES];
  __shared__ float lsum[2][6][TAIL_CTAS][LANES];
  __shared__ float pw[NGRID];
  __shared__ float u_s[NGRID];
  __shared__ float f_s;
  __shared__ float3 fa_s;  // f and amp, from CTA 0
  __shared__ __align__(8) uint64_t mb_pw;
  __shared__ __align__(8) uint64_t mb[2];
  __shared__ float2 csums[FFTCP];
  __shared__ float2 v_s[FFTCP];
  __shared__ __align__(8) uint64_t mb_c;  // CTA 0's: the coarse lane sums
  __shared__ float kern[CP];
  __shared__ unsigned bk[TAIL_T / 32];
  __shared__ int bi[TAIL_T / 32];
  __shared__ float4 rot_s;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32, l = tid % 32;
  if (tid == 0) {
    bulk::init(&mb_pw);
    bulk::init(&mb[0]);
    bulk::init(&mb[1]);
    bulk::expect(&mb_pw, NGRID * sizeof(float));
    bulk::expect(&mb[0], PASS_BYTES);
    bulk::expect(&mb[1], PASS_BYTES);
    if (c == 0) {
      bulk::init(&mb_c);
      bulk::expect(&mb_c, FFTCP * 2 * sizeof(float));
    }
  }
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  const float2* w =
      samples + (long long)s * n_samples + dynamic_start(offset[s], n_samples, WINDOW);
  // the coarse timing's runs, loaded first
  const int lo = c * FFTCP / TAIL_CTAS;
  const int lanes = (c + 1) * FFTCP / TAIL_CTAS - lo;
  float2 cwv[CS::ITEMS];
  if (COARSE) {
    if (c == 0 && tid < CP) kern[tid] = shape_kernel[tid];
    coarse_loads<TAIL_CTAS, TAIL_T>(w, lo, lanes, cwv);
  }
  float2 wv[ITEMS];
  float mv[ITEMS], wmv[ITEMS], wm2v[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int i = tid + k * TAIL_T;
    const int n = i / LANES * T + c * LANES + i % LANES;
    wv[k] = i < ROWS * LANES && n < WINDOW ? w[n] : make_float2(0.0f, 0.0f);
    mv[k] = (float)n - HALF_SPAN;
    wmv[k] = TWO_PI * mv[k];
    wm2v[k] = wmv[k] * wmv[k];
  }
  if (tid < NGRID) u_s[tid] = grid_u[tid];
  wait_for_prerequisite();
  const int k0 = k0_in[s];

  const int g = c * TAIL_WARPS + warp;
  float power = 0.0f;
  if (g < NGRID) {
    const float2* pp = part + ((long long)s * NGRID + g) * T + l;
    float ax[TAIL_CTAS], ay[TAIL_CTAS];
#pragma unroll
    for (int j = 0; j < TAIL_CTAS; ++j) {
      const float2 v = pp[j * LANES];
      ax[j] = v.x;
      ay[j] = v.y;
    }
    const float x = lane_tree(ax), y = lane_tree(ay);
    power = __shfl_sync(0xffffffffu, x * x + y * y, 0);
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (g < NGRID && l < TAIL_CTAS) send(peer(&pw[g], l), power, peer(&mb_pw, l));
  wait_phase(&mb_pw, 0);

  if (warp == 0) {
    float best = -1.0f;
    int at = NGRID;
    for (int q = l; q < NGRID; q += 32) {
      if (pw[q] > best) {
        best = pw[q];
        at = q;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, at, o);
      if (ob > best || (ob == best && oi < at)) {
        best = ob;
        at = oi;
      }
    }
    if (l == 0) {
      if (at == NGRID) at = 0;
      const int i = at < 1 ? 1 : (at > NGRID - 2 ? NGRID - 2 : at);
      const float pm = pw[i - 1], p0 = pw[i], pp = pw[i + 1];
      const float den = (pm - 2.0f * p0) + pp;
      const float d = den != 0.0f ? (0.5f * (pm - pp)) / den : 0.0f;
      const float dc = fminf(fmaxf(d, -1.0f), 1.0f);
      const float ustar = u_s[i] + dc * (u_s[1] - u_s[0]);
      f_s = ((float)k0 + ustar) / 256.0f;
    }
  }
  __syncthreads();

  for (int pass = 0; pass < 3; ++pass) {
    const int nq = pass < 2 ? 6 : 2;
    const int buf = pass & 1;
    const float f = f_s;
    const float cf = NEG_TWO_PI * f;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int i = tid + k * TAIL_T;
      if (i >= ROWS * LANES) break;
      const int r = i / LANES, li = i % LANES;
      float2 xe = make_float2(0.0f, 0.0f), wx = xe, w2x = xe;
      if (r * T + c * LANES + li < WINDOW) {
        xe = cmul(wv[k], cis(cf * mv[k]));
        wx = make_float2(wmv[k] * xe.x, wmv[k] * xe.y);
        w2x = make_float2(wm2v[k] * xe.x, wm2v[k] * xe.y);
      }
      terms[r][0][li] = xe.x;
      terms[r][1][li] = xe.y;
      if (nq == 6) {
        terms[r][2][li] = wx.x;
        terms[r][3][li] = wx.y;
        terms[r][4][li] = w2x.x;
        terms[r][5][li] = w2x.y;
      }
    }
    __syncthreads();
    if (warp < nq) {
      float acc = terms[0][warp][l];
#pragma unroll
      for (int r = 1; r < ROWS; ++r) acc = acc + terms[r][warp][l];
      float* slot = &lsum[buf][warp][c][l];
      if (pass < 2) {
#pragma unroll
        for (int j = 0; j < TAIL_CTAS; ++j)
          send(peer(slot, j), acc, peer(&mb[buf], j));
      } else {
        send(peer(slot, 0), acc, peer(&mb[buf], 0));
      }
    }
    if (pass < 2) {
      if (warp == 0) {
        wait_phase(&mb[buf], 0);
        float tot[6];
#pragma unroll
        for (int q = 0; q < 6; ++q) tot[q] = lane_tree_at(&lsum[buf][q][0][l]);
        if (l == 0) {
          const float S0 = tot[0], S1 = tot[1];
          const float dS0 = tot[3], dS1 = -tot[2];
          const float d2S0 = -tot[4], d2S1 = -tot[5];
          const float grad = 2.0f * (S0 * dS0 + S1 * dS1);
          const float h =
              2.0f * (dS0 * dS0 + dS1 * dS1) + 2.0f * (S0 * d2S0 + S1 * d2S1);
          f_s = h < 0.0f ? f - grad / h : f;
          if (pass == 0 && c == 0) bulk::expect(&mb[0], AMP_BYTES);
        }
      }
      __syncthreads();
    } else if (c == 0 && warp == 0) {
      wait_phase(&mb[0], 1);
      const float ar = lane_tree_at(&lsum[buf][0][0][l]);
      const float ai = lane_tree_at(&lsum[buf][1][0][l]);
      if (l == 0) {
        const float2 amp = make_float2(ar / (float)WINDOW, ai / (float)WINDOW);
        f_out[s] = f;
        amp_out[s] = amp;
        if (COARSE)
          for (int j = 0; j < TAIL_CTAS; ++j)
            *cluster.map_shared_rank(&fa_s, j) = make_float3(f, amp.x, amp.y);
      }
    }
  }
  if (!COARSE) return;  // am_tone's tail alone, without its trigger
  // f and amp in every CTA, and every CTA done with terms
  cluster.sync();
  const float3 fa = fa_s;
  float2* run = reinterpret_cast<float2*>(&terms[0][0][0]);
  coarse_rest<TAIL_CTAS, TAIL_T, false, 4>(
      cwv, lo, lanes, c, s, NEG_TWO_PI * fa.x, make_float2(fa.y, fa.z), run,
      run + PERIODS * CS::W, csums, v_s, kern, bk, bi, &mb_c, &rot_s, prev_angle,
      coarse_override, measured, samperr, prev_angle_out, v_max, nullptr);
}

template <int MODE, int CTAS, bool PDL, int SPLIT>
__global__ void __launch_bounds__(CFO_T * SPLIT) am_cfo_step_variant_kernel(
    const float2* __restrict__ spectra, float* __restrict__ mags,
    int* __restrict__ step) {
  constexpr int BAND = CFO_BINS + 1;  // bins 74..181, 864 bytes a row
  constexpr int ROWS_T = NSYM / SPLIT;  // the symbols a thread loads
  __shared__ unsigned bk[CFO_T * SPLIT / 32];
  __shared__ int bi[CFO_T * SPLIT / 32];
  __shared__ float cb[CTAS];
  __shared__ int ci[CTAS];
  __shared__ float later[SPLIT > 1 ? NSYM - ROWS_T : 1][CFO_T];
  const int r = CTAS > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const int s = blockIdx.y;
  const int b = threadIdx.x % CFO_T, h = threadIdx.x / CFO_T;
  const int blo = r * CFO_BINS / CTAS;
  const int bn = (r + 1) * CFO_BINS / CTAS - blo;
  if (VC_TRIGGER) let_dependents_start();
  if (CTAS > 1)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  float acc = 0.0f;
  if constexpr (MODE == 0) {
    const float2* sp = spectra + ((long long)s * NSYM + h * ROWS_T) * FFT +
                       CFO_LO + blo + min(b, bn - 1);
    float2 v[ROWS_T];
#pragma unroll
    for (int sym = 0; sym < ROWS_T; ++sym) v[sym] = sp[sym * FFT];
#pragma unroll
    for (int sym = 0; sym < ROWS_T; ++sym) {
      const float m = sqrtf(v[sym].x * v[sym].x + v[sym].y * v[sym].y);
      if (SPLIT == 1 || h == 0)
        acc = sym ? acc + m : m;
      else
        later[(h - 1) * ROWS_T + sym][b] = m;
    }
    if constexpr (SPLIT > 1) {
      __syncthreads();
      if (h == 0) {
#pragma unroll
        for (int k = 0; k < NSYM - ROWS_T; ++k) acc = acc + later[k][b];
      }
    }
  } else {
    __shared__ __align__(16) float2 band[NSYM][BAND];
    __shared__ __align__(8) uint64_t bar;
    if (b == 0) bulk::init(&bar);
    __syncthreads();
    if (b == 0) {
      bulk::expect(&bar, NSYM * BAND * sizeof(float2));
      for (int sym = 0; sym < NSYM; ++sym)
        bulk::copy(band[sym], spectra + ((long long)s * NSYM + sym) * FFT + CFO_LO - 1,
                   BAND * sizeof(float2), &bar);
    }
    bulk::wait(&bar);
    const int j = 1 + min(b, CFO_BINS - 1);
    acc = sqrtf(band[0][j].x * band[0][j].x + band[0][j].y * band[0][j].y);
#pragma unroll
    for (int sym = 1; sym < NSYM; ++sym)
      acc = acc + sqrtf(band[sym][j].x * band[sym][j].x +
                        band[sym][j].y * band[sym][j].y);
  }
  if (PDL) wait_for_prerequisite();
  float best = -1.0f;
  int at = 0x7fffffff;
  if (h == 0 && b < bn) {
    mags[s * CFO_BINS + blo + b] = acc;
    best = acc;
    at = blo + b;
  }
  if (CTAS == 1) {
    const int arg = argmax(VC_ARGMAX, best, at, bk, bi);
    if (threadIdx.x == 0) step[s] = arg + CFO_LO - FFT / 2;
    return;
  }
  const int arg = block_argmax(best, at, reinterpret_cast<float*>(bk), bi);
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (b == arg - blo) {  // this CTA's first maximum, to the leader
    *cg::this_cluster().map_shared_rank(&cb[r], 0) = acc;
    *cg::this_cluster().map_shared_rank(&ci[r], 0) = arg;
  }
  cg::this_cluster().sync();
  if (r == 0 && b == 0) {
    float bv = cb[0];
    int ba = ci[0];
    for (int q = 1; q < CTAS; ++q)
      if (cb[q] > bv) {  // ranks hold rising bins: the first wins ties
        bv = cb[q];
        ba = ci[q];
      }
    step[s] = ba + CFO_LO - FFT / 2;
  }
}

std::atomic<uint64_t> coarse_variant_smem_set{0};

}  // namespace

extern "C" int am_coarse_variant(const void* samples, long long n_samples,
                                 const void* offset, const void* f,
                                 const void* amp, const void* prev_angle,
                                 const void* coarse_override,
                                 const void* shape_kernel, void* measured,
                                 void* samperr, void* prev_angle_out,
                                 void* v_max, void* clock, int n_stations,
                                 void* stream) {
  if (n_stations <= 0 || n_samples < WINDOW) return (int)cudaErrorInvalidValue;
  auto kernel = am_coarse_variant_kernel<V_CTAS, V_T, V_PDL != 0>;
  const int smem = Split<V_CTAS, V_T>::SMEM + Split<V_CTAS, V_T>::STAGE;
  if (V_BULK && ((uintptr_t)samples & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaError_t err =
      max_dynamic_smem_once(kernel, smem, coarse_variant_smem_set);
  if (err != cudaSuccess) return (int)err;
  if (V_CTAS > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute attrs[2];
  int n = 0;
  if (V_CTAS > 1) {
    attrs[n].id = cudaLaunchAttributeClusterDimension;
    attrs[n].val.clusterDim.x = V_CTAS;
    attrs[n].val.clusterDim.y = 1;
    attrs[n].val.clusterDim.z = 1;
    ++n;
  }
  if (V_PDL) {
    attrs[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attrs[n].val.programmaticStreamSerializationAllowed = 1;
    ++n;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(V_CTAS, n_stations);
  cfg.blockDim = dim3(V_T);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attrs;
  cfg.numAttrs = n;
  err = cudaLaunchKernelEx(
      &cfg, kernel, (const float2*)samples, n_samples, (const int*)offset,
      (const float*)f, (const float2*)amp, (const float*)prev_angle,
      (const int*)coarse_override, (const float*)shape_kernel, (int*)measured,
      (int*)samperr, (float*)prev_angle_out, (float2*)v_max,
      (long long*)clock);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// am_tone's arguments, then am_coarse's after its f and amp
extern "C" int am_tone_coarse_fused(
    const void* spectra, const void* samples, long long n_samples,
    const void* offset, const void* grid_u, const void* derot,
    const void* twiddle, void* z, void* part, void* k0, void* f, void* amp,
    const void* prev_angle, const void* coarse_override,
    const void* shape_kernel, void* measured, void* samperr,
    void* prev_angle_out, void* v_max, int n_stations, void* stream) {
  if (n_stations <= 0 || n_samples < WINDOW) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)z & 15) != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  am_tone_z_kernel<<<dim3(Z_CTAS, n_stations), T, 0, st>>>(
      (const float2*)spectra, (const float2*)samples, n_samples,
      (const int*)offset, (const float2*)derot, (float2*)z, (int*)k0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int smem = (SB + PW) * ROWS * LANES * (int)sizeof(float2);
  err = max_dynamic_smem_once(am_tone_proj_kernel, smem, proj_smem_set);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute pdl;
  cudaLaunchConfig_t cfg = pdl_config(
      dim3(LANE_GROUPS, GRID_GROUPS, (n_stations + SB - 1) / SB),
      dim3(PW * SPLIT * 32), st, &pdl);
  cfg.dynamicSmemBytes = smem;
  err = cudaLaunchKernelEx(&cfg, am_tone_proj_kernel, (const float2*)z,
                           (const float2*)twiddle, (float2*)part, n_stations);
  if (err != cudaSuccess) return (int)err;
  cfg.gridDim = dim3(TAIL_CTAS, n_stations);
  cfg.blockDim = dim3(TAIL_T);
  cfg.dynamicSmemBytes = 0;
  err = cudaLaunchKernelEx(
      &cfg, am_tone_coarse_fused_kernel<true>, (const float2*)samples,
      n_samples,
      (const int*)offset, (const float*)grid_u, (const float2*)part,
      (const int*)k0, (float*)f, (float2*)amp, (const float*)prev_angle,
      (const int*)coarse_override, (const float*)shape_kernel, (int*)measured,
      (int*)samperr, (float*)prev_angle_out, (float2*)v_max);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int am_cfo_step_variant(const void* spectra, void* mags,
                                   void* step, int n_stations, void* stream) {
  if (n_stations <= 0) return (int)cudaErrorInvalidValue;
  if (VC_MODE == 1 && ((uintptr_t)spectra & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  auto kernel = am_cfo_step_variant_kernel<VC_MODE, VC_CTAS, VC_PDL != 0,
                                            VC_SPLIT>;
  cudaLaunchAttribute attrs[2];
  int n = 0;
  if (VC_CTAS > 1) {
    attrs[n].id = cudaLaunchAttributeClusterDimension;
    attrs[n].val.clusterDim.x = VC_CTAS;
    attrs[n].val.clusterDim.y = 1;
    attrs[n].val.clusterDim.z = 1;
    ++n;
  }
  if (VC_PDL) {
    attrs[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attrs[n].val.programmaticStreamSerializationAllowed = 1;
    ++n;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(VC_CTAS, n_stations);
  cfg.blockDim = dim3(CFO_T * VC_SPLIT);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attrs;
  cfg.numAttrs = n;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, (const float2*)spectra,
                                       (float*)mags, (int*)step);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// am_tone's arguments: the port's first two kernels, then the tail as the
// parent had it (no early start for its dependent)
extern "C" int am_tone_variant(const void* spectra, const void* samples,
                               long long n_samples, const void* offset,
                               const void* grid_u, const void* derot,
                               const void* twiddle, void* z, void* part,
                               void* k0, void* f, void* amp, int n_stations,
                               void* stream) {
  if (n_stations <= 0 || n_samples < WINDOW) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)z & 15) != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  am_tone_z_kernel<<<dim3(Z_CTAS, n_stations), T, 0, st>>>(
      (const float2*)spectra, (const float2*)samples, n_samples,
      (const int*)offset, (const float2*)derot, (float2*)z, (int*)k0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int smem = (SB + PW) * ROWS * LANES * (int)sizeof(float2);
  err = max_dynamic_smem_once(am_tone_proj_kernel, smem, proj_smem_set);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute pdl;
  cudaLaunchConfig_t cfg = pdl_config(
      dim3(LANE_GROUPS, GRID_GROUPS, (n_stations + SB - 1) / SB),
      dim3(PW * SPLIT * 32), st, &pdl);
  cfg.dynamicSmemBytes = smem;
  err = cudaLaunchKernelEx(&cfg, am_tone_proj_kernel, (const float2*)z,
                           (const float2*)twiddle, (float2*)part, n_stations);
  if (err != cudaSuccess) return (int)err;
  cfg.gridDim = dim3(TAIL_CTAS, n_stations);
  cfg.blockDim = dim3(TAIL_T);
  cfg.dynamicSmemBytes = 0;
  err = cudaLaunchKernelEx(
      &cfg, am_tone_coarse_fused_kernel<false>, (const float2*)samples,
      n_samples, (const int*)offset, (const float*)grid_u,
      (const float2*)part, (const int*)k0, (float*)f, (float2*)amp,
      (const float*)nullptr, (const int*)nullptr, (const float*)nullptr,
      (int*)nullptr, (int*)nullptr, (float*)nullptr, (float2*)nullptr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
