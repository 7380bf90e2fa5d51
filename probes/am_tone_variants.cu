// The port's am_tone (K14's tone estimate, nrsc5_tpu_torch/csrc/
// am_coldstart.cu) with its design choices as compile-time knobs, kept to
// time the designs tried against the port's (probes/am_tone_k13_variants.py).
// Built with no -D flags it is the port's am_tone, but for the projection
// launched as clusters of one CTA.  The knobs:
// -DAM_TONE_SB/PW/SPLIT (stations a projection CTA, grid points a
// projection CTA, warps a grid point), -DAM_TONE_PCL (projection CTAs of a
// cluster that share their z tile by multicast copies), -DAM_TONE_TAIL_T
// (the tail's threads a CTA), -DAM_TONE_PDL=0 (no programmatic dependent
// launch); and cuts that time the parts and leave the results wrong:
// -DAM_TONE_PROJ_MODE, -DAM_TONE_TAIL_STOP, -DAM_TONE_TAIL_CLOCK.  The rest
// is the port's source as it stood when the design was chosen, cut to
// am_tone; its comments speak of the port.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../nrsc5_tpu_torch/csrc/bulk_copy.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int FFT = 256;
constexpr int CP = 14;
constexpr int FFTCP = FFT + CP;            // 270
constexpr int NSYM = 32;
constexpr int WINDOW = FFTCP * (NSYM + 1);  // 8910
constexpr int NGRID = 85;
constexpr int T = 256;                      // width of the ordered sums
constexpr int ROWS = (WINDOW + T - 1) / T;  // 35
constexpr int LANES = 32;                   // lanes of the sums a CTA owns
constexpr int LANE_GROUPS = T / LANES;      // 8
constexpr int ZROWS = 7;                    // rows of z a CTA of kernel 1
constexpr int Z_CTAS = ROWS / ZROWS;        // 5 a station
constexpr int PCH = ROWS / ZROWS;           // the projection's bulk copies
// am_tone's design knobs, the port's choice by default
// (probes/am_tone_k13_variants.py rebuilds this source with others and
// times them): stations a projection CTA, grid points a projection CTA,
// warps a grid point, projection CTAs of a cluster that share their z
// tile by multicast copies (1: none), the tail's threads a CTA, and
// programmatic dependent launch of kernels 2 and 3
#ifndef AM_TONE_SB
#define AM_TONE_SB 16
#endif
#ifndef AM_TONE_PW
#define AM_TONE_PW 6
#endif
#ifndef AM_TONE_SPLIT
#define AM_TONE_SPLIT 2
#endif
#ifndef AM_TONE_PCL
#define AM_TONE_PCL 1
#endif
#ifndef AM_TONE_TAIL_T
#define AM_TONE_TAIL_T 512
#endif
#ifndef AM_TONE_PDL
#define AM_TONE_PDL 1
#endif
constexpr int SB = AM_TONE_SB;
constexpr int PW = AM_TONE_PW;
constexpr int SPLIT = AM_TONE_SPLIT;
constexpr int GRID_GROUPS = (NGRID + PW - 1) / PW;
constexpr int PCL = AM_TONE_PCL;
static_assert(GRID_GROUPS % PCL == 0, "the clusters must tile the grid");
constexpr int TAIL_CTAS = LANE_GROUPS;  // the tail's cluster
constexpr int TAIL_T = AM_TONE_TAIL_T;
constexpr int TAIL_WARPS = TAIL_T / 32;
// Probes only, to time the parts (the results are then wrong):
// -DAM_TONE_TAIL_STOP=0, 1 or 2 ends the tail after the parabola or after
// Newton step 1 or 2, writing f; -DAM_TONE_PROJ_MODE=1 (copies only) or 2
// (sums only, on whatever shared memory holds) cuts the projection;
// -DAM_TONE_TAIL_CLOCK=1 has CTA 0 of station 0 write its clock64
// readings at the tail's phase ends, from its start, over the first 19
// int64 of part
#ifndef AM_TONE_TAIL_STOP
#define AM_TONE_TAIL_STOP 3
#endif
#ifndef AM_TONE_PROJ_MODE
#define AM_TONE_PROJ_MODE 0
#endif
#ifndef AM_TONE_TAIL_CLOCK
#define AM_TONE_TAIL_CLOCK 0
#endif

constexpr float NEG_TWO_PI = -6.283185307179586f;
constexpr float TWO_PI = 6.283185307179586f;
constexpr float HALF_SPAN = 4454.5f;        // (WINDOW - 1) / 2

__device__ __forceinline__ long long dynamic_start(long long start,
                                                   long long dim,
                                                   long long size) {
  if (start < 0) start += dim;
  return start < 0 ? 0 : (start > dim - size ? dim - size : start);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

__device__ __forceinline__ float2 cexp(float t) {
  return make_float2(cosf(t), sinf(t));
}

// cos and sin of t as cosf and sinf give them, from one sincosf (one range
// reduction)
__device__ __forceinline__ float2 cis(float t) {
  float sn, cs;
  sincosf(t, &sn, &cs);
  return make_float2(cs, sn);
}

// Programmatic dependent launch: am_tone's kernels 2 and 3 are launched
// to start while the kernel before them ends (each kernel lets its
// dependent start as soon as all its CTAs run), do what does not read
// that kernel's output, and then wait for it to complete.  Both are no-ops
// for a kernel launched plainly.
__device__ __forceinline__ void let_dependents_start() {
#if AM_TONE_PDL
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
#endif
}

__device__ __forceinline__ void wait_for_prerequisite() {
#if AM_TONE_PDL
  asm volatile("griddepcontrol.wait;" ::: "memory");
#endif
}

// Block argmax over one value a thread (index ``at``, or a value of -1
// where a thread holds none): the first index wins ties.  Returns the
// index to every thread.
__device__ int block_argmax(float best, int at, float* bp, int* bi) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, at, o);
    if (ob > best || (ob == best && oi < at)) {
      best = ob;
      at = oi;
    }
  }
  const int warps = blockDim.x / 32;
  if ((threadIdx.x & 31) == 0) {
    bp[threadIdx.x >> 5] = best;
    bi[threadIdx.x >> 5] = at;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < warps; ++w) {
      if (bp[w] > best || (bp[w] == best && bi[w] < at)) {
        best = bp[w];
        at = bi[w];
      }
    }
    bi[0] = at;
  }
  __syncthreads();
  const int r = bi[0];
  __syncthreads();
  return r;
}

// Where sample n of station s lies in kernel 1's z: tiles of the 32 lanes
// of a lane group for SB stations, [chunk][lane group][row][SB][lane], so
// that the projection's CTA (lane group, stations chunk) reads its tile as
// one contiguous run, a row of it (SB x 32 samples) after another.
__device__ __forceinline__ long long z_index(int s, int n) {
  const int r = n / T, t = n % T;
  return ((((long long)(s / SB) * LANE_GROUPS + t / LANES) * ROWS + r) * SB +
          s % SB) * LANES + t % LANES;
}

// am_tone, kernel 1 of 3: k0 from the power DFT's spectra, then z[n] =
// w[n] rot[(k0 n) mod 256] for a run of ZROWS rows of the window (zeros
// past its end).  Every CTA of a station finds the same k0 (the spectra
// read again from L2, 64 KB a CTA); the CTA of the first run writes it
// out for the tail.
__global__ void __launch_bounds__(T) am_tone_z_kernel(
    const float2* __restrict__ spectra, const float2* __restrict__ samples,
    long long n_samples, const int* __restrict__ offset,
    const float2* __restrict__ derot, float2* __restrict__ z,
    int* __restrict__ k0_out) {
  __shared__ float2 rot[FFT];
  __shared__ float bp[T / 32];
  __shared__ int bi[T / 32];
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  let_dependents_start();
  rot[tid] = derot[tid];

  // k0: the power summed over the 32 symbols, bin by bin
  const float2* sp = spectra + (long long)s * NSYM * FFT;
  float p = 0.0f;
  for (int sym = 0; sym < NSYM; ++sym) {
    const float2 v = sp[sym * FFT + tid];
    const float a2 = v.x * v.x + v.y * v.y;
    p = sym ? p + a2 : a2;
  }
  int k0 = block_argmax(p, tid, bp, bi);  // its barriers publish rot
  if (k0 >= FFT / 2) k0 -= FFT;
  if (blockIdx.x == 0 && tid == 0) k0_out[s] = k0;

  const float2* w =
      samples + (long long)s * n_samples + dynamic_start(offset[s], n_samples, WINDOW);
  for (int r = blockIdx.x * ZROWS; r < (blockIdx.x + 1) * ZROWS; ++r) {
    const int n = r * T + tid;
    float2 v = make_float2(0.0f, 0.0f);
    if (n < WINDOW) {
      int k = (k0 * n) % FFT;
      if (k < 0) k += FFT;
      v = cmul(w[n], rot[k]);
    }
    z[z_index(s, n)] = v;
  }
}

// A bulk copy of `bytes` from global `src` to the shared `dst` of every
// CTA of the cluster in `mask`, counted on each one's mbarrier at the
// offset of `bar` (bulk_copy.cuh's copy, multicast).
__device__ __forceinline__ void multicast(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar,
                                          uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes."
      "multicast::cluster [%0], [%1], %2, [%3], %4;" ::"r"(
          bulk::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bulk::smem_addr(bar)), "h"(mask)
      : "memory");
}

// am_tone, kernel 2 of 3: the grid projection.  A CTA holds the lanes [32
// lg, 32 lg + 32) of the ordered sums for up to SB stations and PW grid
// points, SPLIT warps a grid point, each warp SB / SPLIT of the stations.
// Both operands come into shared memory by bulk copies in PCH chunks of
// ZROWS rows, each chunk on its own mbarrier, so that the first rows are
// summed while the later ones arrive: z (35 rows x SB stations x 32 lanes,
// one copy a chunk) and each grid point's rows of the twiddle table (a
// copy a row, issued by its first warp).  A thread sums its lane's 35 rows
// in order for its stations at once, so that each twiddle serves them all.
// Out: the 256 per-lane sums of every (station, grid point), for the
// tail's tree.
__global__ void __cluster_dims__(1, PCL, 1) __launch_bounds__(PW * SPLIT * 32)
am_tone_proj_kernel(const float2* __restrict__ z,
                    const float2* __restrict__ twiddle,
                    float2* __restrict__ part, int n_stations) {
  constexpr int SPT = SB / SPLIT;  // stations a thread
  extern __shared__ __align__(16) float2 smem[];
  float2* zt = smem;                       // [ROWS][SB][LANES]
  float2* twt = smem + ROWS * SB * LANES;  // [PW][ROWS][LANES]
  __shared__ __align__(8) uint64_t zbar[PCH];
  __shared__ __align__(8) uint64_t wbar[PW][PCH];
  const int tid = threadIdx.x;
  const int warp = tid / 32, l = tid % 32;
  const int gw = warp % PW, half = warp / PW;
  const int t0 = blockIdx.x * LANES;
  const int s0 = blockIdx.z * SB + half * SPT;
  const int g = blockIdx.y * PW + gw;
  const float2* tile =
      z + ((long long)blockIdx.z * LANE_GROUPS + blockIdx.x) * ROWS * SB * LANES;
  constexpr int CHUNK = ZROWS * SB * LANES;  // float2 of a z copy
  if (tid < PCH) {
    bulk::init(&zbar[tid]);
    bulk::expect(&zbar[tid], CHUNK * sizeof(float2));
  }
  if (half == 0 && l < PCH) bulk::init(&wbar[gw][l]);
  if (PCL > 1) {
    // the cluster's CTAs share the z tile: each copies a share of its
    // chunks into all of them, once every CTA's mbarriers are ready
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
  const float2* tw = twiddle + (long long)min(g, NGRID - 1) * WINDOW;
  const float2* tws = twt + gw * ROWS * LANES;
  if (g < NGRID && half == 0 && l < PCH && AM_TONE_PROJ_MODE != 2) {
    // chunk l of this grid point's rows (the table does not wait for
    // kernel 1); the last row stops at the window
    uint32_t total = 0;
    for (int r = l * ZROWS; r < (l + 1) * ZROWS; ++r)
      total += (uint32_t)max(0, min(LANES, WINDOW - (r * T + t0))) * 8u;
    bulk::expect(&wbar[gw][l], total);
    for (int r = l * ZROWS; r < (l + 1) * ZROWS; ++r) {
      const int bytes = max(0, min(LANES, WINDOW - (r * T + t0))) * 8;
      if (bytes) bulk::copy(twt + (gw * ROWS + r) * LANES, tw + r * T + t0,
                            bytes, &wbar[gw][l]);
    }
  }
  wait_for_prerequisite();  // kernel 1's z
  let_dependents_start();
  if (tid < PCH && tid % PCL == (int)blockIdx.y % PCL &&
      AM_TONE_PROJ_MODE != 2) {
    if (PCL > 1)
      multicast(zt + tid * CHUNK, tile + tid * CHUNK, CHUNK * sizeof(float2),
                &zbar[tid], (uint16_t)((1u << PCL) - 1));
    else
      bulk::copy(zt + tid * CHUNK, tile + tid * CHUNK, CHUNK * sizeof(float2),
                 &zbar[tid]);
  }
  if (g < NGRID) {
    const int t = t0 + l;
    const float2* zl = zt + half * SPT * LANES + l;  // this thread's stations

    // every station slot is summed, those past n_stations on whatever the
    // tile holds there, and only the real ones are written: no branch
    // between a row's loads and its products
    float2 acc[SPT];
#if AM_TONE_PROJ_MODE == 1
    for (int c = 0; c < PCH; ++c) {
      bulk::wait(&zbar[c]);
      bulk::wait(&wbar[gw][c]);
    }
    acc[0] = cmul(zl[l], tws[l]);
    for (int sl = 1; sl < SPT; ++sl) acc[sl] = acc[0];
#else
    for (int c = 0; c < PCH; ++c) {
      if (AM_TONE_PROJ_MODE != 2) {
        bulk::wait(&zbar[c]);
        bulk::wait(&wbar[gw][c]);
      }
      if (c == 0) {
        const float2 tv = tws[l];
#pragma unroll
        for (int sl = 0; sl < SPT; ++sl) acc[sl] = cmul(zl[sl * LANES], tv);
      }
      // rows 1 .. ROWS - 2 lie inside the window; the last row ends at 8909
      const int r_end = c == PCH - 1 ? ROWS - 1 : (c + 1) * ZROWS;
#pragma unroll 2
      for (int r = c ? c * ZROWS : 1; r < r_end; ++r) {
        const float2 tv = tws[r * LANES + l];
#pragma unroll
        for (int sl = 0; sl < SPT; ++sl) {
          const float2 q = cmul(zl[(r * SB + sl) * LANES], tv);
          acc[sl] = make_float2(acc[sl].x + q.x, acc[sl].y + q.y);
        }
      }
    }
    {
      // past the window the plain version adds a zero term
      const bool in_window = (ROWS - 1) * T + t < WINDOW;
      const float2 tv = tws[(ROWS - 1) * LANES + l];
#pragma unroll
      for (int sl = 0; sl < SPT; ++sl) {
        float2 q = cmul(zl[((ROWS - 1) * SB + sl) * LANES], tv);
        if (!in_window) q = make_float2(0.0f, 0.0f);
        acc[sl] = make_float2(acc[sl].x + q.x, acc[sl].y + q.y);
      }
    }
#endif
#pragma unroll
    for (int sl = 0; sl < SPT; ++sl)
      if (s0 + sl < n_stations)
        part[((long long)(s0 + sl) * NGRID + g) * T + t] = acc[sl];
  }
  // no CTA leaves while the cluster's copies may still land in a peer:
  // each CTA's live warps have waited for all of its chunks
  if (PCL > 1) cg::this_cluster().sync();
}

// The fixed pairwise tree over 256 lane values, lane l of a warp holding
// a_j = the value of lane l + 32 j (j < 8): levels 128, 64 and 32 as one
// expression, then levels 16 .. 1 by shuffles.  Lane 0 ends with the sum.
__device__ __forceinline__ float lane_tree(const float a[TAIL_CTAS]) {
  float v = ((a[0] + a[4]) + (a[2] + a[6])) + ((a[1] + a[5]) + (a[3] + a[7]));
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// lane_tree of p[0], p[LANES], ..., p[7 LANES]: CTA j's sum of a lane
__device__ __forceinline__ float lane_tree_at(const float* p) {
  float a[TAIL_CTAS];
#pragma unroll
  for (int j = 0; j < TAIL_CTAS; ++j) a[j] = p[j * LANES];
  return lane_tree(a);
}

// The 32-bit shared::cluster address of this CTA's `p` in CTA `rank` of
// the cluster.
__device__ __forceinline__ uint32_t peer(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(bulk::smem_addr(p)), "r"(rank));
  return out;
}

// v into the float at `addr` in a peer's shared memory, its 4 bytes
// counted on the peer's mbarrier at `bar`: a one-sided send, no barrier
__device__ __forceinline__ void send(uint32_t addr, float v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];" ::"r"(addr),
      "f"(v), "r"(bar)
      : "memory");
}

// until the phase of `bar` of the given parity has completed; the sends
// counted on it are then visible
__device__ __forceinline__ void wait_phase(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], "
      "%1;\n"
      "@!done bra WAIT;\n"
      "}" ::"r"(bulk::smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// am_tone, kernel 3 of 3: the tail, over a cluster of 8 CTAs a station.
// CTA c owns the lanes [32 c, 32 c + 32) of every 8910-sample sum: its
// threads compute the terms of its 35 x 32 samples wide, a thread sums one
// lane's rows in order and sends the lane sum into every CTA's shared
// memory (st.async, counted on the receiver's mbarrier), so that each CTA
// runs the tree's three levels that cross CTAs and the Newton step on its
// own copy, and all hold the same f, with no cluster barrier after the
// start.  The grid points' powers travel the same way.  The lane sums are
// double-buffered: a CTA sends a pass's sums only after it has received
// every CTA's sums of the pass before, which each CTA sends only after it
// has read its buffer of the pass before that.
__global__ void __cluster_dims__(TAIL_CTAS, 1, 1) __launch_bounds__(TAIL_T)
am_tone_tail_kernel(const float2* __restrict__ samples, long long n_samples,
                    const int* __restrict__ offset,
                    const float* __restrict__ grid_u,
                    const float2* __restrict__ part,
                    const int* __restrict__ k0_in, float* __restrict__ f_out,
                    float2* __restrict__ amp_out) {
  constexpr uint32_t PASS_BYTES = 6 * TAIL_CTAS * LANES * sizeof(float);
  constexpr int ITEMS = (ROWS * LANES + TAIL_T - 1) / TAIL_T;
  constexpr uint32_t AMP_BYTES = 2 * TAIL_CTAS * LANES * sizeof(float);
  __shared__ float terms[ROWS][6][LANES];
  __shared__ float lsum[2][6][TAIL_CTAS][LANES];
  __shared__ float pw[NGRID];
  __shared__ float u_s[NGRID];
  __shared__ float f_s;
  __shared__ __align__(8) uint64_t mb_pw;  // the powers
  __shared__ __align__(8) uint64_t mb[2];  // the lane sums, by buffer
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32, l = tid % 32;
#if AM_TONE_TAIL_CLOCK
  __shared__ long long ticks[20];
#define TAIL_TICK(k) \
  if (c == 0 && s == 0 && tid == 0) ticks[k] = clock64();
#else
#define TAIL_TICK(k)
#endif
  TAIL_TICK(0)
  if (tid == 0) {
    bulk::init(&mb_pw);
    bulk::init(&mb[0]);
    bulk::init(&mb[1]);
    bulk::expect(&mb_pw, NGRID * sizeof(float));
    bulk::expect(&mb[0], PASS_BYTES);
    bulk::expect(&mb[1], PASS_BYTES);
  }
  // every CTA of the cluster must have started, its mbarriers ready,
  // before one sends to it
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // a thread's samples (row i / 32, lane i % 32 of this CTA's lanes, i =
  // tid + k TAIL_T) and their pass-independent factors, in registers
  const float2* w =
      samples + (long long)s * n_samples + dynamic_start(offset[s], n_samples, WINDOW);
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
  wait_for_prerequisite();  // kernel 2's lane sums (and kernel 1's k0)
  const int k0 = k0_in[s];

  // grid point g = TAIL_WARPS c + warp: its tree, its power to every CTA
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
  TAIL_TICK(1)
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  TAIL_TICK(2)
  if (g < NGRID && l < TAIL_CTAS) send(peer(&pw[g], l), power, peer(&mb_pw, l));
  wait_phase(&mb_pw, 0);
  TAIL_TICK(3)

  if (warp == 0) {
    // the first argmax of the powers, a warp over the 85, then the parabola
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
      if (at == NGRID) at = 0;  // no power above -1: the plain version's 0
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
  TAIL_TICK(4)
#if AM_TONE_TAIL_STOP == 0
  if (c == 0 && tid == 0) f_out[s] = f_s;
  return;
#endif

  // two Newton steps, then the amplitude: three passes of lane sums
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
    TAIL_TICK(5 + 5 * pass)
    if (warp < nq) {
      float acc = terms[0][warp][l];
#pragma unroll
      for (int r = 1; r < ROWS; ++r) acc = acc + terms[r][warp][l];
      TAIL_TICK(6 + 5 * pass)
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
        // the six trees, then the step
        wait_phase(&mb[buf], 0);
        TAIL_TICK(7 + 5 * pass)
        float tot[6];
#pragma unroll
        for (int q = 0; q < 6; ++q) tot[q] = lane_tree_at(&lsum[buf][q][0][l]);
        TAIL_TICK(8 + 5 * pass)
        if (l == 0) {
          const float S0 = tot[0], S1 = tot[1];
          const float dS0 = tot[3], dS1 = -tot[2];  // -i t
          const float d2S0 = -tot[4], d2S1 = -tot[5];
          const float grad = 2.0f * (S0 * dS0 + S1 * dS1);
          const float h =
              2.0f * (dS0 * dS0 + dS1 * dS1) + 2.0f * (S0 * d2S0 + S1 * d2S1);
          f_s = h < 0.0f ? f - grad / h : f;
          // buffer 0's second phase: the amplitude's sums, to CTA 0 alone
          if (pass == 0 && c == 0) bulk::expect(&mb[0], AMP_BYTES);
        }
      }
      __syncthreads();
      TAIL_TICK(9 + 5 * pass)
#if AM_TONE_TAIL_STOP == 1 || AM_TONE_TAIL_STOP == 2
      if (pass + 1 == AM_TONE_TAIL_STOP) {
        if (c == 0 && tid == 0) f_out[s] = f_s;
        return;
      }
#endif
    } else if (c == 0 && warp == 0) {
      wait_phase(&mb[0], 1);
      TAIL_TICK(17)
      const float ar = lane_tree_at(&lsum[buf][0][0][l]);
      const float ai = lane_tree_at(&lsum[buf][1][0][l]);
      if (l == 0) {
        f_out[s] = f;
        amp_out[s] = make_float2(ar / (float)WINDOW, ai / (float)WINDOW);
      }
      TAIL_TICK(18)
#if AM_TONE_TAIL_CLOCK
      if (s == 0 && tid == 0)
        for (int k = 0; k < 19; ++k) ((long long*)part)[k] = ticks[k] - ticks[0];
#endif
    }
  }
}

}  // namespace

// The float2 count of am_tone's z scratch for n_stations: the stations
// padded to whole chunks of SB.
extern "C" long long am_tone_z_len(int n_stations) {
  return (long long)((n_stations + SB - 1) / SB) * SB * ROWS * T;
}

// derot: the 256 phasors of the integer derotation; twiddle: the grid's
// phasors float2 [85, 8910]; z: am_tone_z_len(n_stations) float2, part:
// [n_stations, 85, 256] float2 and k0: [n_stations] int32 scratch.  Three
// kernels in turn on the stream.
extern "C" int am_tone(const void* spectra, const void* samples,
                       long long n_samples, const void* offset,
                       const void* grid_u, const void* derot,
                       const void* twiddle, void* z, void* part, void* k0,
                       void* f, void* amp, int n_stations, void* stream) {
  if (n_stations <= 0 || n_samples < WINDOW) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)z & 15) != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  am_tone_z_kernel<<<dim3(Z_CTAS, n_stations), T, 0, st>>>(
      (const float2*)spectra, (const float2*)samples, n_samples,
      (const int*)offset, (const float2*)derot, (float2*)z, (int*)k0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int smem = (SB + PW) * ROWS * LANES * (int)sizeof(float2);
  err = cudaFuncSetAttribute(am_tone_proj_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = AM_TONE_PDL;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(LANE_GROUPS, GRID_GROUPS, (n_stations + SB - 1) / SB);
  cfg.blockDim = dim3(PW * SPLIT * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, am_tone_proj_kernel, (const float2*)z,
                           (const float2*)twiddle, (float2*)part, n_stations);
  if (err != cudaSuccess) return (int)err;
  cfg.gridDim = dim3(TAIL_CTAS, n_stations);
  cfg.blockDim = dim3(TAIL_T);
  cfg.dynamicSmemBytes = 0;
  err = cudaLaunchKernelEx(&cfg, am_tone_tail_kernel, (const float2*)samples,
                           n_samples, (const int*)offset, (const float*)grid_u,
                           (const float2*)part, (const int*)k0, (float*)f,
                           (float2*)amp);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
