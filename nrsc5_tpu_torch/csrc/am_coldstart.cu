// K14: the AM cold start's probe block — the carrier-tone estimate, the
// tone-subtracted coarse timing with the latch override and the
// prev_angle smoothing, and the integer-CFO step from pass 1's spectra.
//
// Replaces the JAX device functions of
// nrsc5_tpu/pipeline/scan_chain_am_rc.py: :350 _am_tone_subtract_rc (am_tone
// estimates the tone, am_coarse subtracts it as it reads the window), :404
// _am_coarse_timing_rc and :439-445 of am_coldstart_block_rc (am_coarse),
// and the magnitude sums of :106 with the host's argmax of :503-506
// (am_cfo_step), for all stations of a cold start at once.  Per station,
// on the window w[n] = samples[offset + n], n < 8910 (offset placed as
// lax.dynamic_slice places it):
//
// am_tone (from the power DFT's spectra P [32, 256] of the window's first
//   256 samples of each symbol):
//   k0 = first argmax_k sum_sym |P[sym, k]|^2, folded to [-128, 128)
//   z[n] = w[n] e^{i ((k0 n) mod 256) (-2pi/256)}
//   S_g = sum_n z[n] e^{i (-2pi/256) (u_g n)}  for the 85 grid points u_g
//   i = clip(first argmax |S_g|^2, 1, 83), parabolic refine -> u*,
//   f = (k0 + u*) / 256; two Newton steps on |S(f)|^2 with m = n - 4454.5,
//   taken only where the curvature h < 0; amp = sum_n w[n] e(n) / 8910,
//   e(n) = e^{i ((-2pi) f) m}.
// am_coarse: x[n] = w[n] - amp conj(e(n));
//   sums[t] = sum_k x[270k + t] conj(x[256 + 270k + t]) (t < 270, k < 32);
//   v[i] = sum_j sums[(i + j) mod 270] kern[j] (j < 14); measured = first
//   argmax |v|^2; samperr = override % 270 where override >= 0, else
//   measured; prev_angle += arg(v e^{-i prev_angle}) * (prev_angle != 0 ?
//   0.25 : 1).
// am_cfo_step (from pass 1's spectra [32, 256], bins 75..181):
//   mags[b] = sum_sym |P[sym, 75 + b]|; step = first argmax - 53.
//
// Every sum runs in an order the plain PyTorch versions reproduce: over
// the 32 symbols and the 14 window taps from the first term to the last;
// over the 8910 samples, lane t of 256 sums samples t, t + 256, ... in
// turn (zeros past the end), then a fixed pairwise tree halves the 256
// partial sums.  The twiddle tables hold the plain version's own phasors
// (built by its expressions on the same device).  Phases are float32 product chains in the reference's
// order, and the trigonometric functions are cosf/sinf with full range
// reduction (Newton's arguments reach ~14000 rad, where __sinf/__cosf are
// wrong by about a radian).  With -fmad=false the kernels then agree with
// their plain versions bit for bit on the card.
//
// Bound on the H100: operations.  The grid projection is 85 x 8910
// complex products a station, ~0.1 Gop for 16 stations on the float32
// cores (no FMA); the window reads are 1.1 MB a kernel.  Design: am_tone
// runs as three kernels in turn.  The grid's phasors e^{i (-2pi/256)(u_g
// n)} depend on neither the station nor the data, so they come in as a
// table (float32 [85, 8910, 2], 6.1 MB, read from L2), and the integer
// derotation's 256 phasors as another.  Kernel 1 finds k0 and derives z
// once a station, in tiles of 32 lanes x 16 stations.  Kernel 2 projects:
// a CTA a tile and 6 grid points, z and the twiddle rows brought into
// shared memory by bulk copies, two warps a grid point, a thread summing
// one lane's rows for 8 stations at once, so that each twiddle load
// serves 8 stations.  Kernel 3 runs the trees, the parabola, Newton and
// amp over a cluster of 8 CTAs a station, each CTA owning 32 of the 256
// lanes and sending its lane sums to every CTA of the cluster.  Kernels 2
// and 3 start while the kernel before them ends (programmatic dependent
// launch).  am_coarse runs over a cluster of 8 CTAs a station, split by
// timing lane: CTA r owns the lanes [270 r / 8, 270 (r + 1) / 8), whose
// 32-term sums read only the positions 270 p + [lo - 14, hi) of the 33
// symbol periods (~1560 samples, 1.4x its share).  Each thread issues its
// window loads first (before it waits for am_tone's tail, under
// programmatic dependent launch), subtracts the tone with one sincosf a
// sample, and each lane's products are taken and summed in symbol order
// by two threads (real, imaginary), sent to the leader CTA by st.async;
// the leader runs the 14-tap window, the argmax (by warp reductions, one
// barrier) and the scalar tail.  A position two CTAs both compute gets the
// same value in each.  am_cfo_step runs one CTA per station, four threads
// a bin each loading 8 of its 32 symbols at once, also under programmatic
// dependent launch (pass 1's spectra are complete before the kernel ahead
// of it starts).  Tables come in as device pointers.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "bulk_copy.cuh"

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
// am_tone's design (probes/am_tone_k13_variants.py times the others
// tried): stations a projection CTA, grid points a projection CTA, warps a
// grid point, and the tail's threads a CTA
constexpr int SB = 16;
constexpr int PW = 6;
constexpr int SPLIT = 2;
constexpr int GRID_GROUPS = (NGRID + PW - 1) / PW;
constexpr int TAIL_CTAS = LANE_GROUPS;  // the tail's cluster
constexpr int TAIL_T = 512;
constexpr int TAIL_WARPS = TAIL_T / 32;

// am_coarse's design (probes/k14_coarse_cfo_variants.py times the others
// tried): the cluster a station, the threads a CTA; a CTA's most lanes, its
// run of each of the 33 symbol periods, and the items of a thread; then
// am_cfo_step's
constexpr int COARSE_CTAS = 8;
constexpr int COARSE_T = 288;
constexpr int PERIODS = NSYM + 1;
constexpr int COARSE_LANES = (FFTCP + COARSE_CTAS - 1) / COARSE_CTAS;  // 34
constexpr int COARSE_W = COARSE_LANES + CP;                             // 48
constexpr int COARSE_ITEMS = (PERIODS * COARSE_W + COARSE_T - 1) / COARSE_T;
constexpr int CFO_T = 128;       // am_cfo_step: bins a CTA (107 used)
constexpr int CFO_SPLIT = 4;     // threads a bin
constexpr int CFO_ROWS = NSYM / CFO_SPLIT;
constexpr int CFO_LO = FFT / 2 - 53;        // CENTER_AM - PIDS_OUTER_INDEX_AM
constexpr int CFO_BINS = 2 * 53 + 1;        // 107
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

// cos and sin of t as cosf and sinf give them, from one sincosf (one range
// reduction)
__device__ __forceinline__ float2 cis(float t) {
  float sn, cs;
  sincosf(t, &sn, &cs);
  return make_float2(cs, sn);
}

// Programmatic dependent launch: am_tone's kernels 2 and 3, am_coarse and
// am_cfo_step are launched to start while the kernel before them ends
// (each of am_tone's kernels lets its dependent start as soon as all its
// CTAs run), do what does not read that kernel's output, and then wait
// for it to complete.  Both are no-ops for a kernel launched plainly.
__device__ __forceinline__ void let_dependents_start() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void wait_for_prerequisite() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// A load, after wait_for_prerequisite, of what the kernel ahead wrote: from
// L2, and never moved above the wait.  A plain load through a const
// __restrict__ pointer may be, the memory being read-only for the kernel's
// life as far as the compiler knows: in the probe block's graph am_coarse
// then read a stale f and amp.
__device__ __forceinline__ float load_after_wait(const float* p) {
  float v;
  asm volatile("ld.global.cg.f32 %0, [%1];" : "=f"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ float2 load_after_wait(const float2* p) {
  float2 v;
  asm volatile("ld.global.cg.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y)
               : "l"(p)
               : "memory");
  return v;
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
__global__ void __launch_bounds__(PW * SPLIT * 32)
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
  __syncthreads();
  const float2* tw = twiddle + (long long)min(g, NGRID - 1) * WINDOW;
  const float2* tws = twt + gw * ROWS * LANES;
  if (g < NGRID && half == 0 && l < PCH) {
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
  if (tid < PCH)
    bulk::copy(zt + tid * CHUNK, tile + tid * CHUNK, CHUNK * sizeof(float2),
               &zbar[tid]);
  if (g < NGRID) {
    const int t = t0 + l;
    const float2* zl = zt + half * SPT * LANES + l;  // this thread's stations

    // every station slot is summed, those past n_stations on whatever the
    // tile holds there, and only the real ones are written: no branch
    // between a row's loads and its products
    float2 acc[SPT];
    for (int c = 0; c < PCH; ++c) {
      bulk::wait(&zbar[c]);
      bulk::wait(&wbar[gw][c]);
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
#pragma unroll
    for (int sl = 0; sl < SPT; ++sl)
      if (s0 + sl < n_stations)
        part[((long long)(s0 + sl) * NGRID + g) * T + t] = acc[sl];
  }
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
  let_dependents_start();  // am_coarse: its window loads
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
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (g < NGRID && l < TAIL_CTAS) send(peer(&pw[g], l), power, peer(&mb_pw, l));
  wait_phase(&mb_pw, 0);

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
        // the six trees, then the step
        wait_phase(&mb[buf], 0);
        float tot[6];
#pragma unroll
        for (int q = 0; q < 6; ++q) tot[q] = lane_tree_at(&lsum[buf][q][0][l]);
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
    } else if (c == 0 && warp == 0) {
      wait_phase(&mb[0], 1);
      const float ar = lane_tree_at(&lsum[buf][0][0][l]);
      const float ai = lane_tree_at(&lsum[buf][1][0][l]);
      if (l == 0) {
        f_out[s] = f;
        amp_out[s] = make_float2(ar / (float)WINDOW, ai / (float)WINDOW);
      }
    }
  }
}

// Whether item j of period p of a CTA's run (position 270 p + lo - 14 + j,
// lanes [lo, lo + lanes)) is read: lane lo + l reads x[270 k + lo + l] at
// run[k][l + 14] and x[256 + 270 k + lo + l] at run[k + 1][l], k < 32, so
// the first period's first 14 items and the last period's last 14 are not.
__device__ __forceinline__ bool coarse_item_read(int p, int j, int lanes) {
  return j < lanes + CP && (p > 0 || j >= CP) && (p < NSYM || j < lanes);
}

// The first argmax over one value a thread, each value >= 0 (a thread
// that holds none gives -1), with one barrier: a value's bits order as
// the value, so each warp takes the largest bits and the least index that
// holds them by two reductions, then warp 0 the same over the warps'.
// Returns the index to the lanes of warp 0.
__device__ int first_argmax(float best, int at, unsigned* bk, int* bi) {
  constexpr unsigned ALL = 0xffffffffu;
  unsigned key = best >= 0.0f ? __float_as_uint(best) : 0u;
  if (best < 0.0f) at = 0x7fffffff;
  unsigned top = __reduce_max_sync(ALL, key);
  at = __reduce_min_sync(ALL, key == top ? at : 0x7fffffff);
  const int lane = threadIdx.x & 31, warps = blockDim.x / 32;
  if (lane == 0) {
    bk[threadIdx.x >> 5] = top;
    bi[threadIdx.x >> 5] = at;
  }
  __syncthreads();
  if (threadIdx.x >= 32) return -1;
  key = lane < warps ? bk[lane] : 0u;
  at = lane < warps ? bi[lane] : 0x7fffffff;
  top = __reduce_max_sync(ALL, key);
  return __reduce_min_sync(ALL, key == top ? at : 0x7fffffff);
}

// am_coarse over a cluster of COARSE_CTAS CTAs a station (the file's head
// gives the split).  Launched with programmatic dependent launch behind
// am_tone's tail: the window loads and the taps come before the wait, f,
// amp, prev_angle and the override after it, and so does every write to
// global memory.  Each lane's two sums go to the leader by st.async,
// counted on the leader's mbarrier, so that only the leader waits for
// them; a warp the sums leave idle reads prev_angle and the override and
// forms prev_angle's rotation meanwhile.
__global__ void __cluster_dims__(COARSE_CTAS, 1, 1) __launch_bounds__(COARSE_T)
am_coarse_kernel(const float2* __restrict__ samples, long long n_samples,
                 const int* __restrict__ offset, const float* __restrict__ f_in,
                 const float2* __restrict__ amp_in,
                 const float* __restrict__ prev_angle,
                 const int* __restrict__ coarse_override,
                 const float* __restrict__ shape_kernel,
                 int* __restrict__ measured, int* __restrict__ samperr,
                 float* __restrict__ prev_angle_out,
                 float2* __restrict__ v_max) {
  constexpr int ROT_THREAD = COARSE_T - 32;  // past every sum thread
  static_assert(ROT_THREAD >= 2 * COARSE_LANES, "a warp free of sums");
  __shared__ float2 run[PERIODS][COARSE_W];  // the tone-subtracted runs
  __shared__ float2 sums[FFTCP];  // the leader's: every lane's sums
  __shared__ float2 v_s[FFTCP];
  __shared__ float kern[CP];
  __shared__ unsigned bk[COARSE_T / 32];
  __shared__ int bi[COARSE_T / 32];
  __shared__ float2 rot_s;  // the leader's: e^{-i prev_angle}
  __shared__ float pa_s;
  __shared__ int ov_s;
  __shared__ __align__(8) uint64_t mb;  // the leader's: the sums' bytes
  cg::cluster_group cluster = cg::this_cluster();
  const int r = static_cast<int>(cluster.block_rank());
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int lo = r * FFTCP / COARSE_CTAS;
  const int lanes = (r + 1) * FFTCP / COARSE_CTAS - lo;

  // the loads first: the window, which no kernel of the probe block writes
  // (the leader's mbarrier is made ready while the offset comes)
  const int off = offset[s];
  if (r == 0 && tid == 0) {
    bulk::init(&mb);
    bulk::expect(&mb, FFTCP * 2 * sizeof(float));
  }
  const float2* w =
      samples + (long long)s * n_samples + dynamic_start(off, n_samples, WINDOW);
  float2 wv[COARSE_ITEMS];
#pragma unroll
  for (int k = 0; k < COARSE_ITEMS; ++k) {
    const int i = tid + k * COARSE_T;
    const int p = i / COARSE_W, j = i % COARSE_W;
    wv[k] = make_float2(0.0f, 0.0f);
    if (p < PERIODS && coarse_item_read(p, j, lanes))
      wv[k] = w[FFTCP * p + lo - CP + j];
  }
  if (r == 0 && tid < CP) kern[tid] = shape_kernel[tid];
  // every CTA of the cluster must have started, the leader's mbarrier
  // ready, before one sends to the leader
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  wait_for_prerequisite();  // am_tone's f and amp
  const float c = NEG_TWO_PI * load_after_wait(f_in + s);
  const float2 amp = load_after_wait(amp_in + s);
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
#pragma unroll
  for (int k = 0; k < COARSE_ITEMS; ++k) {
    const int i = tid + k * COARSE_T;
    const int p = i / COARSE_W, j = i % COARSE_W;
    if (p < PERIODS && coarse_item_read(p, j, lanes)) {
      const int n = FFTCP * p + lo - CP + j;
      const float2 e = cis(c * ((float)n - HALF_SPAN));
      const float2 tone = cmul(amp, make_float2(e.x, -e.y));
      run[p][j] = make_float2(wv[k].x - tone.x, wv[k].y - tone.y);
    }
  }
  __syncthreads();

  // each lane's products and their sum in symbol order, the real and the
  // imaginary part on two threads, sent to the leader
  if (tid < 2 * lanes) {
    const int l = tid >> 1, im = tid & 1;
    float terms[NSYM];
#pragma unroll
    for (int k = 0; k < NSYM; ++k) {
      const float2 a = run[k][l + CP], b = run[k + 1][l];  // a conj(b)
      terms[k] = im ? a.y * b.x - a.x * b.y : a.x * b.x + a.y * b.y;
    }
    float acc = terms[0];
#pragma unroll
    for (int k = 1; k < NSYM; ++k) acc = acc + terms[k];
    send(peer(reinterpret_cast<float*>(&sums[lo + l]) + im, 0), acc,
         peer(&mb, 0));
  }
  if (r != 0) return;

  // the leader: prev_angle's rotation while the sums come, then the
  // circular 14-tap window, its first argmax and the scalar steps
  if (tid == ROT_THREAD) {
    ov_s = coarse_override[s];
    pa_s = prev_angle[s];
    rot_s = cis(-pa_s);
  }
  wait_phase(&mb, 0);
  float best = -1.0f;
  int at = 0;
  if (tid < FFTCP) {
    float2 v = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int j = 0; j < CP; ++j) {
      int m = tid + j;
      if (m >= FFTCP) m -= FFTCP;
      const float2 t = make_float2(sums[m].x * kern[j], sums[m].y * kern[j]);
      v = j ? make_float2(v.x + t.x, v.y + t.y) : t;
    }
    v_s[tid] = v;
    best = v.x * v.x + v.y * v.y;
    at = tid;
  }
  const int i_max = first_argmax(best, at, bk, bi);  // its barrier: rot_s
  if (tid == 0) {
    const float2 v = v_s[i_max];
    const float2 q = cmul(v, rot_s);
    const float diff = atan2f(q.y, q.x);
    const int ov = ov_s;
    const float pa = pa_s;
    measured[s] = i_max;
    samperr[s] = ov >= 0 ? ov % FFTCP : i_max;
    prev_angle_out[s] = pa + diff * (pa != 0.0f ? 0.25f : 1.0f);
    v_max[s] = v;
  }
}

// am_cfo_step: a CTA a station, CFO_SPLIT threads a bin, each loading
// CFO_ROWS symbols of it at once; the first sums its magnitudes, then the
// others' (through shared memory) in symbol order.  Launched with
// programmatic dependent launch: pass 1's spectra were complete before
// the kernel ahead of this one started, so the loads and the sums come
// before the wait, the writes after it.
__global__ void __launch_bounds__(CFO_T * CFO_SPLIT) am_cfo_step_kernel(
    const float2* __restrict__ spectra, float* __restrict__ mags,
    int* __restrict__ step) {
  __shared__ float later[NSYM - CFO_ROWS][CFO_T];  // symbols CFO_ROWS..31
  __shared__ unsigned bk[CFO_T * CFO_SPLIT / 32];
  __shared__ int bi[CFO_T * CFO_SPLIT / 32];
  const int s = blockIdx.x;
  const int b = threadIdx.x % CFO_T, h = threadIdx.x / CFO_T;
  const float2* sp = spectra + ((long long)s * NSYM + h * CFO_ROWS) * FFT +
                     CFO_LO + min(b, CFO_BINS - 1);
  float2 v[CFO_ROWS];
#pragma unroll
  for (int k = 0; k < CFO_ROWS; ++k) v[k] = sp[k * FFT];
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < CFO_ROWS; ++k) {
    const float m = sqrtf(v[k].x * v[k].x + v[k].y * v[k].y);
    if (h == 0)
      acc = k ? acc + m : m;
    else
      later[(h - 1) * CFO_ROWS + k][b] = m;
  }
  __syncthreads();
  if (h == 0) {
#pragma unroll
    for (int k = 0; k < NSYM - CFO_ROWS; ++k) acc = acc + later[k][b];
  }
  wait_for_prerequisite();
  float best = -1.0f;
  int at = 0;
  if (h == 0 && b < CFO_BINS) {
    mags[s * CFO_BINS + b] = acc;
    best = acc;
    at = b;
  }
  const int arg = first_argmax(best, at, bk, bi);
  if (threadIdx.x == 0) step[s] = arg + CFO_LO - FFT / 2;
}

}  // namespace

// Programmatic dependent launch for a kernel of a plain C launch
// configuration: it may start while the kernel ahead of it on the stream
// ends.
static cudaLaunchConfig_t pdl_config(dim3 grid, dim3 block, cudaStream_t st,
                                     cudaLaunchAttribute* pdl) {
  pdl->id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl->val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.stream = st;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  return cfg;
}

// cudaFuncSetAttribute(kernel, max dynamic shared memory, bytes) once a
// device in the process, `set` holding the kernel's devices (bit d: device
// d): the attribute stays set, and a launch should not cost a driver call
template <typename Kernel>
static cudaError_t max_dynamic_smem_once(Kernel kernel, int bytes,
                                         std::atomic<uint64_t>& set) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (bit && (set.load(std::memory_order_relaxed) & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) set.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

static std::atomic<uint64_t> proj_smem_set{0};

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
  err = cudaLaunchKernelEx(&cfg, am_tone_tail_kernel, (const float2*)samples,
                           n_samples, (const int*)offset, (const float*)grid_u,
                           (const float2*)part, (const int*)k0, (float*)f,
                           (float2*)amp);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int am_coarse(const void* samples, long long n_samples,
                         const void* offset, const void* f, const void* amp,
                         const void* prev_angle, const void* coarse_override,
                         const void* shape_kernel, void* measured,
                         void* samperr, void* prev_angle_out, void* v_max,
                         int n_stations, void* stream) {
  if (n_stations <= 0 || n_samples < WINDOW) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute pdl;
  cudaLaunchConfig_t cfg = pdl_config(dim3(COARSE_CTAS, n_stations),
                                      dim3(COARSE_T), (cudaStream_t)stream,
                                      &pdl);
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, am_coarse_kernel, (const float2*)samples, n_samples,
      (const int*)offset, (const float*)f, (const float2*)amp,
      (const float*)prev_angle, (const int*)coarse_override,
      (const float*)shape_kernel, (int*)measured, (int*)samperr,
      (float*)prev_angle_out, (float2*)v_max);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int am_cfo_step(const void* spectra, void* mags, void* step,
                           int n_stations, void* stream) {
  if (n_stations <= 0) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute pdl;
  cudaLaunchConfig_t cfg = pdl_config(dim3(n_stations), dim3(CFO_T * CFO_SPLIT),
                                      (cudaStream_t)stream, &pdl);
  cudaError_t err = cudaLaunchKernelEx(&cfg, am_cfo_step_kernel,
                                       (const float2*)spectra, (float*)mags,
                                       (int*)step);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
