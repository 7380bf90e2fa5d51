// The reference-subcarrier Costas PLL step, shared by K10 (cfo_scan.cu, the
// cold start's CFO scan) and K4 (sync_block.cu), so that the two kernels
// track bit-identically; K18 (sync_fm_c.cu) takes costas_advance_c, the
// same step with the complex chain's phase detector.
//
// One step on reference sample v with phase ph and frequency fr:
//   v2     = v*v
//   err    = 0.5 * wrap_pi(angle(v2) - 2*ph)
//   derot  = v * e^{-i ph}
//   fr     = clip(fr + beta*err, -0.5, 0.5)
//   ph     = wrap_pi(ph + fr + cf + alpha*err)
// with wrap_pi(x) = x - 2pi*rint(x / 2pi) (round half to even, as
// jnp.round).  f32 in the reference's order: the build passes -fmad=false,
// and the constants come in as floats so nothing promotes to double.

#pragma once

#include <cuda_runtime.h>

namespace nrsc5 {

__device__ __forceinline__ float wrap_pi(float x, float two_pi) {
  return x - two_pi * rintf(x / two_pi);
}

// the three parts of a step, run apart: K4 and K10 take the angles and the
// derotations of all their steps in parallel and keep only the phase and
// frequency recursion on the track's thread (a step is costas_derot at the
// old phase, then costas_advance on costas_angle)
__device__ __forceinline__ float costas_angle(float2 v) {
  const float v2r = v.x * v.x - v.y * v.y;
  const float v2i = v.x * v.y + v.y * v.x;
  return atan2f(v2i, v2r);
}

__device__ __forceinline__ void costas_advance(float a, float& ph, float& fr,
                                               float cf, float alpha,
                                               float beta, float two_pi) {
  const float err = 0.5f * wrap_pi(a - 2.0f * ph, two_pi);
  fr = fminf(fmaxf(fr + beta * err, -0.5f), 0.5f);
  ph = wrap_pi(ph + fr + cf + alpha * err, two_pi);
}

__device__ __forceinline__ float2 costas_derot(float2 v, float ph) {
  const float c = cosf(-ph), s = sinf(-ph);
  return make_float2(v.x * c - v.y * s, v.x * s + v.y * c);
}

// the step of the complex chain's costas_track (nrsc5_tpu/ops/sync_fm.py):
// err = 0.5 * angle(v^2 e^{-2i ph}), with the cosine and sine of -2 ph
// inside the recursion, then the same frequency and phase updates (cf = 0)
__device__ __forceinline__ void costas_advance_c(float2 v, float& ph,
                                                 float& fr, float alpha,
                                                 float beta, float two_pi) {
  const float v2r = v.x * v.x - v.y * v.y;
  const float v2i = v.x * v.y + v.y * v.x;
  const float t = -2.0f * ph;
  const float c = cosf(t), s = sinf(t);
  const float err = 0.5f * atan2f(v2r * s + v2i * c, v2r * c - v2i * s);
  fr = fminf(fmaxf(fr + beta * err, -0.5f), 0.5f);
  ph = wrap_pi(ph + fr + alpha * err, two_pi);
}

}  // namespace nrsc5
