// The rotation phasor of K7 (rotate.cu) and K12 (synth.cu): a harmonic of a
// spectrum times exp(i 2 pi sign frac(s k)), as ops/fourier.py phasor forms
// it: f = (s k) floor-mod 1 in float64 (fmod, and 1 added to a negative
// remainder, as torch.remainder), the angle 2 pi f, then cos and sin; the
// complex product in rounded real operations (no fused multiply-add).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

// X * exp(i 2 pi sign frac(s k)), each product and sum rounded
__device__ __forceinline__ double2 rotated(double2 v, double s, int k, double two_pi) {
  double f = fmod(__dmul_rn(s, (double)k), 1.0);
  if (f != 0.0 && f < 0.0) f = __dadd_rn(f, 1.0);
  double sn, cs;
  sincos(__dmul_rn(two_pi, f), &sn, &cs);
  return make_double2(__dsub_rn(__dmul_rn(v.x, cs), __dmul_rn(v.y, sn)),
                      __dadd_rn(__dmul_rn(v.x, sn), __dmul_rn(v.y, cs)));
}

}  // namespace
