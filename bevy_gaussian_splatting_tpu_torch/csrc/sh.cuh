// The SH colour stage's basis and contraction, shared by the fused serving
// projection (csrc/project.cu) and the training colour stage's forward and
// backward (csrc/sh.cu), so that every kernel that evaluates a gaussian's
// colour does it with the same float32 operations, in ops/sh.py's order.
// Both sources are built with --fmad=false: nothing here contracts a product
// and a sum that the eager chain rounds twice.

#pragma once

#include <cuda_runtime.h>

// a Python float as PyTorch casts it to float32 (from its double value)
#define F(x) static_cast<float>(x)

namespace {

// src/material/spherical_harmonics.wgsl:3-20, float32 (ops/sh.py SHC)
__constant__ float kShc[16] = {
    F(0.28209479177387814), F(-0.4886025119029199), F(0.4886025119029199), F(-0.4886025119029199),
    F(1.0925484305920792),  F(-1.0925484305920792), F(0.31539156525252005), F(-1.0925484305920792),
    F(0.5462742152960396),  F(-0.5900435899266435), F(2.890611442640554),  F(-0.4570457994644658),
    F(0.3731763325901154),  F(-0.4570457994644658), F(1.445305721320277),  F(-0.5900435899266435),
};

// sh.py sh_basis at degree kDeg (<= 3)
template <int kDeg>
__device__ __forceinline__ void sh_basis(float x, float y, float z, float* b) {
  const float* c = kShc;
  b[0] = c[0];
  if (kDeg >= 1) {
    b[1] = c[1] * y;
    b[2] = c[2] * z;
    b[3] = c[3] * x;
  }
  if (kDeg >= 2) {
    const float xx = x * x, yy = y * y, zz = z * z;
    b[4] = (c[4] * x) * y;
    b[5] = (c[5] * y) * z;
    b[6] = c[6] * ((zz * 2.0f - xx) - yy);
    b[7] = (c[7] * x) * z;
    b[8] = c[8] * (xx - yy);
    if (kDeg >= 3) {
      b[9] = (c[9] * y) * (xx * 3.0f - yy);
      b[10] = ((c[10] * x) * y) * z;
      b[11] = (c[11] * y) * ((zz * 4.0f - xx) - yy);
      b[12] = (c[12] * z) * ((zz * 2.0f - xx * 3.0f) - yy * 3.0f);
      b[13] = (c[13] * x) * ((zz * 4.0f - xx) - yy);
      b[14] = (c[14] * z) * (xx - yy);
      b[15] = (c[15] * x) * (xx - yy * 3.0f);
    }
  }
}

// sh.py _interleaved_contract over kCoeffs coefficients of a row read as
// float4s, in j order: acc = b[0] * sh[0:3] (kFirst), then acc + b[j] *
// sh[3j:3j+3].  A 4D row is three such runs of one sum, one a harmonic.
template <int kCoeffs, bool kFirst>
__device__ __forceinline__ void contract(const float* b, const float4* row, float* rgb) {
  constexpr int kVec = (3 * kCoeffs + 3) / 4;
  float s[4 * kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    const float4 q = __ldg(row + v);
    s[4 * v] = q.x;
    s[4 * v + 1] = q.y;
    s[4 * v + 2] = q.z;
    s[4 * v + 3] = q.w;
  }
#pragma unroll
  for (int j = 0; j < kCoeffs; ++j) {
    for (int ch = 0; ch < 3; ++ch) rgb[ch] = (kFirst && j == 0) ? b[0] * s[ch] : rgb[ch] + b[j] * s[3 * j + ch];
  }
}

}  // namespace
