// The SH colour stage of the training projection, forward and backward, one
// launch each.
//
// Replaces no TPU kernel.  The JAX package leaves ops/sh.py to XLA, which
// fuses the colour stage and its gradient.  Run eagerly, the same stage is
// a loop over the coefficients, acc = acc + basis[:, j:j+1] * sh[:, 3j:3j+3]
// (16 terms in 3D, 48 in 4D), and autograd answers each slice with a
// zero-filled gradient as wide as all of sh, then adds them together: in 4D
// at 1M gaussians some 145 GB of fills and adds a step for 1.2 GB of work.
//
//   sh_fwd_kernel  rgb [N, 3] = 0.5 + sum_j F_j * sh[:, 3j:3j+3], the eager
//                  chain's bits: csrc/sh.cuh's basis and contraction, the
//                  4D harmonics T_b = cos(2 pi b theta), theta = dir_t /
//                  duration, as sh.py spherindrical_harmonics_lookup
//                  computes them, F_{16b+i} = Y_i T_b.
//   sh_bwd_kernel  from d_rgb = g [N, 3]:
//                    d_sh[3j+c] = F_j g_c, autograd's own product, so the
//                      same bits (plus +0 where more than one coefficient
//                      is summed: autograd adds the zero-filled slices, which
//                      turns a -0 into +0); padding columns and columns
//                      above the evaluated degree 0;
//                    dF_j = sum_c g_c sh[3j+c];
//                    4D: dY_i = sum_b dF_{16b+i} T_b, dT_b = sum_i
//                      dF_{16b+i} Y_i, dtheta = sum_{b>=1} dT_b (-sin(2 pi b
//                      theta)) 2 pi b, d_dir_t = dtheta / duration;
//                    d_dir from the derivatives of sh_basis's polynomials.
//                  The gradient of duration is not formed (a constant).
//
// kKind 0-3: a 3D row (Gaussian3dCloud, 2DGS surfels) with SH evaluated
// through that degree, row width sh_width (pad_4(3 (d+1)^2), or wider for a
// higher storage degree); 4: a 4D row (degree 3 times 3 harmonics, 144
// floats).
//
// Bound on the H100: memory.  A 4D gaussian's forward reads 576 + 16 bytes
// and writes 12; its backward reads 576 + 12 + 16 + 4 and writes 576 + 12 +
// 4.  The arithmetic (some 300 float operations and two cosines, two sines)
// is far below the byte time.
//   Forward: one thread a gaussian, its row read with 16-byte loads, as the
//   fused projection reads it (a sum in j order cannot be split across
//   threads without changing its bits).
//   Backward: a block of kThreads gaussians.  Each thread works out its
//   gaussian's F_j and stages them, and the block's g, in shared memory.
//   Then the block walks its contiguous span of sh and d_sh in units of 12
//   floats (4 coefficients, three 16-byte loads and stores), neighbouring
//   threads on neighbouring units, so that a warp reads and writes 1.5 KB of
//   contiguous memory an instruction triple; each unit's dF_j overwrite its
//   F_j in shared memory.  Last, each thread folds its gaussian's dF_j into
//   d_dir and d_dir_t.  Every dF_j is summed by one thread, in one order: no
//   atomics, the same bits on every run.  Chosen by a timed A/B on the card
//   against one thread a gaussian reading and writing its own row in 16-byte
//   accesses (a warp's accesses 576 bytes apart in 4D), which took 3.3 times
//   as long at 1M, in 3D and in 4D.

#include <cuda_runtime.h>

#include <cstdint>

#include "sh.cuh"

namespace {

constexpr int kThreads = 128;

constexpr float kTwoPi = F(2.0 * 3.141592653589793 * 1);  // 2.0 * math.pi * 1
constexpr float kFourPi = F(2.0 * 3.141592653589793 * 2);  // 2.0 * math.pi * 2

template <int kKind>
struct Shape {
  static constexpr bool k4d = kKind == 4;
  static constexpr int kDeg = k4d ? 3 : kKind;
  static constexpr int kBasis = (kDeg + 1) * (kDeg + 1);  // Y_i
  static constexpr int kCoeffs = k4d ? 3 * kBasis : kBasis;  // F_j
  static constexpr int kStride = kCoeffs | 1;  // odd: a thread a row, no bank conflicts
};

// a gaussian's direction, and its 4D harmonics T_b and their arguments
struct Inputs {
  float x, y, z;
  float t[3], arg[3];
};

template <bool k4d>
__device__ __forceinline__ Inputs read_inputs(const float* dir, const float* dir_t, const float* duration, int i) {
  Inputs in;
  in.x = dir[3 * i];
  in.y = dir[3 * i + 1];
  in.z = dir[3 * i + 2];
  if (k4d) {
    // sh.py: theta = dir_t / duration (a tensor: a true division), the
    // harmonics cos(2.0 * math.pi * k * theta) (a float32 product)
    const float theta = dir_t[i] / __ldg(duration);
    in.arg[0] = 0.0f;
    in.arg[1] = kTwoPi * theta;
    in.arg[2] = kFourPi * theta;
    in.t[0] = 1.0f;
    in.t[1] = cosf(in.arg[1]);
    in.t[2] = cosf(in.arg[2]);
  }
  return in;
}

template <int kKind>
__global__ void __launch_bounds__(kThreads)
    sh_fwd_kernel(const float* __restrict__ dir, const float* __restrict__ dir_t, const float* __restrict__ duration,
                  const float* __restrict__ sh, int n, int sh_width, float* __restrict__ rgb) {
  using S = Shape<kKind>;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const Inputs in = read_inputs<S::k4d>(dir, dir_t, duration, i);
  const float4* row = reinterpret_cast<const float4*>(sh + (size_t)i * sh_width);
  float b[16], acc[3];
  sh_basis<S::kDeg>(in.x, in.y, in.z, b);
  if constexpr (S::k4d) {
    // the full basis in blocks of 16 (12 float4s of the row) a harmonic
    float full[16];
    for (int j = 0; j < 16; ++j) full[j] = b[j] * in.t[0];
    contract<16, true>(full, row, acc);
    for (int j = 0; j < 16; ++j) full[j] = b[j] * in.t[1];
    contract<16, false>(full, row + 12, acc);
    for (int j = 0; j < 16; ++j) full[j] = b[j] * in.t[2];
    contract<16, false>(full, row + 24, acc);
  } else {
    contract<S::kBasis, true>(b, row, acc);
  }
  for (int c = 0; c < 3; ++c) rgb[3 * i + c] = acc[c] + 0.5f;
}

// d_dir of sh_basis<kDeg> at (x, y, z) from dY, the gradient of each Y_i
template <int kDeg>
__device__ __forceinline__ void sh_basis_grad(float x, float y, float z, const float* dY, float* d) {
  const float* c = kShc;
  float dx = 0.0f, dy = 0.0f, dz = 0.0f;
  if (kDeg >= 1) {
    dy += c[1] * dY[1];
    dz += c[2] * dY[2];
    dx += c[3] * dY[3];
  }
  if (kDeg >= 2) {
    const float e4 = c[4] * dY[4], e5 = c[5] * dY[5], e6 = c[6] * dY[6], e7 = c[7] * dY[7], e8 = c[8] * dY[8];
    dx += e4 * y + e7 * z + (e8 - e6) * (2.0f * x);
    dy += e4 * x + e5 * z - (e6 + e8) * (2.0f * y);
    dz += e5 * y + e7 * x + e6 * (4.0f * z);
    if (kDeg >= 3) {
      const float xx = x * x, yy = y * y, zz = z * z;
      const float xy = x * y, xz = x * z, yz = y * z;
      const float e9 = c[9] * dY[9], e10 = c[10] * dY[10], e11 = c[11] * dY[11], e12 = c[12] * dY[12];
      const float e13 = c[13] * dY[13], e14 = c[14] * dY[14], e15 = c[15] * dY[15];
      dx += e9 * (6.0f * xy) + e10 * yz - e11 * (2.0f * xy) - e12 * (6.0f * xz) +
            e13 * (4.0f * zz - 3.0f * xx - yy) + e14 * (2.0f * xz) + e15 * (3.0f * (xx - yy));
      dy += e9 * (3.0f * (xx - yy)) + e10 * xz + e11 * (4.0f * zz - xx - 3.0f * yy) - e12 * (6.0f * yz) -
            e13 * (2.0f * xy) - e14 * (2.0f * yz) - e15 * (6.0f * xy);
      dz += e10 * xy + e11 * (8.0f * yz) + e12 * (6.0f * zz - 3.0f * (xx + yy)) + e13 * (8.0f * xz) +
            e14 * (xx - yy);
    }
  }
  d[0] = dx;
  d[1] = dy;
  d[2] = dz;
}

// autograd's d_sh entry: the product F_j g_c, and where it adds more than
// one zero-filled slice, that sum's +0
template <int kCoeffs>
__device__ __forceinline__ float d_sh_entry(float f, float g) {
  return kCoeffs > 1 ? f * g + 0.0f : f * g;
}

template <int kKind>
__global__ void __launch_bounds__(kThreads)
    sh_bwd_kernel(const float* __restrict__ dir, const float* __restrict__ dir_t, const float* __restrict__ duration,
                  const float* __restrict__ sh, const float* __restrict__ grad, int n, int sh_width,
                  float* __restrict__ d_sh, float* __restrict__ d_dir, float* __restrict__ d_dir_t) {
  using S = Shape<kKind>;
  __shared__ float s_f[kThreads * S::kStride];  // F_j, then dF_j, a gaussian a row
  __shared__ float s_g[kThreads * 3];
  const int first = blockIdx.x * kThreads;
  const int rows = min(kThreads, n - first);
  const int r = threadIdx.x;
  const int i = first + r;

  // the block's g, a contiguous span of 3 rows floats
  for (int k = r; k < 3 * rows; k += kThreads) s_g[k] = grad[3 * (size_t)first + k];
  Inputs in;
  float y[16];
  if (r < rows) {
    in = read_inputs<S::k4d>(dir, dir_t, duration, i);
    sh_basis<S::kDeg>(in.x, in.y, in.z, y);
    float* f = s_f + r * S::kStride;
    if constexpr (S::k4d) {
      for (int b = 0; b < 3; ++b)
        for (int k = 0; k < 16; ++k) f[16 * b + k] = y[k] * in.t[b];
    } else {
      for (int k = 0; k < S::kBasis; ++k) f[k] = y[k];
    }
  }
  __syncthreads();

  // the span in units of 12 floats: unit u of a row holds coefficients
  // 4u..4u+3; float4s past the row's width are not touched
  const int vecs = sh_width / 4;
  const int units = (vecs + 2) / 3;
  const float4* src = reinterpret_cast<const float4*>(sh) + (size_t)first * vecs;
  float4* dst = reinterpret_cast<float4*>(d_sh) + (size_t)first * vecs;
  for (int q = r; q < rows * units; q += kThreads) {
    const int row = q / units;
    const int u = q - row * units;
    const int v0 = 3 * u;
    const int nv = min(3, vecs - v0);
    float s[12];
    if (4 * u < S::kCoeffs) {
      for (int v = 0; v < 3; ++v) {
        const float4 w = v < nv ? __ldg(src + (size_t)row * vecs + v0 + v) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        s[4 * v] = w.x;
        s[4 * v + 1] = w.y;
        s[4 * v + 2] = w.z;
        s[4 * v + 3] = w.w;
      }
    }
    const float g0 = s_g[3 * row], g1 = s_g[3 * row + 1], g2 = s_g[3 * row + 2];
    float o[12];
    float* f = s_f + row * S::kStride;
    for (int m = 0; m < 4; ++m) {
      const int j = 4 * u + m;
      if (j < S::kCoeffs) {
        const float fj = f[j];
        f[j] = (g0 * s[3 * m] + g1 * s[3 * m + 1]) + g2 * s[3 * m + 2];
        o[3 * m] = d_sh_entry<S::kCoeffs>(fj, g0);
        o[3 * m + 1] = d_sh_entry<S::kCoeffs>(fj, g1);
        o[3 * m + 2] = d_sh_entry<S::kCoeffs>(fj, g2);
      } else {
        o[3 * m] = o[3 * m + 1] = o[3 * m + 2] = 0.0f;
      }
    }
    for (int v = 0; v < nv; ++v)
      dst[(size_t)row * vecs + v0 + v] = make_float4(o[4 * v], o[4 * v + 1], o[4 * v + 2], o[4 * v + 3]);
  }
  __syncthreads();

  if (r >= rows) return;
  const float* df = s_f + r * S::kStride;
  float dY[16];
  if constexpr (S::k4d) {
    float dT[3] = {0.0f, 0.0f, 0.0f};
    for (int k = 0; k < 16; ++k) {
      dY[k] = (df[k] * in.t[0] + df[16 + k] * in.t[1]) + df[32 + k] * in.t[2];
      for (int b = 1; b < 3; ++b) dT[b] += df[16 * b + k] * y[k];
    }
    // d cos(a)/da = -sin(a), a = 2 pi b theta
    const float dtheta = (dT[1] * -sinf(in.arg[1])) * kTwoPi + (dT[2] * -sinf(in.arg[2])) * kFourPi;
    d_dir_t[i] = dtheta / __ldg(duration);
  } else {
    for (int k = 0; k < S::kBasis; ++k) dY[k] = df[k];
  }
  float d[3];
  sh_basis_grad<S::kDeg>(in.x, in.y, in.z, dY, d);
  for (int c = 0; c < 3; ++c) d_dir[3 * i + c] = d[c];
}

bool aligned(const void* p, uintptr_t bytes) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0; }

// the widths a kind takes: a row holds its evaluated coefficients, in whole float4s
bool valid(int kind, int sh_width, const void* dir_t, const void* duration) {
  if (kind < 0 || kind > 4 || sh_width % 4 != 0) return false;
  const int coeffs = kind == 4 ? 48 : (kind + 1) * (kind + 1);
  return sh_width >= 3 * coeffs && (kind == 4) == (dir_t != nullptr) && (kind == 4) == (duration != nullptr);
}

}  // namespace

// dir: [N, 3]; dir_t: [N] (4D, else null); duration: a float32 on the card
// (4D, else null); sh: [N, sh_width], 16-byte aligned; rgb: [N, 3].
// kind: 0-3 a 3D row evaluated through that degree, 4 a 4D row.
// Returns a cudaError_t.
extern "C" int bgs_sh_forward(const void* dir, const void* dir_t, const void* duration, const void* sh, int n,
                              int sh_width, int kind, void* rgb, void* stream) {
  if (!aligned(sh, 16)) return (int)cudaErrorMisalignedAddress;
  if (!valid(kind, sh_width, dir_t, duration)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
#define BGS_ARGS \
  (const float*)dir, (const float*)dir_t, (const float*)duration, (const float*)sh, n, sh_width, (float*)rgb
  switch (kind) {
    case 0: sh_fwd_kernel<0><<<blocks, kThreads, 0, s>>>(BGS_ARGS); break;
    case 1: sh_fwd_kernel<1><<<blocks, kThreads, 0, s>>>(BGS_ARGS); break;
    case 2: sh_fwd_kernel<2><<<blocks, kThreads, 0, s>>>(BGS_ARGS); break;
    case 3: sh_fwd_kernel<3><<<blocks, kThreads, 0, s>>>(BGS_ARGS); break;
    default: sh_fwd_kernel<4><<<blocks, kThreads, 0, s>>>(BGS_ARGS); break;
  }
#undef BGS_ARGS
  return (int)cudaGetLastError();
}

// As bgs_sh_forward, with grad: d_rgb [N, 3]; writes d_sh [N, sh_width]
// (16-byte aligned) whole, d_dir [N, 3] and, in 4D, d_dir_t [N].
extern "C" int bgs_sh_backward(const void* dir, const void* dir_t, const void* duration, const void* sh,
                               const void* grad, int n, int sh_width, int kind, void* d_sh, void* d_dir,
                               void* d_dir_t, void* stream) {
  if (!(aligned(sh, 16) && aligned(d_sh, 16))) return (int)cudaErrorMisalignedAddress;
  if (!valid(kind, sh_width, dir_t, duration) || (kind == 4) != (d_dir_t != nullptr))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
#define BGS_ARGS                                                                                               \
  (const float*)dir, (const float*)dir_t, (const float*)duration, (const float*)sh, (const float*)grad, n, \
      sh_width, (float*)d_sh, (float*)d_dir, (float*)d_dir_t
  switch (kind) {
    case 0: sh_bwd_kernel<0><<<blocks, kThreads, 0, s>>>(BGS_ARGS); break;
    case 1: sh_bwd_kernel<1><<<blocks, kThreads, 0, s>>>(BGS_ARGS); break;
    case 2: sh_bwd_kernel<2><<<blocks, kThreads, 0, s>>>(BGS_ARGS); break;
    case 3: sh_bwd_kernel<3><<<blocks, kThreads, 0, s>>>(BGS_ARGS); break;
    default: sh_bwd_kernel<4><<<blocks, kThreads, 0, s>>>(BGS_ARGS); break;
  }
#undef BGS_ARGS
  return (int)cudaGetLastError();
}
