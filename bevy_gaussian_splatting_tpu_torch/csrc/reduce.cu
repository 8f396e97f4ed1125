// Segmented gradient reduce: per-pair gradient rows in expansion-slot order
// -> per-depth-rank totals.
//
// Replaces the TPU kernel bevy_gaussian_splatting_tpu/ops/pallas/reduce.py
// `_reduce_kernel` (launched by `pallas_segment_reduce`).
//
// Inputs: dslot [P, cols] f32, the backward's per-pair gradients reordered to
// expansion-slot order (cols = 10 for OBB / AABB rows, 16 for 2DGS); cum [N]
// i32, the inclusive pair counts in depth order, clamped at P.  Depth rank r
// owns the contiguous slots [cum[r-1], cum[r]) (cum[-1] = 0).  Output drank
// [N, cols] f32; a rank with no slots gets 0.
//
// The TPU kernel's one-hot MXU matmul, 512-slot windows, chunk owners and
// straddle merge exist because its grid runs in order on one core.  Here one
// thread owns one (rank, column) and sums its slots in slot order: no
// atomics, deterministic, and bit-equal to the plain version
// (ops/cuda/reduce.py), which adds in the same order.  The column count is an
// argument: the threads of a rank read its rows as contiguous runs of
// 4 * cols bytes whatever the width.
//
// Bound on the H100: bytes.  Each owned slot row (4 * cols B) is read once
// and each output row written once; one add per value read.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
segment_reduce_kernel(const float* __restrict__ dslot, const int* __restrict__ cum, int n, int cols,
                      float* __restrict__ drank) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)n * cols) return;
  const int r = (int)(i / cols);
  const int col = (int)(i - (long long)r * cols);
  const int s0 = r > 0 ? cum[r - 1] : 0;
  const int s1 = cum[r];
  float acc = 0.0f;
  for (int s = s0; s < s1; ++s) acc += dslot[(long long)s * cols + col];
  drank[i] = acc;
}

}  // namespace

extern "C" int bgs_segment_reduce(const void* dslot, const void* cum, int n, int cols, void* drank,
                                  void* stream) {
  if (cols <= 0) return (int)cudaErrorInvalidValue;
  const long long threads = (long long)n * cols;
  if (threads > 0) {
    const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
    segment_reduce_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)dslot, (const int*)cum, n, cols, (float*)drank);
  }
  return (int)cudaGetLastError();
}
