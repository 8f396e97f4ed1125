// Segmented gradient reduce: per-pair gradient rows in expansion-slot order
// -> per-depth-rank totals.
//
// Replaces the TPU kernel bevy_gaussian_splatting_tpu/ops/pallas/reduce.py
// `_reduce_kernel` (launched by `pallas_segment_reduce`).
//
// Inputs: dslot [P, 10] f32, the backward's per-pair gradients reordered to
// expansion-slot order; cum [N] i32, the inclusive pair counts in depth order,
// clamped at P.  Depth rank r owns the contiguous slots [cum[r-1], cum[r])
// (cum[-1] = 0).  Output drank [N, 10] f32; a rank with no slots gets 0.
//
// The TPU kernel's one-hot MXU matmul, 512-slot windows, chunk owners and
// straddle merge exist because its grid runs in order on one core.  Here one
// thread owns one (rank, column) and sums its slots in slot order: no
// atomics, deterministic, and bit-equal to the plain version
// (ops/cuda/reduce.py), which adds in the same order.
//
// Bound on the H100: bytes.  Each owned slot row (40 B) is read once and each
// output row written once; one add per value read.  The ten threads of a rank
// read its rows as contiguous 40-byte runs.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 10;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
segment_reduce_kernel(const float* __restrict__ dslot, const int* __restrict__ cum, int n,
                      float* __restrict__ drank) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)n * kCols) return;
  const int r = (int)(i / kCols);
  const int col = (int)(i - (long long)r * kCols);
  const int s0 = r > 0 ? cum[r - 1] : 0;
  const int s1 = cum[r];
  float acc = 0.0f;
  for (int s = s0; s < s1; ++s) acc += dslot[(long long)s * kCols + col];
  drank[i] = acc;
}

}  // namespace

extern "C" int bgs_segment_reduce(const void* dslot, const void* cum, int n, void* drank,
                                  void* stream) {
  const long long threads = (long long)n * kCols;
  if (threads > 0) {
    const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
    segment_reduce_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)dslot, (const int*)cum, n, (float*)drank);
  }
  return (int)cudaGetLastError();
}
