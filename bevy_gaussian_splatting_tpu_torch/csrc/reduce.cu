// Segmented gradient reduce: per-pair gradient rows in expansion-slot order
// -> per-depth-rank totals.
//
// Replaces the TPU kernel bevy_gaussian_splatting_tpu/ops/pallas/reduce.py
// `_reduce_kernel` (launched by `pallas_segment_reduce`).
//
// Inputs: dslot [P, cols] f32, the backward's per-pair gradients reordered to
// expansion-slot order (cols = 10 for OBB / AABB rows, 16 for 2DGS, 23 for
// 2DGS with the surface maps); cum [N]
// i32, the inclusive pair counts in depth order, clamped at P.  Depth rank r
// owns the contiguous slots [cum[r-1], cum[r]) (cum[-1] = 0).  Output drank
// [N, cols] f32; a rank with no slots gets 0.
//
// Each (rank, column) sums its slots in slot order from 0.0f: no atomics, no
// tree, deterministic, and bit-equal to the plain version
// (ops/cuda/reduce.py), which adds in the same order.  The TPU kernel's
// one-hot MXU matmul, 512-slot windows, chunk owners and straddle merge exist
// because its grid runs in order on one core; none of it is needed here.
//
// Bound on the H100: bytes.  Each owned slot row (4 * cols B) is read once
// and each output row written once; one add per value read.  Segments are
// short (about 1.5 slots a rank on the bench scene), so a thread per (rank,
// column) reading device memory directly spends its time on loop overhead
// and on 40-byte rows that straddle 32-byte sectors.  Design: a block owns
// up to kRanks consecutive ranks, whose slots form one contiguous run of
// dslot; below kRanks * kMinBlocks ranks it owns fewer, so that a small
// problem still spreads over the SMs, but never so few that a thread has
// less than one (rank, column).  A grid whose blocks give each thread at most
// one (the convergence protocol's 192 or 512 ranks) sums from device memory
// directly: for one sum a thread, staging only adds a round trip.  Else:
//   1. The block stages the ranks' bounds, then copies their run into
//      shared memory with 16-byte asynchronous copies (cp.async); a head and
//      a tail that are not 16-byte aligned (a 10-column run starting at an
//      odd slot) go by 4-byte loads.
//   2. Each thread sums (rank, column)s from shared memory, in slot order,
//      and the block writes its [ranks, cols] output as one coalesced run.
// The kernel is templated on the column count (10, 16 and 23; 0 takes it
// from the argument), so rows are indexed by constants.  A run longer than the
// staging buffer (the 4DGS scene's larger splats: 128 ranks of up to 6
// pairs at 1920x1080) is staged in windows of whole ranks, one after the
// other, each as long as the buffer allows; a rank longer than the buffer
// alone (thousands of slots) is summed from device memory in the same
// order, giving the same bits.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRanks = 128;  // most ranks a block owns
constexpr int kMinBlocks = 264;  // blocks below which a block owns fewer ranks: two an SM
constexpr int kStage = 6144;  // floats of a block's staged run (24 KB)

// kBlocksPerSm resident blocks: 32 registers a thread (the staged buffer
// allows 9 blocks).  Left free, the compiler took 40 for the window loop and
// the kernel lost 4-5% on the 3D bench scene at 6 blocks an SM.
constexpr int kBlocksPerSm = 8;

template <int kCols>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
segment_reduce_kernel(const float* __restrict__ dslot, const int* __restrict__ cum, int n, int cols_arg,
                      int ranks, float* __restrict__ drank) {
  // s_cum[i] = cum[r0 + i - 1]: rank r0 + i owns slots [s_cum[i], s_cum[i + 1])
  __shared__ int s_cum[kRanks + 1];
  __shared__ __align__(16) float s_rows[kStage];
  const int cols = kCols > 0 ? kCols : cols_arg;
  const int r0 = blockIdx.x * ranks;
  const int nr = min(ranks, n - r0);
  float* out = drank + (long long)r0 * cols;
  if (ranks * cols <= kThreads) {  // grid-uniform: a (rank, column) a thread, from device memory
    if ((int)threadIdx.x < nr * cols) {
      const int i = threadIdx.x / cols;
      const int a = r0 + i > 0 ? __ldg(cum + r0 + i - 1) : 0;
      const int b = __ldg(cum + r0 + i);
      const float* row = dslot + ((long long)a * cols + (threadIdx.x - i * cols));
      float acc = 0.0f;
      for (int s = a; s < b; ++s, row += cols) acc += __ldg(row);
      out[threadIdx.x] = acc;
    }
    return;
  }
  for (int i = threadIdx.x; i <= nr; i += kThreads) s_cum[i] = r0 + i > 0 ? __ldg(cum + r0 + i - 1) : 0;
  __syncthreads();

  // windows of whole ranks [i0, i1) whose run, from the 16-byte aligned
  // float at or below its start, fits the buffer: one window where the
  // block's whole run fits (and one, empty, for a run of no slots); no sum
  // spans two windows.  A rank longer than the buffer alone is summed from
  // device memory, in the same slot order.
  int i0 = 0;
  do {
    const long long g0 = (long long)s_cum[i0] * cols;
    const long long wb = g0 - (long long)((reinterpret_cast<std::uintptr_t>(dslot + g0) & 15) >> 2);
    int i1 = nr;
    if ((long long)s_cum[nr] * cols - wb > kStage) {  // block-uniform: the last rank end whose run fits
      int lo = i0, hi = nr - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if ((long long)s_cum[mid] * cols - wb <= kStage) lo = mid; else hi = mid - 1;
      }
      i1 = lo;
    }
    if (i1 == i0) {  // rank i0 alone passes the buffer
      for (int c = threadIdx.x; c < cols; c += kThreads) {
        const float* row = dslot + (g0 + c);
        float acc = 0.0f;
        for (int s = s_cum[i0]; s < s_cum[i0 + 1]; ++s, row += cols) acc += __ldg(row);
        out[i0 * cols + c] = acc;
      }
      ++i0;
      continue;
    }
    const long long w1 = (long long)s_cum[i1] * cols;
    const long long head = min(wb == g0 ? g0 : wb + 4, w1);  // the first aligned float at or past g0
    const long long body = head + ((w1 - head) & ~3LL);  // aligned run [head, body)
    for (long long f = g0 + threadIdx.x; f < head; f += kThreads) s_rows[f - wb] = __ldg(dslot + f);
    for (long long f = body + threadIdx.x; f < w1; f += kThreads) s_rows[f - wb] = __ldg(dslot + f);
    for (long long f = head + 4LL * threadIdx.x; f < body; f += 4LL * kThreads) {
      __pipeline_memcpy_async(s_rows + (f - wb), dslot + f, 16);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    for (int o = i0 * cols + threadIdx.x; o < i1 * cols; o += kThreads) {
      const int i = o / cols;
      const int c = o - i * cols;
      const float* row = s_rows + ((long long)s_cum[i] * cols + c - wb);
      float acc = 0.0f;
      for (int s = s_cum[i]; s < s_cum[i + 1]; ++s, row += cols) acc += *row;
      out[o] = acc;
    }
    __syncthreads();  // the next window overwrites the staged rows
    i0 = i1;
  } while (i0 < nr);
}

template <int kCols>
void launch(const float* dslot, const int* cum, int n, int cols, float* drank, cudaStream_t stream) {
  // n > 0 and cols > 0: at least one rank
  const int ranks = min(kRanks, max((n + kMinBlocks - 1) / kMinBlocks, max(kThreads / cols, 1)));
  const int blocks = (n + ranks - 1) / ranks;
  segment_reduce_kernel<kCols><<<blocks, kThreads, 0, stream>>>(dslot, cum, n, cols, ranks, drank);
}

}  // namespace

extern "C" int bgs_segment_reduce(const void* dslot, const void* cum, int n, int cols, void* drank,
                                  void* stream) {
  if (cols <= 0) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<std::uintptr_t>(dslot) & 3) return (int)cudaErrorMisalignedAddress;
  if (n > 0) {
    const float* d = (const float*)dslot;
    float* out = (float*)drank;
    const cudaStream_t s = (cudaStream_t)stream;
    if (cols == 10) {
      launch<10>(d, (const int*)cum, n, cols, out, s);
    } else if (cols == 16) {
      launch<16>(d, (const int*)cum, n, cols, out, s);
    } else if (cols == 23) {
      launch<23>(d, (const int*)cum, n, cols, out, s);
    } else {
      launch<0>(d, (const int*)cum, n, cols, out, s);
    }
  }
  return (int)cudaGetLastError();
}
