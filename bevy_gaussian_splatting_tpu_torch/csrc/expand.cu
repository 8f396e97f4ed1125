// Pair expansion: slot -> (tile id, cloud index, depth rank).
//
// Replaces the TPU kernel bevy_gaussian_splatting_tpu/ops/pallas/expand.py
// `_expand_kernel` (launched by `pallas_expand_pairs`).  Gaussians arrive in
// front-to-back depth order with their inclusive pair counts `cum`; slot s
// belongs to owner = #{r : cum[r] <= s} and is the k-th tile of the owner's
// tile rectangle, k = s - cum[owner - 1]:
//
//   tile    = (ty0[owner] + k / w[owner]) * tx_count + tx0[owner] + k % w[owner]
//   g_cloud = perm[owner]
//   rank    = owner
//
// Slots at or past total = cum[n - 1] get the sentinel tile, cloud index 0
// and rank n.
//
// Bound on the H100: memory.  Each slot writes 12 bytes and the search reads
// log2(n) words of `cum`; all arithmetic is integer and small.  Design: one
// thread per slot, int32 throughout, a binary search (upper bound) over
// `cum`.  The TPU kernel's windowed comparison, one-hot MXU gather, byte
// splitting and f32 table existed only because the MXU casts to bf16; none
// of it is needed here.  The top levels of the search hit the same few
// words in every thread and stay in L1/L2.

#include <cuda_runtime.h>

namespace {

__global__ void expand_pairs_kernel(const int* __restrict__ cum,
                                    const int* __restrict__ rect_w,
                                    const int* __restrict__ tx0,
                                    const int* __restrict__ ty0,
                                    const int* __restrict__ perm, int n,
                                    int p_max, int tx_count, int sentinel,
                                    int* __restrict__ tile,
                                    int* __restrict__ g_cloud,
                                    int* __restrict__ rank) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= p_max) return;
  const int total = n > 0 ? cum[n - 1] : 0;
  if (s >= total) {
    tile[s] = sentinel;
    g_cloud[s] = 0;
    rank[s] = n;
    return;
  }
  // first r with cum[r] > s; exists because cum[n - 1] = total > s
  int lo = 0;
  int hi = n - 1;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(cum + mid) <= s) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int owner = lo;
  const int k = s - (owner > 0 ? cum[owner - 1] : 0);
  const int w = rect_w[owner];
  tile[s] = (ty0[owner] + k / w) * tx_count + tx0[owner] + k % w;
  g_cloud[s] = perm[owner];
  rank[s] = owner;
}

}  // namespace

extern "C" int bgs_expand_pairs(const void* cum, const void* rect_w,
                                const void* tx0, const void* ty0,
                                const void* perm, int n, int p_max,
                                int tx_count, int sentinel, void* tile,
                                void* g_cloud, void* rank, void* stream) {
  if (p_max > 0) {
    const int threads = 256;
    const int blocks = (p_max + threads - 1) / threads;
    expand_pairs_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int*)cum, (const int*)rect_w, (const int*)tx0,
        (const int*)ty0, (const int*)perm, n, p_max, tx_count, sentinel,
        (int*)tile, (int*)g_cloud, (int*)rank);
  }
  return (int)cudaGetLastError();
}
