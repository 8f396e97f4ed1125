// Pair expansion: slot -> (tile id, cloud index, depth rank).
//
// Replaces the TPU kernel bevy_gaussian_splatting_tpu/ops/pallas/expand.py
// `_expand_kernel` (launched by `pallas_expand_pairs`).  Gaussians arrive in
// front-to-back depth order with their inclusive pair counts `cum`; slot s
// belongs to owner = #{r : cum[r] <= s} and is the k-th tile of the owner's
// tile rectangle, k = s - cum[owner - 1]:
//
//   tile    = (ty0[owner] + k / w) * tx_count + tx0[owner] + k % w,
//             w = max(rect_w[owner], 1)
//   g_cloud = perm[owner]
//   rank    = owner
//
// Slots at or past total = cum[n - 1] get the sentinel tile, cloud index 0
// and rank n.
//
// Bound on the H100: memory.  Each slot writes 12 bytes and each owner's
// five table words are read; the arithmetic is a few integer operations a
// slot.  Design: a block owns kSlots consecutive slots, four a thread.
//   1. Two warps find the owners of the block's first and last pair-holding
//      slot, each by a 32-way search over `cum` (a ballot per level: four
//      dependent loads at n = 1M, where a binary search takes twenty).  A
//      table of at most kWindow ranks (the convergence protocol's hundreds)
//      is staged whole instead: no search, one round trip.
//   2. The block stages that owner window (cum, rect_w, tx0, ty0, perm) into
//      shared memory with coalesced loads.  The binning puts its zero-count
//      (inactive) ranks first and caps the rest at the tail, so past the
//      first owner every rank owns a slot and the window holds at most
//      kSlots ranks (the TPU kernel's windowing argument, expand.py:8-13).
//   3. Each thread searches its first slot's owner in the staged window,
//      walks its next three slots forward, and writes each output as one
//      16-byte store of four slots.
// A window longer than kWindow (interior runs of zero-count ranks, which a
// caller other than the binning may pass) takes a slower path in the same
// kernel: each slot searches `cum` in device memory between the two owners.
// Blocks wholly at or past the total only store the sentinel fill.  The
// TPU kernel's windowed comparison, one-hot MXU gather, byte splitting and
// f32 table existed only because the MXU casts to bf16; none of it is
// needed here.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;  // consecutive slots a thread, int4 stores of four
constexpr int kSlots = kThreads * kPerThread;  // slots a block
constexpr int kWindow = kSlots;  // ranks a block stages

// First r in [lo, hi] with cum[r] > s, given cum[hi] > s, by the whole warp:
// each level probes 32 points and keeps the span below the first that
// holds.  Warp-uniform arguments.
__device__ int warp_upper_bound(const int* __restrict__ cum, int lo, int hi, int s) {
  const int lane = threadIdx.x & 31;
  while (lo < hi) {
    const int step = (hi - lo + 32) / 32;  // ceil((hi - lo + 1) / 32)
    const int probe = min(lo + (lane + 1) * step - 1, hi);  // lane 31 probes hi
    const unsigned holds = __ballot_sync(0xffffffffu, __ldg(cum + probe) > s);
    const int first = __ffs(holds) - 1;
    hi = min(lo + (first + 1) * step - 1, hi);
    lo += first * step;
  }
  return lo;
}

// First r in [lo, hi] with cum[r] > s, given cum[hi] > s, by one thread.
__device__ int upper_bound(const int* cum, int lo, int hi, int s) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (cum[mid] <= s) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ __forceinline__ int tile_of(int k, int w, int tx, int ty, int tx_count) {
  const int row = k / w;
  return (ty + row) * tx_count + tx + (k - row * w);
}

__global__ void __launch_bounds__(kThreads)
expand_pairs_kernel(const int* __restrict__ cum, const int* __restrict__ rect_w, const int* __restrict__ tx0,
                    const int* __restrict__ ty0, const int* __restrict__ perm, int n, int p_max, int tx_count,
                    int sentinel, int* __restrict__ tile, int* __restrict__ g_cloud, int* __restrict__ rank) {
  // s_cum[i] = cum[o0 + i - 1] (the slots before rank o0 + i), the rest at
  // [i] = rank o0 + i
  __shared__ int s_cum[kWindow + 1];
  __shared__ int s_w[kWindow];
  __shared__ int s_tx[kWindow];
  __shared__ int s_ty[kWindow];
  __shared__ int s_perm[kWindow];
  __shared__ int s_owner[2];

  const int b0 = blockIdx.x * kSlots;
  const int s0 = b0 + threadIdx.x * kPerThread;
  const int total = n > 0 ? __ldg(cum + n - 1) : 0;
  const int live = min(min(b0 + kSlots, p_max), total);  // the block's pairs are [b0, live)
  int t[kPerThread], g[kPerThread], r[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    t[j] = sentinel;
    g[j] = 0;
    r[j] = n;
  }

  if (b0 < live) {  // block-uniform: the block holds pairs
    int o0 = 0;  // the window [o0, o1]: every rank of a small table
    int o1 = n - 1;
    if (n > kWindow) {  // grid-uniform
      const int warp = threadIdx.x >> 5;
      if (warp < 2) {
        const int o = warp_upper_bound(cum, 0, n - 1, warp == 0 ? b0 : live - 1);
        if ((threadIdx.x & 31) == 0) s_owner[warp] = o;
      }
      __syncthreads();
      o0 = s_owner[0];
      o1 = s_owner[1];
    }
    const int len = o1 - o0 + 1;
    if (len <= kWindow) {  // block-uniform: stage the window
      for (int i = threadIdx.x; i < len; i += kThreads) {
        s_cum[i + 1] = __ldg(cum + o0 + i);
        s_w[i] = max(__ldg(rect_w + o0 + i), 1);
        s_tx[i] = __ldg(tx0 + o0 + i);
        s_ty[i] = __ldg(ty0 + o0 + i);
        s_perm[i] = __ldg(perm + o0 + i);
      }
      if (threadIdx.x == 0) s_cum[0] = o0 > 0 ? __ldg(cum + o0 - 1) : 0;
      __syncthreads();
      if (s0 < live) {
        // s_cum[len] = cum[o1] > live - 1 >= s0 bounds the search (o1 owns
        // slot live - 1 or is the last rank)
        int i = upper_bound(s_cum + 1, 0, len - 1, s0);
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) {
          const int s = s0 + j;
          if (s < live) {
            while (s_cum[i + 1] <= s) ++i;
            t[j] = tile_of(s - s_cum[i], s_w[i], s_tx[i], s_ty[i], tx_count);
            g[j] = s_perm[i];
            r[j] = o0 + i;
          }
        }
      }
    } else {
      // a window too long to stage: search device memory between the two
      // owners, slot by slot
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int s = s0 + j;
        if (s < live) {
          const int o = upper_bound(cum, o0, o1, s);
          const int k = s - (o > 0 ? __ldg(cum + o - 1) : 0);
          t[j] = tile_of(k, max(__ldg(rect_w + o), 1), __ldg(tx0 + o), __ldg(ty0 + o), tx_count);
          g[j] = __ldg(perm + o);
          r[j] = o;
        }
      }
    }
  }

#pragma unroll
  for (int q = 0; q < kPerThread; q += 4) {
    const int s = s0 + q;
    if (s + 4 <= p_max) {  // the outputs are 16-byte aligned (bgs_expand_pairs checks)
      *reinterpret_cast<int4*>(tile + s) = make_int4(t[q], t[q + 1], t[q + 2], t[q + 3]);
      *reinterpret_cast<int4*>(g_cloud + s) = make_int4(g[q], g[q + 1], g[q + 2], g[q + 3]);
      *reinterpret_cast<int4*>(rank + s) = make_int4(r[q], r[q + 1], r[q + 2], r[q + 3]);
    } else {
#pragma unroll
      for (int j = q; j < q + 4; ++j) {
        if (s0 + j < p_max) {
          tile[s0 + j] = t[j];
          g_cloud[s0 + j] = g[j];
          rank[s0 + j] = r[j];
        }
      }
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" int bgs_expand_pairs(const void* cum, const void* rect_w, const void* tx0, const void* ty0,
                                const void* perm, int n, int p_max, int tx_count, int sentinel, void* tile,
                                void* g_cloud, void* rank, void* stream) {
  if (!(aligned16(tile) && aligned16(g_cloud) && aligned16(rank))) return (int)cudaErrorMisalignedAddress;
  if (p_max > 0) {
    const int blocks = (int)(((long long)p_max + kSlots - 1) / kSlots);
    expand_pairs_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)cum, (const int*)rect_w, (const int*)tx0, (const int*)ty0, (const int*)perm, n, p_max,
        tx_count, sentinel, (int*)tile, (int*)g_cloud, (int*)rank);
  }
  return (int)cudaGetLastError();
}
