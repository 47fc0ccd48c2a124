// Active-lane compaction shared by the closest-hit kernels K1, K2 and K3.
//
// A disabled lane (maxt <= 0, -inf or NaN) never hits, and on a bounce
// after the first, in the PRB replay and in its shadow tests the active
// lanes lie scattered over the batch. A warp sweeps the whole table (K1,
// K3) or walks as long as the longest walk among its lanes (K2) as soon as
// one of its lanes is active, so a kernel that gives each warp 32
// neighbouring lanes pays for the disabled ones too. Two queues in shared
// memory avoid that:
//
// - Queue/gather (K1, K3): a block takes a chunk of kThreads * kPerThread
//   lanes, writes the miss (t = inf, prim = -1, u = v = 0) to each disabled
//   one, and gathers the active ones into a queue, in lane order, so that
//   its warps then sweep dense groups of active rays. Every ray of a sweep
//   costs the same, so the block's barriers cost little.
// - WarpQueue/refill (K2): each warp takes 32 lanes of the batch at a time
//   from a counter in device memory, writes the miss to the disabled ones
//   (t = their own maxt, K2's contract) and queues the active ones, and
//   hands them to its lanes as their rays end. A BVH walk's length varies
//   from ray to ray; without a barrier no warp waits for another, and a
//   lane whose walk ended takes the next ray at once.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace active_queue {

template <int kThreads, int kPerThread>
struct Queue {
  static constexpr int kChunk = kThreads * kPerThread;
  static constexpr int kSlots = kPerThread * (kThreads / 32);
  static_assert(kThreads % 32 == 0 && kSlots <= 32, "one warp scans the slot counts");
  int idx[kChunk];      // lane index of each queued ray
  float maxt[kChunk];   // its maxt, the starting best t
  int offset[32];       // per (round, warp) slot: its first queue position
  int count;            // queued rays
};

// Fills `q` with the active lanes of [base, base + kChunk) and writes the
// miss to the disabled ones; returns the number of active lanes. Every
// thread of the block must call it; it begins and ends with a barrier, so
// that the queue of the previous chunk is no longer being read when it is
// overwritten, and the new one is complete when it returns.
template <int kThreads, int kPerThread>
__device__ __forceinline__ int gather(Queue<kThreads, kPerThread>& q,
                                      const float* __restrict__ maxt,
                                      long long base, int n,
                                      float* __restrict__ t_out,
                                      int* __restrict__ p_out,
                                      float* __restrict__ u_out,
                                      float* __restrict__ v_out) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float mt[kPerThread];
  unsigned mask[kPerThread];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const long long i = base + j * kThreads + threadIdx.x;
    const bool in_range = i < n;
    mt[j] = in_range ? maxt[i] : -1.f;
    const bool active = mt[j] > 0.f;
    mask[j] = __ballot_sync(0xffffffffu, active);
    if (lane == 0) q.offset[j * kWarps + warp] = __popc(mask[j]);
    if (in_range && !active) {
      t_out[i] = CUDART_INF_F;
      p_out[i] = -1;
      u_out[i] = 0.f;
      v_out[i] = 0.f;
    }
  }
  __syncthreads();
  if (warp == 0) {
    // exclusive scan of the slot counts, slots in lane order
    const int c = lane < Queue<kThreads, kPerThread>::kSlots ? q.offset[lane] : 0;
    int x = c;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, s);
      if (lane >= s) x += y;
    }
    if (lane < Queue<kThreads, kPerThread>::kSlots) q.offset[lane] = x - c;
    if (lane == 31) q.count = x;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    if (mask[j] >> lane & 1u) {
      const int pos = q.offset[j * kWarps + warp] + __popc(mask[j] & below);
      q.idx[pos] = static_cast<int>(base + j * kThreads + threadIdx.x);
      q.maxt[pos] = mt[j];
    }
  }
  __syncthreads();
  return q.count;
}

// One warp's queue of active lanes, in shared memory. Its count and whether
// the batch is exhausted live in the warp's registers (WarpCursor), the same
// in every lane.
struct WarpQueue {
  // a fetch of 32 lanes happens only while fewer than 32 are queued
  static constexpr int kCapacity = 64;
  int idx[kCapacity];
  float maxt[kCapacity];
};

struct WarpCursor {
  int count = 0;
  bool exhausted = false;
};

// Gives each idle lane (a bit of `idle`) the next queued active lane: for
// each one that gets a ray it returns true and sets `i` (the lane index)
// and `mt` (its maxt). Until the queue holds a ray for every idle lane, the
// warp takes the next 32 positions [p, p + 32) of the batch from `counter`
// (zeroed before the launch, shared by all warps), writes the miss to the
// disabled lanes (t = the lane's own maxt bit for bit, as K2's contract
// has it, prim = -1, u = v = 0) and queues the active ones. Every lane of
// the warp must call it.
__device__ __forceinline__ bool refill(WarpQueue& q, WarpCursor& c, unsigned idle,
                                       unsigned* __restrict__ counter,
                                       const float* __restrict__ maxt, int n,
                                       float* __restrict__ t_out, int* __restrict__ p_out,
                                       float* __restrict__ u_out, float* __restrict__ v_out,
                                       int& i, float& mt) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int need = __popc(idle);
  while (c.count < need && !c.exhausted) {
    unsigned base = 0;
    if (lane == 0) base = atomicAdd(counter, 32u);
    base = __shfl_sync(0xffffffffu, base, 0);
    if (base >= static_cast<unsigned>(n)) {
      c.exhausted = true;
      break;
    }
    const long long pos = static_cast<long long>(base) + lane;
    const bool in_range = pos < n;
    const int j = static_cast<int>(pos);
    const float m = in_range ? maxt[j] : -1.f;
    const bool active = m > 0.f;
    const unsigned mask = __ballot_sync(0xffffffffu, active);
    if (in_range && !active) {
      t_out[j] = m;
      p_out[j] = -1;
      u_out[j] = 0.f;
      v_out[j] = 0.f;
    }
    if (active) {
      q.idx[c.count + __popc(mask & below)] = j;
      q.maxt[c.count + __popc(mask & below)] = m;
    }
    c.count += __popc(mask);
    __syncwarp();
  }
  // the idle lanes take the newest rays, the last `take` of the queue
  const int take = min(need, c.count);
  const int rank = __popc(idle & below);
  const bool got = (idle >> lane & 1u) && rank < take;
  if (got) {
    i = q.idx[c.count - take + rank];
    mt = q.maxt[c.count - take + rank];
  }
  c.count -= take;
  __syncwarp();
  return got;
}

// Blocks for a persistent grid: as many as fit on the card at once, but no
// more than there are chunks. Returns a CUDA error code, 0 on success.
template <typename Kernel>
inline int persistent_blocks(Kernel kernel, int threads, size_t smem,
                             long long chunks, int* blocks) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long most = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  *blocks = static_cast<int>(chunks < most ? chunks : most);
  return 0;
}

}  // namespace active_queue
