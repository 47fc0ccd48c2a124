// Closest-hit and any-hit of rays over a threaded wide-leaf BVH (kernel K2).
//
// Replaces the TPU kernel mitsuba_tpu/ops/bvh_sweep.py:_kernel (launched by
// _pallas_bvh_sweep, entries bvh_sweep_intersect and bvh_sweep_occluded).
// Contract (see ops/bvh_sweep.py):
//   nodes [M, 8] float32: box lo (0-2), hi (3-5), then two int32 stored
//   bitwise: the skip link (6; -1 ends the walk) and the leaf payload
//   start << 8 | count (7; 0 for an internal node), in DFS order;
//   rows [T, 12] float32: the triangle table's rows (v0 | e1 | e2) in leaf
//   order, each padded with 3 zeros to 48 bytes (built once per geometry
//   by the caller); o, d [N, 3]; maxt [N], maxt <= 0 (or -inf, or NaN)
//   disabling a lane.
//   Out: t [N] (maxt on a miss, bit for bit), prim [N] int32 (-1 on a
//   miss), u, v [N].
//
// What bounds it on an H100: by its bound, operations. Each lane reads its
// ray (28 B; 4 B when disabled) and writes 16 B, and the tables are read
// once (7.3 MB of triangles, 32 B a node for the 202,800-triangle mesh);
// the work is a slab test (23 fp32 operations) per node visit and a
// Moller-Trumbore test per leaf triangle (14, 24 or 46 operations with the
// early stops below), tens of visits and tests per ray, so the operations
// outweigh the bytes by two orders. In practice it is held by latency and
// divergence: each step of a walk is a dependent load of a node, then of
// up to 64 leaf rows, and the lanes of a warp walk walks of different
// lengths through different leaves.
//
// Design:
// - Active-lane queue per warp (active_queue.cuh: WarpQueue, refill). Each
//   warp takes 32 lanes of the batch at a time from a counter in device
//   memory, writes the miss to the disabled ones and queues the active
//   ones in shared memory. A lane whose ray ended takes the next queued ray
//   at once, so a warp stays full of live rays on scattered batches and
//   no lane waits for the longest walk of its group; the grid is
//   persistent (sized from the occupancy API) and has no block barrier.
// - While-while walk (Aila and Laine, "Understanding the Efficiency of Ray
//   Traversal on GPUs", HPG 2009): a round walks internal nodes until the
//   lane's next leaf box is hit (or its walk ends), and only then tests
//   that leaf, so the lanes of a warp test their leaves together instead
//   of one after another. The walk itself is unchanged: stackless, on a
//   box hit an internal node descends to node + 1, otherwise the walk goes
//   to the skip link; a node is two float4 loads through the read-only
//   path (__ldg).
// - A leaf row is three 16-byte loads from the padded table.
// - A triangle test stops after det when |det| <= 1e-12 and after u when
//   u < 0, u > 1 or u is NaN (as K1): those terms come first in the hit
//   condition, and u > 1 with v >= 0 gives RN(u + v) >= u > 1, so the
//   skipped v and t could never be used. The template flag kAnyHit ends
//   the walk at the first hit.
// - 128 threads a block, __launch_bounds__(128, 8): ptxas gives 47
//   (closest hit) and 43 (any hit) registers and no spill (the -Xptxas -v
//   report that chip_smoke.py and scripts/torch_bench_bvh.py print).
// Measured and left out (scripts/torch_bench_bvh.py, PERF.md): the
// coherence sort of the JAX package (ray_sort_key and maybe_sort_order in
// ops/bvh_sweep.py). Lane order is already coherent (a warp holds two
// pixels' samples): over a mesh pass's 16 launches the kernel ran no
// faster on batches gathered in the sort's order than in lane order, and
// the key, the sort, the gather and the scatter back cost several times
// the kernel. Not measured: shared-memory staging of the top of the tree,
// a nearest-child-first walk with a stack, another leaf width.
//
// Numerics: the arithmetic is written in the order of the plain PyTorch
// version (ops/bvh_sweep.py:bvh_sweep_reference and
// ops/intersect.py:moller_trumbore), each product and sum rounded on its
// own. Build with -fmad=false and without --use_fast_math, so that no
// product is contracted into an FMA and 1/x is the IEEE quotient; both then
// make the same visits and agree bitwise (prim, t, u, v): each lane's walk
// is the plain walk's, whichever lane and round it runs in.

#include <cuda_runtime.h>

#include "active_queue.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMinBlocks = 8;

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float ix, iy, iz;   // 1 / d, |d| < 1e-12 replaced by +-1e-12
  float bt, bu, bv;
  int bp;
};

__device__ __forceinline__ float guard(float x) {
  return fabsf(x) < 1e-12f ? (x >= 0.f ? 1e-12f : -1e-12f) : x;
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o,
                                        const float* __restrict__ d, int i, float maxt) {
  Ray r;
  r.ox = o[3 * i + 0]; r.oy = o[3 * i + 1]; r.oz = o[3 * i + 2];
  r.dx = d[3 * i + 0]; r.dy = d[3 * i + 1]; r.dz = d[3 * i + 2];
  r.ix = 1.0f / guard(r.dx);
  r.iy = 1.0f / guard(r.dy);
  r.iz = 1.0f / guard(r.dz);
  r.bt = maxt;
  r.bp = -1;
  r.bu = 0.f;
  r.bv = 0.f;
  return r;
}

// Slab test of `node` against the running best t; sets its skip link and
// payload.
__device__ __forceinline__ bool visit(const float4* __restrict__ nodes, int node,
                                      const Ray& r, int& skip, int& payload) {
  const float4 a = __ldg(nodes + 2 * node);       // lo.x lo.y lo.z hi.x
  const float4 b = __ldg(nodes + 2 * node + 1);   // hi.y hi.z skip payload
  const float t0x = (a.x - r.ox) * r.ix, t1x = (a.w - r.ox) * r.ix;
  const float t0y = (a.y - r.oy) * r.iy, t1y = (b.x - r.oy) * r.iy;
  const float t0z = (a.z - r.oz) * r.iz, t1z = (b.y - r.oz) * r.iz;
  const float tmin = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  const float tmax = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  skip = __float_as_int(b.z);
  payload = __float_as_int(b.w);
  return tmax >= fmaxf(tmin, 0.f) && tmin < r.bt;
}

// Rows [start, end) in ascending order against the running best t, strict
// t < best t; true when an any-hit walk found its hit.
template <bool kAnyHit>
__device__ __forceinline__ bool test_leaf(const float4* __restrict__ rows, int start,
                                          int end, Ray& r) {
  for (int k = start; k < end; ++k) {
    const float4 a = __ldg(rows + 3 * k), b = __ldg(rows + 3 * k + 1), c = __ldg(rows + 3 * k + 2);
    const float v0x = a.x, v0y = a.y, v0z = a.z;
    const float e1x = a.w, e1y = b.x, e1z = b.y;
    const float e2x = b.z, e2y = b.w, e2z = c.x;

    // pvec = d x e2
    const float pvx = r.dy * e2z - r.dz * e2y;
    const float pvy = r.dz * e2x - r.dx * e2z;
    const float pvz = r.dx * e2y - r.dy * e2x;
    const float det = e1x * pvx + e1y * pvy + e1z * pvz;
    if (!(fabsf(det) > 1e-12f)) continue;
    const float inv_det = 1.0f / det;
    const float tvx = r.ox - v0x;
    const float tvy = r.oy - v0y;
    const float tvz = r.oz - v0z;
    const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
    if (!(u >= 0.f) || u > 1.f) continue;
    // qvec = tvec x e1
    const float qvx = tvy * e1z - tvz * e1y;
    const float qvy = tvz * e1x - tvx * e1z;
    const float qvz = tvx * e1y - tvy * e1x;
    const float v = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * inv_det;
    const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
    if (v >= 0.f && u + v <= 1.f && t > 0.f && t < r.bt) {
      r.bt = t;
      r.bp = k;
      r.bu = u;
      r.bv = v;
      if (kAnyHit) return true;
    }
  }
  return false;
}

// One round of the while-while walk from `node`: internal nodes until a
// leaf box is hit or the walk ends, then that leaf. `node` becomes the next
// node of the walk, -1 at its end.
template <bool kAnyHit>
__device__ __forceinline__ void walk_round(const float4* __restrict__ nodes,
                                           const float4* __restrict__ rows, Ray& r,
                                           int& node) {
  int start = 0, end = 0;
  while (node >= 0) {
    int skip, payload;
    const bool hit = visit(nodes, node, r, skip, payload);
    if (hit && payload == 0) {
      node += 1;
      continue;
    }
    node = skip;
    if (hit) {
      start = payload >> 8;
      end = start + (payload & 0xFF);
      break;
    }
  }
  if (test_leaf<kAnyHit>(rows, start, end, r)) node = -1;
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
bvh_sweep_kernel(const float4* __restrict__ nodes, const float4* __restrict__ rows,
                 const float* __restrict__ o, const float* __restrict__ d,
                 const float* __restrict__ maxt, int n, unsigned* __restrict__ counter, float* __restrict__ t_out,
                 int* __restrict__ p_out, float* __restrict__ u_out,
                 float* __restrict__ v_out) {
  __shared__ active_queue::WarpQueue queues[kThreads / 32];
  active_queue::WarpQueue& q = queues[threadIdx.x >> 5];
  active_queue::WarpCursor cursor;
  int node = -1;   // the lane's next node, -1 when it has no ray walking
  int cur = -1;    // the lane index of its ray
  Ray r;
  for (;;) {
    if (node < 0 && cur >= 0) {
      t_out[cur] = r.bt;
      p_out[cur] = r.bp;
      u_out[cur] = r.bu;
      v_out[cur] = r.bv;
      cur = -1;
    }
    const unsigned idle = __ballot_sync(0xffffffffu, node < 0);
    if (idle) {
      float mt;
      if (active_queue::refill(q, cursor, idle, counter, maxt, n, t_out, p_out, u_out, v_out,
                               cur, mt)) {
        r = load_ray(o, d, cur, mt);
        node = 0;
      }
    }
    // no lane walking after a refill: the queue is empty and the batch done
    if (__ballot_sync(0xffffffffu, node >= 0) == 0) break;
    if (node >= 0) walk_round<kAnyHit>(nodes, rows, r, node);
  }
}

template <bool kAnyHit>
int launch(const float* nodes, const float* rows, const float* o, const float* d,
           const float* maxt, int n, int* counter, float* t_out, int* p_out, float* u_out,
           float* v_out, cudaStream_t stream) {
  auto kernel = bvh_sweep_kernel<kAnyHit>;
  int blocks = 0;
  int rc = active_queue::persistent_blocks(
      kernel, kThreads, 0, (static_cast<long long>(n) + kThreads - 1) / kThreads, &blocks);
  if (rc != 0) return rc;
  rc = static_cast<int>(cudaMemsetAsync(counter, 0, sizeof(int), stream));
  if (rc != 0) return rc;
  kernel<<<blocks, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(nodes), reinterpret_cast<const float4*>(rows), o, d,
      maxt, n, reinterpret_cast<unsigned*>(counter), t_out, p_out, u_out, v_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` (a cudaStream_t) and returns the first CUDA error of
// the set-up or the launch, so that a refused launch reaches the caller.
// `nodes` and `rows` must be 16-byte aligned; `counter` is one int of
// device memory, which the launcher zeroes on the stream.
extern "C" int bvh_sweep_launch(const float* nodes, const float* rows, const float* o,
                                const float* d, const float* maxt, int n, int anyhit,
                                int* counter, float* t_out, int* p_out, float* u_out,
                                float* v_out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  return anyhit ? launch<true>(nodes, rows, o, d, maxt, n, counter, t_out, p_out, u_out,
                               v_out, s)
                : launch<false>(nodes, rows, o, d, maxt, n, counter, t_out, p_out, u_out,
                                v_out, s);
}
