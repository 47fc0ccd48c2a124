// Brute-force Moller-Trumbore closest hit of rays against a triangle table.
//
// Replaces the TPU kernel mitsuba_tpu/ops/intersect.py:_kernel (launched by
// _pallas_intersect). Contract, the same as the TPU kernel's:
//   table [T, 9] float32 rows (v0 | e1 | e2); o, d [N, 3]; maxt [N].
//   A hit needs |det| > 1e-12, u >= 0, v >= 0, u + v <= 1 and
//   0 < t < best_t, with best_t starting at maxt; triangles are visited in
//   ascending index and the test is strict, so on a tie the first index
//   wins. maxt <= 0 (or -inf, or NaN) disables a lane.
//   Out: t [N] (inf on a miss), prim [N] int32 (-1 on a miss), u, v [N].
//
// What bounds it on an H100: operations. Each active (ray, triangle) pair
// costs 46 fp32 operations (one of them an IEEE reciprocal). Every lane
// reads its maxt (4 B) and writes t, prim, u, v (16 B); only an active lane
// needs its o and d (24 B). One fused launch of the Cornell box with every
// lane active (2N = 8.4 M rays, 36 triangles) is ~13.9 GFLOP, 0.21 ms at
// 67 TFLOP/s, against ~0.37 GB, 0.11 ms at 3.35 TB/s. The early stops
// below leave 14 operations of a pair that fails on det and 24 of one
// that fails on u (~60% of the 46 a pair on the Cornell box; chip_smoke.py
// counts them from each run's inputs). Built with -fmad=false, every
// product and sum is an instruction of its own, so the rate it can reach
// is half the published one (which counts an FMA as 2).
//
// Design:
// - The caller passes the real rows only (render/shapes.py drops the
//   degenerate padding rows, which could never hit).
// - A persistent grid (as many 256-thread blocks as fit on the card) walks
//   the rays in chunks of 1024. Each block gathers a chunk's active lanes
//   into a queue in shared memory (active_queue.cuh) and writes the miss to
//   the disabled ones without a sweep, so its warps sweep dense groups of
//   active rays even where the active lanes lie scattered.
// - The table lives in dynamic shared memory, sized from it, each row as 12
//   floats (three 16-byte broadcast loads). A table of at most 1024 rows is
//   staged once per block; a larger one (at most 4096 rows) is staged in
//   1024-row tiles for each chunk of 256 rays.
// - A pair stops after u when |det| <= 1e-12, u < 0 (or NaN) or u > 1:
//   those terms come first in the hit condition, and u > 1 with v >= 0
//   gives RN(u + v) >= u > 1, so the skipped v and t could never be used.
//
// Numerics: the arithmetic is written in the order of the plain PyTorch
// version (ops/intersect.py:tri_intersect_reference), each product and sum
// rounded on its own. Build with -fmad=false and without --use_fast_math,
// so that no product is contracted into an FMA and 1/det is the IEEE
// quotient; the kernel then agrees with the plain version bitwise.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "active_queue.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileTris = 1024;
// 6 blocks an SM hold ptxas to 40 registers (48 of the 64 warps resident,
// at the cost of an 8-byte spill); it ran faster on an H100 than ptxas's
// own 46 registers (5 blocks) and than 8 blocks (32 registers, spills)
constexpr int kMinBlocks = 6;

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float bt, bu, bv;
  int bp;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o,
                                        const float* __restrict__ d, int i,
                                        float maxt) {
  Ray r;
  r.ox = o[3 * i + 0]; r.oy = o[3 * i + 1]; r.oz = o[3 * i + 2];
  r.dx = d[3 * i + 0]; r.dy = d[3 * i + 1]; r.dz = d[3 * i + 2];
  r.bt = maxt;
  r.bp = -1;
  r.bu = 0.f;
  r.bv = 0.f;
  return r;
}

__device__ __forceinline__ void store(const Ray& r, int i, float* __restrict__ t_out,
                                      int* __restrict__ p_out, float* __restrict__ u_out,
                                      float* __restrict__ v_out) {
  t_out[i] = r.bp >= 0 ? r.bt : CUDART_INF_F;
  p_out[i] = r.bp;
  u_out[i] = r.bu;
  v_out[i] = r.bv;
}

// rows [0, rows) of `tri` (rows of 12 floats: v0, e1, e2, 3 zeros) are the
// table's rows [first, first + rows), visited in ascending order
__device__ __forceinline__ void sweep(const float4* __restrict__ tri, int rows,
                                      int first, Ray& r) {
  for (int k = 0; k < rows; ++k) {
    const float4 a = tri[3 * k], b = tri[3 * k + 1], c = tri[3 * k + 2];
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
      r.bp = first + k;
      r.bu = u;
      r.bv = v;
    }
  }
}

// rows [first, first + rows) of the [T, 9] table into 12-float rows
__device__ __forceinline__ void stage(const float* __restrict__ table, int first,
                                      int rows, float* __restrict__ tri) {
  for (int k = threadIdx.x; k < rows * 12; k += kThreads) {
    const int row = k / 12, col = k - 12 * row;
    tri[k] = col < 9 ? table[(first + row) * 9 + col] : 0.f;
  }
}

// kTiled = false: the whole table (at most kTileTris rows) staged once,
// kPerThread queued rays a thread per chunk, one after the other.
// kTiled = true: one queued ray a thread per chunk, and the table staged in
// kTileTris-row tiles for every chunk.
template <int kPerThread, bool kTiled>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
tri_intersect_kernel(const float* __restrict__ table, int n_tri,
                     const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ maxt, int n,
                     float* __restrict__ t_out, int* __restrict__ p_out,
                     float* __restrict__ u_out, float* __restrict__ v_out) {
  using Queue = active_queue::Queue<kThreads, kPerThread>;
  extern __shared__ float4 tri[];
  __shared__ Queue q;

  if (!kTiled) stage(table, 0, n_tri, reinterpret_cast<float*>(tri));
  const long long step = static_cast<long long>(gridDim.x) * Queue::kChunk;
  for (long long base = static_cast<long long>(blockIdx.x) * Queue::kChunk; base < n;
       base += step) {
    // gather() opens with a barrier, which also publishes the staged table
    const int count = active_queue::gather(q, maxt, base, n, t_out, p_out, u_out, v_out);
    if (!kTiled) {
      for (int e = threadIdx.x; e < count; e += kThreads) {
        const int i = q.idx[e];
        Ray r = load_ray(o, d, i, q.maxt[e]);
        sweep(tri, n_tri, 0, r);
        store(r, i, t_out, p_out, u_out, v_out);
      }
    } else {
      // every thread takes part in the staging barriers; a thread without
      // a queued ray only skips the sweep
      const bool has = static_cast<int>(threadIdx.x) < count;
      const int i = has ? q.idx[threadIdx.x] : 0;
      Ray r = has ? load_ray(o, d, i, q.maxt[threadIdx.x]) : Ray{};
      for (int first = 0; first < n_tri; first += kTileTris) {
        const int rows = min(kTileTris, n_tri - first);
        __syncthreads();
        stage(table, first, rows, reinterpret_cast<float*>(tri));
        __syncthreads();
        if (has) sweep(tri, rows, first, r);
      }
      if (has) store(r, i, t_out, p_out, u_out, v_out);
    }
  }
}

template <int kPerThread, bool kTiled>
int launch(const float* table, int n_tri, const float* o, const float* d,
           const float* maxt, int n, float* t_out, int* p_out, float* u_out,
           float* v_out, cudaStream_t stream) {
  auto kernel = tri_intersect_kernel<kPerThread, kTiled>;
  const size_t smem = sizeof(float) * 12 * (n_tri < kTileTris ? n_tri : kTileTris);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kChunk = kThreads * kPerThread;
  int blocks = 0;
  const int rc = active_queue::persistent_blocks(
      kernel, kThreads, smem, (static_cast<long long>(n) + kChunk - 1) / kChunk, &blocks);
  if (rc != 0) return rc;
  kernel<<<blocks, kThreads, smem, stream>>>(table, n_tri, o, d, maxt, n, t_out, p_out,
                                             u_out, v_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` (a cudaStream_t) and returns the first CUDA error of
// the set-up or the launch, so that a refused launch reaches the caller.
extern "C" int tri_intersect_launch(const float* table, int n_tri,
                                    const float* o, const float* d,
                                    const float* maxt, int n, float* t_out,
                                    int* p_out, float* u_out, float* v_out,
                                    void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  if (n_tri <= kTileTris)
    return launch<4, false>(table, n_tri, o, d, maxt, n, t_out, p_out, u_out, v_out, s);
  return launch<1, true>(table, n_tri, o, d, maxt, n, t_out, p_out, u_out, v_out, s);
}
