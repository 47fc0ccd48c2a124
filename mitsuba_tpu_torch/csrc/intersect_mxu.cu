// Closest hit of rays over a triangle table, every per-pair quantity from
// one matrix product on the tensor cores (kernel K3).
//
// Replaces the TPU kernel mitsuba_tpu/ops/intersect_mxu.py:_kernel (in
// mxu_intersect). Contract (see ops/intersect_mxu.py), K1's:
//   cols [16, 4 Tp] float32 from build_mxu_cols: per triangle j the det,
//   u', v' and t' columns at j, Tp + j, 2 Tp + j, 3 Tp + j (Tp a multiple
//   of 8, at most 512; padding columns are zero and never hit);
//   o, d [N, 3], maxt [N]; maxt <= 0 (or -inf, or NaN) disables a lane.
//   Out: t [N] (inf on a miss), prim [N] int32 (-1 on a miss), u, v [N].
//
// Each ray's feature row is [d, o x d, o, 1] (the TPU kernel carries maxt
// in slot 10; here it is read on its own, so that an infinite maxt never
// meets a zero column as 0 * inf = NaN). build_mxu_cols fills only slots
// 0-5 of the det, u' and v' columns and only slots 6-9 of the t' columns,
// so each quantity is one k-step of 8: det, u', v' contract
// [d, o x d, 0, 0] with slots 0-7 of their columns, t' contracts
// [o, 1, 0, 0, 0, 0] with slots 6-9. The products run as mma.sync
// m16n8k8 in TF32 with the 3xTF32 split: each operand x = hi + lo with
// hi = tf32(x) and lo = tf32(x - hi), and the product a_lo b_hi +
// a_hi b_lo + a_hi b_hi accumulated in fp32, 12 mma.sync per 16 rays x 8
// triangles. Plain TF32 keeps 11 bits of each operand and would move hits
// on grazing rays; the split keeps about 22.
//
// Epilogue, per lane on its fragment: a lane holds det, u', v', t' of rays
// (g, g + 8) and triangles (2q, 2q + 1) of the 8-column tile (g = lane / 4,
// q = lane % 4). It applies |det| > 1e-12, one IEEE reciprocal, u, v >= 0,
// u + v <= 1, 0 < t < maxt, and keeps the closest t, visiting its
// triangles in ascending order with a strict t < best_t. The four lanes of
// a row group then reduce (t, index) with shuffles, the lower index winning
// a tie: the lowest triangle index among equal t's, as jnp.argmin picks.
//
// What bounds it on an H100: on the Cornell box's bounce-0 batch (8.4 M
// rays, half of them disabled, 36 triangles) the bytes, ~44 B per active
// ray (o, d, maxt in; t, prim, u, v out) and ~20 B per disabled one: about
// 0.08 ms at 3.35 TB/s, against ~0.07 ms of 3xTF32 products at 495 TFLOP/s
// and ~0.01 ms of fp32 epilogue at 67 TFLOP/s (chip_smoke.py computes the
// bound from each run's inputs). In practice the epilogue's ~20
// instructions per pair, on the CUDA cores, cost more than the products.
//
// Design:
// - A persistent grid of 256-thread blocks. Each block splits the columns
//   into hi and lo once, while it stages them, and lays them out as the
//   mma.sync B fragments of each lane: one 16-byte load gives a lane its
//   hi and lo of one quantity of an 8-column tile, without bank conflicts
//   (Tp x 256 B: 10 KB for the Cornell box, 128 KB at Tp = 512).
// - The block gathers the active lanes of each 1024-lane chunk into a
//   queue in shared memory (active_queue.cuh) and writes the miss to the
//   disabled ones; each warp takes 16 queued rays at a time. Lanes 0-15
//   load the rays' o and lanes 16-31 their d, once; shuffles give each
//   lane what its A fragments need, and each lane splits its features once
//   for the whole sweep over the columns.
// - After the reduction, 16 lanes store: lane (g, 0) ray g, lane (g, 1)
//   ray g + 8.
//
// Numerics: o x d and the epilogue are written in the order of the plain
// PyTorch version (ops/intersect_mxu.py:mxu_intersect_reference) and built
// with -fmad=false, so they round as it does; the contraction rounds
// differently (3xTF32, fp32 accumulation in the tensor cores' order), so
// kernel and plain version agree to a bound, not bitwise (chip_smoke.py).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "active_queue.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPerThread = 4;
using Queue = active_queue::Queue<kThreads, kPerThread>;

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// D = A B + D, A [16 x 8] row-major and B [8 x 8] column-major fragments
__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// slot k of the k-step of quantity c, for triangle j of the column table:
// det, u', v' (c < 3) read slots 0-7, t' (c = 3) slots 6-9 (then zeros)
__device__ __forceinline__ float b_value(const float* __restrict__ cols, int tp, int c,
                                         int k, int j) {
  const int slot = c < 3 ? k : (k < 4 ? 6 + k : -1);
  return slot < 0 ? 0.f : cols[slot * 4 * tp + c * tp + j];
}

// the 3xTF32 contraction of one 16-ray x 8-triangle tile, all 4 quantities:
// a1 are the fragments of [d, o x d, 0, 0], a2 those of [o, 1, 0 ...]
// (whose k >= 4 half is zero), b the 4 staged B fragments of the tile
__device__ __forceinline__ void contract(const uint32_t (&a1h)[4], const uint32_t (&a1l)[4],
                                         const uint32_t (&a2h)[2], const uint32_t (&a2l)[2],
                                         const uint4 (&b)[4], float (&acc)[4][4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
    // b[c] = (hi of k q, hi of k q + 4, lo of k q, lo of k q + 4)
    if (c < 3) {
      mma_tf32(acc[c], a1l[0], a1l[1], a1l[2], a1l[3], b[c].x, b[c].y);
      mma_tf32(acc[c], a1h[0], a1h[1], a1h[2], a1h[3], b[c].z, b[c].w);
      mma_tf32(acc[c], a1h[0], a1h[1], a1h[2], a1h[3], b[c].x, b[c].y);
    } else {
      mma_tf32(acc[c], a2l[0], a2l[1], 0u, 0u, b[c].x, b[c].y);
      mma_tf32(acc[c], a2h[0], a2h[1], 0u, 0u, b[c].z, b[c].w);
      mma_tf32(acc[c], a2h[0], a2h[1], 0u, 0u, b[c].x, b[c].y);
    }
  }
}

__device__ __forceinline__ void hit_test(float det, float up, float vp, float tq,
                                         float maxt, int j, float& bt, int& bp,
                                         float& bu, float& bv) {
  const bool ok = fabsf(det) > 1e-12f;
  const float inv_det = ok ? 1.0f / det : 0.0f;
  const float u = up * inv_det;
  const float v = vp * inv_det;
  const float t = tq * inv_det;
  const bool hit = ok && u >= 0.f && v >= 0.f && u + v <= 1.f && t > 0.f && t < maxt;
  if (hit && t < bt) {
    bt = t;
    bp = j;
    bu = u;
    bv = v;
  }
}

// reduce (t, prim, u, v) over the 4 lanes of a row group: the smallest t,
// the lowest prim among equal t's (a miss carries prim -1, t inf)
__device__ __forceinline__ void group_min(float& bt, int& bp, float& bu, float& bv) {
#pragma unroll
  for (int m = 1; m <= 2; m <<= 1) {
    const float ot = __shfl_xor_sync(0xffffffffu, bt, m);
    const int op = __shfl_xor_sync(0xffffffffu, bp, m);
    const float ou = __shfl_xor_sync(0xffffffffu, bu, m);
    const float ov = __shfl_xor_sync(0xffffffffu, bv, m);
    const bool take = op >= 0 && (bp < 0 || ot < bt || (ot == bt && op < bp));
    if (take) {
      bt = ot;
      bp = op;
      bu = ou;
      bv = ov;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
mxu_intersect_kernel(const float* __restrict__ cols, int tp,
                     const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ maxt, int n,
                     float* __restrict__ t_out, int* __restrict__ p_out,
                     float* __restrict__ u_out, float* __restrict__ v_out) {
  // bfrag[(jt * 4 + c) * 32 + lane]: lane (g, q)'s B fragment of quantity
  // c in column tile jt, b0 = (k q, n g), b1 = (k q + 4, n g), hi and lo
  extern __shared__ uint4 bfrag[];
  __shared__ Queue q;

  const int n_ct = tp / 8;
  for (int f = threadIdx.x; f < n_ct * 4 * 32; f += kThreads) {
    const int l = f & 31, c = (f >> 5) & 3, jt = f >> 7;
    const int j = 8 * jt + (l >> 2), k = l & 3;
    uint4 v;
    split(b_value(cols, tp, c, k, j), v.x, v.z);
    split(b_value(cols, tp, c, k + 4, j), v.y, v.w);
    bfrag[f] = v;
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int qd = lane & 3;
  const long long step = static_cast<long long>(gridDim.x) * Queue::kChunk;
  for (long long base = static_cast<long long>(blockIdx.x) * Queue::kChunk; base < n;
       base += step) {
    // gather() opens with a barrier, which also publishes the staged table
    const int count = active_queue::gather(q, maxt, base, n, t_out, p_out, u_out, v_out);
    for (int e0 = 16 * warp; e0 < count; e0 += 16 * kWarps) {
      // lanes 0-15 load o, lanes 16-31 d, of queued ray e0 + (lane & 15)
      const int e_mine = e0 + (lane & 15);
      const bool mine = e_mine < count;
      const int i_mine = mine ? q.idx[e_mine] : 0;
      const float* src = lane < 16 ? o : d;
      const float x = mine ? src[3 * i_mine + 0] : 0.f;
      const float y = mine ? src[3 * i_mine + 1] : 0.f;
      const float z = mine ? src[3 * i_mine + 2] : 0.f;
      float ro[2][3], rd[2][3];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = g + 8 * h;
        ro[h][0] = __shfl_sync(0xffffffffu, x, r);
        ro[h][1] = __shfl_sync(0xffffffffu, y, r);
        ro[h][2] = __shfl_sync(0xffffffffu, z, r);
        rd[h][0] = __shfl_sync(0xffffffffu, x, 16 + r);
        rd[h][1] = __shfl_sync(0xffffffffu, y, 16 + r);
        rd[h][2] = __shfl_sync(0xffffffffu, z, 16 + r);
      }
      // A fragments: a0 (row g, k q), a1 (row g + 8, k q), a2 (row g,
      // k q + 4), a3 (row g + 8, k q + 4); rows g and g + 8 are h = 0, 1
      uint32_t a1h[4], a1l[4], a2h[2], a2l[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* ob = ro[h];
        const float* db = rd[h];
        // [d, o x d, 0, 0] at k = q and k = q + 4
        float lo_k, hi_k;
        switch (qd) {
          case 0: lo_k = db[0]; hi_k = ob[2] * db[0] - ob[0] * db[2]; break;
          case 1: lo_k = db[1]; hi_k = ob[0] * db[1] - ob[1] * db[0]; break;
          case 2: lo_k = db[2]; hi_k = 0.f; break;
          default: lo_k = ob[1] * db[2] - ob[2] * db[1]; hi_k = 0.f; break;
        }
        split(lo_k, a1h[h], a1l[h]);
        split(hi_k, a1h[2 + h], a1l[2 + h]);
        // [o, 1, 0 ...] at k = q (k = q + 4 is zero)
        split(qd == 0 ? ob[0] : qd == 1 ? ob[1] : qd == 2 ? ob[2] : 1.0f, a2h[h], a2l[h]);
      }
      const bool act0 = e0 + g < count;
      const bool act1 = e0 + g + 8 < count;
      const float mt0 = act0 ? q.maxt[e0 + g] : -1.f;
      const float mt1 = act1 ? q.maxt[e0 + g + 8] : -1.f;
      float bt0 = CUDART_INF_F, bt1 = CUDART_INF_F;
      int bp0 = -1, bp1 = -1;
      float bu0 = 0.f, bv0 = 0.f, bu1 = 0.f, bv1 = 0.f;
      for (int jt = 0; jt < n_ct; ++jt) {
        uint4 b[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) b[c] = bfrag[(jt * 4 + c) * 32 + lane];
        float acc[4][4];
        contract(a1h, a1l, a2h, a2l, b, acc);
        // C fragment: c0 (row g, n 2q), c1 (g, 2q+1), c2 (g+8, 2q), c3 (g+8, 2q+1)
        const int j = 8 * jt + 2 * qd;
        hit_test(acc[0][0], acc[1][0], acc[2][0], acc[3][0], mt0, j, bt0, bp0, bu0, bv0);
        hit_test(acc[0][1], acc[1][1], acc[2][1], acc[3][1], mt0, j + 1, bt0, bp0, bu0, bv0);
        hit_test(acc[0][2], acc[1][2], acc[2][2], acc[3][2], mt1, j, bt1, bp1, bu1, bv1);
        hit_test(acc[0][3], acc[1][3], acc[2][3], acc[3][3], mt1, j + 1, bt1, bp1, bu1, bv1);
      }
      group_min(bt0, bp0, bu0, bv0);
      group_min(bt1, bp1, bu1, bv1);
      const bool store0 = qd == 0 && act0, store1 = qd == 1 && act1;
      if (store0 || store1) {
        const int i = q.idx[e0 + g + (store1 ? 8 : 0)];
        const int bp = store1 ? bp1 : bp0;
        t_out[i] = bp >= 0 ? (store1 ? bt1 : bt0) : CUDART_INF_F;
        p_out[i] = bp;
        u_out[i] = bp >= 0 ? (store1 ? bu1 : bu0) : 0.f;
        v_out[i] = bp >= 0 ? (store1 ? bv1 : bv0) : 0.f;
      }
    }
  }
}

}  // namespace

// Launches on `stream` (a cudaStream_t) and returns the first CUDA error of
// the set-up or the launch, so that a refused launch reaches the caller.
extern "C" int mxu_intersect_launch(const float* cols, int tp, const float* o,
                                    const float* d, const float* maxt, int n,
                                    float* t_out, int* p_out, float* u_out,
                                    float* v_out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = sizeof(uint4) * 4 * 32 * (tp / 8);
  cudaError_t err = cudaFuncSetAttribute(
      mxu_intersect_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  const int rc = active_queue::persistent_blocks(
      mxu_intersect_kernel, kThreads, smem,
      (static_cast<long long>(n) + Queue::kChunk - 1) / Queue::kChunk, &blocks);
  if (rc != 0) return rc;
  mxu_intersect_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      cols, tp, o, d, maxt, n, t_out, p_out, u_out, v_out);
  return static_cast<int>(cudaGetLastError());
}
