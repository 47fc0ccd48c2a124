// A second design of kernel K3 (mitsuba_tpu_torch/csrc/intersect_mxu.cu,
// the same contract and launcher), with the products issued as Hopper
// warpgroup MMAs: wgmma.mma_async m64n32k8 TF32, A from registers, B from
// shared memory. scripts/torch_bench_closest_hit.py builds it and times it
// in turns with the package's K3; the package ships the faster of the two.
//
// A warpgroup (4 warps) takes 64 queued rays. The columns are regrouped
// while they are staged: per 8-triangle group, 32 columns in the order
// [det (8) | u' (8) | v' (8) | t' (8)], so that each thread's accumulator
// fragment holds all four quantities of the same two triangles (2q,
// 2q + 1) for rows g and g + 8 of its warp, and the epilogue stays per
// thread. One A serves every column, so the contraction keeps two k-steps:
// [d, o x d, 0, 0] against slots 0-7 (zero in the t' columns) and
// [o, 1, 0 ...] against slots 6-9 (zero in the others); with the 3xTF32
// split that is 6 wgmma per group. B is split into hi and lo once, while it
// is staged, in K-major core matrices (8 columns x 4 k, 128 B; no swizzle),
// 4 KB per group. Groups go 5 at a time (N = 160 columns, the Cornell
// box's whole table) between a commit and a wait. ptxas serializes the
// wgmma behind the branch that skips groups past the table's end; padding
// the table to a multiple of 5 groups instead lifts that, but raised the
// registers from 124 to 176 and ran slower on an H100.
//
// Everything else (the active-lane queue, the epilogue, the reduction over
// a row group and its tie rule, -fmad=false) is the mma.sync kernel's.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "active_queue.cuh"

namespace {

constexpr int kThreads = 256;            // 2 warpgroups
constexpr int kPerThread = 4;
constexpr int kGroups = 5;               // 8-triangle groups per commit
constexpr int kMaxTp = 256;              // 32 groups x 4 KB of shared memory
// core matrices of B: the next one along k 128 B on, along n 256 B on
constexpr int kLbo = 128;
constexpr int kSbo = 256;
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

// K-major, no swizzle: start address, LBO (next core matrix along k), SBO
// (next core matrix along n), all in 16-byte units
__device__ __forceinline__ uint64_t b_desc(const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kLbo >> 4) << 16) |
         (static_cast<uint64_t>(kSbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[16], uint32_t a0, uint32_t a1,
                                           uint32_t a2, uint32_t a3, uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc), "r"(scale_d));
}

// keeps the compiler from moving reads of an accumulator above the wait
__device__ __forceinline__ void fence_operand(float& x) {
  asm volatile("" : "+f"(x)::"memory");
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
mxu_intersect_wgmma_kernel(const float* __restrict__ cols, int tp,
                           const float* __restrict__ o, const float* __restrict__ d,
                           const float* __restrict__ maxt, int n,
                           float* __restrict__ t_out, int* __restrict__ p_out,
                           float* __restrict__ u_out, float* __restrict__ v_out) {
  // tiles[((gi * 2 + s) * 2 + h) * 256 + ...]: group gi, k-step s, hi (h 0)
  // or lo (h 1); element (n, k) of a tile at word
  // (n / 8) * kSbo / 4 + (k / 4) * kLbo / 4 + (n % 8) * 4 + k % 4
  extern __shared__ uint32_t tiles[];
  __shared__ Queue q;

  const int n_groups = tp / 8;
  for (int f = threadIdx.x; f < n_groups * 2 * 32 * 8; f += kThreads) {
    const int k = f & 7, nn = (f >> 3) & 31, s = (f >> 8) & 1, gi = f >> 9;
    const int c = nn >> 3, j = 8 * gi + (nn & 7);
    // step 0 feeds det, u', v' from slots 0-7; step 1 feeds t' from 6-9
    const int slot = s == 0 ? (c < 3 ? k : -1) : (c == 3 && k < 4 ? 6 + k : -1);
    const float x = slot < 0 ? 0.f : cols[slot * 4 * tp + c * tp + j];
    uint32_t hi, lo;
    split(x, hi, lo);
    const int w = (nn >> 3) * (kSbo / 4) + (k >> 2) * (kLbo / 4) + (nn & 7) * 4 + (k & 3);
    tiles[((gi * 2 + s) * 2 + 0) * 256 + w] = hi;
    tiles[((gi * 2 + s) * 2 + 1) * 256 + w] = lo;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wg = warp >> 2;
  const int row0 = 16 * (warp & 3);
  const int g = lane >> 2;
  const int qd = lane & 3;
  const long long step = static_cast<long long>(gridDim.x) * Queue::kChunk;
  for (long long base = static_cast<long long>(blockIdx.x) * Queue::kChunk; base < n;
       base += step) {
    const int count = active_queue::gather(q, maxt, base, n, t_out, p_out, u_out, v_out);
    for (int e0 = 64 * wg + row0; e0 - row0 < count; e0 += 128) {
      const int e_mine = e0 + (lane & 15);
      const bool mine = e_mine < count;
      const int i_mine = mine ? q.idx[e_mine] : 0;
      const float* src = lane < 16 ? o : d;
      const float x = mine ? src[3 * i_mine + 0] : 0.f;
      const float y = mine ? src[3 * i_mine + 1] : 0.f;
      const float z = mine ? src[3 * i_mine + 2] : 0.f;
      uint32_t a1h[4], a1l[4], a2h[2], a2l[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = g + 8 * h;
        float ob[3], db[3];
        ob[0] = __shfl_sync(0xffffffffu, x, r);
        ob[1] = __shfl_sync(0xffffffffu, y, r);
        ob[2] = __shfl_sync(0xffffffffu, z, r);
        db[0] = __shfl_sync(0xffffffffu, x, 16 + r);
        db[1] = __shfl_sync(0xffffffffu, y, 16 + r);
        db[2] = __shfl_sync(0xffffffffu, z, 16 + r);
        float lo_k, hi_k;
        switch (qd) {
          case 0: lo_k = db[0]; hi_k = ob[2] * db[0] - ob[0] * db[2]; break;
          case 1: lo_k = db[1]; hi_k = ob[0] * db[1] - ob[1] * db[0]; break;
          case 2: lo_k = db[2]; hi_k = 0.f; break;
          default: lo_k = ob[1] * db[2] - ob[2] * db[1]; hi_k = 0.f; break;
        }
        split(lo_k, a1h[h], a1l[h]);
        split(hi_k, a1h[2 + h], a1l[2 + h]);
        split(qd == 0 ? ob[0] : qd == 1 ? ob[1] : qd == 2 ? ob[2] : 1.0f, a2h[h], a2l[h]);
      }
      const bool act0 = e0 + g < count;
      const bool act1 = e0 + g + 8 < count;
      const float mt0 = act0 ? q.maxt[e0 + g] : -1.f;
      const float mt1 = act1 ? q.maxt[e0 + g + 8] : -1.f;
      float bt0 = CUDART_INF_F, bt1 = CUDART_INF_F;
      int bp0 = -1, bp1 = -1;
      float bu0 = 0.f, bv0 = 0.f, bu1 = 0.f, bv1 = 0.f;
      for (int g0 = 0; g0 < n_groups; g0 += kGroups) {
        float acc[kGroups][16];
#pragma unroll
        for (int b = 0; b < kGroups; ++b)
#pragma unroll
          for (int r = 0; r < 16; ++r) acc[b][r] = 0.f;
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int b = 0; b < kGroups; ++b) {
          if (g0 + b < n_groups) {
            const uint32_t* t0 = tiles + (g0 + b) * 4 * 256;
            // step 0: [d, o x d, 0, 0]; step 1: [o, 1, 0 ...], k >= 4 zero
            wgmma_tf32(acc[b], a1l[0], a1l[1], a1l[2], a1l[3], b_desc(t0), 0);
            wgmma_tf32(acc[b], a1h[0], a1h[1], a1h[2], a1h[3], b_desc(t0 + 256), 1);
            wgmma_tf32(acc[b], a1h[0], a1h[1], a1h[2], a1h[3], b_desc(t0), 1);
            wgmma_tf32(acc[b], a2l[0], a2l[1], 0u, 0u, b_desc(t0 + 512), 1);
            wgmma_tf32(acc[b], a2h[0], a2h[1], 0u, 0u, b_desc(t0 + 768), 1);
            wgmma_tf32(acc[b], a2h[0], a2h[1], 0u, 0u, b_desc(t0 + 512), 1);
          }
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
        for (int b = 0; b < kGroups; ++b)
#pragma unroll
          for (int r = 0; r < 16; ++r) fence_operand(acc[b][r]);
#pragma unroll
        for (int b = 0; b < kGroups; ++b) {
          if (g0 + b < n_groups) {
            // acc[b][4 c + r]: quantity c; r 0 (row g, n 2q), 1 (g, 2q+1),
            // 2 (g+8, 2q), 3 (g+8, 2q+1)
            const int j = 8 * (g0 + b) + 2 * qd;
            const float* a = acc[b];
            hit_test(a[0], a[4], a[8], a[12], mt0, j, bt0, bp0, bu0, bv0);
            hit_test(a[1], a[5], a[9], a[13], mt0, j + 1, bt0, bp0, bu0, bv0);
            hit_test(a[2], a[6], a[10], a[14], mt1, j, bt1, bp1, bu1, bv1);
            hit_test(a[3], a[7], a[11], a[15], mt1, j + 1, bt1, bp1, bu1, bv1);
          }
        }
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

// K3's launcher signature (mxu_intersect_launch); tp above kMaxTp is
// refused with cudaErrorInvalidValue.
extern "C" int mxu_intersect_launch(const float* cols, int tp, const float* o,
                                    const float* d, const float* maxt, int n,
                                    float* t_out, int* p_out, float* u_out,
                                    float* v_out, void* stream) {
  if (tp > kMaxTp) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = sizeof(uint32_t) * 4 * 256 * (tp / 8);
  cudaError_t err = cudaFuncSetAttribute(
      mxu_intersect_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  const int rc = active_queue::persistent_blocks(
      mxu_intersect_wgmma_kernel, kThreads, smem,
      (static_cast<long long>(n) + Queue::kChunk - 1) / Queue::kChunk, &blocks);
  if (rc != 0) return rc;
  mxu_intersect_wgmma_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      cols, tp, o, d, maxt, n, t_out, p_out, u_out, v_out);
  return static_cast<int>(cudaGetLastError());
}
