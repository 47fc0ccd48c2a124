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
// Each ray's feature row is [d, o x d, o, 1] (10 slots, padded to 16; the
// TPU kernel carries maxt in slot 10, here it is read on its own, so that
// an infinite maxt never meets a zero column as 0 * inf = NaN). The
// contraction [16 rays, 16] @ [16, 8 columns] is mma.sync m16n8k8 in TF32,
// two k-steps, with the 3xTF32 split: each operand x = hi + lo with hi =
// tf32(x) and lo = tf32(x - hi), and the product a_lo b_hi + a_hi b_lo +
// a_hi b_hi accumulated in fp32. Plain TF32 keeps 11 bits of each operand
// and would move hits on grazing rays; the split keeps about 22.
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
// and ~0.03 ms of fp32 epilogue at 67 TFLOP/s (chip_smoke.py computes the
// bound from each run's inputs).
//
// Design: 8 warps a block; the block stages the whole column table into
// dynamic shared memory once, k-major with a row stride of 4 Tp + 8 floats,
// so that the B-fragment loads of a warp fall on 32 distinct banks (128 KB
// at Tp = 512, above the 48 KB of static shared memory). The grid is as
// many blocks as fit on the card at once, and each warp walks 16-ray tiles
// with a stride of all the warps, so that the table is staged once per
// block, not once per tile. A tile whose 16 lanes are all disabled is
// written as misses without a product. The B operand is split into hi and
// lo at every use; wgmma, and a split table staged once, are left to the
// change that makes K3 fast.
//
// Numerics: o x d and the epilogue are written in the order of the plain
// PyTorch version (ops/intersect_mxu.py:mxu_intersect_reference) and built
// with -fmad=false, so they round as it does; the contraction rounds
// differently (3xTF32, fp32 accumulation in the tensor cores' order), so
// kernel and plain version agree to a bound, not bitwise (chip_smoke.py).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kFeat = 16;

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
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// slot k (0-9) of the ray's feature row [d, o x d, o, 1]; 0 beyond
__device__ __forceinline__ float feature(const float (&o)[3], const float (&d)[3],
                                         int k) {
  switch (k) {
    case 0: return d[0];
    case 1: return d[1];
    case 2: return d[2];
    case 3: return o[1] * d[2] - o[2] * d[1];
    case 4: return o[2] * d[0] - o[0] * d[2];
    case 5: return o[0] * d[1] - o[1] * d[0];
    case 6: return o[0];
    case 7: return o[1];
    case 8: return o[2];
    case 9: return 1.0f;
    default: return 0.0f;
  }
}

__device__ __forceinline__ void load_ray(const float* __restrict__ o,
                                         const float* __restrict__ d, int i,
                                         bool active, float (&ro)[3],
                                         float (&rd)[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    ro[c] = active ? o[3 * i + c] : 0.f;
    rd[c] = active ? d[3 * i + c] : 0.f;
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

__device__ __forceinline__ void store(int i, int n, float bt, int bp, float bu,
                                      float bv, float* __restrict__ t_out,
                                      int* __restrict__ p_out,
                                      float* __restrict__ u_out,
                                      float* __restrict__ v_out) {
  if (i < n) {
    t_out[i] = bp >= 0 ? bt : CUDART_INF_F;
    p_out[i] = bp;
    u_out[i] = bp >= 0 ? bu : 0.f;
    v_out[i] = bp >= 0 ? bv : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
mxu_intersect_kernel(const float* __restrict__ cols, int tp,
                     const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ maxt, int n,
                     float* __restrict__ t_out, int* __restrict__ p_out,
                     float* __restrict__ u_out, float* __restrict__ v_out) {
  extern __shared__ float sc[];
  const int width = 4 * tp;
  const int stride = width + 8;
  for (int k = threadIdx.x; k < kFeat * width; k += kThreads) {
    const int row = k / width;
    sc[row * stride + (k - row * width)] = cols[k];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int n_tiles = (n + 15) / 16;
  const int n_warps = gridDim.x * kWarps;
  for (int tile = blockIdx.x * kWarps + (threadIdx.x >> 5); tile < n_tiles;
       tile += n_warps) {
    const int r0 = 16 * tile + g;
    const int r1 = r0 + 8;
    const float mt0 = r0 < n ? maxt[r0] : -1.f;
    const float mt1 = r1 < n ? maxt[r1] : -1.f;
    const bool act0 = mt0 > 0.f;
    const bool act1 = mt1 > 0.f;
    float bt0 = CUDART_INF_F, bt1 = CUDART_INF_F;
    int bp0 = -1, bp1 = -1;
    float bu0 = 0.f, bv0 = 0.f, bu1 = 0.f, bv1 = 0.f;

    if (__any_sync(0xffffffffu, act0 || act1)) {
      float o0[3], d0[3], o1[3], d1[3];
      load_ray(o, d, r0, act0, o0, d0);
      load_ray(o, d, r1, act1, o1, d1);
      // A fragments of the two k-steps: a0 (row g, k q), a1 (row g+8, k q),
      // a2 (row g, k q+4), a3 (row g+8, k q+4), k offset by 8 in step 1
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        split(feature(o0, d0, 8 * s + q), ah[s][0], al[s][0]);
        split(feature(o1, d1, 8 * s + q), ah[s][1], al[s][1]);
        split(feature(o0, d0, 8 * s + q + 4), ah[s][2], al[s][2]);
        split(feature(o1, d1, 8 * s + q + 4), ah[s][3], al[s][3]);
      }
      for (int jt = 0; jt < tp; jt += 8) {
        // acc[c]: the 16 x 8 tile of quantity c (det, u', v', t')
        float acc[4][4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
          const float* col = sc + c * tp + jt + g;
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            // B fragment: b0 (k q, n g), b1 (k q+4, n g)
            uint32_t bh0, bl0, bh1, bl1;
            split(col[(8 * s + q) * stride], bh0, bl0);
            split(col[(8 * s + q + 4) * stride], bh1, bl1);
            mma_tf32(acc[c], al[s], bh0, bh1);
            mma_tf32(acc[c], ah[s], bl0, bl1);
            mma_tf32(acc[c], ah[s], bh0, bh1);
          }
        }
        // C fragment: c0 (row g, n 2q), c1 (g, 2q+1), c2 (g+8, 2q), c3 (g+8, 2q+1)
        const int j = jt + 2 * q;
        hit_test(acc[0][0], acc[1][0], acc[2][0], acc[3][0], mt0, j, bt0, bp0, bu0, bv0);
        hit_test(acc[0][1], acc[1][1], acc[2][1], acc[3][1], mt0, j + 1, bt0, bp0, bu0, bv0);
        hit_test(acc[0][2], acc[1][2], acc[2][2], acc[3][2], mt1, j, bt1, bp1, bu1, bv1);
        hit_test(acc[0][3], acc[1][3], acc[2][3], acc[3][3], mt1, j + 1, bt1, bp1, bu1, bv1);
      }
      group_min(bt0, bp0, bu0, bv0);
      group_min(bt1, bp1, bu1, bv1);
    }
    if (q == 0) {
      store(r0, n, bt0, bp0, bu0, bv0, t_out, p_out, u_out, v_out);
      store(r1, n, bt1, bp1, bu1, bv1, t_out, p_out, u_out, v_out);
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
  const size_t smem = sizeof(float) * kFeat * (4 * tp + 8);
  cudaError_t err = cudaFuncSetAttribute(
      mxu_intersect_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, mxu_intersect_kernel, kThreads, smem)) != cudaSuccess)
    return static_cast<int>(err);
  const int tiles = (n + 15) / 16;
  const int want = (tiles + kWarps - 1) / kWarps;
  const int blocks = want < sms * (per_sm > 0 ? per_sm : 1) ? want : sms * (per_sm > 0 ? per_sm : 1);
  mxu_intersect_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      cols, tp, o, d, maxt, n, t_out, p_out, u_out, v_out);
  return static_cast<int>(cudaGetLastError());
}
