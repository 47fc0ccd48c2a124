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
// costs 46 fp32 operations (one of them an IEEE reciprocal), counting the
// real triangles, not the degenerate padding rows. Every lane reads its
// maxt (4 B) and writes t, prim, u, v (16 B); only an active lane needs its
// o and d (24 B). One fused launch of the Cornell box with every lane
// active (2N = 8.4 M rays, 36 real of 64 rows) is ~13.9 GFLOP, 0.21 ms at
// 67 TFLOP/s, against ~0.37 GB, 0.11 ms at 3.35 TB/s. On the first bounce
// half the lanes are disabled: ~6.9 GFLOP, 0.10 ms, against ~0.27 GB,
// 0.08 ms, so operations bound it there too.
//
// Design: one thread per ray, 256 threads per block. The block stages the
// table into shared memory in tiles of at most 1024 rows (36 KB, inside the
// 48 KB of static shared memory), and every thread of the block then reads
// the same row at once, which the hardware broadcasts. A disabled lane reads
// only its maxt and skips the sweep: no t satisfies 0 < t < maxt <= 0.
//
// Numerics: the arithmetic is written in the order of the plain PyTorch
// version (ops/intersect.py:tri_intersect_reference), each product and sum
// rounded on its own. Build with -fmad=false and without --use_fast_math,
// so that no product is contracted into an FMA and 1/det is the IEEE
// quotient; the kernel then agrees with the plain version bitwise.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileTris = 1024;

__global__ void __launch_bounds__(kThreads)
tri_intersect_kernel(const float* __restrict__ table, int n_tri,
                     const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ maxt, int n,
                     float* __restrict__ t_out, int* __restrict__ p_out,
                     float* __restrict__ u_out, float* __restrict__ v_out) {
  __shared__ float tri[kTileTris * 9];

  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool in_range = i < n;
  float bt = in_range ? maxt[i] : -1.f;
  // every thread of the block takes part in the staging barriers below,
  // in range or not; only the sweep is skipped, and a disabled lane never
  // reads its ray
  const bool active = in_range && bt > 0.f;
  float o_x = 0.f, o_y = 0.f, o_z = 0.f, d_x = 0.f, d_y = 0.f, d_z = 0.f;
  if (active) {
    o_x = o[3 * i + 0]; o_y = o[3 * i + 1]; o_z = o[3 * i + 2];
    d_x = d[3 * i + 0]; d_y = d[3 * i + 1]; d_z = d[3 * i + 2];
  }
  int bp = -1;
  float bu = 0.f, bv = 0.f;

  for (int base = 0; base < n_tri; base += kTileTris) {
    const int rows = min(kTileTris, n_tri - base);
    __syncthreads();
    for (int k = threadIdx.x; k < rows * 9; k += kThreads) {
      tri[k] = table[base * 9 + k];
    }
    __syncthreads();
    if (!active) continue;
    for (int k = 0; k < rows; ++k) {
      const float* r = tri + 9 * k;
      const float v0x = r[0], v0y = r[1], v0z = r[2];
      const float e1x = r[3], e1y = r[4], e1z = r[5];
      const float e2x = r[6], e2y = r[7], e2z = r[8];

      // pvec = d x e2
      const float pvx = d_y * e2z - d_z * e2y;
      const float pvy = d_z * e2x - d_x * e2z;
      const float pvz = d_x * e2y - d_y * e2x;
      const float det = e1x * pvx + e1y * pvy + e1z * pvz;
      const bool det_ok = fabsf(det) > 1e-12f;
      const float inv_det = det_ok ? 1.0f / det : 0.0f;
      const float tvx = o_x - v0x;
      const float tvy = o_y - v0y;
      const float tvz = o_z - v0z;
      const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
      // qvec = tvec x e1
      const float qvx = tvy * e1z - tvz * e1y;
      const float qvy = tvz * e1x - tvx * e1z;
      const float qvz = tvx * e1y - tvy * e1x;
      const float v = (d_x * qvx + d_y * qvy + d_z * qvz) * inv_det;
      const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
      const bool hit = det_ok && u >= 0.f && v >= 0.f && u + v <= 1.f &&
                       t > 0.f && t < bt;
      if (hit) {
        bt = t;
        bp = base + k;
        bu = u;
        bv = v;
      }
    }
  }

  if (in_range) {
    t_out[i] = bp >= 0 ? bt : CUDART_INF_F;
    p_out[i] = bp;
    u_out[i] = bu;
    v_out[i] = bv;
  }
}

}  // namespace

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError(), so
// that a refused launch is reported to the caller.
extern "C" int tri_intersect_launch(const float* table, int n_tri,
                                    const float* o, const float* d,
                                    const float* maxt, int n, float* t_out,
                                    int* p_out, float* u_out, float* v_out,
                                    void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    tri_intersect_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        table, n_tri, o, d, maxt, n, t_out, p_out, u_out, v_out);
  }
  return static_cast<int>(cudaGetLastError());
}
