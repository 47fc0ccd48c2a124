// Closest-hit and any-hit of rays over a threaded wide-leaf BVH (kernel K2).
//
// Replaces the TPU kernel mitsuba_tpu/ops/bvh_sweep.py:_kernel (launched by
// _pallas_bvh_sweep, entries bvh_sweep_intersect and bvh_sweep_occluded).
// Contract (see ops/bvh_sweep.py):
//   nodes [M, 8] float32: box lo (0-2), hi (3-5), then two int32 stored
//   bitwise: the skip link (6; -1 ends the walk) and the leaf payload
//   start << 8 | count (7; 0 for an internal node), in DFS order;
//   table [T, 9] float32 rows (v0 | e1 | e2) in leaf order; o, d [N, 3];
//   maxt [N], maxt <= 0 (or -inf, or NaN) disabling a lane.
//   Out: t [N] (maxt on a miss), prim [N] int32 (-1 on a miss), u, v [N].
//
// What bounds it on an H100: by its bound, operations. Each lane reads its
// ray (28 B; 4 B when disabled) and writes 16 B, and the two tables are read
// once (7.3 MB of triangles and 32 B a node for the 202,800-triangle mesh);
// the work is a slab test (23 fp32 operations) per node visit and a
// Moller-Trumbore test (46) per leaf triangle, tens of visits and hundreds of
// tests per ray, so the operations outweigh the bytes by two orders. In
// practice it is held by latency: every step of the walk is a dependent
// load of a node, then of up to 64 leaf rows (through L1/L2, the tables fit
// in the 50 MB L2), and the lanes of a warp diverge, most on incoherent
// bounce rays.
//
// Design: one thread per ray, 128 threads per block, no stack: on a box hit
// an internal node descends to node + 1, otherwise the walk goes to the
// skip link, so a lane's node index only increases and the walk ends. A
// node is two float4 loads through the read-only path (__ldg). The leaf's
// rows are read from the [T, 9] table. The template flag kAnyHit ends the
// walk at the first hit. A disabled lane reads only its maxt. Ray sorting,
// shared-memory staging of the top of the tree and warp-coherent traversal
// are left to a later change.
//
// Numerics: the arithmetic is written in the order of the plain PyTorch
// version (ops/bvh_sweep.py:bvh_sweep_reference and
// ops/intersect.py:moller_trumbore), each product and sum rounded on its
// own. Build with -fmad=false and without --use_fast_math, so that no
// product is contracted into an FMA and 1/x is the IEEE quotient; both then
// make the same visits and agree bitwise (prim, t, u, v).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
bvh_sweep_kernel(const float4* __restrict__ nodes, const float* __restrict__ table,
                 const float* __restrict__ o, const float* __restrict__ d,
                 const float* __restrict__ maxt, int n,
                 float* __restrict__ t_out, int* __restrict__ p_out,
                 float* __restrict__ u_out, float* __restrict__ v_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float bt = maxt[i];
  int bp = -1;
  float bu = 0.f, bv = 0.f;

  if (bt > 0.f) {
    const float o_x = o[3 * i + 0], o_y = o[3 * i + 1], o_z = o[3 * i + 2];
    const float d_x = d[3 * i + 0], d_y = d[3 * i + 1], d_z = d[3 * i + 2];
    // 1 / d with |d| < 1e-12 replaced by +-1e-12
    const float s_x = fabsf(d_x) < 1e-12f ? (d_x >= 0.f ? 1e-12f : -1e-12f) : d_x;
    const float s_y = fabsf(d_y) < 1e-12f ? (d_y >= 0.f ? 1e-12f : -1e-12f) : d_y;
    const float s_z = fabsf(d_z) < 1e-12f ? (d_z >= 0.f ? 1e-12f : -1e-12f) : d_z;
    const float inv_x = 1.0f / s_x, inv_y = 1.0f / s_y, inv_z = 1.0f / s_z;

    int node = 0;
    while (node >= 0) {
      const float4 a = __ldg(nodes + 2 * node);       // lo.x lo.y lo.z hi.x
      const float4 b = __ldg(nodes + 2 * node + 1);   // hi.y hi.z skip payload
      const float t0x = (a.x - o_x) * inv_x, t1x = (a.w - o_x) * inv_x;
      const float t0y = (a.y - o_y) * inv_y, t1y = (b.x - o_y) * inv_y;
      const float t0z = (a.z - o_z) * inv_z, t1z = (b.y - o_z) * inv_z;
      const float tmin = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
      const float tmax = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
      const bool hit_box = tmax >= fmaxf(tmin, 0.f) && tmin < bt;
      const int skip = __float_as_int(b.z);
      const int payload = __float_as_int(b.w);
      if (hit_box && payload == 0) {
        node += 1;
        continue;
      }
      node = skip;
      if (!hit_box) continue;

      const int start = payload >> 8;
      const int end = start + (payload & 0xFF);
      for (int k = start; k < end; ++k) {
        const float* r = table + 9 * k;
        const float v0x = __ldg(r + 0), v0y = __ldg(r + 1), v0z = __ldg(r + 2);
        const float e1x = __ldg(r + 3), e1y = __ldg(r + 4), e1z = __ldg(r + 5);
        const float e2x = __ldg(r + 6), e2y = __ldg(r + 7), e2z = __ldg(r + 8);

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
        if (det_ok && u >= 0.f && v >= 0.f && u + v <= 1.f && t > 0.f && t < bt) {
          bt = t;
          bp = k;
          bu = u;
          bv = v;
          if (kAnyHit) {
            node = -1;
            break;
          }
        }
      }
    }
  }

  t_out[i] = bt;
  p_out[i] = bp;
  u_out[i] = bu;
  v_out[i] = bv;
}

}  // namespace

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError(), so
// that a refused launch is reported to the caller. `nodes` must be 16-byte
// aligned.
extern "C" int bvh_sweep_launch(const float* nodes, const float* table,
                                const float* o, const float* d,
                                const float* maxt, int n, int anyhit,
                                float* t_out, int* p_out, float* u_out,
                                float* v_out, void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    const float4* nodes4 = reinterpret_cast<const float4*>(nodes);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (anyhit) {
      bvh_sweep_kernel<true><<<blocks, kThreads, 0, s>>>(
          nodes4, table, o, d, maxt, n, t_out, p_out, u_out, v_out);
    } else {
      bvh_sweep_kernel<false><<<blocks, kThreads, 0, s>>>(
          nodes4, table, o, d, maxt, n, t_out, p_out, u_out, v_out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
