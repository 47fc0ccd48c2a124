"""Closest hit over a triangle table with every per-pair quantity from one
matrix product: kernel K3 and its plain version (counterpart of
mitsuba_tpu/ops/intersect_mxu.py).

Moller-Trumbore is bilinear in per-ray and per-triangle quantities, so every
determinant it needs is the dot product of a ray's feature row with a
triangle's column:

    feature(ray) = [d, o x d, o, 1, maxt, 0 ...]            (16 slots)
    det = d . (e2 x e1)
    u'  = u det = (o x d) . e2 - d . (e2 x v0)
    v'  = v det = -(o x d) . e1 - d . (v0 x e1)
    t'  = t det = o . n - v0 . n,        n = e1 x e2

and all of them come from one [N, 16] @ [16, 4 Tp] contraction, followed by
an epilogue: |det| > 1e-12, one reciprocal, u, v >= 0, u + v <= 1,
0 < t < maxt, and the closest t, the lowest triangle index on ties.

``mxu_intersect`` launches the hand-written CUDA kernel
``csrc/intersect_mxu.cu`` (which replaces the TPU kernel
``mitsuba_tpu/ops/intersect_mxu.py:_kernel``) for tensors on the card: the
contraction runs on the tensor cores in TF32 with the 3xTF32 split. It runs
``mxu_intersect_reference`` for tensors on the CPU. A tensor on the card
never falls back to the plain version.

The contraction runs over the ten geometric slots only: maxt rides in slot
10, whose column is zero, and an infinite maxt would turn 0 * inf into NaN.

Contract (K1's, ``ops/intersect.py``): cols [16, 4 Tp] float32 from
``build_mxu_cols`` (Tp a multiple of 8, at most MAX_MXU_TRIS); rays o, d
[N, 3] and maxt [N] float32, maxt <= 0 (or -inf, or NaN) disabling a lane.
Returns t [N] (inf on a miss), prim [N] int32 (-1 on a miss), u, v [N] (0
on a miss).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build
from ..core.frame import cross, dot

K_FEAT = 16
# feature slots that carry geometry: d (0-2), o x d (3-5), o (6-8), 1 (9)
K_GEOM = 10
MAX_MXU_TRIS = 512
# the kernel's n-tile (mma.sync m16n8k8): the triangle count is padded to it
N_TILE = 8


def build_mxu_cols(tri_v0, tri_e1, tri_e2):
    """Column table [16, 4 Tp] float32 from triangle arrays [T, 3]: the
    det, u', v' and t' columns of each triangle, in four groups of Tp (T
    padded to a multiple of N_TILE, and to at least one tile, with zero
    columns, which never hit)."""
    n = cross(tri_e1, tri_e2)
    T = tri_v0.shape[0]
    z3 = torch.zeros_like(tri_v0)
    z1 = torch.zeros_like(tri_v0[:, :1])
    zpad = torch.zeros(T, K_FEAT - K_GEOM, dtype=tri_v0.dtype, device=tri_v0.device)
    # feature layout: [d (0:3), o x d (3:6), o (6:9), 1 (9), maxt (10), pad]
    det_col = torch.cat([cross(tri_e2, tri_e1), z3, z3, z1, zpad], dim=-1)
    u_col = torch.cat([-cross(tri_e2, tri_v0), tri_e2, z3, z1, zpad], dim=-1)
    v_col = torch.cat([-cross(tri_v0, tri_e1), -tri_e1, z3, z1, zpad], dim=-1)
    t_col = torch.cat([z3, z3, n, -dot(tri_v0, n, keepdims=True), zpad], dim=-1)
    pad = max(N_TILE, T + (-T) % N_TILE) - T
    groups = [torch.cat([c, c.new_zeros(pad, K_FEAT)]) for c in (det_col, u_col, v_col, t_col)]
    return torch.cat(groups).T.contiguous()


def mxu_features(o, d, maxt):
    """Ray feature rows [N, 16]: d, o x d, o, 1, maxt, zeros."""
    n = o.shape[0]
    return torch.cat([d, cross(o, d), o, o.new_ones(n, 1), maxt[:, None],
                      o.new_zeros(n, K_FEAT - K_GEOM - 1)], dim=-1)


def mxu_epilogue(prod, maxt):
    """K3's epilogue on the contraction [R, 4 Tp] of R rays: (t, prim, u,
    v), the closest hit, the lowest triangle index among equal t's."""
    tp = prod.shape[1] // 4
    det, up, vp, tq = prod[:, :tp], prod[:, tp:2 * tp], prod[:, 2 * tp:3 * tp], prod[:, 3 * tp:]
    ok = torch.abs(det) > 1e-12
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    u = up * inv_det
    v = vp * inv_det
    t = tq * inv_det
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0) & (t < maxt[:, None])
    t_m = torch.where(hit, t, float("inf"))
    best_t = t_m.amin(dim=1)
    col = torch.arange(tp, device=prod.device)
    idx = torch.where(t_m == best_t[:, None], col, tp).amin(dim=1)
    found = best_t < float("inf")
    j = torch.clamp(idx, max=tp - 1)[:, None]
    return (torch.where(found, best_t, float("inf")),
            torch.where(found, idx, -1).to(torch.int32),
            torch.where(found, u.gather(1, j)[:, 0], 0.0),
            torch.where(found, v.gather(1, j)[:, 0], 0.0))


def mxu_intersect_reference(cols, o, d, maxt, ray_chunk=1 << 16):
    """Plain PyTorch version of K3: the features, the contraction as an
    explicit float32 sum over the geometric slots k = 0..9 in ascending
    order (no matrix-product library call, so it does not depend on BLAS),
    then the epilogue. Rays go in chunks, to bound the [chunk, 4 Tp]
    intermediate."""
    outs = []
    for r0 in range(0, max(o.shape[0], 1), ray_chunk):
        sl = slice(r0, r0 + ray_chunk)
        feat = mxu_features(o[sl], d[sl], maxt[sl])
        prod = feat[:, 0:1] * cols[0]
        for k in range(1, K_GEOM):
            prod = prod + feat[:, k:k + 1] * cols[k]
        outs.append(mxu_epilogue(prod, maxt[sl]))
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _check(cols, o, d, maxt):
    dev = cols.device
    for name, x in (("o", o), ("d", d), ("maxt", maxt)):
        if x.device != dev:
            raise ValueError(f"mxu_intersect: {name} is on {x.device}, the columns on {dev}")
    for name, x in (("cols", cols), ("o", o), ("d", d), ("maxt", maxt)):
        if x.dtype != torch.float32:
            raise TypeError(f"mxu_intersect: {name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"mxu_intersect: {name} must be contiguous")
    if cols.ndim != 2 or cols.shape[0] != K_FEAT or cols.shape[1] % (4 * N_TILE):
        raise ValueError(
            f"mxu_intersect: cols must be [{K_FEAT}, 4 Tp] with Tp a multiple of "
            f"{N_TILE}, got {tuple(cols.shape)}"
        )
    if cols.shape[1] // 4 > MAX_MXU_TRIS:
        raise ValueError(
            f"mxu_intersect: {cols.shape[1] // 4} triangles > {MAX_MXU_TRIS}; "
            "use the shared-memory kernel (intersector='smem') or a BVH"
        )
    n = o.shape[0]
    if o.shape != (n, 3) or d.shape != (n, 3) or maxt.shape != (n,):
        raise ValueError(
            "mxu_intersect: rays must be o [N,3], d [N,3], maxt [N]; got "
            f"{tuple(o.shape)}, {tuple(d.shape)}, {tuple(maxt.shape)}"
        )
    if n >= 2**31 - 16:
        raise ValueError("mxu_intersect: more than 2^31 - 17 rays in one launch")


# -fmad=false: the features (o x d) and the epilogue round every product and
# sum as the plain version does; only the contraction differs (3xTF32)
BUILD_FLAGS = ("-fmad=false",)


@functools.cache
def _launcher():
    fn = cuda_build.load("intersect_mxu", BUILD_FLAGS).mxu_intersect_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, ci, vp, vp, vp, ci, vp, vp, vp, vp, vp]
    fn.restype = ci
    return fn


def mxu_intersect(cols, o, d, maxt):
    """Closest hit of each ray over the column table (see the module
    docstring). On the card this launches K3 and counts the launch in
    ``mxu_intersect.launches``; on the CPU it runs the plain version."""
    _check(cols, o, d, maxt)
    if cols.device.type == "cpu":
        return mxu_intersect_reference(cols, o, d, maxt)
    if cols.device.type != "cuda":
        raise ValueError(f"mxu_intersect: no kernel for device {cols.device}")
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    prim = torch.empty(n, dtype=torch.int32, device=o.device)
    u = torch.empty(n, dtype=torch.float32, device=o.device)
    v = torch.empty(n, dtype=torch.float32, device=o.device)
    if n == 0:
        return t, prim, u, v
    launch = _launcher()
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream(o.device).cuda_stream
        rc = launch(
            cols.data_ptr(), cols.shape[1] // 4, o.data_ptr(), d.data_ptr(),
            maxt.data_ptr(), n, t.data_ptr(), prim.data_ptr(), u.data_ptr(),
            v.data_ptr(), stream,
        )
    mxu_intersect.launches += 1
    if rc != 0:
        raise RuntimeError(f"mxu_intersect: kernel launch failed with CUDA error {rc}")
    return t, prim, u, v


mxu_intersect.launches = 0
