"""Closest-hit query over a triangle table: kernel K1 and its plain version
(counterpart of mitsuba_tpu/ops/intersect.py).

``tri_intersect`` launches the hand-written CUDA kernel
``csrc/tri_intersect.cu`` (which replaces the TPU kernel
``mitsuba_tpu/ops/intersect.py:_kernel``) for tensors on the card, and runs
``tri_intersect_reference`` for tensors on the CPU. A tensor on the card
never falls back to the plain version.

Contract (the TPU kernel's): table [T, 9] float32 rows (v0 | e1 | e2) with
T <= MAX_SMEM_TRIS; rays o, d [N, 3] and maxt [N] float32. A hit needs
|det| > 1e-12, barycentrics inside the triangle and 0 < t < best_t, with
best_t starting at maxt; on a tie the first triangle index wins; maxt <= 0
or -inf disables a lane. Returns t [N] (inf on a miss), prim [N] int32
(-1 on a miss), u [N], v [N] (0 on a miss).

The gradient of the hit (the JAX package's custom VJP) is not ported yet.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

MAX_SMEM_TRIS = 4096


def build_tri_table(geometry):
    """[T, 9] float32 triangle table (v0 | e1 | e2) of a Geometry."""
    return torch.cat(
        [geometry.tri_v0, geometry.tri_e1, geometry.tri_e2], dim=-1
    ).to(torch.float32).contiguous()


def _check(table, o, d, maxt):
    dev = table.device
    for name, x in (("o", o), ("d", d), ("maxt", maxt)):
        if x.device != dev:
            raise ValueError(f"tri_intersect: {name} is on {x.device}, the table on {dev}")
    for name, x in (("table", table), ("o", o), ("d", d), ("maxt", maxt)):
        if x.dtype != torch.float32:
            raise TypeError(f"tri_intersect: {name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"tri_intersect: {name} must be contiguous")
    if table.ndim != 2 or table.shape[1] != 9:
        raise ValueError(f"tri_intersect: table must be [T, 9], got {tuple(table.shape)}")
    if table.shape[0] > MAX_SMEM_TRIS:
        raise ValueError(
            f"tri_intersect: {table.shape[0]} triangles > {MAX_SMEM_TRIS}; "
            "larger meshes take the BVH path"
        )
    n = o.shape[0]
    if o.shape != (n, 3) or d.shape != (n, 3) or maxt.shape != (n,):
        raise ValueError(
            "tri_intersect: rays must be o [N,3], d [N,3], maxt [N]; got "
            f"{tuple(o.shape)}, {tuple(d.shape)}, {tuple(maxt.shape)}"
        )
    if n >= 2**31:
        raise ValueError("tri_intersect: more than 2^31 - 1 rays in one launch")


def moller_trumbore(o, d, tri):
    """Moller-Trumbore of rays [R] against triangles, (t, u, v, hit), each
    [R, C]: tri is [C, 9] (every ray against the same C triangles) or
    [R, C, 9] (each ray against its own). The same operations in the same
    order as the kernels K1 and K2."""
    o_x, o_y, o_z = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    d_x, d_y, d_z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = tri.unbind(-1)
    # pvec = d x e2
    pvx = d_y * e2z - d_z * e2y
    pvy = d_z * e2x - d_x * e2z
    pvz = d_x * e2y - d_y * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    det_ok = torch.abs(det) > 1e-12
    inv_det = torch.where(det_ok, 1.0 / det, 0.0)
    tvx = o_x - v0x
    tvy = o_y - v0y
    tvz = o_z - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    # qvec = tvec x e1
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (d_x * qvx + d_y * qvy + d_z * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    hit = det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
    return t, u, v, hit


def tri_intersect_reference(table, o, d, maxt, tri_chunk=64, ray_chunk=1 << 20):
    """Plain PyTorch version of K1: a sweep over chunks of triangles (and of
    rays, to bound memory) with a running closest-hit reduction. The
    closest hit of a chunk is its smallest t, the lowest index among equal
    t's; it replaces the running best only when strictly closer. That is
    the kernel's ascending sweep with a strict test, so the results agree
    bitwise."""
    n, T = o.shape[0], table.shape[0]
    outs = []
    for r0 in range(0, max(n, 1), ray_chunk):
        ro, rd = o[r0:r0 + ray_chunk], d[r0:r0 + ray_chunk]
        bt = maxt[r0:r0 + ray_chunk]
        bp = torch.full_like(bt, -1, dtype=torch.int32)
        bu = torch.zeros_like(bt)
        bv = torch.zeros_like(bt)
        for c0 in range(0, T, tri_chunk):
            tri = table[c0:c0 + tri_chunk]
            t, u, v, hit = moller_trumbore(ro, rd, tri)
            t = torch.where(hit, t, float("inf"))
            tmin = t.amin(dim=1)
            col = torch.arange(tri.shape[0], device=t.device)
            j = torch.where(t == tmin[:, None], col, tri.shape[0]).amin(dim=1)
            j = torch.clamp(j, max=tri.shape[0] - 1)[:, None]
            closer = tmin < bt
            bt = torch.where(closer, tmin, bt)
            bp = torch.where(closer, (c0 + j[:, 0]).to(torch.int32), bp)
            bu = torch.where(closer, u.gather(1, j)[:, 0], bu)
            bv = torch.where(closer, v.gather(1, j)[:, 0], bv)
        outs.append((torch.where(bp >= 0, bt, float("inf")), bp, bu, bv))
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat(parts) for parts in zip(*outs))


# -fmad=false: no FMA contraction, so the kernel rounds every product and
# sum as the plain version does (see csrc/tri_intersect.cu)
BUILD_FLAGS = ("-fmad=false",)


@functools.cache
def _launcher():
    fn = cuda_build.load("tri_intersect", BUILD_FLAGS).tri_intersect_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, ci, vp, vp, vp, ci, vp, vp, vp, vp, vp]
    fn.restype = ci
    return fn


def tri_intersect(table, o, d, maxt):
    """Closest hit of each ray over the triangle table (see the module
    docstring for the contract). On the card this launches K1 and counts
    the launch in ``tri_intersect.launches``; on the CPU it runs the plain
    version."""
    _check(table, o, d, maxt)
    if table.device.type == "cpu":
        return tri_intersect_reference(table, o, d, maxt)
    if table.device.type != "cuda":
        raise ValueError(f"tri_intersect: no kernel for device {table.device}")
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
            table.data_ptr(), table.shape[0], o.data_ptr(), d.data_ptr(),
            maxt.data_ptr(), n, t.data_ptr(), prim.data_ptr(), u.data_ptr(),
            v.data_ptr(), stream,
        )
    tri_intersect.launches += 1
    if rc != 0:
        raise RuntimeError(f"tri_intersect: kernel launch failed with CUDA error {rc}")
    return t, prim, u, v


tri_intersect.launches = 0
