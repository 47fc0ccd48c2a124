"""Closest-hit query over a triangle table: kernel K1, its plain version and
the gradient of the hit (counterpart of mitsuba_tpu/ops/intersect.py).

``smem_intersect`` launches the hand-written CUDA kernel
``csrc/tri_intersect.cu`` (which replaces the TPU kernel
``mitsuba_tpu/ops/intersect.py:_kernel``) for tensors on the card, and runs
``tri_intersect_reference`` for tensors on the CPU. A tensor on the card
never falls back to the plain version.

``tri_intersect`` is the differentiable entry (the JAX package's custom VJP
as a ``torch.autograd.Function``). Its forward is K1 (``intersector=
"smem"``) or K3 (``"mma"``, ``ops/intersect_mxu.py``: the same contract,
the determinants from the tensor cores); its backward, the same for both,
is the analytic VJP of the planar hit (``mt_vjp``) in plain PyTorch, as the
JAX package's is plain XLA: cotangents for the rays' o and d, and for the
table rows of the hit triangles, added with ``index_add_``; none for maxt.

Contract (the TPU kernel's): table [T, 9] float32 rows (v0 | e1 | e2) with
T <= MAX_SMEM_TRIS; rays o, d [N, 3] and maxt [N] float32. A hit needs
|det| > 1e-12, barycentrics inside the triangle and 0 < t < best_t, with
best_t starting at maxt; on a tie the first triangle index wins; maxt <= 0
or -inf disables a lane. Returns t [N] (inf on a miss), prim [N] int32
(-1 on a miss), u [N], v [N] (0 on a miss).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build, intersect_mxu

MAX_SMEM_TRIS = 4096
INTERSECTORS = ("smem", "mma")


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
    """Moller-Trumbore of rays [R] against triangles, (t, u, v, hit,
    det_ok), each [R, C]: tri is [C, 9] (every ray against the same C
    triangles) or [R, C, 9] (each ray against its own). The same operations
    in the same order as the kernels K1 and K2. det_ok (|det| > 1e-12) is
    where u is the kernels' u; the kernels stop a pair after det where it
    is false, and after u where u < 0, u > 1 or u is NaN."""
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
    return t, u, v, hit, det_ok


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
            t, u, v, hit, _ = moller_trumbore(ro, rd, tri)
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


def smem_intersect(table, o, d, maxt):
    """Closest hit of each ray over the triangle table (see the module
    docstring for the contract). On the card this launches K1 and counts
    the launch in ``smem_intersect.launches``; on the CPU it runs the plain
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
    smem_intersect.launches += 1
    if rc != 0:
        raise RuntimeError(f"tri_intersect: kernel launch failed with CUDA error {rc}")
    return t, prim, u, v


smem_intersect.launches = 0


def mt_vjp(e1, e2, d, g_t, g_u, g_v, valid):
    """The Moller-Trumbore VJP shared by K1, K2 and K3's wrappers (the JAX
    package's mt_vjp). The hit solves M x = o - v0 with M = [-d | e1 | e2]
    and x = (t, u, v); for a cotangent g on x, y = M^-T g gives
    grad_o = y, grad_v0 = -y, grad_d = t y, grad_e1 = -u y, grad_e2 = -v y,
    with y = (g_t (e1 x e2) + g_u (d x e2) + g_v (e1 x d)) / det and
    det = -(d . e1 x e2). Lanes that are not valid, or whose det is below
    1e-12, get y = 0."""
    nrm = torch.linalg.cross(e1, e2)
    det = -(d * nrm).sum(-1)
    ok = valid & (torch.abs(det) > 1e-12)
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    y = (g_t[:, None] * nrm + g_u[:, None] * torch.linalg.cross(d, e2)
         + g_v[:, None] * torch.linalg.cross(e1, d)) * inv_det[:, None]
    return torch.where(ok[:, None], y, 0.0)


def hit_vjp(table, prim, t, u, v, d, g_t, g_u, g_v):
    """Cotangents (table, o, d) of a closest hit (t, prim, u, v) for the
    output cotangents g_t, g_u, g_v (None for an output with none): the
    table rows of the hit triangles get (-y | -u y | -v y), added with
    index_add_. A miss gets nothing: its t may be inf, so t y is masked."""
    zero = torch.zeros_like(t)
    g_t, g_u, g_v = (zero if g is None else g for g in (g_t, g_u, g_v))
    valid = prim >= 0
    p = torch.clamp(prim, min=0).to(torch.int64)
    rows = table[p]
    y = mt_vjp(rows[:, 3:6], rows[:, 6:9], d, g_t, g_u, g_v, valid)
    ct_rows = torch.cat([-y, -u[:, None] * y, -v[:, None] * y], dim=-1)
    ct_table = torch.zeros_like(table).index_add_(0, p, torch.where(valid[:, None], ct_rows, 0.0))
    return ct_table, y, torch.where(valid, t, 0.0)[:, None] * y


def _closest_hit(intersector, table, o, d, maxt):
    """The forward of either route, looked up at call time."""
    if intersector == "smem":
        return smem_intersect(table, o, d, maxt)
    cols = intersect_mxu.build_mxu_cols(table[:, 0:3], table[:, 3:6], table[:, 6:9])
    return intersect_mxu.mxu_intersect(cols, o, d, maxt)


class TriIntersect(torch.autograd.Function):
    """Closest hit with the analytic VJP of the planar hit (the JAX
    package's tri_intersect custom VJP)."""

    @staticmethod
    def forward(ctx, table, o, d, maxt, intersector):
        t, prim, u, v = _closest_hit(intersector, table, o, d, maxt)
        ctx.save_for_backward(table, prim, t, u, v, d)
        ctx.mark_non_differentiable(prim)
        return t, prim, u, v

    @staticmethod
    def backward(ctx, g_t, _g_prim, g_u, g_v):
        table, prim, t, u, v, d = ctx.saved_tensors
        ct_table, ct_o, ct_d = hit_vjp(table, prim, t, u, v, d, g_t, g_u, g_v)
        return ct_table, ct_o, ct_d, None, None


def tri_intersect(table, o, d, maxt, intersector="smem"):
    """Differentiable closest hit (t, prim, u, v) of each ray over the
    triangle table, through K1 (``intersector="smem"``) or K3 (``"mma"``);
    see the module docstring."""
    if intersector not in INTERSECTORS:
        raise ValueError(f"intersector must be one of {INTERSECTORS}, got {intersector!r}")
    _check(table, o, d, maxt)
    return TriIntersect.apply(table, o, d, maxt, intersector)
