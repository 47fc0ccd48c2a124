"""Geometry: host-side build, closest-hit and shadow queries, and shading
(counterpart of mitsuba_tpu/render/shapes.py, triangles and analytic
spheres).

All shapes of a scene are compiled into one struct-of-arrays triangle table
(a rectangle is 2 triangles, a cube 12, a mesh its faces), padded with
degenerate rows to a multiple of TRI_CHUNK. A scene of at most
MAX_SMEM_TRIS triangles is queried through kernel K1
(``ops/intersect.py``), which sweeps the table's real rows (the padding
rows sit at the end and never hit, so the prim indices do not move), or,
when it was loaded with ``intersector="mma"`` and has at most MAX_MXU_TRIS
triangles, through kernel K3 (``ops/intersect_mxu.py``), which takes every
determinant from one matrix product on the tensor cores. A larger one gets a
wide-leaf BVH (built on the host, ``native.build_bvh_wide``), its
triangle arrays permuted into leaf order, and is queried through kernel K2
(``ops/bvh_sweep.py``): closest hit, and any hit for shadow rays.

Analytic spheres are a second table (centre, radius, shape): primitive ids
[n_tris, n_tris + S) after the (padded) triangles. Every closest-hit and
shadow query runs the sphere pass after the triangle kernel: a dense [N, S]
quadratic in plain PyTorch, bounded by the kernel's t, where a sphere wins
only when strictly closer than the triangle (the JAX package's
``_sphere_pass``). A scene without triangles launches no closest-hit
kernel: there is nothing for it to sweep. Capsules and SDF grids are not
yet ported; disks and cylinders are tessellated into triangles by the
loader, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import native
from ..core.frame import coordinate_system, cross, dot, normalize
from ..ops.bvh_sweep import MAX_WIDE_LEAF, bvh_sweep_intersect, bvh_sweep_occluded, kernel_rows
from ..ops.intersect import INTERSECTORS, MAX_SMEM_TRIS, build_tri_table, tri_intersect
from ..ops.intersect_mxu import MAX_MXU_TRIS
from .records import PreliminaryIntersection, Ray, SurfaceInteraction

TRI_CHUNK = 64


@dataclass
class Geometry:
    """Flattened triangle geometry. ``vertices`` is the source of truth: the
    per-triangle tables tri_v0/e1/e2/ng/vn (and bvh_rows) are derived from
    it by refresh(). With a BVH, every per-triangle array (tri_face
    included) is in the BVH's leaf order; refresh() keeps that order and the
    BVH."""

    vertices: torch.Tensor    # [V, 3] concatenated per-mesh vertex buffer
    vertex_normals: torch.Tensor  # [V, 3] per-vertex normals (zeros if none)
    tri_face: torch.Tensor    # [T, 3] int64 vertex indices (padding: all 0)
    tri_v0: torch.Tensor      # [T, 3]
    tri_e1: torch.Tensor      # [T, 3] v1 - v0
    tri_e2: torch.Tensor      # [T, 3] v2 - v0
    tri_ng: torch.Tensor      # [T, 3] unit geometric normal (0 on padding)
    tri_vn: torch.Tensor      # [T, 3, 3] per-vertex shading normals
    tri_uv: torch.Tensor      # [T, 3, 2] per-vertex uv
    tri_shape: torch.Tensor   # [T] int32 shape index (-1 on padding)
    n_tris: int               # T, padded
    has_vertex_normals: bool = False
    # [M, 8] float32 wide-leaf BVH nodes as native.build_bvh_wide returns
    # them; None when the scene is small enough for K1
    bvh_nodes: torch.Tensor | None = None
    # (start, count) per mesh into `vertices`, in build order; traverse()
    # exposes each as `<shape>.vertex_positions`
    mesh_vertex_slices: tuple = ()
    # closest-hit kernel of a triangle table: "smem" (K1) or "mma" (K3)
    intersector: str = "smem"
    # triangles before the padding rows, which K1 and K3 do not sweep (K3
    # pads to its own n-tile); None sweeps every row
    n_real_tris: int | None = None
    # with a BVH: the table (v0 | e1 | e2) as K2 reads it, [T, 12] with
    # 16-byte rows (ops/bvh_sweep.py:kernel_rows), without a gradient; built
    # with the tables, so that no launch pads the table again
    bvh_rows: torch.Tensor | None = None
    # the unique mesh edges, for silhouette sampling (ad/projective.py):
    # endpoint vertex indices [E, 2] int64, the one or two adjacent
    # triangles [E, 2] int64 (-1: an open edge) and the shape [E] int32 (-1
    # on the one pad row of an empty scene); built once, with the tables.
    # edge_fv [E, 2, 2] int64: the same endpoints as the vertices of each
    # of the two triangles (the first's where the edge is open), which
    # differ from edge_v where a mesh splits its vertices at the edge
    edge_v: torch.Tensor | None = None
    edge_f: torch.Tensor | None = None
    edge_shape: torch.Tensor | None = None
    edge_fv: torch.Tensor | None = None
    # analytic spheres: centre [S, 3], radius [S], shape [S] int32 (one
    # zero row of shape -1 when S is 0); traverse() exposes each as
    # `<shape>.center` and `<shape>.radius`
    sph_center: torch.Tensor | None = None
    sph_radius: torch.Tensor | None = None
    sph_shape: torch.Tensor | None = None
    n_spheres: int = 0

    @property
    def has_bvh(self):
        return self.bvh_nodes is not None

    def refresh(self):
        """Recompute the derived per-triangle tables from `vertices`."""
        f = self.tri_face
        p0 = self.vertices[f[:, 0]]
        p1 = self.vertices[f[:, 1]]
        p2 = self.vertices[f[:, 2]]
        e1 = p1 - p0
        e2 = p2 - p0
        ng = cross(e1, e2)
        # degenerate padding rows get a zero normal
        n2 = dot(ng, ng, keepdims=True)
        good = n2 > 1e-24
        ng = torch.where(good, ng * torch.rsqrt(torch.where(good, n2, 1.0)), 0.0)
        return dataclasses.replace(self, tri_v0=p0, tri_e1=e1, tri_e2=e2, tri_ng=ng,
                                   tri_vn=self._shading_normals(ng),
                                   bvh_rows=self._bvh_rows(p0, e1, e2))

    def _bvh_rows(self, v0, e1, e2):
        if not self.has_bvh:
            return None
        return kernel_rows(torch.cat([v0, e1, e2], dim=-1).detach().to(torch.float32))

    def _shading_normals(self, ng):
        """[T, 3, 3] per-vertex shading normals: the vertex normals gathered
        through tri_face. Meshes without normals carry zero vertex normals:
        their rows take the face normal ng."""
        if not self.has_vertex_normals:
            return ng[:, None, :].expand(-1, 3, -1)
        f = self.tri_face
        vn = torch.stack([self.vertex_normals[f[:, k]] for k in range(3)], dim=1)
        missing = dot(vn, vn, keepdims=True) < 1e-12
        return torch.where(missing, ng[:, None, :], vn)


def build_geometry(tri_meshes, device, intersector="smem", spheres=()):
    """Host-side geometry compile. tri_meshes: list of dicts {vertices
    [V,3], faces [F,3], shape_index, normals (optional) [V,3], uvs
    (optional) [V,2]}; spheres: list of dicts {center [3], radius,
    shape_index}. `intersector` picks the closest-hit kernel of a
    triangle table: "smem" (K1) or "mma" (K3, at most MAX_MXU_TRIS
    triangles and no BVH; a ValueError otherwise)."""
    if intersector not in INTERSECTORS:
        raise ValueError(f"intersector must be one of {INTERSECTORS}, got {intersector!r}")
    v0s, e1s, e2s, ngs, uvs, sids = [], [], [], [], [], []
    verts_all, vnorms_all, faces_all, vslices = [], [], [], []
    v_off = 0
    any_vn = False
    for m in tri_meshes:
        V = np.asarray(m["vertices"], np.float32)
        F = np.asarray(m["faces"], np.int32)
        verts_all.append(V)
        faces_all.append(F + v_off)
        if m.get("normals") is not None and len(m["normals"]) == len(V):
            vnorms_all.append(np.asarray(m["normals"], np.float32))
            any_vn = True
        else:
            vnorms_all.append(np.zeros_like(V))
        vslices.append((v_off, V.shape[0]))
        v_off += V.shape[0]
        p0, p1, p2 = V[F[:, 0]], V[F[:, 1]], V[F[:, 2]]
        e1, e2 = p1 - p0, p2 - p0
        ng = np.cross(e1, e2)
        area2 = np.linalg.norm(ng, axis=-1, keepdims=True)
        ng = ng / np.maximum(area2, 1e-20)
        v0s.append(p0)
        e1s.append(e1)
        e2s.append(e2)
        ngs.append(ng)
        if m.get("uvs") is not None:
            U = np.asarray(m["uvs"], np.float32)
            uvs.append(np.stack([U[F[:, 0]], U[F[:, 1]], U[F[:, 2]]], axis=1))
        else:
            default_uv = np.array([[0, 0], [1, 0], [1, 1]], np.float32)
            uvs.append(np.tile(default_uv[None], (F.shape[0], 1, 1)))
        sids.append(np.full((F.shape[0],), m["shape_index"], np.int32))

    def cat(lst, empty_shape):
        if lst:
            return np.concatenate(lst, axis=0)
        return np.zeros(empty_shape, np.float32)

    T = sum(x.shape[0] for x in v0s)
    # pad to a chunk multiple with degenerate triangles (e1=e2=0 -> det=0, no hit)
    T_pad = max(((T + TRI_CHUNK - 1) // TRI_CHUNK) * TRI_CHUNK, TRI_CHUNK)

    def pad(x, total, fill=0.0):
        pad_n = total - x.shape[0]
        if pad_n <= 0:
            return x
        return np.concatenate(
            [x, np.full((pad_n,) + x.shape[1:], fill, x.dtype)], axis=0
        )

    tri = {
        "tri_v0": pad(cat(v0s, (0, 3)), T_pad),
        "tri_e1": pad(cat(e1s, (0, 3)), T_pad),
        "tri_e2": pad(cat(e2s, (0, 3)), T_pad),
        "tri_ng": pad(cat(ngs, (0, 3)), T_pad),
        "tri_uv": pad(cat(uvs, (0, 3, 2)), T_pad),
        "tri_shape": pad(
            np.concatenate(sids, axis=0) if sids else np.zeros((0,), np.int32), T_pad, -1
        ).astype(np.int32),
        "tri_face": pad(
            np.concatenate(faces_all, axis=0) if faces_all else np.zeros((0, 3), np.int32),
            T_pad, 0,
        ).astype(np.int64),
    }
    if intersector == "mma" and T > MAX_MXU_TRIS:
        raise ValueError(
            f"intersector='mma' takes at most {MAX_MXU_TRIS} triangles; this scene has {T}"
            + (" and takes the BVH path" if T > MAX_SMEM_TRIS else "")
        )
    bvh_nodes = None
    if T > MAX_SMEM_TRIS:
        # large scenes: the native binned-SAH BVH, and every per-triangle
        # array in its leaf order (the padding rows stay at the end: the
        # leaves never reach them)
        tris9 = np.concatenate([tri["tri_v0"][:T], tri["tri_e1"][:T], tri["tri_e2"][:T]], axis=-1)
        bvh_nodes, order = native.build_bvh_wide(tris9, max_leaf=MAX_WIDE_LEAF)
        perm = np.concatenate([order, np.arange(T, T_pad)]).astype(np.int64)
        tri = {k: x[perm] for k, x in tri.items()}

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    edge_v, edge_f, edge_shape, edge_fv = edge_table(tri["tri_face"][:T], tri["tri_shape"][:T],
                                                     cat(verts_all, (1, 3)))
    S = len(spheres)
    sph = {
        "sph_center": np.asarray([s["center"] for s in spheres], np.float32).reshape(S, 3)
        if S else np.zeros((1, 3), np.float32),
        "sph_radius": np.asarray([s["radius"] for s in spheres], np.float32).reshape(S)
        if S else np.zeros((1,), np.float32),
        "sph_shape": np.asarray([s["shape_index"] for s in spheres], np.int32).reshape(S)
        if S else np.full((1,), -1, np.int32),
    }
    geom = Geometry(
        vertices=dev(cat(verts_all, (1, 3))),
        vertex_normals=dev(cat(vnorms_all, (1, 3))),
        **{k: dev(x) for k, x in tri.items()},
        tri_vn=None,
        n_tris=T_pad,
        has_vertex_normals=any_vn,
        bvh_nodes=None if bvh_nodes is None else dev(bvh_nodes),
        mesh_vertex_slices=tuple(vslices),
        intersector=intersector,
        n_real_tris=T,
        edge_v=dev(edge_v),
        edge_f=dev(edge_f),
        edge_shape=dev(edge_shape),
        edge_fv=dev(edge_fv),
        **{k: dev(x) for k, x in sph.items()},
        n_spheres=S,
    )
    return dataclasses.replace(geom, tri_vn=geom._shading_normals(geom.tri_ng),
                               bvh_rows=geom._bvh_rows(geom.tri_v0, geom.tri_e1, geom.tri_e2))


def weld(vertices, faces, tri_shape):
    """faces [T, 3] with each vertex replaced by the lowest-numbered vertex
    of the same shape at the same position (bit for bit)."""
    V = vertices.shape[0]
    vshape = np.full(V, -1, np.int64)
    vshape[faces.reshape(-1)] = np.repeat(tri_shape.astype(np.int64), 3)
    key = np.concatenate([vshape[:, None].astype(np.float64),
                          vertices.astype(np.float64)], axis=1)
    _, first, inverse = np.unique(key, axis=0, return_index=True, return_inverse=True)
    return first[inverse.reshape(-1)][faces]


def edge_table(faces, tri_shape, vertices, weld_vertices=True):
    """The unique edges of the triangles `faces` [T, 3] (in the table's
    order, so after a BVH's permutation): (edge_v [E, 2], the canonical
    (low, high) vertex pairs in ascending order; edge_f [E, 2], the first
    and second triangle that holds each, -1 where only one does; edge_shape
    [E], the shape of the first; edge_fv [E, 2, 2], the endpoints of
    edge_v as vertices of each of the two triangles, the first's twice on
    an open edge). With `weld_vertices`, an edge is a pair of positions of
    one shape (``weld``): a mesh whose faces do not share their vertices
    (the cube, a mesh split at its normal or uv seams) has each edge once,
    with its two faces, and edge_fv names each face's copies of its
    endpoints. Without it, an edge is a pair of vertex indices, as the JAX
    package keys it: such a mesh has each edge twice, open. An empty scene
    gets one pad row (shape -1)."""
    T = faces.shape[0]
    if T == 0:
        return (np.zeros((1, 2), np.int64), np.full((1, 2), -1, np.int64),
                np.full((1,), -1, np.int32), np.zeros((1, 2, 2), np.int64))
    raw = faces.astype(np.int64)
    faces = weld(vertices, faces, tri_shape) if weld_vertices else raw
    pairs = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0)
    raw_pairs = np.concatenate([raw[:, [0, 1]], raw[:, [1, 2]], raw[:, [2, 0]]], axis=0)
    # each face's copies of the endpoints, in the order of (low, high)
    raw_pairs = np.where((pairs[:, 0] <= pairs[:, 1])[:, None], raw_pairs, raw_pairs[:, ::-1])
    owner = np.tile(np.arange(T, dtype=np.int64), 3)
    key = pairs.min(axis=1).astype(np.int64) * np.int64(1 << 32) + pairs.max(axis=1)
    order = np.argsort(key, kind="stable")
    key_s, owner_s, raw_s = key[order], owner[order], raw_pairs[order]
    uniq, start = np.unique(key_s, return_index=True)
    nxt = np.minimum(start + 1, key_s.shape[0] - 1)
    has2 = (key_s[nxt] == uniq) & (nxt != start)
    edge_v = np.stack([uniq // (1 << 32), uniq % (1 << 32)], axis=-1).astype(np.int64)
    edge_f = np.stack([owner_s[start], np.where(has2, owner_s[nxt], -1)], axis=-1)
    edge_fv = np.stack([raw_s[start], np.where(has2[:, None], raw_s[nxt], raw_s[start])], axis=1)
    return (edge_v, edge_f.astype(np.int64), tri_shape[owner_s[start]].astype(np.int32),
            edge_fv.astype(np.int64))


def ray_intersect_preliminary(geom: Geometry, ray: Ray, active=None):
    """Closest-hit query through kernel K1 (or K3, as the geometry asks), or
    K2 on a BVH, then the sphere pass; inactive lanes never hit. t is inf on
    a miss. Both queries are differentiable in the rays and the triangle
    table, the sphere pass in the spheres too."""
    if active is None:
        active = torch.ones(ray.o.shape[0], dtype=torch.bool, device=ray.o.device)
    maxt = torch.where(active, ray.maxt, -float("inf")).contiguous()
    o, d = ray.o.contiguous(), ray.d.contiguous()
    if geom.has_bvh:
        t, prim, u, v = bvh_sweep_intersect(geom.bvh_nodes, build_tri_table(geom), o, d, maxt,
                                            geom.bvh_rows)
        t = torch.where(prim >= 0, t, float("inf"))
    elif geom.n_real_tris == 0:
        # no triangle to sweep: every lane misses them
        return sphere_pass(geom, ray, _miss(maxt), maxt)
    else:
        # the real rows only: a slice, so the cotangent of the hit still
        # reaches the whole table (zero on the padding rows)
        t, prim, u, v = tri_intersect(build_tri_table(geom)[:geom.n_real_tris], o, d, maxt,
                                      geom.intersector)
    pi = PreliminaryIntersection(t=t, prim_index=prim, prim_uv=torch.stack([u, v], dim=-1))
    return sphere_pass(geom, ray, pi, maxt)


def sphere_pass(geom: Geometry, ray: Ray, pi: PreliminaryIntersection, maxt):
    """The analytic spheres after the triangles' closest hit `pi`, bounded
    by its t where a triangle was hit and by `maxt` (-inf on inactive
    lanes) elsewhere: a sphere replaces the hit only when strictly closer,
    and keeps the triangle's prim_uv (the JAX package's _sphere_pass)."""
    if geom.n_spheres == 0:
        return pi
    best_t = torch.where(pi.prim_index >= 0, pi.t, maxt)
    # ||o + t d - c||^2 = r^2 over [N, S]
    oc = ray.o[:, None, :] - geom.sph_center[None]
    b = dot(oc, ray.d[:, None, :])
    c = dot(oc, oc) - geom.sph_radius[None] ** 2
    disc = b * b - c
    # masked sqrt: sqrt(max(disc, 0)) has a NaN adjoint at disc <= 0
    pos = disc > 0.0
    sq = torch.where(pos, torch.sqrt(torch.where(pos, disc, 1.0)), 0.0)
    t0 = -b - sq
    t_s = torch.where(t0 > 0.0, t0, -b + sq)
    t_s = torch.where((disc >= 0.0) & (t_s > 0.0), t_s, float("inf"))
    tj, j = torch.min(t_s, dim=-1)
    closer = tj < best_t
    prim = torch.where(closer, geom.n_tris + j.to(torch.int32), pi.prim_index)
    t = torch.where(prim >= 0, torch.where(closer, tj, best_t), float("inf"))
    return PreliminaryIntersection(t=t, prim_index=prim, prim_uv=pi.prim_uv)


def ray_test(geom: Geometry, ray: Ray, active=None):
    """Shadow query: any hit through K2 on a BVH (the walk ends at the
    first hit), ORed with the sphere pass; on a triangle table it is a
    closest-hit query through the geometry's intersector."""
    if not geom.has_bvh:
        return ray_intersect_preliminary(geom, ray, active).is_valid
    if active is None:
        active = torch.ones(ray.o.shape[0], dtype=torch.bool, device=ray.o.device)
    maxt = torch.where(active, ray.maxt, -float("inf")).contiguous()
    occ = bvh_sweep_occluded(
        geom.bvh_nodes, build_tri_table(geom), ray.o.contiguous(), ray.d.contiguous(), maxt,
        geom.bvh_rows,
    )
    if geom.n_spheres:
        occ = occ | sphere_pass(geom, ray, _miss(maxt), maxt).is_valid
    return occ & active


def _miss(maxt):
    """The PreliminaryIntersection of lanes that hit no triangle."""
    return PreliminaryIntersection(
        t=torch.full_like(maxt, float("inf")),
        prim_index=torch.full(maxt.shape, -1, dtype=torch.int32, device=maxt.device),
        prim_uv=torch.zeros(maxt.shape + (2,), dtype=torch.float32, device=maxt.device))


def compute_surface_interaction(geom: Geometry, ray: Ray, pi: PreliminaryIntersection):
    """Shading frame, uv and shape index of the closest hits. With vertex
    normals the shading normal is the normalized barycentric blend of the
    hit triangle's three. A sphere hit takes the radial normal and the
    (azimuth, polar angle) uv."""
    valid = pi.is_valid
    prim = torch.clamp(pi.prim_index, min=0).to(torch.int64)
    tprim = torch.clamp(prim, max=geom.n_tris - 1)

    t = torch.where(valid, pi.t, float("inf"))
    p = ray.at(torch.where(valid, pi.t, 0.0))

    u = pi.prim_uv[:, 0]
    v = pi.prim_uv[:, 1]
    w = 1.0 - u - v
    ng = geom.tri_ng[tprim]
    if geom.has_vertex_normals:
        vn = geom.tri_vn[tprim]
        sh_n = normalize(w[:, None] * vn[:, 0] + u[:, None] * vn[:, 1] + v[:, None] * vn[:, 2])
    else:
        sh_n = ng
    uv3 = geom.tri_uv[tprim]
    uv = w[:, None] * uv3[:, 0] + u[:, None] * uv3[:, 1] + v[:, None] * uv3[:, 2]
    shape_index = geom.tri_shape[tprim]

    if geom.n_spheres:
        is_tri = (prim < geom.n_tris)[:, None]
        sprim = torch.clamp(prim - geom.n_tris, 0, geom.n_spheres - 1)
        ng_s = normalize(p - geom.sph_center[sprim])
        ng = torch.where(is_tri, ng, ng_s)
        sh_n = torch.where(is_tri, sh_n, ng_s)
        uv = torch.where(is_tri, uv, sphere_uv(ng_s))
        shape_index = torch.where(is_tri[:, 0], shape_index, geom.sph_shape[sprim])

    # orient the geometric normal to the shading normal's hemisphere
    ng = torch.where(dot(ng, sh_n, keepdims=True) < 0.0, -ng, ng)

    sh_s, sh_t = coordinate_system(sh_n)
    wi_world = -ray.d
    wi_local = torch.stack(
        [dot(wi_world, sh_s), dot(wi_world, sh_t), dot(wi_world, sh_n)], dim=-1
    )
    return SurfaceInteraction(
        t=t, p=p, n=ng, sh_n=sh_n, sh_s=sh_s, sh_t=sh_t, uv=uv, wi=wi_local,
        shape_index=torch.where(valid, shape_index, -1),
        prim_index=torch.where(valid, pi.prim_index, -1),
        prim_uv=pi.prim_uv,
    )


def sphere_uv(n):
    """The uv of a unit radial direction n on a sphere: (azimuth / 2 pi +
    1/2, polar angle / pi)."""
    theta = torch.arccos(torch.clamp(n[..., 2], -1.0, 1.0))
    phi = torch.atan2(n[..., 1], n[..., 0])
    return torch.stack([phi / (2 * math.pi) + 0.5, theta / math.pi], dim=-1)


# ---------------------------------------------------------------------------
# Host-side shape builders
# ---------------------------------------------------------------------------

def make_rectangle(to_world):
    """Unit rectangle [-1,1]^2 in the z=0 plane -> 2 triangles."""
    V = np.array(
        [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32
    )
    F = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    UV = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    Vw = np.asarray(to_world.m)[:3, :3] @ V.T
    Vw = (Vw + np.asarray(to_world.m)[:3, 3:4]).T
    return {"vertices": Vw.astype(np.float32), "faces": F, "uvs": UV}


def make_cube(to_world):
    """Unit cube [-1,1]^3 -> 12 triangles."""
    faces6 = []
    verts = []
    uvs = []
    idx = 0
    axes = [
        np.array([0, 0, -1.0]), np.array([0, 0, 1.0]),
        np.array([0, -1.0, 0]), np.array([0, 1.0, 0]),
        np.array([-1.0, 0, 0]), np.array([1.0, 0, 0]),
    ]
    for n in axes:
        # a face with outward normal n
        a = np.array([1.0, 0, 0]) if abs(n[0]) < 0.9 else np.array([0, 1.0, 0])
        u = np.cross(n, a)
        u /= np.linalg.norm(u)
        v = np.cross(n, u)
        c = np.stack([n + (-u - v), n + (u - v), n + (u + v), n + (-u + v)])
        # wind so that the face normal points outward
        wind_n = np.cross(c[1] - c[0], c[2] - c[0])
        if np.dot(wind_n, n) < 0:
            c = c[::-1]
        verts.append(c)
        uvs.append(np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32))
        faces6.append(np.array([[idx, idx + 1, idx + 2], [idx, idx + 2, idx + 3]]))
        idx += 4
    V = np.concatenate(verts).astype(np.float32)
    F = np.concatenate(faces6).astype(np.int32)
    UV = np.concatenate(uvs).astype(np.float32)
    Vw = (np.asarray(to_world.m)[:3, :3] @ V.T + np.asarray(to_world.m)[:3, 3:4]).T
    return {"vertices": Vw.astype(np.float32), "faces": F, "uvs": UV}


def make_sphere(spec, to_world):
    """An analytic sphere's {center, radius}: the centre through to_world,
    the radius scaled by the cube root of its linear part's determinant."""
    mm = np.asarray(to_world.m)
    c = mm[:3, :3] @ np.asarray(spec.get("center", [0, 0, 0]), np.float32) + mm[:3, 3]
    scale = float(np.cbrt(abs(np.linalg.det(mm[:3, :3]))))
    return {"center": c, "radius": float(spec.get("radius", 1.0)) * scale}


# the segments of the tessellated cylinder and disk, as the JAX package's loader has them
CYLINDER_SEGMENTS = 96
DISK_SEGMENTS = 64


def make_cylinder(spec, to_world):
    """An open cylinder from p0 to p1 of `radius`, a strip of 2 k triangles
    (k = CYLINDER_SEGMENTS) with radial vertex normals, as the JAX
    package's loader tessellates it."""
    k = CYLINDER_SEGMENTS
    r = float(spec.get("radius", 1.0))
    p0 = np.asarray(spec.get("p0", [0, 0, 0]), np.float32)
    p1 = np.asarray(spec.get("p1", [0, 0, 1]), np.float32)
    axis = p1 - p0
    az = axis / max(np.linalg.norm(axis), 1e-12)
    ax = np.array([1.0, 0, 0], np.float32)
    if abs(az @ ax) > 0.9:
        ax = np.array([0, 1.0, 0], np.float32)
    ax = ax - (ax @ az) * az
    ax /= np.linalg.norm(ax)
    ay = np.cross(az, ax)
    ang = np.linspace(0, 2 * np.pi, k, endpoint=False)
    ring = (np.outer(np.cos(ang), ax) + np.outer(np.sin(ang), ay)) * r
    V = np.concatenate([p0 + ring, p1 + ring]).astype(np.float32)
    N = np.concatenate([ring / r, ring / r]).astype(np.float32)
    idx = np.arange(k, dtype=np.int32)
    nxt = np.roll(idx, -1)
    F = np.concatenate([np.stack([idx, nxt, idx + k], -1),
                        np.stack([nxt, nxt + k, idx + k], -1)]).astype(np.int32)
    UV = np.stack([np.concatenate([ang, ang]) / (2 * np.pi),
                   np.concatenate([np.zeros(k), np.ones(k)])], -1).astype(np.float32)
    mm = np.asarray(to_world.m)
    Vw = (mm[:3, :3] @ V.T + mm[:3, 3:4]).T.astype(np.float32)
    Nw = (np.linalg.inv(mm[:3, :3]).T @ N.T).T
    Nw = (Nw / np.linalg.norm(Nw, axis=-1, keepdims=True)).astype(np.float32)
    return {"vertices": Vw, "faces": F, "normals": Nw, "uvs": UV}


def make_disk(to_world):
    """The unit disk in the z = 0 plane, a fan of k = DISK_SEGMENTS
    triangles, as the JAX package's loader tessellates it."""
    k = DISK_SEGMENTS
    ang = np.linspace(0, 2 * np.pi, k, endpoint=False)
    V = np.concatenate([np.zeros((1, 3), np.float32),
                        np.stack([np.cos(ang), np.sin(ang), np.zeros(k)], -1).astype(np.float32)])
    F = np.stack([np.zeros(k, np.int32), np.arange(1, k + 1, dtype=np.int32),
                  np.roll(np.arange(1, k + 1, dtype=np.int32), -1)], -1)
    mm = np.asarray(to_world.m)
    return {"vertices": (mm[:3, :3] @ V.T + mm[:3, 3:4]).T.astype(np.float32), "faces": F}
