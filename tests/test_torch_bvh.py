"""Slice 2 of the port, the large-mesh path, held against the JAX package on
the CPU: the native loaders and BVH builder, the plain version of kernel K2
(closest hit and any hit), shading with vertex normals, and a mesh scene
rendered end to end.

The port's BVH build is the JAX package's C++ built by the port, so nodes
and leaf order are held bitwise. The plain walk is held against the JAX
package's XLA traversal (mitsuba_tpu/render/bvh.py:bvh_intersect), not its
Pallas kernel in interpret mode, which takes minutes on the CPU: prim
bitwise on every lane, t, u, v within 1e-6 scaled by each hit's
conditioning, as in tests/test_torch_intersect.py, with the FMA
contraction of XLA on the CPU witnessed on every hit. (The flat 1e-6 that
the K1 tests hold on well-conditioned hits does not cover a ray that
starts several triangle sizes away: the cancellation in o - v0 costs a few
ulp more.) The kernel
itself is held bitwise against the plain version on the card, in
tests/test_torch_cuda.py.

The gradient of the hit (``bvh_sweep_intersect``'s backward) is held
against ``jax.vjp`` of render/bvh.py:bvh_intersect_ad, the XLA traversal
whose custom VJP is the Pallas kernel's (both are ops/intersect.py:mt_vjp
and a scatter into the leaf-order triangle arrays): o and d at rtol 1e-5
on the well-conditioned hits, each table row within 1e-5 of the sum of
|y| k over its lanes (y = mt_vjp's vector, of which the row's terms are
-y, -u y, -v y with u, v in [0, 1]; k = 1 / (|cos| sin) the hit's
conditioning: the random soup has grazing hits and slivers, whose u and v
the two packages round apart by ~1e-6 k, a large part of a small u). The tape gradient of the mesh's vertices
through a k=30 mesh scene is held against jax.grad of the same loss.
"""
import dataclasses
import struct

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mitsuba_tpu as mj
from mitsuba_tpu import native as JN
from mitsuba_tpu.ops import bvh_sweep as JB
from mitsuba_tpu.render import shapes as JSH
from mitsuba_tpu.render.bvh import bvh_intersect, bvh_intersect_ad
from mitsuba_tpu.render.params import _tree_get, _tree_set
from mitsuba_tpu.render.records import Ray as JRay
from mitsuba_tpu.render_api import render_lanes as j_render_lanes

import mitsuba_tpu_torch as mt
from mitsuba_tpu_torch import native as TN
from mitsuba_tpu_torch.ops import bvh_sweep as K2
from mitsuba_tpu_torch.render import shapes as TSH
from mitsuba_tpu_torch.render.records import Ray as TRay
from mitsuba_tpu_torch.render.scene_loader import mesh_scene, spherified_cube
from mitsuba_tpu_torch.render_api import make_wavefront
from mitsuba_tpu_torch.render_api import render_lanes as t_render_lanes

from mitsuba_tpu_torch.ops import intersect as K1

from test_torch_intersect import (
    _assert_hits_within_scaled_bound, _conditioning, _well_conditioned,
)


@pytest.fixture(autouse=True)
def _rgb():
    mj.set_variant("rgb")
    yield


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread. PyTorch's CPU kernels hand contiguous float
    math (sqrt, log, sin, cos, exp) to MKL's vector library in chunks, one
    per thread; when two threads make a process's first such call at once,
    MKL's lazy kernel dispatch races, and one chunk has come back from its
    low-accuracy kernel (a 4096-lane sqrt off by up to 2.98e-4 relative on
    lanes 2048-4095). One thread also keeps the suite's worker processes
    from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _soup_tris(n_tris, seed):
    """[T, 9] (v0 | e1 | e2) triangles with random vertices in [-3, 3]^3
    (the soup of tests/test_torch_intersect.py), an eighth of them
    duplicated (exact ties)."""
    r = np.random.default_rng(seed)
    V = r.uniform(-3, 3, (n_tris, 3, 3)).astype(np.float32)
    tris = np.concatenate([V[:, 0], V[:, 1] - V[:, 0], V[:, 2] - V[:, 0]], axis=-1)
    dup = r.choice(n_tris, n_tris // 8, replace=False)
    tris[dup] = tris[r.choice(n_tris, n_tris // 8)]
    return tris


def _sphere_tris(k):
    return np.concatenate(spherified_cube(k), axis=-1)


def _rays(n, seed):
    """Rays aimed into the soup's box; a quarter of the lanes disabled, a
    quarter with a finite maxt."""
    r = np.random.default_rng(seed)
    o = r.uniform(-6, 6, (n, 3)).astype(np.float32)
    d = (r.uniform(-2, 2, (n, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    maxt = np.full(n, np.inf, np.float32)
    maxt[1::4] = -np.inf
    maxt[2::4] = r.uniform(0.5, 8.0, maxt[2::4].shape)
    return o, d, maxt


# ---------------------------------------------------------------------------
# host C++: loaders and BVH builder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["soup3000", "sphere30"])
def test_build_bvh_wide_matches_jax_bitwise(case):
    tris = _soup_tris(3000, 0) if case == "soup3000" else _sphere_tris(30)
    nodes, order = TN.build_bvh_wide(tris, max_leaf=K2.MAX_WIDE_LEAF)
    j_nodes, j_order = JN.build_bvh_wide(tris, max_leaf=64)
    np.testing.assert_array_equal(nodes.view(np.int32), j_nodes.view(np.int32))
    np.testing.assert_array_equal(order, j_order)
    assert sorted(order.tolist()) == list(range(tris.shape[0]))
    payload = nodes[:, 7].view(np.int32)
    assert (payload & 0xFF).max() <= 64 and (payload & 0xFF).sum() == tris.shape[0]


def test_spherified_cube_is_the_bench_scripts(monkeypatch):
    import importlib.util
    import os
    import sys

    path = os.path.join(os.path.dirname(__file__), "..", "scripts", "bench_bvh.py")
    spec = importlib.util.spec_from_file_location("bench_bvh", path)
    bench = importlib.util.module_from_spec(spec)
    # the script puts its own checkout on sys.path when it is imported
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec.loader.exec_module(bench)
    for a, b in zip(spherified_cube(30), bench.spherified_cube(30)):
        np.testing.assert_array_equal(a, b)


def _quad_obj(path):
    path.write_text(
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
        "vn 0 0 1\nvn 0 0 1\nvn 0 0 1\nvn 0 0 1\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "f 1/1/1 2/2/2 3/3/3 4/4/4\n"
    )


def _quad_ply(path):
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(b"element vertex 4\nproperty float x\nproperty float y\nproperty float z\n")
        f.write(b"element face 2\nproperty list uchar int vertex_indices\nend_header\n")
        for v in [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0)]:
            f.write(struct.pack("<3f", *v))
        f.write(struct.pack("<B3i", 3, 0, 1, 2))
        f.write(struct.pack("<B3i", 3, 0, 2, 3))


@pytest.mark.parametrize("kind", ["obj", "ply"])
def test_mesh_loaders_match_jax(kind, tmp_path):
    path = tmp_path / f"quad.{kind}"
    (_quad_obj if kind == "obj" else _quad_ply)(path)
    port = (TN.load_obj if kind == "obj" else TN.load_ply)(str(path))
    ref = (JN.load_obj if kind == "obj" else JN.load_ply)(str(path))
    assert port.keys() == ref.keys()
    assert port["faces"].tolist() == [[0, 1, 2], [0, 2, 3]]
    for key in ref:
        assert port[key].dtype == ref[key].dtype
        np.testing.assert_array_equal(port[key], ref[key], err_msg=key)
    with pytest.raises(IOError):
        TN.load_obj(str(tmp_path / "missing.obj"))


# ---------------------------------------------------------------------------
# K2's plain version
# ---------------------------------------------------------------------------

def test_plain_walk_matches_jax_bvh_intersect():
    tris = _soup_tris(3000, 1)
    nodes, order = TN.build_bvh_wide(tris, max_leaf=K2.MAX_WIDE_LEAF)
    table = tris[order]
    o, d, maxt = _rays(1024, 2)
    jt, jp, ju, jv = (np.asarray(x) for x in bvh_intersect(
        jnp.asarray(nodes[:, 0:3]), jnp.asarray(nodes[:, 3:6]),
        jnp.asarray(nodes[:, 6].view(np.int32)), jnp.asarray(nodes[:, 7].view(np.int32)),
        jnp.asarray(table[:, 0:3]), jnp.asarray(table[:, 3:6]), jnp.asarray(table[:, 6:9]),
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(maxt),
    ))
    args = [torch.from_numpy(x) for x in (nodes, table, o, d, maxt)]
    stats = {}
    tt, tp, tu, tv = K2.bvh_sweep_reference(*args, stats=stats)
    assert tp.dtype == torch.int32 and not stats["hit_max_steps"]
    assert stats["node_visits"] > 0 and stats["tri_tests"] > 0
    hit = jp >= 0
    assert 100 < hit.sum() < (maxt > 0).sum()
    np.testing.assert_array_equal(tp.numpy(), jp)
    _assert_hits_within_scaled_bound(
        table, o, d, tt.numpy(), tu.numpy(), tv.numpy(), jt, jp, ju, jv
    )
    # a miss keeps its maxt; a disabled lane never hits
    np.testing.assert_array_equal(tt.numpy()[~hit], maxt[~hit])
    assert (tp.numpy()[~(maxt > 0)] == -1).all()

    # any hit (through the wrapper, which runs the plain version on the
    # CPU): the same booleans as the closest hit
    np.testing.assert_array_equal(K2.bvh_sweep_occluded(*args).numpy(), hit)


def test_plain_walk_reports_the_step_cap():
    tris = _soup_tris(3000, 1)
    nodes, order = TN.build_bvh_wide(tris)
    o, d, maxt = _rays(64, 3)
    stats = {}
    K2.bvh_sweep_reference(*(torch.from_numpy(x) for x in (nodes, tris[order], o, d, maxt)),
                           max_steps=2, stats=stats)
    assert stats["steps"] == 2 and stats["hit_max_steps"]


def test_bvh_wrapper_rejects_bad_inputs():
    nodes = torch.zeros(3, 8)
    table = torch.zeros(64, 9)
    o, d, maxt = torch.zeros(8, 3), torch.zeros(8, 3), torch.ones(8)
    with pytest.raises(TypeError):
        K2.bvh_sweep_intersect(nodes, table.double(), o, d, maxt)
    with pytest.raises(ValueError):
        K2.bvh_sweep_intersect(torch.zeros(3, 6), table, o, d, maxt)
    with pytest.raises(ValueError):
        K2.bvh_sweep_intersect(nodes, torch.zeros(64, 8), o, d, maxt)
    with pytest.raises(ValueError):
        K2.bvh_sweep_occluded(nodes, table, o, d, torch.ones(7))
    with pytest.raises(ValueError):
        K2.bvh_sweep_intersect(nodes, table, torch.zeros(3, 8).t(), d, maxt)
    # no device other than the CPU (plain version) and CUDA (kernel)
    with pytest.raises(ValueError):
        K2.bvh_sweep_intersect(*(x.to("meta") for x in (nodes, table, o, d, maxt)))


def test_plain_walk_counts_the_early_stops():
    """One leaf of 64 rows (8 of them degenerate) and rays that start in its
    box, so that every active ray tests every row: the walk's det and u
    stops equal a count over all (active ray, row) pairs, and they lie
    within its tests."""
    tris = _soup_tris(64, 4)
    tris[::8, 6:9] = tris[::8, 3:6]            # e2 = e1: det = 0
    nodes, order = TN.build_bvh_wide(tris, max_leaf=K2.MAX_WIDE_LEAF)
    assert nodes.shape[0] == 1
    table = torch.from_numpy(tris[order])
    o, d, maxt = (torch.from_numpy(x) for x in _rays(512, 6))
    o = o * 0.4                                # inside the leaf's box
    stats = {}
    K2.bvh_sweep_reference(torch.from_numpy(nodes), table, o, d, maxt, stats=stats)
    active = maxt > 0
    _, u, _, _, det_ok = K1.moller_trumbore(o[active], d[active], table)
    u_stop = det_ok & ~((u >= 0) & (u <= 1))
    assert stats["tri_tests"] == int(active.sum()) * 64
    assert stats["tri_det_stops"] == int((~det_ok).sum()) > 0
    assert stats["tri_u_stops"] == int(u_stop.sum()) > 0
    assert stats["tri_det_stops"] + stats["tri_u_stops"] < stats["tri_tests"]
    # any hit: the same counts over the rows each walk tested
    any_stats = {}
    K2.bvh_sweep_reference(torch.from_numpy(nodes), table, o, d, maxt, anyhit=True,
                           stats=any_stats)
    assert 0 < any_stats["tri_tests"] < stats["tri_tests"]
    assert 0 < any_stats["tri_det_stops"] + any_stats["tri_u_stops"] < any_stats["tri_tests"]


def test_geometry_keeps_the_kernel_rows_with_its_tables():
    """Geometry.bvh_rows, K2's [T, 12] copy of the table, is kernel_rows of
    the table after the load and after refresh() with moved vertices,
    carries no gradient, exists only with a BVH, and is refused beside a
    table it does not fit."""
    g = mt.load_dict(_normals_scene(), device="cpu").geometry
    assert torch.equal(g.bvh_rows, K2.kernel_rows(K1.build_tri_table(g)))
    g2 = dataclasses.replace(g, vertices=(g.vertices * 1.5).requires_grad_()).refresh()
    table = K1.build_tri_table(g2)
    assert table.requires_grad and not g2.bvh_rows.requires_grad
    assert torch.equal(g2.bvh_rows, K2.kernel_rows(table.detach()))
    assert not torch.equal(g2.bvh_rows, g.bvh_rows)
    small = mt.load_dict(mt.cornell_box(), device="cpu").geometry
    assert small.bvh_rows is None and small.refresh().bvh_rows is None
    o, d, maxt = torch.zeros(8, 3), torch.ones(8, 3), torch.ones(8)
    with pytest.raises(ValueError):
        K2.bvh_sweep(g.bvh_nodes, table.detach(), o, d, maxt, rows=g.bvh_rows[:-1])
    with pytest.raises(TypeError):
        K2.bvh_sweep_occluded(g.bvh_nodes, table, o, d, maxt, g.bvh_rows.double())


# ---------------------------------------------------------------------------
# the JAX package's coherence order (ray_sort_key, maybe_sort_order)
# ---------------------------------------------------------------------------

def _sort_inputs():
    """Root box of the 3000-triangle soup's BVH, and rays: a third of them
    pointing away from the box (most of those miss it), zero direction
    components, NaN origins and directions, disabled lanes and finite
    maxt."""
    nodes, _ = TN.build_bvh_wide(_soup_tris(3000, 1), max_leaf=K2.MAX_WIDE_LEAF)
    o, d, maxt = _rays(4096, 5)
    d[0::3] *= -1.0
    d[5::7, 1] = 0.0
    o[11::97] = np.nan
    d[13::89, 2] = np.nan
    return np.ascontiguousarray(nodes[0, 0:3]), np.ascontiguousarray(nodes[0, 3:6]), o, d, maxt


def test_ray_sort_key_matches_jax_bitwise():
    lo, hi, o, d, maxt = _sort_inputs()
    keys = []
    for args in ((o, d, lo, hi, maxt), (o, d, lo, hi)):
        want = np.asarray(JB.ray_sort_key(*(jnp.asarray(x) for x in args)))
        got = K2.ray_sort_key(*(torch.from_numpy(x) for x in args))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        keys.append(got.numpy())
    # the cull bit: on the disabled lanes and on some of the active ones
    # (those that miss the box), and only with maxt
    cull = keys[0] >> 30
    assert cull[maxt == -np.inf].all()
    assert 0 < cull[maxt > 0].sum() < (maxt > 0).sum()
    assert not (keys[1] >> 30).any()


@pytest.mark.parametrize("case", ["camera rays in coherence order", "scattered rays"])
def test_maybe_sort_order_matches_jax(case, tmp_path):
    """The same permutation as the JAX package's on the k=30 mesh scene's
    camera rays (16x16 @ 256 spp) put in coherence order, which the
    statistic finds coherent (the identity), and on rays with random
    origins in the scene and random directions (both stable argsorts)."""
    scene = mt.load_dict(mesh_scene(tmp_path / "sphere.obj", k=30, res=16), device="cpu")
    nodes = scene.geometry.bvh_nodes
    lo, hi = nodes[0, 0:3], nodes[0, 3:6]
    if case == "scattered rays":
        r = np.random.default_rng(7)
        o = torch.from_numpy(r.uniform(-1, 1, (1 << 16, 3)).astype(np.float32))
        d = torch.from_numpy(r.normal(size=(1 << 16, 3)).astype(np.float32))
        maxt = torch.full((1 << 16,), float("inf"))
    else:
        n = scene.film.n_pixels * 256
        _, ray, _, _, _ = make_wavefront(scene, 0, 0, n, 0, 256, 256)
        key = K2.ray_sort_key(ray.o, ray.d, lo, hi, ray.maxt)
        perm = torch.from_numpy(np.argsort(key.numpy(), kind="stable"))
        o, d, maxt = ray.o[perm], ray.d[perm], ray.maxt[perm]
    key = K2.ray_sort_key(o, d, lo, hi, maxt)
    want = np.asarray(JB.maybe_sort_order(jnp.asarray(key.numpy())))
    got = K2.maybe_sort_order(key)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    identity = np.arange(key.shape[0])
    assert (want == identity).all() == (case != "scattered rays")


@pytest.mark.parametrize("anyhit", [False, True], ids=["closest", "anyhit"])
def test_plain_walk_is_invariant_under_the_coherence_order(anyhit):
    """Each ray's walk depends on that ray alone: the plain walk on the
    batch in the JAX package's coherence order, scattered back, is bitwise
    the walk in lane order, with the same work (so the order of a batch
    is free, and the port, which keeps lane order, loses nothing by it)."""
    tris = _soup_tris(3000, 1)
    nodes, order = TN.build_bvh_wide(tris, max_leaf=K2.MAX_WIDE_LEAF)
    nodes, table = torch.from_numpy(nodes), torch.from_numpy(tris[order])
    o, d, maxt = (torch.from_numpy(x) for x in _rays(1024, 2))
    key = K2.ray_sort_key(o, d, nodes[0, 0:3], nodes[0, 3:6], maxt)
    perm = K2.maybe_sort_order(key).to(torch.int64)
    assert not torch.equal(perm, torch.arange(1024))
    s_ref, s_got = {}, {}
    ref = K2.bvh_sweep_reference(nodes, table, o, d, maxt, anyhit, stats=s_ref)
    got = K2.bvh_sweep_reference(nodes, table, o[perm], d[perm], maxt[perm], anyhit, stats=s_got)
    for g, r in zip(got, ref):
        back = torch.empty_like(g)
        back[perm] = g
        assert torch.equal(back.view(torch.int32), r.view(torch.int32))
    for k in ("node_visits", "tri_tests", "tri_det_stops", "tri_u_stops"):
        assert s_got[k] == s_ref[k]


# ---------------------------------------------------------------------------
# geometry: BVH build through load_dict, vertex normals
# ---------------------------------------------------------------------------

def _normals_scene():
    """A k=30 sphere (10,800 triangles, the BVH path) as a raw `mesh` with
    per-vertex normals, under a non-uniform scale: the normals go through
    the inverse transpose."""
    v0, e1, e2 = spherified_cube(30)
    V = np.concatenate([v0, v0 + e1, v0 + e2], axis=0)
    n = v0.shape[0]
    F = np.stack([np.arange(n), np.arange(n) + n, np.arange(n) + 2 * n], -1)
    d = mj.cornell_box()
    del d["small-box"], d["large-box"]
    d["ball"] = {
        "type": "mesh", "vertex_positions": V, "faces": F, "normals": V,
        "to_world": [{"type": "scale", "value": [0.4, 0.3, 0.35]}],
        "bsdf": {"type": "ref", "id": "white"},
    }
    return d


def test_surface_interaction_with_vertex_normals_matches_jax():
    js = mj.load_dict(_normals_scene())
    ts = mt.load_dict(_normals_scene(), device="cpu")
    jg, tg = js.geometry.refresh(), ts.geometry.refresh()
    assert jg.has_bvh and tg.has_bvh and jg.has_vertex_normals and tg.has_vertex_normals
    np.testing.assert_array_equal(tg.tri_face.numpy(), np.asarray(jg.tri_face))
    np.testing.assert_array_equal(tg.vertex_normals.numpy(), np.asarray(jg.vertex_normals))
    np.testing.assert_allclose(tg.tri_vn.numpy(), np.asarray(jg.tri_vn), rtol=1e-6, atol=1e-6)

    r = np.random.default_rng(4)
    o = r.uniform(-0.9, 0.9, (1024, 3)).astype(np.float32)
    o[:, 2] = 0.95
    d = (r.uniform(-0.3, 0.3, (1024, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    jr = JRay(o=jnp.asarray(o), d=jnp.asarray(d), maxt=jnp.full(1024, jnp.inf))
    jpi = JSH.ray_intersect_preliminary(jg, jr)
    tpi = TSH.ray_intersect_preliminary(tg, TRay.make(torch.from_numpy(o), torch.from_numpy(d)))
    np.testing.assert_array_equal(tpi.prim_index.numpy(), np.asarray(jpi.prim_index))
    ball = np.asarray(jg.tri_shape)[np.maximum(np.asarray(jpi.prim_index), 0)] == 6
    assert ball.sum() > 500
    # shade the same hits on both sides
    tpi.t = torch.from_numpy(np.array(jpi.t))
    tpi.prim_uv = torch.from_numpy(np.array(jpi.prim_uv))
    jsi = JSH.compute_surface_interaction(jg, jr, jpi)
    tsi = TSH.compute_surface_interaction(tg, TRay.make(torch.from_numpy(o), torch.from_numpy(d)), tpi)
    for k in ("t", "p", "n", "sh_n", "sh_s", "sh_t", "uv", "wi"):
        np.testing.assert_allclose(getattr(tsi, k).numpy(), np.asarray(getattr(jsi, k)),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    # the blended normal is not the face normal on the sphere
    sh_n, ng = tsi.sh_n.numpy()[ball], tsi.n.numpy()[ball]
    assert np.mean(np.abs(np.sum(sh_n * ng, axis=-1)) < 0.99999) > 0.5


# ---------------------------------------------------------------------------
# the slice: a k=30 mesh scene at 16x16 @ 2 spp
# ---------------------------------------------------------------------------

def test_mesh_scene_radiance_matches_jax(tmp_path):
    d = mesh_scene(tmp_path / "sphere.obj", k=30, res=16)
    d["integrator"]["max_depth"] = 3
    js = mj.load_dict(d)
    ts = mt.load_dict(d, device="cpu")
    assert js.geometry.has_bvh and ts.geometry.has_bvh
    assert ts.geometry.n_tris == js.geometry.n_tris > 10800
    np.testing.assert_array_equal(
        ts.geometry.bvh_nodes.numpy(),
        np.concatenate([js.geometry.bvh_lo, js.geometry.bvh_hi,
                        np.asarray(js.geometry.bvh_skip).view(np.float32)[:, None],
                        np.asarray(js.geometry.bvh_payload).view(np.float32)[:, None]], axis=1),
    )
    n = 16 * 16 * 2
    Lj, _, _, aux_j = j_render_lanes(js, jnp.uint32(0), 0, n, 0, 2, 2, 0)
    Lt, aux_t = t_render_lanes(ts, 0, 0, n, 0, 2, 2, 0)
    Lj, Lt = np.asarray(Lj), Lt.numpy()
    assert np.isfinite(Lt).all() and Lt.mean() > 0
    assert int(aux_t["n_rays"]) == int(float(aux_j["n_rays"]))
    np.testing.assert_allclose(Lt, Lj, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the gradient of the hit
# ---------------------------------------------------------------------------

def test_bvh_sweep_vjp_matches_jax():
    tris = _soup_tris(3000, 1)
    nodes, order = TN.build_bvh_wide(tris, max_leaf=K2.MAX_WIDE_LEAF)
    table = tris[order]
    o, d, maxt = _rays(1024, 2)
    maxt[2::4] = np.inf           # no finite maxt: a miss's t is inf, as in a render
    r = np.random.default_rng(9)
    g_t, g_u, g_v = (r.normal(size=o.shape[0]).astype(np.float32) for _ in range(3))
    nj = [jnp.asarray(x) for x in (nodes[:, 0:3], nodes[:, 3:6], nodes[:, 6].view(np.int32),
                                   nodes[:, 7].view(np.int32))]
    (jt, jp, ju, jv), pull = jax.vjp(
        lambda v0, e1, e2, oo, dd: bvh_intersect_ad(*nj, v0, e1, e2, oo, dd, jnp.asarray(maxt)),
        *(jnp.asarray(x) for x in (table[:, 0:3], table[:, 3:6], table[:, 6:9], o, d)))
    jc = [np.asarray(x) for x in pull((jnp.asarray(g_t), np.zeros(o.shape[0], jax.dtypes.float0),
                                       jnp.asarray(g_u), jnp.asarray(g_v)))]
    tb, to, td = (torch.from_numpy(x).requires_grad_() for x in (table, o, d))
    t, p, u, v = K2.bvh_sweep_intersect(torch.from_numpy(nodes), tb, to, td, torch.from_numpy(maxt))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    cts = torch.autograd.grad((t, u, v), (tb, to, td), [torch.from_numpy(g) for g in (g_t, g_u, g_v)])
    hit = p.numpy() >= 0
    well = _well_conditioned(table, p.numpy(), d)
    assert well.sum() > 200 and (~hit).sum() > 200
    for got, want in zip(cts[1:], jc[3:]):
        np.testing.assert_allclose(got.numpy()[well], want[well], rtol=1e-5, atol=1e-6)
        assert not got.numpy()[~hit].any()
    pl = torch.from_numpy(np.maximum(p.numpy(), 0)).to(torch.int64)
    rows = tb.detach()[pl]
    y = K1.mt_vjp(rows[:, 3:6], rows[:, 6:9], td.detach(),
                  *(torch.from_numpy(g) for g in (g_t, g_u, g_v)), p >= 0)
    cos, sin = _conditioning(table, p.numpy(), d)
    k = torch.from_numpy(np.maximum(1.0, 1.0 / np.maximum(cos * sin, 1e-30)).astype(np.float32))
    scale = torch.zeros_like(tb).index_add_(0, pl, (k[:, None] * y.abs()).repeat(1, 3)).numpy()
    want_table = np.concatenate(jc[:3], axis=1)
    assert np.abs(want_table).max() > 0
    assert np.all(np.abs(cts[0].numpy() - want_table) <= 1e-5 * scale + 1e-7)


def test_tape_mesh_vertex_gradient_matches_jax(tmp_path):
    """d sum(image) / d mesh.vertex_positions through the path integrator
    and K2's plain walk, against jax.grad of the JAX render."""
    d = mesh_scene(tmp_path / "sphere.obj", k=30, res=16)
    d["integrator"]["max_depth"] = 3
    js = mj.load_dict(d)
    key = "mesh.vertex_positions"
    path = dict(js.param_paths)[key]
    want = np.asarray(jax.grad(
        lambda v: jnp.sum(mj.render(_tree_set(js, path, v), spp=2, seed=1)))(_tree_get(js, path)))
    ts = mt.load_dict(d, device="cpu")
    assert ts.geometry.has_bvh
    params = mt.traverse(ts)
    v = params[key].clone().requires_grad_()
    mt.render(params.update({key: v}), spp=2, seed=1).sum().backward()
    got = v.grad.numpy()
    assert np.isfinite(got).all()
    finite = np.isfinite(want).all(-1)
    assert (~finite).any()                       # the reference's NaN, witnessed
    assert (np.abs(got[finite]).sum(-1) > 0).sum() >= 10
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-4,
                               atol=1e-4 * np.abs(want[finite]).max())
