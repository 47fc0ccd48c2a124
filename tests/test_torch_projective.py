"""The port's projective (boundary) gradients of moving meshes, and
LargeSteps, held against the JAX package on the CPU.

The scenes are tests/test_projective.py's silhouette scene (an emissive
background behind a dark occluder), point-light shadow scene (a floor, an
occluder outside the view and a point light) and area-light shadow scene
(the indirect pass: its soft shadows), and the Cornell box, at a 12 x 12
film. The Cornell box's edge table shows where the port welds a mesh's
vertices and the JAX package does not; a flat cube, where the welded
edges' cotangent goes among the vertex copies. The cbox's whole backward
is held against the JAX package run on the port's edge tables.

Boundary passes, lane by lane (both packages draw the same numbers): the
JAX package's per-lane weight k and curve normal n_hat are read from the
closure of the curve function it differentiates, inside its jitted pass.
A lane's validity or side can part where a probe ray 0.05 px from the
curve classifies foreground and background differently under XLA's fused
multiply-adds; the share of such lanes is held at <= 1%, k on the other
lanes at rtol 1e-5, and the cotangent summed over the other lanes at rtol
1e-5 (only the rows where the JAX cotangent is finite: its hit VJP gives
NaN on a miss, ROADMAP Queue 3). The whole backward (the interior term and
the boundary terms) is held at rtol 1e-4 against jax.grad of the same
loss, the polarized I and Q losses too. No finite-difference test of the
JAX package is repeated here: the card holds the port to finite
differences (chip_smoke.py).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mitsuba_tpu as mj
from mitsuba_tpu.ad import projective as JP
from mitsuba_tpu.ad.largesteps import LargeSteps as JLargeSteps
from mitsuba_tpu.render.params import _tree_get, _tree_set

import mitsuba_tpu_torch as mt
from mitsuba_tpu_torch.ad import LargeSteps
from mitsuba_tpu_torch.ad import projective as TP
from mitsuba_tpu_torch.ad.prb import PRBIntegrator
from mitsuba_tpu_torch.integrators.direct import DirectIntegrator
from mitsuba_tpu_torch.render import shapes

W, SEED = 12, 7
PART_SHARE = 0.01      # lanes whose validity or side may part
K_RTOL = 1e-5          # per-lane weights and summed cotangents
GRAD_RTOL = 1e-4       # the whole backward against jax.grad


@pytest.fixture(autouse=True)
def _rgb():
    mj.set_variant("rgb")
    mt.set_variant("rgb")
    yield
    mj.set_variant("rgb")
    mt.set_variant("rgb")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (ROADMAP Queue 3: MKL's first vector-math call
    from two threads can take its low-accuracy kernel on one chunk)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _film():
    return {"type": "hdrfilm", "width": W, "height": W, "rfilter": {"type": "box"}}


def _silhouette(integrator, T, occluder_bsdf=None, radiance=None):
    return {
        "type": "scene", "integrator": integrator,
        "sensor": {"type": "perspective", "fov": 40.0,
                   "to_world": {"type": "look_at", "origin": [0, 0, 4], "target": [0, 0, 0],
                                "up": [0, 1, 0]},
                   "film": _film()},
        "bg": {"type": "rectangle",
               "to_world": T.Transform.translate([0, 0, -1]) @ T.Transform.scale([6, 6, 1]),
               "emitter": {"type": "area", "radiance": radiance or
                           {"type": "rgb", "value": [1.0, 0.8, 0.6]}}},
        "occluder": {"type": "rectangle",
                     "to_world": T.Transform.translate([0.3, 0.0, 1.0])
                     @ T.Transform.scale([0.6, 0.6, 1]),
                     "bsdf": occluder_bsdf or {"type": "diffuse", "reflectance": {
                         "type": "rgb", "value": [0.1, 0.1, 0.1]}}},
    }


def _shadow(integrator, T):
    return {
        "type": "scene", "integrator": integrator,
        "sensor": {"type": "perspective", "fov": 30.0,
                   "to_world": {"type": "look_at", "origin": [0, 0, 5], "target": [0, 0, 0],
                                "up": [0, 1, 0]},
                   "film": _film()},
        "floor": {"type": "rectangle", "to_world": T.Transform.scale([8, 8, 1]),
                  "bsdf": {"type": "diffuse", "reflectance": {"type": "rgb",
                                                              "value": [0.7, 0.7, 0.7]}}},
        "occluder": {"type": "rectangle",
                     "to_world": T.Transform.translate([2.5, 1.0, 2.0])
                     @ T.Transform.scale([0.9, 0.9, 1]),
                     "bsdf": {"type": "diffuse", "reflectance": {"type": "rgb",
                                                                 "value": [0.2, 0.2, 0.2]}}},
        "light": {"type": "point", "position": [5.0, 2.0, 4.5], "intensity": 60.0},
    }


def _cbox(integrator, T):
    d = T.cornell_box()
    d["sensor"]["film"] = _film()
    d["integrator"] = integrator
    return d


def _area_shadow(integrator, T):
    """tests/test_projective.py's area-light shadow scene: the shadow scene
    with a small emitting panel where the point light was."""
    d = _shadow(integrator, T)
    del d["light"]
    d["panel"] = {"type": "rectangle",
                  "to_world": T.Transform.translate([5.0, 2.0, 4.5])
                  @ T.Transform.look_at([0, 0, 0], [-5.0, -2.0, -4.5], [0, 1, 0])
                  @ T.Transform.scale([0.4, 0.4, 1]),
                  "emitter": {"type": "area", "radiance": {"type": "rgb",
                                                           "value": [120.0, 120.0, 120.0]}}}
    return d


SCENES = {"silhouette": _silhouette, "shadow": _shadow, "cbox": _cbox,
          "area-shadow": _area_shadow}


def _load(name, integrator):
    make = SCENES[name]
    return mj.load_dict(make(integrator, mj)), mt.load_dict(make(integrator, mt), device="cpu")


@pytest.mark.parametrize("name", ["shadow", "silhouette"])
def test_edge_tables_and_silhouette_weights(name):
    js, ts = _load(name, {"type": "direct_projective"})
    gj, gt = js.geometry, ts.geometry
    for field in ("edge_v", "edge_f", "edge_shape"):
        np.testing.assert_array_equal(getattr(gt, field).numpy(), np.asarray(getattr(gj, field)),
                                      err_msg=field)
    views = [dict(viewpoint=(js.sensors[0].position, ts.sensors[0].position))]
    if name == "shadow":
        pos = np.asarray([5.0, 2.0, 4.5], np.float32)
        views.append(dict(viewpoint=(jnp.asarray(pos), torch.from_numpy(pos))))
        dirn = np.asarray([0.3, -0.2, -0.93], np.float32)
        views.append(dict(direction=(jnp.asarray(dirn), torch.from_numpy(dirn))))
    for view in views:
        (key, (vj, vt)), = view.items()
        w_j = np.asarray(JP.silhouette_weights(gj, **{key: vj})[0])
        w_t = TP.silhouette_weights(gt, **{key: vt})[0].numpy()
        np.testing.assert_array_equal(w_t > 0, w_j > 0)
        np.testing.assert_allclose(w_t, w_j, rtol=1e-6)
        assert (w_t > 0).any()


def test_edges_of_a_mesh_without_shared_vertices():
    """A standing difference (ROADMAP Queue 3): the JAX package keys an
    edge by its vertex indices, so the cbox's boxes (cubes whose faces do
    not share vertices) have each of their 12 edges twice, open, and both
    copies count as silhouettes from everywhere; the port welds a shape's
    vertices at one position, so each box edge is one edge between its two
    faces (18 with the faces' diagonals), with each face's copies of its
    endpoints, and the walls' rectangles keep their 4 open edges. Keyed
    by vertex index (weld_vertices=False), the port's table is the JAX
    package's."""
    js, ts = _load("cbox", {"type": "direct_projective"})
    shape_j = np.asarray(js.geometry.edge_shape)
    open_j = np.asarray(js.geometry.edge_f)[:, 1] < 0
    shape_t = ts.geometry.edge_shape.numpy()
    open_t = ts.geometry.edge_f[:, 1].numpy() < 0
    boxes = [6, 7]
    for s in boxes:
        assert (shape_j == s).sum() == 30 and (open_j & (shape_j == s)).sum() == 24
        assert (shape_t == s).sum() == 18 and not (open_t & (shape_t == s)).any()
    for s in range(6):
        assert (open_t & (shape_t == s)).sum() == (open_j & (shape_j == s)).sum() == 4
    # every port edge joins two vertices at the positions of a JAX edge
    V_t, V_j = ts.geometry.vertices.numpy(), np.asarray(js.geometry.vertices)
    pos_j = {tuple(sorted(map(tuple, V_j[e]))) for e in np.asarray(js.geometry.edge_v)}
    assert all(tuple(sorted(map(tuple, V_t[e]))) in pos_j for e in ts.geometry.edge_v.numpy())
    # each face's copies of the endpoints: vertices of that face, at the
    # edge's positions
    g = ts.geometry
    faces, ev, ef, efv = (x.numpy() for x in (g.tri_face, g.edge_v, g.edge_f, g.edge_fv))
    for s in (0, 1):
        f = np.where(ef[:, s] >= 0, ef[:, s], ef[:, 0])
        assert all(set(efv[e, s]) <= set(faces[f[e]]) for e in range(ev.shape[0]))
        np.testing.assert_array_equal(V_t[efv[:, s]], V_t[ev])
    split = (shape_t >= 6) & (efv[:, 0] != efv[:, 1]).any(-1)
    assert split.sum() == 24      # each box's 12 edges between two faces
    # keyed by vertex index, the port's table is the JAX package's
    T = g.n_real_tris
    tables = shapes.edge_table(faces[:T], g.tri_shape[:T].numpy(), V_t, weld_vertices=False)
    for field, got in zip(("edge_v", "edge_f", "edge_shape"), tables):
        np.testing.assert_array_equal(got, np.asarray(getattr(js.geometry, field)), err_msg=field)
    np.testing.assert_array_equal(tables[3], np.stack([tables[0]] * 2, axis=1))


def test_split_vertices_take_the_cotangent_of_the_face_seen():
    """The silhouette scene with a flat cube for its occluder (faces that
    do not share vertices; tests/test_projective.py's occluder, thinned,
    turned so that the lowest-numbered copies are in faces turned away):
    the primary pass gives each sampled silhouette edge's cotangent to the
    copies of its endpoints in the face the camera sees, none to the copies
    in the faces turned away. Summed over the copies at each position, it
    is the cotangent of the same lanes given to the lowest-numbered copy
    (the welded edge table's own endpoints)."""
    d = _silhouette({"type": "direct_projective"}, mt)
    d["occluder"] = dict(d["occluder"], type="cube", to_world=d["occluder"]["to_world"]
                         @ mt.Transform.rotate([1, 0, 0], 90) @ mt.Transform.scale([1, 1, 0.2]))
    ts = mt.load_dict(d, device="cpu")
    g = ts.geometry
    d_img = torch.from_numpy(np.random.default_rng(3).random((W, W, 3)).astype(np.float32))
    lanes = TP.primary_boundary_lanes(ts, d_img, SEED, W * W * 4)
    assert int(lanes.valid.sum()) > 0
    ct = lanes.vjp(g.vertices).numpy()
    lowest = dataclasses.replace(g, edge_fv=g.edge_v[:, None, :].expand(-1, 2, -1).contiguous())
    ct_low = TP.primary_boundary_lanes(dataclasses.replace(ts, geometry=lowest), d_img, SEED,
                                       W * W * 4).vjp(g.vertices).numpy()
    T = g.n_real_tris
    faces = g.tri_face[:T].numpy()
    occ = g.tri_shape[:T].numpy() == 1
    centroid = g.tri_v0 + (g.tri_e1 + g.tri_e2) / 3.0
    seen = (torch.sum(g.tri_ng * (ts.sensors[0].position - centroid), -1) > 0)[:T].numpy()
    away = np.unique(faces[occ & ~seen])
    assert np.abs(ct[away]).max() == 0.0 and np.abs(ct_low[away]).max() > 0.0
    assert np.abs(ct[np.unique(faces[occ & seen])]).max() > 0.0
    V = g.vertices.numpy()
    _, pos = np.unique(V, axis=0, return_inverse=True)
    pos = pos.reshape(-1)
    summed, summed_low = np.zeros((pos.max() + 1, 3)), np.zeros((pos.max() + 1, 3))
    np.add.at(summed, pos, ct)
    np.add.at(summed_low, pos, ct_low)
    np.testing.assert_allclose(summed, summed_low, rtol=K_RTOL, atol=K_RTOL * np.abs(summed).max())


def test_no_crease_term():
    """A fault of the JAX package's estimator, which the port follows
    (ROADMAP Queue 3): the passes sample silhouette and open edges only.
    The edges of a flat-shaded mesh between two faces that both face the
    camera (the boxes' creases, across which the shading jumps) get
    weight 0, so their motion is in no boundary term and the cbox's
    gradient for a box's scale misses it (chip_smoke.py prints its AD
    beside its central difference)."""
    _, ts = _load("cbox", {"type": "prb_projective"})
    g = ts.geometry
    w, _, _ = TP.silhouette_weights(g, viewpoint=ts.sensors[0].position)
    n0, n1 = g.tri_ng[g.edge_f[:, 0]], g.tri_ng[g.edge_f[:, 1].clamp(min=0)]
    crease = (g.edge_f[:, 1] >= 0) & (torch.sum(n0 * n1, dim=-1) < 0.5)
    mid = 0.5 * (g.vertices[g.edge_v[:, 0]] + g.vertices[g.edge_v[:, 1]])
    to_cam = ts.sensors[0].position - mid
    both = (torch.sum(n0 * to_cam, -1) > 0) & (torch.sum(n1 * to_cam, -1) > 0)
    assert int((crease & both).sum()) >= 4
    assert float(w[crease & both].abs().sum()) == 0.0


def _jax_pass_lanes(fn, scene, d_img, n_b):
    """(cotangent, [(k, n_hat)] of each curve function differentiated) of
    a JAX boundary pass, jitted: jax.grad is wrapped to read the curve
    function's closure inside the trace."""
    real = jax.grad

    def run(d):
        seen = []

        def grad(f, *a, **kw):
            seen.append(f)
            return real(f, *a, **kw)

        jax.grad = grad
        try:
            g = fn(scene, d, jnp.uint32(SEED), n_b)
        finally:
            jax.grad = real
        lanes = []
        for f in seen:
            cells = dict(zip(f.__code__.co_freevars, (c.cell_contents for c in f.__closure__)))
            lanes.append((cells["k_w"] if "k_w" in cells else cells["k"], cells["n_hat"]))
        return g, lanes

    return jax.jit(run)(d_img)


PASSES = {
    "primary": ("silhouette", "direct_projective", JP.primary_boundary_vjp,
                lambda s, d, n: [TP.primary_boundary_lanes(s, d, SEED, n)]),
    "shadow": ("shadow", "direct_projective", JP.shadow_boundary_vjp,
               lambda s, d, n: [l for _, l in TP.shadow_boundary_lanes(s, d, SEED, n)]),
    # prb max_depth 3: seed vertices at depth 1 and 2 (K = 2)
    "indirect": ("area-shadow", "prb_projective", JP.indirect_boundary_vjp,
                 lambda s, d, n: [l for _, l in TP.indirect_boundary_lanes(s, d, SEED, n)]),
}


@pytest.mark.parametrize("which", sorted(PASSES))
def test_boundary_pass_lane_by_lane(which):
    name, integ, jax_fn, port_lanes = PASSES[which]
    js, ts = _load(name, {"type": integ, "max_depth": 3})
    d_img = np.random.default_rng(3).random((W, W, 3)).astype(np.float32)
    n_b = W * W * 4
    g_j, lanes_j = _jax_pass_lanes(jax_fn, js, jnp.asarray(d_img), n_b)
    lanes_t = port_lanes(ts, torch.from_numpy(d_img), n_b)
    assert len(lanes_t) == len(lanes_j) >= 1
    g_j = np.asarray(g_j)
    rows = np.isfinite(g_j).all(-1)
    verts = ts.geometry.vertices
    n_valid = 0
    for (k_j, n_j), lt in zip(lanes_j, lanes_t):
        k_j, n_j = np.asarray(k_j), np.asarray(n_j)
        k_t, n_t = lt.k.numpy(), lt.n_hat.numpy()
        v_j, v_t = k_j != 0, k_t != 0
        parted = (v_j != v_t) | (v_j & v_t & (np.sum(n_j * n_t, -1) < 0))
        assert parted.mean() <= PART_SHARE, parted.mean()
        keep = v_j & v_t & ~parted
        n_valid += int(keep.sum())
        np.testing.assert_allclose(k_t[keep], k_j[keep], rtol=K_RTOL, atol=1e-6 * np.abs(k_j).max())
        # the cotangent of the lanes kept, from each package's k and n_hat
        # through the port's curve map
        both = TP.CurveLanes(valid=lt.valid, n_hat=lt.n_hat, k=torch.where(
            torch.from_numpy(keep), lt.k, 0.0), curve_fn=lt.curve_fn, edge=lt.edge)
        from_j = TP.CurveLanes(valid=lt.valid, n_hat=torch.from_numpy(n_j.copy()),
                               k=torch.from_numpy(np.where(keep, k_j, 0.0)), curve_fn=lt.curve_fn,
                               edge=lt.edge)
        c_t, c_j = both.vjp(verts).numpy()[rows], from_j.vjp(verts).numpy()[rows]
        np.testing.assert_allclose(c_t, c_j, rtol=K_RTOL, atol=K_RTOL * np.abs(c_j).max())
    assert n_valid > 0
    # and the passes' own cotangents
    g_t = getattr(TP, jax_fn.__name__)(ts, torch.from_numpy(d_img), SEED, n_b).numpy()
    np.testing.assert_allclose(g_t[rows], g_j[rows], rtol=1e-4, atol=1e-4 * np.abs(g_j).max())


def _with_port_edges(js, ts):
    """The JAX scene js with the port's edge tables (the same vertex
    buffer; on a mesh whose faces share their vertices, the same tables)."""
    g = ts.geometry
    np.testing.assert_array_equal(g.vertices.numpy(), np.asarray(js.geometry.vertices))
    return js.replace(geometry=js.geometry.replace(
        edge_v=jnp.asarray(g.edge_v.numpy().astype(np.int32)),
        edge_f=jnp.asarray(g.edge_f.numpy().astype(np.int32)),
        edge_shape=jnp.asarray(g.edge_shape.numpy())))


@pytest.mark.parametrize("case", ["direct_projective-silhouette", "prb_projective-shadow",
                                  "prb_projective-cbox"])
def test_whole_backward_matches_jax_grad(case):
    """d sum(image) / d theta through the whole backward: for the
    silhouette scene, the occluder's scale (the primary silhouette and the
    direct integrator's tape); for the shadow scene with prb max_depth 2,
    the occluder's scale (its shadow) and the floor's height (the interior
    term: the PRB node and the tape pass through path, which runs K1's
    backward); for the Cornell box with prb max_depth 4 (chip_smoke.py's
    configuration), the small box's scale: the interior term, the primary
    silhouettes and the indirect pass under the area light. The cbox's
    boxes split their vertices, so the JAX package runs on the port's
    welded edge tables (ROADMAP's standing differences); the scale moves
    every copy of a corner alike, so where each edge's cotangent goes among
    the copies does not change it."""
    integ_t, name = case.split("-")
    integ = {"type": integ_t, "max_depth": 4 if name == "cbox" else 2, "sppp": 4, "sppi": 4}
    js, ts = _load(name, integ)
    js = _with_port_edges(js, ts)
    keys = {"shadow": ["occluder.vertex_positions", "floor.vertex_positions"],
            "cbox": ["small-box.vertex_positions"]}.get(name, ["occluder.vertex_positions"])
    paths = dict(js.param_paths)
    bases = [_tree_get(js, paths[k]) for k in keys]
    offs = [bases[0] - jnp.mean(bases[0], 0, keepdims=True)]
    if len(keys) == 2:
        offs.append(jnp.zeros_like(bases[1]).at[:, 2].set(1.0))

    def loss(t):
        s = js
        for i, k in enumerate(keys):
            s = _tree_set(s, paths[k], bases[i] + t[i] * offs[i])
        return jnp.sum(mj.render(s, spp=4, seed=SEED))

    g_j = np.asarray(jax.jit(jax.grad(loss))(jnp.zeros(len(keys))))
    p = mt.traverse(ts)
    t = torch.zeros(len(keys), requires_grad=True)
    vals = {k: p[k] + t[i] * torch.from_numpy(np.array(offs[i])) for i, k in enumerate(keys)}
    stats = {}
    img = mt.render(p.update(vals), spp=4, seed=SEED, stats=stats)
    img.sum().backward()
    assert stats["n_rays"] > 0
    assert np.isfinite(g_j).all() and np.abs(g_j).min() > 1.0
    np.testing.assert_allclose(t.grad.numpy(), g_j, rtol=GRAD_RTOL)
    base_cls = DirectIntegrator if integ_t == "direct_projective" else PRBIntegrator
    assert type(ts.integrator.base) is base_cls


def test_prb_projective_polarized_I_and_Q():
    """prb_projective in mono_polarized on tests/test_projective_polarized.py's
    scene (a linear polarizer in front of an unpolarized emitter): d/d scale
    of sum(I) and of sum(Q^2), one JAX backward compiled for both
    cotangents."""
    mj.set_variant("mono_polarized")
    mt.set_variant("mono_polarized")
    integ = {"type": "prb_projective", "max_depth": 4, "sppp": 4, "sppi": 0}
    bsdf = {"type": "polarizer", "theta": 0.0}
    js = mj.load_dict(_silhouette(integ, mj, bsdf, 1.0))
    ts = mt.load_dict(_silhouette(integ, mt, bsdf, 1.0), device="cpu")
    key = "occluder.vertex_positions"
    path = dict(js.param_paths)[key]
    base = _tree_get(js, path)
    off = base - jnp.mean(base, 0, keepdims=True)

    def render_t(t):
        return mj.render(_tree_set(js, path, base + t * off), spp=4, seed=SEED)

    img_j, vjp_fn = jax.jit(lambda t: jax.vjp(render_t, t))(jnp.asarray(0.0))
    bwd = jax.jit(lambda fn, ct: fn(ct)[0])
    ct_i = jnp.zeros_like(img_j).at[:, :, 0].set(1.0)
    ct_q = jnp.zeros_like(img_j).at[:, :, 1].set(2.0 * img_j[:, :, 1])
    want = [float(bwd(vjp_fn, ct_i)), float(bwd(vjp_fn, ct_q))]

    got = []
    for comp in (lambda im: im[:, :, 0].sum(), lambda im: (im[:, :, 1] ** 2).sum()):
        p = mt.traverse(ts)
        t = torch.zeros((), requires_grad=True)
        img = mt.render(p.update({key: p[key] + t * torch.from_numpy(np.array(off))}), spp=4,
                        seed=SEED)
        comp(img).backward()
        got.append(float(t.grad))
    assert img.shape == (W, W, 4, 1)
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(img_j), rtol=1e-4, atol=1e-6)
    assert min(abs(w) for w in want) > 1.0
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL)


def test_direct_projective_refused_polarized_and_progressive_single_shot():
    mt.set_variant("mono_polarized")
    with pytest.raises(ValueError):
        mt.load_dict(_silhouette({"type": "direct_projective"}, mt), device="cpu")
    mt.set_variant("rgb")
    ts = mt.load_dict(_silhouette({"type": "direct_projective"}, mt), device="cpu")
    (done, img), = list(mt.render_progressive(ts, seed=2, spp=4))
    assert done == 4 and torch.equal(img, mt.render(ts, seed=2, spp=4))


def _grid_mesh(n=6, seed=0):
    xs, ys = np.meshgrid(np.arange(n), np.arange(n))
    z = 0.1 * np.random.default_rng(seed).standard_normal(n * n)
    V = np.stack([xs.ravel(), ys.ravel(), z], -1).astype(np.float32)
    F = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j
            F += [[a, a + 1, a + n], [a + 1, a + n + 1, a + n]]
    return V, np.asarray(F, np.int32)


def test_largesteps_matches_jax():
    """to_differential exactly up to the order of the scatter's sums,
    from_differential (CG to 1e-6) and its gradient (the adjoint solve)
    within 1e-5 of the JAX package's."""
    V, F = _grid_mesh()
    ls_j, ls_t = JLargeSteps(V, F, 19.0), LargeSteps(torch.from_numpy(V), F, 19.0)
    u_j = np.asarray(ls_j.to_differential(V))
    u_t = ls_t.to_differential(torch.from_numpy(V))
    np.testing.assert_allclose(u_t.numpy(), u_j, rtol=1e-6, atol=1e-6)
    v_t = ls_t.from_differential(u_t)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(ls_j.from_differential(u_j)), atol=1e-5)
    np.testing.assert_allclose(v_t.numpy(), V, atol=1e-5)
    w = np.random.default_rng(1).standard_normal(V.shape).astype(np.float32)
    g_j = np.asarray(jax.grad(lambda u: jnp.sum(ls_j.from_differential(u) * w))(
        jnp.asarray(u_j)))
    u = u_t.clone().requires_grad_()
    (ls_t.from_differential(u) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(u.grad.numpy(), g_j, atol=1e-5)


def test_vertex_writes_in_an_optimisation_loop():
    """SceneParameters rebuilds the shared vertex buffer at each write, so
    a loop that writes a shape's vertices, renders and calls backward on
    one view works (each iteration's graph is its own), and its gradient
    is a fresh view's."""
    ts = mt.load_dict(_silhouette({"type": "direct_projective", "sppp": 1, "sppi": 0}, mt),
                      device="cpu")
    key = "occluder.vertex_positions"
    p = mt.traverse(ts)
    base = p[key].clone()
    grads = []
    for _ in range(2):
        v = base.clone().requires_grad_()
        mt.render(p.update({key: v}), spp=1, seed=SEED).sum().backward()
        grads.append(v.grad)
    v = base.clone().requires_grad_()
    mt.render(mt.traverse(ts).update({key: v}), spp=1, seed=SEED).sum().backward()
    assert torch.equal(grads[0], grads[1]) and torch.equal(grads[1], v.grad)
    assert float(v.grad.abs().sum()) > 0


def test_one_shape_written_once_and_another_in_a_loop():
    """A shape written once, with a graph, then another written, rendered
    and differentiated in a loop: each update rebuilds the shared vertex
    buffer from its detached values and the rows written in it, so the
    first shape keeps its value and no iteration reaches a graph that an
    earlier backward freed; the loop's gradients are a fresh view's."""
    ts = mt.load_dict(_silhouette({"type": "direct_projective", "sppp": 1, "sppi": 0}, mt),
                      device="cpu")
    p = mt.traverse(ts)
    bg, occ = p["bg.vertex_positions"].clone(), p["occluder.vertex_positions"].clone()
    s = torch.ones((), requires_grad=True)
    moved = bg * (1.01 * s)
    p.update({"bg.vertex_positions": moved})
    mt.render(p.scene, spp=1, seed=SEED).sum().backward()
    assert s.grad is not None
    grads = []
    for _ in range(3):
        v = occ.clone().requires_grad_()
        mt.render(p.update({"occluder.vertex_positions": v}), spp=1, seed=SEED).sum().backward()
        assert torch.equal(p["bg.vertex_positions"], moved.detach())
        grads.append(v.grad)
    fresh = mt.traverse(ts)
    v = occ.clone().requires_grad_()
    mt.render(fresh.update({"bg.vertex_positions": moved.detach(), "occluder.vertex_positions": v}),
              spp=1, seed=SEED).sum().backward()
    assert all(torch.equal(g, v.grad) for g in grads)
    assert float(v.grad.abs().sum()) > 0
