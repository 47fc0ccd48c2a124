"""Kernel K1 (closest hit over a triangle table) in the port, held against
the JAX package.

On the CPU the port's wrapper runs the plain PyTorch version; it is held
against the JAX Pallas kernel in interpret mode and against the JAX XLA
closest-hit path. prim must be bitwise equal on every lane. t, u, v agree
at rtol=1e-6, atol=1e-6 on every well-conditioned hit, and on every other
hit at that bound scaled by the hit's conditioning k = 1 / (|cos| sin):
|cos| between the ray and the triangle's normal, sin of the angle between
its edges. A ray that grazes its triangle's plane or a sliver triangle
amplifies rounding differences past 1e-6, and the two packages round
differently: XLA on the CPU contracts a*b+c into fused multiply-adds and
the port does not. The tests show it on every hit: the port equals an
unfused float32 evaluation of the formula bitwise, the JAX result equals a
fused one on more lanes than it equals the unfused one, and both lie
within the scaled bound of a float64 evaluation. The cbox has no
ill-conditioned hits. The CUDA kernel itself is held bitwise against the
plain version on the card, in tests/test_torch_cuda.py.

The gradient of the hit (``tri_intersect``'s backward, ``mt_vjp`` and the
scatter into the table) is held against ``jax.vjp`` of the JAX package's
``tri_intersect`` (its custom VJP, the kernel in interpret mode) at rtol
1e-5: both evaluate the same closed form, XLA with FMAs. A table row sums
the cotangents of many lanes, so it is held at 1e-5 of the sum of their
magnitudes. On a miss the JAX VJP gives NaN for d (t = inf times y = 0);
the port gives 0. The tape gradient of a vertex parameter through the path
integrator is held against jax.grad of the same loss at rtol 1e-4.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mitsuba_tpu as mj
from mitsuba_tpu.ops.intersect import build_tri_table as j_build_table
from mitsuba_tpu.ops.intersect import tri_intersect as j_tri_intersect
from mitsuba_tpu.render import shapes as JSH
from mitsuba_tpu.render.params import _tree_get, _tree_set
from mitsuba_tpu.render.records import Ray as JRay
from mitsuba_tpu.render_api import make_wavefront as j_make_wavefront

import mitsuba_tpu_torch as mt
from mitsuba_tpu_torch.ops import intersect as K1

TOL = dict(rtol=1e-6, atol=1e-6)
# jitted, so that the cases (all of the same shapes) share one compile of
# the interpret-mode kernel
_j_tri_intersect_jit = jax.jit(j_tri_intersect)
INTERPRET_ROWS = 256


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


def _cbox_dict(w=16):
    d = mj.cornell_box()
    d["sensor"]["film"]["width"] = w
    d["sensor"]["film"]["height"] = w
    return d


def _soup(n_tris, n_rays, seed):
    """A random triangle soup with duplicated triangles (exact ties) and
    rays aimed at it; a quarter of the lanes disabled, a quarter with a
    finite maxt."""
    r = np.random.default_rng(seed)
    V = r.uniform(-3, 3, (3 * n_tris, 3)).astype(np.float32)
    F = np.arange(3 * n_tris, dtype=np.int32).reshape(n_tris, 3)
    dup = r.choice(n_tris, n_tris // 8, replace=False)
    F[dup] = F[r.choice(n_tris, n_tris // 8)]       # duplicated rows -> ties
    geom = JSH.build_geometry([{"vertices": V, "faces": F, "shape_index": 0}], [])
    o = r.uniform(-6, 6, (n_rays, 3)).astype(np.float32)
    target = r.uniform(-2, 2, (n_rays, 3)).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    maxt = np.full(n_rays, np.inf, np.float32)
    maxt[1::4] = -np.inf
    maxt[2::4] = r.uniform(0.5, 8.0, maxt[2::4].shape).astype(np.float32)
    maxt[3::8] = -1.0
    return geom, o, d, maxt


def _cbox_rays(n):
    scene = mj.load_dict(_cbox_dict())
    _, ray, _, _, _ = j_make_wavefront(scene, jnp.uint32(3), 0, n, 0, 4, 4, 0)
    maxt = np.asarray(ray.maxt).copy()
    maxt[1::3] = -np.inf                                # disabled lanes
    maxt[2::3] = 1.5                                    # finite maxt
    return scene.geometry, np.asarray(ray.o), np.asarray(ray.d), maxt


def _cases():
    return [("cbox", lambda: _cbox_rays(2048)),
            ("soup64", lambda: _soup(64, 2048, 5)),
            ("soup200", lambda: _soup(200, 2048, 6))]


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _conditioning(table, prim, d):
    """Per lane: (|cos| of the ray against the hit triangle's normal, sin of
    the angle between the triangle's edges), in float64."""
    row = table[np.maximum(prim, 0)].astype(np.float64)
    e1, e2 = row[:, 3:6], row[:, 6:9]
    nrm = np.cross(e1, e2)
    area = np.maximum(np.linalg.norm(nrm, axis=-1), 1e-30)
    cos = np.abs(np.sum(d * nrm, axis=-1)) / area
    sin = area / np.maximum(np.linalg.norm(e1, axis=-1) * np.linalg.norm(e2, axis=-1), 1e-30)
    return cos, sin


def _well_conditioned(table, prim, d):
    """Hits whose ray meets the triangle's plane at |cos| >= 0.05 on a
    triangle whose edges meet at sin >= 0.35."""
    cos, sin = _conditioning(table, prim, d)
    return (prim >= 0) & (cos >= 0.05) & (sin >= 0.35)


def _fma32(a, b, c):
    """float32 a*b + c rounded once: the product of two float32 is exact in
    float64."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def _moller_trumbore(row, o, d, dtype, fused=False):
    """(t, u, v) of each ray against its row of the table, in numpy: the
    port's formula in `dtype`, each product and sum rounded on its own, or
    (float32, fused=True) with every a*b + c and a*b - c*d contracted into
    one rounding, the way XLA on the CPU may contract it."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = row.astype(dtype).T
    o_x, o_y, o_z = o.astype(dtype).T
    d_x, d_y, d_z = d.astype(dtype).T

    def cross(a, b, c, e):          # a*b - c*e
        return _fma32(a, b, -(c * e)) if fused else a * b - c * e

    def dot(a1, b1, a2, b2, a3, b3):
        return _fma32(a3, b3, _fma32(a2, b2, a1 * b1)) if fused else a1 * b1 + a2 * b2 + a3 * b3

    pvx, pvy, pvz = cross(d_y, e2z, d_z, e2y), cross(d_z, e2x, d_x, e2z), cross(d_x, e2y, d_y, e2x)
    inv_det = dtype(1) / dot(e1x, pvx, e1y, pvy, e1z, pvz)
    tvx, tvy, tvz = o_x - v0x, o_y - v0y, o_z - v0z
    u = dot(tvx, pvx, tvy, pvy, tvz, pvz) * inv_det
    qvx, qvy, qvz = cross(tvy, e1z, tvz, e1y), cross(tvz, e1x, tvx, e1z), cross(tvx, e1y, tvy, e1x)
    v = dot(d_x, qvx, d_y, qvy, d_z, qvz) * inv_det
    t = dot(e2x, qvx, e2y, qvy, e2z, qvz) * inv_det
    return t, u, v


def _assert_same_hits(table, o, d, t_port, p_port, u_port, v_port, t_ref, p_ref, u_ref, v_ref):
    np.testing.assert_array_equal(p_port, p_ref)
    assert np.array_equal(np.isfinite(t_port), np.isfinite(t_ref))
    well = _well_conditioned(table, p_ref, d)
    assert well.sum() >= 0.8 * (p_ref >= 0).sum()
    np.testing.assert_allclose(t_port[well], t_ref[well], **TOL)
    np.testing.assert_allclose(u_port[well], u_ref[well], **TOL)
    np.testing.assert_allclose(v_port[well], v_ref[well], **TOL)
    _assert_hits_within_scaled_bound(
        table, o, d, t_port, u_port, v_port, t_ref, p_ref, u_ref, v_ref
    )


def _assert_hits_within_scaled_bound(table, o, d, t_port, u_port, v_port, t_ref, p_ref, u_ref, v_ref):
    """Every hit, the ill-conditioned ones included, within 1e-6 scaled by
    its conditioning of the reference and of a float64 evaluation, and the
    FMA contraction witnessed."""
    hit = p_ref >= 0
    row, oh, dh = table[p_ref[hit]], o[hit], d[hit]
    cos, sin = _conditioning(table, p_ref, d)
    tol = TOL["rtol"] / (cos[hit] * sin[hit])
    port = (t_port[hit], u_port[hit], v_port[hit])
    ref = (t_ref[hit], u_ref[hit], v_ref[hit])
    exact = _moller_trumbore(row, oh, dh, np.float64)
    unfused = _moller_trumbore(row, oh, dh, np.float32)
    fused = _moller_trumbore(row, oh, dh, np.float32, fused=True)
    for name, a, b, x, un, fu in zip("tuv", port, ref, exact, unfused, fused):
        for what, got, want in (("port vs JAX", a, b), ("port vs float64", a, x),
                                ("JAX vs float64", b, x)):
            err = np.abs(got.astype(np.float64) - want) / np.maximum(1.0, np.abs(want))
            assert (err <= tol).all(), f"{name}, {what}: worst {np.max(err / tol)} x the scaled bound"
        np.testing.assert_array_equal(a, un)        # the port rounds every operation
        if not np.array_equal(b, un):               # the reference differs by its contractions
            assert np.mean(b == fu) > np.mean(b == un), name


@pytest.mark.parametrize("name,make", _cases(), ids=[c[0] for c in _cases()])
def test_plain_k1_matches_pallas_interpret(name, make):
    geom, o, d, maxt = make()
    # every case's table padded with degenerate rows to INTERPRET_ROWS, so
    # that all share one compile of the interpret-mode kernel; a table of at
    # most 64 rows would take the kernel's fully unrolled branch, which
    # costs ~17 s to compile on the CPU (the JAX package's own
    # tests/test_pallas_intersect.py runs that branch on the cbox)
    table = j_build_table(geom)
    table = jnp.concatenate([table, jnp.zeros((INTERPRET_ROWS - table.shape[0], 9), table.dtype)])
    jt, jp, ju, jv = _j_tri_intersect_jit(
        table, jnp.asarray([table.shape[0]], jnp.int32), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(maxt),
    )
    tt, tp, tu, tv = K1.tri_intersect(*_torch(np.asarray(table), o, d, maxt))
    assert tp.dtype == torch.int32
    _assert_same_hits(
        np.asarray(table), o, d, tt.numpy(), tp.numpy(), tu.numpy(), tv.numpy(),
        np.asarray(jt), np.asarray(jp), np.asarray(ju), np.asarray(jv),
    )
    hit = np.asarray(jp) >= 0
    assert hit.any() and (~hit).any()
    assert (tp.numpy()[~(maxt > 0)] == -1).all()        # disabled lanes never hit


@pytest.mark.parametrize("name,make", _cases(), ids=[c[0] for c in _cases()])
def test_port_shapes_match_xla_closest_hit(name, make):
    """The port's ray_intersect_preliminary against the JAX XLA path
    (shapes.ray_intersect_preliminary on the CPU), on the same geometry."""
    from mitsuba_tpu_torch.render import records as TR
    from mitsuba_tpu_torch.render import shapes as TSH

    geom, o, d, maxt = make()
    active = maxt != -np.inf
    jpi = JSH.ray_intersect_preliminary(
        geom, JRay(o=jnp.asarray(o), d=jnp.asarray(d), maxt=jnp.asarray(maxt)),
        jnp.asarray(active),
    )
    tgeom = TSH.Geometry(
        vertices=torch.zeros(1, 3), vertex_normals=torch.zeros(1, 3),
        tri_face=torch.zeros(geom.n_tris, 3, dtype=torch.int64),
        tri_v0=_torch(np.asarray(geom.tri_v0))[0], tri_e1=_torch(np.asarray(geom.tri_e1))[0],
        tri_e2=_torch(np.asarray(geom.tri_e2))[0], tri_ng=_torch(np.asarray(geom.tri_ng))[0],
        tri_vn=_torch(np.asarray(geom.tri_vn))[0], tri_uv=_torch(np.asarray(geom.tri_uv))[0],
        tri_shape=_torch(np.asarray(geom.tri_shape))[0], n_tris=geom.n_tris,
    )
    to, td, tm, ta = _torch(o, d, maxt, active)
    tpi = TSH.ray_intersect_preliminary(tgeom, TR.Ray(o=to, d=td, maxt=tm), ta)
    juv = np.asarray(jpi.prim_uv)
    tuv = tpi.prim_uv.numpy()
    _assert_same_hits(
        np.asarray(j_build_table(geom)), o, d, tpi.t.numpy(), tpi.prim_index.numpy(), tuv[:, 0], tuv[:, 1],
        np.asarray(jpi.t), np.asarray(jpi.prim_index), juv[:, 0], juv[:, 1],
    )


@pytest.mark.parametrize("tri_chunk,ray_chunk", [(7, 100), (1, 333), (200, 4096)])
def test_plain_k1_chunking_is_bitwise_invariant(tri_chunk, ray_chunk):
    """Ties straddle the chunk boundaries: the first index must still win,
    and t, u, v must not change by a bit."""
    geom, o, d, maxt = _soup(200, 1024, 9)
    args = _torch(np.asarray(j_build_table(geom)), o, d, maxt)
    ref = K1.tri_intersect_reference(*args)
    got = K1.tri_intersect_reference(*args, tri_chunk=tri_chunk, ray_chunk=ray_chunk)
    for a, b in zip(ref, got):
        assert torch.equal(a, b)


def test_first_index_wins_ties():
    v0 = np.array([[-1, -1, 0]], np.float32)
    row = np.concatenate([v0, [[2, 0, 0]], [[0, 2, 0]]], axis=-1).astype(np.float32)
    table = torch.from_numpy(np.concatenate([np.zeros((3, 9), np.float32), row, row, row]))
    o = torch.tensor([[-0.5, -0.5, 1.0], [-0.5, -0.5, 1.0]])
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    maxt = torch.tensor([10.0, 1.0])       # the second lane's hit at t=1 is not < maxt
    t, p, u, v = K1.tri_intersect(table, o, d, maxt)
    assert p.tolist() == [3, -1]
    assert t[0].item() == 1.0 and t[1].item() == float("inf")
    assert u[1].item() == 0.0 and v[1].item() == 0.0


@pytest.mark.parametrize("name", ["port-cbox", "cbox", "soup64", "soup200"])
def test_trimming_the_padding_rows_changes_nothing(name):
    """The routes sweep only the table's real rows (render/shapes.py): the
    plain K1 over them gives the same prim, t, u, v, bit for bit, as over
    the table with its degenerate padding rows. "port-cbox" is the port's
    own cbox geometry and its n_real_tris; the others are _cases()'s
    tables padded to INTERPRET_ROWS."""
    geom, o, d, maxt = dict(_cases())["cbox" if name == "port-cbox" else name]()
    if name == "port-cbox":
        tgeom = mt.load_dict(_cbox_dict(), device="cpu").geometry
        table, n_real = K1.build_tri_table(tgeom), tgeom.n_real_tris
        assert (n_real, table.shape[0]) == (36, 64)
    else:
        table = np.asarray(j_build_table(geom))
        n_real = int(np.nonzero(np.abs(table).sum(1))[0].max()) + 1
        table = torch.from_numpy(np.concatenate(
            [table[:n_real], np.zeros((INTERPRET_ROWS - n_real, 9), np.float32)]))
    assert not table[n_real:, 3:].any()         # degenerate: e1 = e2 = 0
    rays = _torch(o, d, maxt)
    full = K1.tri_intersect_reference(table, *rays)
    trimmed = K1.tri_intersect_reference(table[:n_real], *rays)
    assert (full[1] >= 0).any()
    for a, b in zip(trimmed, full):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_trimmed_route_gradients_equal_the_padded_routes(monkeypatch):
    """A 16x16 cbox gradient step through the trimmed route (the table's
    real rows) and through the whole padded table (n_real_tris None): the
    PRB step's gradient of white.reflectance.value is the same bit for bit
    (its replay intersects the detached scene, so no cotangent reaches the
    table there), and in the path integrator's tape gradient of
    floor.vertex_positions, where the hit's VJP runs, every cotangent that
    reaches the padded table through the slice is zero on the padding rows
    and equal to the padded route's on the real rows."""
    from mitsuba_tpu_torch.render import shapes as TSH

    cts = []
    build = TSH.build_tri_table

    def recording(geom):
        table = build(geom)
        if table.requires_grad:
            table.register_hook(lambda g: cts.append(g.clone()))
        return table

    monkeypatch.setattr(TSH, "build_tri_table", recording)

    def step(trim, integrator, key):
        d = _cbox_dict(16)
        d["integrator"] = {"type": integrator, "max_depth": 3}
        scene = mt.load_dict(d, device="cpu")
        n_real = scene.geometry.n_real_tris
        if not trim:
            scene = dataclasses.replace(
                scene, geometry=dataclasses.replace(scene.geometry, n_real_tris=None))
        params = mt.traverse(scene)
        v = params[key].clone().requires_grad_()
        cts.clear()
        mt.render(params.update({key: v}), spp=2, seed=1).mean().backward()
        return v.grad, list(cts), n_real

    g_trim, ct_trim, _ = step(True, "prb", "white.reflectance.value")
    g_full, ct_full, _ = step(False, "prb", "white.reflectance.value")
    assert torch.equal(g_trim, g_full) and (g_trim != 0).all()
    assert not ct_trim and not ct_full
    g_trim, ct_trim, n_real = step(True, "path", "floor.vertex_positions")
    g_full, ct_full, _ = step(False, "path", "floor.vertex_positions")
    assert torch.equal(g_trim, g_full) and g_trim.abs().max() > 0
    assert len(ct_trim) == len(ct_full) > 0
    for a, b in zip(ct_trim, ct_full):
        assert a.shape == b.shape == (64, 9)
        assert not a[n_real:].any() and not b[n_real:].any()
        assert torch.equal(a[:n_real], b[:n_real])
    assert any(a.abs().max() > 0 for a in ct_trim)


def test_wrapper_rejects_bad_inputs():
    table = torch.zeros(64, 9)
    o = torch.zeros(8, 3)
    d = torch.zeros(8, 3)
    maxt = torch.ones(8)
    with pytest.raises(TypeError):
        K1.tri_intersect(table.double(), o, d, maxt)
    with pytest.raises(ValueError):
        K1.tri_intersect(table, torch.zeros(3, 8).t(), d, maxt)        # not contiguous
    with pytest.raises(ValueError):
        K1.tri_intersect(torch.zeros(64, 8), o, d, maxt)
    with pytest.raises(ValueError):
        K1.tri_intersect(torch.zeros(K1.MAX_SMEM_TRIS + 1, 9), o, d, maxt)
    with pytest.raises(ValueError):
        K1.tri_intersect(table, o, d, torch.ones(7))
    # no device other than the CPU (plain version) and CUDA (kernel)
    with pytest.raises(ValueError):
        K1.tri_intersect(*(x.to("meta") for x in (table, o, d, maxt)))


def test_build_tri_table_matches_jax():
    jscene = mj.load_dict(_cbox_dict())
    tscene = mt.load_dict(_cbox_dict(), device="cpu")
    np.testing.assert_array_equal(
        K1.build_tri_table(tscene.geometry).numpy(), np.asarray(j_build_table(jscene.geometry))
    )


# ---------------------------------------------------------------------------
# the gradient of the hit
# ---------------------------------------------------------------------------

@jax.jit
def _j_vjp(table, o, d, maxt, g_t, g_u, g_v):
    n_tri = jnp.asarray([table.shape[0]], jnp.int32)
    out, pull = jax.vjp(lambda tb, oo, dd: j_tri_intersect(tb, n_tri, oo, dd, maxt), table, o, d)
    return out, pull((g_t, np.zeros(g_t.shape, jax.dtypes.float0), g_u, g_v))


def test_tri_intersect_vjp_matches_jax():
    geom, o, d, maxt = _cbox_rays(2048)
    table = np.asarray(j_build_table(geom))
    table = np.concatenate([table, np.zeros((INTERPRET_ROWS - table.shape[0], 9), np.float32)])
    r = np.random.default_rng(8)
    g_t, g_u, g_v = (r.normal(size=o.shape[0]).astype(np.float32) for _ in range(3))
    (jt, jp, ju, jv), (jc_table, jc_o, jc_d) = (
        [np.asarray(x) for x in part] for part in _j_vjp(*map(jnp.asarray, (table, o, d, maxt, g_t, g_u, g_v)))
    )
    tb, to, td = (x.requires_grad_() for x in _torch(table, o, d))
    t, p, u, v = K1.tri_intersect(tb, to, td, torch.from_numpy(maxt))
    np.testing.assert_array_equal(p.numpy(), jp)
    cts = torch.autograd.grad((t, u, v), (tb, to, td), _torch(g_t, g_u, g_v))
    hit = jp >= 0
    assert hit.sum() > 200 and (~hit).sum() > 200
    for got, want in zip(cts[1:], (jc_o, jc_d)):
        np.testing.assert_allclose(got.numpy()[hit], want[hit], rtol=1e-5, atol=1e-6)
        assert not got.numpy()[~hit].any()
    assert not jc_o[~hit].any() and np.isnan(jc_d[~hit]).all()
    # each row: within 1e-5 of the summed magnitudes of its lanes' terms
    pl = torch.from_numpy(np.maximum(jp, 0)).to(torch.int64)
    rows = torch.from_numpy(table)[pl]
    y = K1.mt_vjp(rows[:, 3:6], rows[:, 6:9], td.detach(), *_torch(g_t, g_u, g_v), p >= 0)
    terms = torch.cat([y, u.detach()[:, None] * y, v.detach()[:, None] * y], dim=-1).abs()
    scale = torch.zeros_like(tb).index_add_(0, pl, terms).numpy()
    assert np.all(np.abs(cts[0].numpy() - jc_table) <= 1e-5 * scale + 1e-7)
    assert np.abs(jc_table).max() > 0


def test_tape_vertex_gradient_matches_jax():
    """d sum(image) / d floor.vertex_positions through the path integrator
    and K1's plain version, against jax.grad of the JAX render."""
    d = _cbox_dict(8)
    d["integrator"] = {"type": "path", "max_depth": 2}
    js = mj.load_dict(d)
    key = "floor.vertex_positions"
    path = dict(js.param_paths)[key]
    want = np.asarray(jax.grad(
        lambda v: jnp.sum(mj.render(_tree_set(js, path, v), spp=2, seed=1)))(_tree_get(js, path)))
    p = mj.traverse(js)
    ts = mt.traverse(mt.load_dict(d, device="cpu")).update({k: np.asarray(p[k]) for k in p.keys()})
    params = mt.traverse(ts)
    v = params[key].clone().requires_grad_()
    mt.render(params.update({key: v}), spp=2, seed=1).sum().backward()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(v.grad.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
