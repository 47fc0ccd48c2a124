"""The port's Cornell-box forward path held against the JAX package on the
CPU: module by module, then the whole slice.

Both packages load the same scene dict; the JAX scene's parameters are
carried into the port with ``traverse(scene).update(...)``. Module parity
is held at rtol=1e-6 (atol=1e-6 where a value can be near 0, since XLA's
and torch's log, sin, cos and rsqrt may differ in the last place). The
slice is held per pixel at depth 2, and per lane at depth 8, where an
ulp-level difference can flip a rare Russian-roulette or edge-hit
decision and send one path elsewhere.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import mitsuba_tpu as mj
from mitsuba_tpu.core import warp as jwarp
from mitsuba_tpu.render import film as jfilm
from mitsuba_tpu.render import shapes as JSH
from mitsuba_tpu.render.records import Ray as JRay
from mitsuba_tpu.render_api import make_wavefront as j_make_wavefront
from mitsuba_tpu.render_api import render_lanes as j_render_lanes

import mitsuba_tpu_torch as mt
from mitsuba_tpu_torch.core import warp as twarp
from mitsuba_tpu_torch.render import film as tfilm
from mitsuba_tpu_torch.render import shapes as TSH
from mitsuba_tpu_torch.render.records import Ray as TRay
from mitsuba_tpu_torch.render_api import make_wavefront as t_make_wavefront
from mitsuba_tpu_torch.render_api import render_lanes as t_render_lanes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = 16
SPP = 4


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


def _cbox(max_depth=8, defer_nee=True):
    d = mj.cornell_box()
    d["sensor"]["film"]["width"] = W
    d["sensor"]["film"]["height"] = W
    d["integrator"]["max_depth"] = max_depth
    d["integrator"]["defer_nee"] = defer_nee
    return d


def _pair(**kw):
    """(JAX scene, port scene on the CPU with the JAX parameters carried in)."""
    js = mj.load_dict(_cbox(**kw))
    p = mj.traverse(js)
    ts = mt.traverse(mt.load_dict(_cbox(**kw), device="cpu")).update(
        {k: np.asarray(p[k]) for k in p.keys()}
    )
    return js, ts


def _close(a, b, rtol=1e-6, atol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _u(n, k, seed):
    return np.random.default_rng(seed).random((n, k), dtype=np.float32)


# ---------------------------------------------------------------------------
# (c) module parity
# ---------------------------------------------------------------------------

def test_loader_geometry_and_camera_match_jax():
    js = mj.load_dict(_cbox())
    ts = mt.load_dict(_cbox(), device="cpu")
    for k in ("tri_v0", "tri_e1", "tri_e2", "tri_ng", "tri_uv", "tri_shape"):
        a = getattr(ts.geometry, k).numpy()
        assert a.shape[0] == 64
        np.testing.assert_array_equal(a, np.asarray(getattr(js.geometry, k)), err_msg=k)
    np.testing.assert_array_equal(
        ts.sensors[0].to_world_m.numpy(), np.asarray(js.sensors[0].to_world_m)
    )
    assert ts.sensors[0].tan_half_fov_x.item() == float(js.sensors[0].tan_half_fov_x)
    assert set(mt.traverse(ts).keys()) == set(mj.traverse(js).keys())


def test_traverse_update_rederives_geometry_and_emitter_cdf():
    ts = mt.load_dict(_cbox(), device="cpu")
    params = mt.traverse(ts)
    light = params["light.vertex_positions"].numpy() * np.float32(1.5)
    new = params.update({"light.vertex_positions": light, "red.reflectance.value": [0.1, 0.2, 0.3]})
    assert params.scene is new and ts.geometry.vertices is not new.geometry.vertices
    em_old, em_new = ts.emitters[0], new.emitters[0]
    assert em_new.total_area.item() == pytest.approx(em_old.total_area.item() * 2.25, rel=1e-5)
    tri = em_new.tri_index
    np.testing.assert_allclose(
        new.geometry.tri_e1[tri].numpy(), ts.geometry.tri_e1[tri].numpy() * 1.5, rtol=1e-6
    )
    assert params["red.reflectance.value"].tolist() == pytest.approx([0.1, 0.2, 0.3])
    assert mt.traverse(ts)["red.reflectance.value"].tolist() != pytest.approx([0.1, 0.2, 0.3])


def test_sample_ray_matches_jax():
    js, ts = _pair()
    pos, ap = _u(4096, 2, 1), _u(4096, 2, 2)
    jr = js.sensors[0].sample_ray(jnp.asarray(pos), jnp.asarray(ap))
    tr = ts.sensors[0].sample_ray(torch.from_numpy(pos), torch.from_numpy(ap))
    _close(tr.o, jr.o)
    _close(tr.d, jr.d, atol=1e-6)


@pytest.mark.parametrize("rfilter", ["gaussian", "box", "tent"])
def test_sample_filter_offset_matches_jax(rfilter):
    u = _u(8192, 2, 3)
    _close(
        tfilm.sample_filter_offset(rfilter, torch.from_numpy(u)),
        jfilm.sample_filter_offset(rfilter, jnp.asarray(u)),
        atol=1e-6,
    )


def test_develop_matches_jax():
    film_j = jfilm.Film(width=8, height=6)
    film_t = tfilm.Film(width=8, height=6)
    vals = _u(8 * 6 * 5, 3, 4) * 10
    _close(tfilm.develop(film_t, torch.from_numpy(vals), 5), jfilm.develop(film_j, jnp.asarray(vals), 5))


def test_warps_match_jax():
    u = _u(8192, 2, 5)
    tu, ju = torch.from_numpy(u), jnp.asarray(u)
    wo_t = twarp.square_to_cosine_hemisphere(tu).numpy()
    wo_j = np.array(jwarp.square_to_cosine_hemisphere(ju))
    _close(wo_t[:, :2], wo_j[:, :2], atol=1e-6)
    # z = sqrt(1 - x^2 - y^2) amplifies an ulp of x, y by 1/z at the disk's
    # rim: z itself is held where z >= 0.1, z^2 everywhere
    rim = wo_j[:, 2] < 0.1
    _close(wo_t[~rim, 2], wo_j[~rim, 2], atol=1e-6)
    _close(wo_t[:, 2] ** 2, wo_j[:, 2] ** 2, atol=1e-6)
    pdf_t = twarp.square_to_cosine_hemisphere_pdf(torch.from_numpy(wo_j)).numpy()
    _close(pdf_t, jwarp.square_to_cosine_hemisphere_pdf(jnp.asarray(wo_j)), atol=1e-6)
    _close(twarp.square_to_uniform_triangle(tu), jwarp.square_to_uniform_triangle(ju), atol=1e-6)
    _close(twarp.interval_to_tent(tu[:, 0]), jwarp.interval_to_tent(ju[:, 0]), atol=1e-6)


def test_area_emitter_sample_direction_matches_jax():
    js, ts = _pair()
    ref_p = (_u(4096, 3, 6) * 1.8 - 0.9).astype(np.float32)
    u2 = _u(4096, 2, 7)
    jds, jw = js.emitters[0].sample_direction(jnp.asarray(ref_p), jnp.asarray(u2), js.geometry, None, 3, 0)
    tds, tw = ts.emitters[0].sample_direction(torch.from_numpy(ref_p), torch.from_numpy(u2), ts.geometry, 0, 3)
    for k in ("p", "n", "d", "dist", "pdf", "uv"):
        _close(getattr(tds, k), getattr(jds, k), atol=1e-6)
    _close(tw, jw, rtol=1e-5)


def test_compute_surface_interaction_matches_jax():
    js, ts = _pair()
    _, jray, _, _, _ = j_make_wavefront(js, jnp.uint32(0), 0, W * W * SPP, 0, SPP, SPP, 0)
    _, tray, _, _, _ = t_make_wavefront(ts, 0, 0, W * W * SPP, 0, SPP, SPP, 0)
    _close(tray.o, jray.o)
    _close(tray.d, jray.d, atol=1e-6)
    # shade the same rays on both sides
    o, d = np.array(jray.o), np.array(jray.d)
    jr = JRay(o=jnp.asarray(o), d=jnp.asarray(d), maxt=jnp.full(o.shape[0], jnp.inf))
    tr = TRay.make(torch.from_numpy(o), torch.from_numpy(d))
    jsi = JSH.compute_surface_interaction(js.geometry, jr, JSH.ray_intersect_preliminary(js.geometry, jr))
    tsi = TSH.compute_surface_interaction(ts.geometry, tr, TSH.ray_intersect_preliminary(ts.geometry, tr))
    np.testing.assert_array_equal(tsi.prim_index.numpy(), np.asarray(jsi.prim_index))
    np.testing.assert_array_equal(tsi.shape_index.numpy(), np.asarray(jsi.shape_index))
    for k in ("t", "p", "n", "sh_n", "sh_s", "sh_t", "uv", "wi"):
        _close(getattr(tsi, k), getattr(jsi, k), atol=1e-6)


# ---------------------------------------------------------------------------
# (d) the slice: cbox 16x16 @ 4 spp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_depth,defer_nee", [(2, True), (2, False), (8, True)])
def test_cbox_radiance_matches_jax(max_depth, defer_nee):
    js, ts = _pair(max_depth=max_depth, defer_nee=defer_nee)
    n = W * W * SPP
    Lj, _, _, aux_j = j_render_lanes(js, jnp.uint32(0), 0, n, 0, SPP, SPP, 0)
    Lt, aux_t = t_render_lanes(ts, 0, 0, n, 0, SPP, SPP, 0)
    Lj, Lt = np.asarray(Lj), Lt.numpy()
    assert np.isfinite(Lt).all() and Lt.mean() > 0
    assert int(aux_t["n_rays"]) == int(float(aux_j["n_rays"]))
    lane_ok = np.isclose(Lt, Lj, rtol=1e-4, atol=1e-5).all(axis=-1)
    print(f"max_depth={max_depth}: {int((~lane_ok).sum())} of {n} lanes differ")
    if max_depth == 2:
        img_t = mt.render(ts, spp=SPP, seed=0).numpy()
        img_j = np.asarray(jfilm.develop(js.film, jnp.asarray(Lj), SPP))
        np.testing.assert_allclose(img_t, img_j, rtol=1e-4, atol=1e-5)
    else:
        assert lane_ok.mean() >= 0.99


def test_spp_per_pass_split_is_bitwise_invariant():
    d = _cbox()
    d["sensor"]["film"]["width"] = d["sensor"]["film"]["height"] = 8
    ts = mt.load_dict(d, device="cpu")
    a = mt.render(ts, spp=4, seed=3)
    b = mt.render(ts, spp=4, seed=3, spp_per_pass=2)
    stats = {}
    c = mt.render(ts, spp=4, seed=3, spp_per_pass=3, stats=stats)
    assert torch.equal(a, b) and torch.equal(a, c)
    assert stats["n_rays"] > 8 * 8 * 4 and stats["n_invalid"] == 0


# ---------------------------------------------------------------------------
# (e) no JAX, (f) device selection, refusals
# ---------------------------------------------------------------------------

def test_port_imports_and_renders_without_jax(tmp_path):
    script = textwrap.dedent("""
        import importlib.abc, sys
        BLOCKED = ("jax", "jaxlib", "flax", "mitsuba_tpu")
        for name in list(sys.modules):
            if name.split(".")[0] in BLOCKED:
                del sys.modules[name]
        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"blocked import of {name}")
                return None
        sys.meta_path.insert(0, Block())
        import mitsuba_tpu_torch as mt
        from mitsuba_tpu_torch.render.scene_loader import mesh_scene
        d = mt.cornell_box()
        d["sensor"]["film"]["width"] = d["sensor"]["film"]["height"] = 8
        img = mt.render(mt.load_dict(d, device="cpu"), spp=2, seed=0)
        assert img.shape == (8, 8, 3) and bool(img.isfinite().all())
        # the mesh path: native loader and BVH builder, K2's plain version
        scene = mt.load_dict(mesh_scene(sys.argv[1], k=30, res=8), device="cpu")
        assert scene.geometry.has_bvh
        img = mt.render(scene, spp=1, seed=0)
        assert img.shape == (8, 8, 3) and bool(img.isfinite().all())
        # the PRB gradient step and the optimizers (mitsuba_tpu_torch.ad)
        import mitsuba_tpu_torch.ad as ad
        d["integrator"] = {"type": "prb", "max_depth": 2}
        params = mt.traverse(mt.load_dict(d, device="cpu"))
        v = params["white.reflectance.value"].clone().requires_grad_()
        mt.render(params.update({"white.reflectance.value": v}), spp=2, seed=0).mean().backward()
        opt = ad.Adam(lr=0.1)
        opt["white.reflectance.value"] = v.detach()
        assert bool(opt.step({"white.reflectance.value": v.grad})["white.reflectance.value"].isfinite().all())
        # a grid medium in a null cube under a constant environment (volpath),
        # as a wavefront and with path regeneration
        import numpy as np
        grid = np.random.default_rng(3).random((8, 8, 8, 1)).astype(np.float32)
        vol = {"type": "scene",
               "integrator": {"type": "volpath", "max_depth": 3, "track_steps": 4, "nee_steps": 4},
               "sensor": {"type": "perspective", "fov": 45,
                          "to_world": [{"type": "look_at", "origin": [0, 0, 4], "target": [0, 0, 0],
                                        "up": [0, 1, 0]}],
                          "film": {"type": "hdrfilm", "width": 8, "height": 8,
                                   "rfilter": {"type": "box"}}},
               "light": {"type": "constant", "radiance": 1.0},
               "cloud": {"type": "cube", "bsdf": {"type": "null"},
                         "interior": {"type": "heterogeneous",
                                      "sigma_t": {"type": "gridvolume", "data": grid,
                                                  "bbox_min": [-1, -1, -1], "bbox_max": [1, 1, 1]},
                                      "albedo": 0.9, "phase": {"type": "hg", "g": 0.5}}}}
        for regen in (False, True):
            vol["integrator"]["regenerate"] = regen
            img = mt.render(mt.load_dict(vol, device="cpu"), spp=2, seed=0)
            assert img.shape == (8, 8, 3) and bool(img.isfinite().all()) and float(img.mean()) > 0
        # the last integrators and the boundary gradients: ptracer,
        # volpathmis, prb_projective on vertex_positions, LargeSteps, and
        # the adding-doubling solver
        from mitsuba_tpu_torch.ad import projective, largesteps
        from mitsuba_tpu_torch.integrators import ptracer, volpathmis
        from mitsuba_tpu_torch.utils import doubling
        d["integrator"] = {"type": "ptracer", "max_depth": 2}
        assert bool(mt.render(mt.load_dict(d, device="cpu"), spp=1, seed=0).isfinite().all())
        vol["integrator"] = {"type": "volpathmis", "max_depth": 2}
        assert bool(mt.render(mt.load_dict(vol, device="cpu"), spp=1, seed=0).isfinite().all())
        d["integrator"] = {"type": "prb_projective", "max_depth": 2, "sppp": 1, "sppi": 1}
        params = mt.traverse(mt.load_dict(d, device="cpu"))
        v = params["small-box.vertex_positions"].clone().requires_grad_()
        mt.render(params.update({"small-box.vertex_positions": v}), spp=1, seed=0).mean().backward()
        assert bool(v.grad.isfinite().all()) and float(v.grad.abs().sum()) > 0
        ls = ad.LargeSteps(v.detach(), [[0, 1, 2], [0, 2, 3]])
        assert bool((ls.from_differential(ls.to_differential(v.detach())) - v).abs().max() < 1e-4)
        assert doubling.doubling_slab(0.25, [0.5], n_gauss=8, nphi=8)["e"] > 0
        assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", script, str(tmp_path / "sphere.obj")],
        capture_output=True, text=True, env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("OK")


def test_load_dict_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.load_dict(mt.cornell_box())
    with pytest.raises(RuntimeError):
        mt.load_dict(mt.cornell_box(), device="cuda")


def test_unported_parts_raise():
    mt.set_variant("llvm_ad_rgb")
    mt.set_variant("scalar_rgb")
    mt.set_variant("llvm_ad_spectral_polarized")
    mt.set_variant("rgb")
    d = _cbox()
    d["white"] = {"type": "normalmap", "bsdf": {"type": "diffuse"}}
    with pytest.raises(NotImplementedError):
        mt.load_dict(d, device="cpu")
    d = _cbox()
    d["sensor"]["sampler"] = {"type": "sobol", "sample_count": 4}
    with pytest.raises(NotImplementedError):
        mt.load_dict(d, device="cpu")
    d = _cbox()
    d["sdf"] = {"type": "sdfgrid", "data": np.zeros((4, 4, 4), np.float32)}
    with pytest.raises(NotImplementedError):
        mt.load_dict(d, device="cpu")
    d = _cbox()
    d["mesh"] = {"type": "serialized", "filename": "mesh.serialized"}
    with pytest.raises(NotImplementedError):
        mt.load_dict(d, device="cpu")
    # an envmap file of a format neither package reads: the JAX package's
    # own ValueError
    d = _cbox()
    d["env"] = {"type": "envmap", "filename": "sky.exr"}
    with pytest.raises(ValueError, match="unsupported image format"):
        mt.load_dict(d, device="cpu")
    # what the port now loads: an analytic sphere, an envmap from data, a
    # mitchell film
    d = _cbox()
    d["ball"] = {"type": "sphere", "radius": 0.2}
    d["env"] = {"type": "envmap", "data": np.ones((4, 8, 3), np.float32)}
    d["sensor"]["film"]["rfilter"] = {"type": "mitchell"}
    scene = mt.load_dict(d, device="cpu")
    assert scene.geometry.n_spheres == 1 and scene.film.rfilter == "mitchell"
    assert scene.env_emitter >= 0 and "env.data" in mt.traverse(scene)