"""The material-preview slice of the port as a whole against the JAX
package on the CPU: renders of spheres_scene (analytic spheres, a sphere
light, a spot, an envmap, a thin lens, a mitchell filter), the fused
many-lights cbox through path and through the particle tracer (with a
collimated panel), the projector; a mesh on the BVH with an analytic
sphere; the prb gradients for the envmap's data and a sphere's
reflectance; and what stays unported (a sphere's center or radius
gradient, the projective terms of spheres, spots and projectors).

Inputs come from the scene builders and numpy seeds; the JAX side goes
through jax.jit with the scene closed over. Each render's lanes are held
at rtol 1e-4 / atol 1e-5 (tests/test_torch_render.py's lane tolerance),
all but PARTING_SHARE of them: at depth a few lanes' paths part (the
glass sphere amplifies XLA's fused multiply-adds, as the glass box of
tests/test_torch_materials.py does); the means within 1e-3 relative; the
gradients within 1e-3 relative (the envmap's as its sum and its largest
texels).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mitsuba_tpu as mj
from mitsuba_tpu.render_api import _ptracer_pass, render_lanes as j_render_lanes

import mitsuba_tpu_torch as mt
from mitsuba_tpu_torch.render.scene_loader import mesh_scene, sky_envmap
from mitsuba_tpu_torch.render_api import render_lanes as t_render_lanes

LANE_TOL = dict(rtol=1e-4, atol=1e-5)
PARTING_SHARE = 0.01
MEAN_RTOL = 1e-3
GRAD_RTOL = 1e-3
W, SPP = 16, 4


@pytest.fixture(autouse=True)
def _rgb():
    mj.set_variant("rgb")
    mt.set_variant("rgb")
    yield


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (ROADMAP Queue 3)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lanes_match(d, n_pix=W * W, spp=SPP):
    """The lanes of one pass of the dict in both packages: their means
    within MEAN_RTOL, all but PARTING_SHARE within LANE_TOL, the same ray
    counts. Returns the port's scene and lanes."""
    js, ts = mj.load_dict(d), mt.load_dict(d, device="cpu")
    n = n_pix * spp
    Lj, _, _, aux_j = jax.jit(lambda: j_render_lanes(js, jnp.uint32(0), 0, n, 0, spp, spp, 0))()
    Lt, aux_t = t_render_lanes(ts, 0, 0, n, 0, spp, spp, 0)
    Lj, Lt = np.asarray(Lj), Lt.numpy()
    assert np.isfinite(Lt).all() and Lt.mean() > 0
    parting = ~np.isclose(Lt, Lj, **LANE_TOL).all(axis=-1)
    assert parting.mean() <= PARTING_SHARE, f"{parting.sum()} of {n} lanes part"
    np.testing.assert_allclose(Lt.mean(0), Lj.mean(0), rtol=MEAN_RTOL)
    assert abs(int(aux_t["n_rays"]) - int(float(aux_j["n_rays"]))) <= parting.sum() * 16
    return ts, Lt


def test_spheres_scene_matches_jax():
    ts, Lt = _lanes_match(mt.spheres_scene(W, SPP))
    assert ts.geometry.n_spheres == 4 and ts.film.rfilter == "mitchell"
    # every kind of hit: the spheres, the sphere light, the floor, the sky
    assert Lt.max() > 10.0


@pytest.mark.parametrize("integrator", ["path", "ptracer"])
def test_manylights_matches_jax(integrator):
    """The cbox lit by 8 fused panels (the loader's AreaEmitterArray):
    path lanes; the particle tracer's image with a collimated panel
    (rtol 1e-4: its splats are summed in another order)."""
    if integrator == "path":
        _lanes_match(mt.manylights_scene(W, SPP))
        return
    d = mt.manylights_scene(W, SPP, {"type": "ptracer", "max_depth": 4}, beam=True)
    js, ts = mj.load_dict(d), mt.load_dict(d, device="cpu")
    img_j = np.asarray(_ptracer_pass(js, jnp.uint32(0), SPP, 0))
    img_t = mt.render(ts, spp=SPP, seed=0)
    np.testing.assert_allclose(img_t.numpy(), img_j, rtol=1e-4, atol=1e-6)
    beamless = mt.render(mt.load_dict(mt.manylights_scene(W, SPP, d["integrator"]),
                                      device="cpu"), spp=SPP, seed=0)
    assert float(img_t.mean()) != float(beamless.mean())


def test_projector_matches_jax():
    """The projector's cbox with a disk (a fan of 64 triangles) and a
    cylinder (a strip of 192) on its floor: their triangle tables are the
    JAX loader's, and the lanes match."""
    d = mt.projector_scene(W, SPP)
    grey = {"type": "diffuse", "reflectance": 0.5}
    d["disk"] = {"type": "disk", "bsdf": grey,
                 "to_world": [{"type": "scale", "value": 0.3},
                              {"type": "rotate", "axis": [1, 0, 0], "angle": -90},
                              {"type": "translate", "value": [0.35, -0.99, 0.3]}]}
    d["pillar"] = {"type": "cylinder", "p0": [-0.45, -1.0, -0.2], "p1": [-0.45, -0.3, -0.2],
                   "radius": 0.15, "bsdf": grey}
    ts, _ = _lanes_match(d)
    assert type(ts.emitters[1]).__name__ == "ProjectorEmitter"
    js, g = mj.load_dict(d).geometry, ts.geometry
    n = int((g.tri_shape >= 0).sum())
    assert n == int((np.asarray(js.tri_shape) >= 0).sum())
    # the last two shapes loaded
    assert np.bincount(g.tri_shape[:n].numpy())[-2:].tolist() == [64, 192]
    for key in ("tri_v0", "tri_e1", "tri_e2", "tri_ng", "tri_vn", "tri_uv"):
        np.testing.assert_allclose(getattr(g, key)[:n].numpy(), np.asarray(getattr(js, key))[:n],
                                   rtol=1e-6, atol=1e-7, err_msg=key)


def test_bvh_mesh_with_a_sphere_matches_jax(tmp_path):
    """A mesh of 10,800 triangles (the BVH, K2's plain walk) with an
    analytic sphere and the envmap: the sphere pass after the BVH's
    closest hit and ORed with its any hit."""
    d = mesh_scene(str(tmp_path / "s.obj"), k=30, res=8)
    d["ball"] = {"type": "sphere", "center": [-0.4, -0.6, 0.3], "radius": 0.3,
                 "bsdf": {"type": "diffuse", "reflectance": 0.6}}
    d["sky"] = {"type": "envmap", "data": sky_envmap(16, 32)}
    d["integrator"] = {"type": "path", "max_depth": 3}
    ts, _ = _lanes_match(d, n_pix=64, spp=2)
    assert ts.geometry.has_bvh and ts.geometry.n_spheres == 1


def test_prb_gradients_match_jax():
    """The image mean's gradient for the envmap's data and the diffuse
    sphere's reflectance, prb max_depth 4, 16x16 @ 4 spp."""
    keys = ["sky.data", "diffuse-ball.bsdf.reflectance.value"]
    d = mt.spheres_scene(W, SPP, {"type": "prb", "max_depth": 4})
    js = mj.load_dict(d)

    def loss(v):
        return jnp.mean(mj.render(mj.traverse(js).update(dict(zip(keys, v))), spp=SPP, seed=0))

    pj = mj.traverse(js)
    val_j, g_j = jax.jit(jax.value_and_grad(loss))(tuple(pj[k] for k in keys))
    p = mt.traverse(mt.load_dict(d, device="cpu"))
    v = {k: p[k].detach().clone().requires_grad_() for k in keys}
    img = mt.render(p.update(v), spp=SPP, seed=0)
    img.mean().backward()
    np.testing.assert_allclose(float(img.detach().mean()), float(val_j), rtol=MEAN_RTOL)
    g_env, g_env_j = v[keys[0]].grad.numpy(), np.asarray(g_j[0])
    np.testing.assert_allclose(g_env.sum(), g_env_j.sum(), rtol=GRAD_RTOL)
    top = np.argsort(-np.abs(g_env_j).reshape(-1))[:16]
    np.testing.assert_allclose(g_env.reshape(-1)[top], g_env_j.reshape(-1)[top], rtol=GRAD_RTOL)
    np.testing.assert_allclose(v[keys[1]].grad.numpy(), np.asarray(g_j[1]), rtol=GRAD_RTOL)


def test_unported_sphere_gradients_raise_and_updates_stay_live():
    p = mt.traverse(mt.load_dict(mt.spheres_scene(8, 2, {"type": "path", "max_depth": 2}),
                                 device="cpu"))
    for key in ("diffuse-ball.center", "diffuse-ball.radius"):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            p.update({key: p[key].clone().requires_grad_()})
    before = mt.render(p.scene, spp=2, seed=0)
    moved = p.update({"diffuse-ball.center": [0.2, -0.5, 0.1], "bulb.radius": 0.12})
    assert moved.geometry.sph_center[0].tolist() == pytest.approx([0.2, -0.5, 0.1])
    assert not torch.equal(mt.render(moved, spp=2, seed=0), before)
    for d in (mt.spheres_scene(8, 2), mt.projector_scene(8, 2)):
        d["integrator"] = {"type": "prb_projective", "max_depth": 2}
        if "bulb" in d:
            del d["bulb"], d["diffuse-ball"], d["gold-ball"], d["glass-ball"]
        with pytest.raises(NotImplementedError, match="not yet ported"):
            mt.render(mt.load_dict(d, device="cpu"), spp=1)
    d = mt.spheres_scene(8, 2, {"type": "direct_projective"})
    with pytest.raises(NotImplementedError, match="sphere"):
        mt.render(mt.load_dict(d, device="cpu"), spp=1)
