"""The surface-materials slice of the port held against the JAX package on
the CPU, at 16x16 @ 4 spp: the materials scene (a gold rough conductor,
bk7 glass, a two-sided rough plastic, a diffuse/silver blend, a mask) and
the polarimeter scene (polarized plastic, smooth gold, a linear polarizer
and a quarter-wave plate in front of the camera) per lane; the direct,
depth, AOV and moment integrators; the PRB gradients through the new
BSDFs' attached evaluations (prb, prb_polarized); the reference's errors
and the loader's refusals.

The JAX gradients are computed live, one jax.jit(jax.value_and_grad) per
variant shared by a module-scoped fixture (tracing and compiling the JAX
package's polarized PRB replay takes ~35 s on the CPU).

Two standing differences show at depth, both ROADMAP Queue 3's last-bit
one (XLA contracts FMAs on the CPU, the port does not). The small box's
bottom face and the floor are coplanar (y = -1), so a ray that reaches
the floor under the glass box meets two triangles at the same t to the
last bit or two, and rounding decides which one it hits
(test_coplanar_floor_ties_split_by_rounding witnesses it); and inside the
JAX package's jitted bounce loop XLA fuses products into sums, whose last
bits a chain of reflections inside the glass box amplifies until a path
turns elsewhere (run op by op, with jax.disable_jit(), those paths are the
port's). At depth 8, 7 of the 1,024 materials lanes differ. So the
per-lane checks hold 99% of the lanes at depth 8, and the gradients are
taken at max_depth 4, where no lane's path differs. On the CPU the port's
own transcendental functions part a few deep lanes more
(test_last_place_of_sin_parts_a_deep_lane).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mitsuba_tpu as mj
from mitsuba_tpu.render import film as jfilm
from mitsuba_tpu.render import shapes as JSH
from mitsuba_tpu.render.records import Ray as JRay
from mitsuba_tpu.render_api import render_lanes as j_render_lanes

import mitsuba_tpu_torch as mt
from mitsuba_tpu_torch.render import shapes as TSH
from mitsuba_tpu_torch.render.records import Ray as TRay
from mitsuba_tpu_torch.render_api import render_lanes as t_render_lanes

W, SPP = 16, 4
N = W * W * SPP
PRB_DEPTH = 4
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _rgb():
    yield
    mj.set_variant("rgb")
    mt.set_variant("rgb")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (ROADMAP Queue 3)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _variant(name):
    mj.set_variant(name)
    mt.set_variant(name)


def _scene_dict(scene, max_depth):
    if scene == "materials":
        return mt.materials_scene(W, SPP, {"type": "path", "max_depth": max_depth})
    return mt.polarimeter_scene(W, SPP, {"type": "stokes", "integrator": {
        "type": "volpath", "max_depth": max_depth}})


_JAX_LANES = {}


def _lanes(d, key=None):
    """(the JAX package's lanes, its counters, the port's lanes, its
    counters, JAX scene, port scene) of one 16x16 @ 4 spp pass at seed 0;
    with a key, the JAX package's lanes are kept for the module."""
    js, ts = mj.load_dict(d), mt.load_dict(d, device="cpu")
    if key not in _JAX_LANES:
        Lj, _, _, aux_j = j_render_lanes(js, jnp.uint32(0), 0, N, 0, SPP, SPP, 0)
        _JAX_LANES[key] = (np.asarray(Lj), aux_j)
    Lj, aux_j = _JAX_LANES.pop(key) if key is None else _JAX_LANES[key]
    Lt, aux_t = t_render_lanes(ts, 0, 0, N, 0, SPP, SPP, 0)
    return Lj, aux_j, Lt.numpy(), aux_t, js, ts


@pytest.mark.parametrize("scene,variant,max_depth", [
    ("materials", "rgb", 2), ("materials", "rgb", 8),
    ("polarimeter", "rgb_polarized", 2), ("polarimeter", "rgb_polarized", 8)])
def test_radiance_matches_jax(scene, variant, max_depth):
    """Per lane ([N, 3], or Stokes [N, 3, 4] in the sensor frame) against
    the JAX package's (rtol 1e-4, atol 1e-5 per value): at depth 2 every
    lane, the image too (rtol 1e-4, atol 1e-5) and n_rays equal; at depth 8
    at least 99% of the lanes (the coplanar floor, module docstring), and
    n_rays within 2 max_depth rays of each differing lane."""
    _variant(variant)
    Lj, aux_j, Lt, aux_t, js, ts = _lanes(_scene_dict(scene, max_depth),
                                          (scene, variant, max_depth))
    assert np.isfinite(Lt).all()
    assert (Lt[..., 0] if Lt.ndim == 3 else Lt).mean() > 0
    lane_ok = np.isclose(Lt, Lj, rtol=1e-4, atol=1e-5).reshape(N, -1).all(axis=-1)
    n_differ = int((~lane_ok).sum())
    rays_t, rays_j = int(aux_t["n_rays"]), int(float(aux_j["n_rays"]))
    print(f"{scene} depth {max_depth}: {n_differ} of {N} lanes differ, n_rays {rays_t} "
          f"(JAX {rays_j})")
    if max_depth == 2:
        assert n_differ == 0 and rays_t == rays_j
        img_t = mt.render(ts, spp=SPP, seed=0).numpy()
        img_j = np.asarray(jfilm.develop(js.film, jnp.asarray(Lj), SPP))
        np.testing.assert_allclose(img_t, img_j, rtol=1e-4, atol=1e-5)
    else:
        assert lane_ok.mean() >= 0.99
        assert abs(rays_t - rays_j) <= 2 * max_depth * n_differ


def test_coplanar_floor_ties_split_by_rounding():
    """The standing difference behind the differing lanes: rays from inside
    the small box toward its bottom face, which lies on the floor's plane.
    Both packages hit one of the two shapes at the same t (within 1e-6
    relative) on every ray; which one wins a tie differs on some rays, by
    the rounding of the intersection (the JAX package's contracted FMAs)."""
    _variant("rgb")
    d = mt.materials_scene(W, SPP)
    js, ts = mj.load_dict(d), mt.load_dict(d, device="cpu")
    r = np.random.default_rng(5)
    n = 4096
    o = np.float32([0.335, -0.7, 0.38]) + r.uniform(-0.1, 0.1, (n, 3)).astype(np.float32)
    dirs = r.normal(size=(n, 3))
    dirs[:, 1] = -np.abs(dirs[:, 1]) - 1.0
    dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)
    jpi = JSH.ray_intersect_preliminary(js.geometry, JRay(
        o=jnp.asarray(o), d=jnp.asarray(dirs), maxt=jnp.full(n, jnp.inf)))
    tpi = TSH.ray_intersect_preliminary(ts.geometry, TRay.make(torch.from_numpy(o),
                                                                torch.from_numpy(dirs)))
    names = [k for k, v in d.items() if isinstance(v, dict) and v.get("type") in
             ("rectangle", "cube")]
    floor, box = names.index("floor"), names.index("small-box")
    shape_j = np.asarray(js.geometry.tri_shape)[np.asarray(jpi.prim_index)]
    shape_t = ts.geometry.tri_shape.numpy()[tpi.prim_index.numpy()]
    assert np.isin(shape_j, [floor, box]).all() and np.isin(shape_t, [floor, box]).all()
    np.testing.assert_allclose(tpi.t.numpy(), np.asarray(jpi.t), rtol=1e-6)
    split = shape_j != shape_t
    print(f"{int(split.sum())} of {n} rays hit the other coplanar shape")
    assert 0 < split.sum() < n // 4



def test_last_place_of_sin_parts_a_deep_lane():
    """The standing difference behind the CPU port's materials-prb gradient
    at max_depth 8 (ROADMAP Queue 3): one lane of the 64x64 @ 16 spp
    backward pass (pixel 269, sample 13, at seed_grad of seed 0), traced
    alone. Up to max_depth 7 the port's radiance is the JAX package's run
    op by op to the bit; at max_depth 8 its last bounce reaches another
    point (radiance 0.0719 against 0.0684 in red). With torch.sin rounded
    correctly (through float64) the port's lane is the JAX package's again:
    PyTorch's vectorized CPU sin misses the correctly rounded value by one
    place for one of the lane's arguments, and the path amplifies it. On
    the whole pass 75 of 65,536 lanes part so (53 with every
    transcendental function rounded correctly: XLA's own functions and
    products differ in other last places); the roulette weights the
    surviving deep paths by 1/q, so those lanes move the gradient by 8%,
    as XLA's FMAs move the JAX package's own jitted gradient 7% from its
    op-by-op one (scripts/torch_materials_parting.py)."""
    from mitsuba_tpu.render_api import wavefront_for as j_wavefront_for
    from mitsuba_tpu_torch.ad.render_ad import derive_seed_grad
    from mitsuba_tpu_torch.render_api import wavefront_for as t_wavefront_for

    _variant("rgb")
    seed = derive_seed_grad(0)
    pix, sidx = np.array([269]), np.array([13])

    def lane(max_depth, sin=torch.sin, jax_too=True):
        d = mt.materials_scene(64, 16, {"type": "path", "max_depth": max_depth})
        ts = mt.load_dict(d, device="cpu")
        rng, ray, _, _, _ = t_wavefront_for(ts, seed, torch.from_numpy(pix), torch.from_numpy(sidx), 16)
        saved, torch.sin = torch.sin, sin
        try:
            Lt, _ = ts.integrator.sample(ts, rng, ray, torch.ones(1, dtype=torch.bool))
        finally:
            torch.sin = saved
        if not jax_too:
            return Lt.numpy()[0], None
        js = mj.load_dict(d)
        with jax.disable_jit():
            r, ry, wl, _, _ = j_wavefront_for(js, jnp.uint32(seed), jnp.asarray(pix, jnp.uint32),
                                              jnp.asarray(sidx, jnp.uint32), jnp.uint32(16), 0)
            Lj, _ = js.integrator.sample(js, r, ry, wl, jnp.ones(1, bool))
        return Lt.numpy()[0], np.asarray(Lj)[0]

    t7, j7 = lane(7)
    np.testing.assert_array_equal(t7, j7)
    t8, j8 = lane(8)
    assert abs(float(t8[0] - j8[0])) > 1e-3
    t8_rn, _ = lane(8, lambda x, sin=torch.sin: sin(x.double()).float(), jax_too=False)
    np.testing.assert_array_equal(t8_rn, j8)

@pytest.mark.parametrize("integrator", [
    {"type": "direct"},
    {"type": "depth"},
    {"type": "aov", "aovs": "dd.y:depth,nn:sh_normal"},
    # the nested path at depth 2, where every lane's path is the same in
    # both packages (module docstring)
    {"type": "moment", "integrator": {"type": "path", "max_depth": 2}},
], ids=["direct", "depth", "aov", "moment"])
def test_integrators_match_jax(integrator):
    """direct, depth, aov and moment on the materials scene, every lane
    within rtol 1e-5, atol 1e-5 (2e-6 where a depth is the value: t
    rounds to ~1e-7 of the camera distance); the AOV's negative normals
    reach the film unclamped, as the reference's signed output; depth and
    aov in a polarized variant give [H, W, C], not Stokes. The JAX
    package's moment integrator runs on the lanes of its path integrator at
    depth 2, which test_radiance_matches_jax keeps (one compile less)."""
    _variant("rgb")
    d = mt.materials_scene(W, SPP, integrator)
    if integrator["type"] == "moment":
        from mitsuba_tpu.integrators.aov import MomentIntegrator

        key = ("materials", "rgb", 2)
        if key not in _JAX_LANES:
            _lanes(_scene_dict(*key[::2]), key)
        L_path, aux = _JAX_LANES[key]

        class PathLanes:
            def sample(self, *args):
                return jnp.asarray(L_path), aux

        _JAX_LANES["moment"] = (np.asarray(
            MomentIntegrator(nested=PathLanes()).sample(None, None, None, None, None)[0]), aux)
        Lj, _, Lt, _, js, ts = _lanes(d, "moment")
    else:
        Lj, _, Lt, _, js, ts = _lanes(d)
    atol = 2e-6 if integrator["type"] in ("depth", "aov") else 1e-5
    np.testing.assert_allclose(Lt, Lj, rtol=1e-5, atol=atol)
    assert Lt.mean() > 0
    img = mt.render(ts, spp=SPP, seed=0)
    np.testing.assert_allclose(img.numpy(), np.asarray(jfilm.develop(js.film, jnp.asarray(Lj),
                                                                     SPP)),
                               rtol=1e-5, atol=atol)
    if integrator["type"] == "aov":
        assert (Lt < 0).any() and bool((img < 0).any())
        assert type(ts.integrator).signed_output
    if integrator["type"] in ("depth", "aov"):
        _variant("rgb_polarized")
        pol = mt.render(mt.load_dict(d, device="cpu"), spp=SPP, seed=0)
        assert pol.shape == (W, W, 3)
        torch.testing.assert_close(pol, img, rtol=0, atol=0)


@pytest.fixture(scope="module")
def jax_grads():
    """case -> (dict, keys, the JAX package's loss and its gradients) at
    16x16 @ 4 spp, seed 0, max_depth PRB_DEPTH: jax.jit(jax.value_and_grad)
    once per case for the module. "materials": prb in rgb, the image mean,
    for the rough conductor's alpha and the blend's weight; "polarimeter":
    prb (so prb_polarized) in rgb_polarized, the sum of I, for the
    polarized plastic's diffuse reflectance and the polarizer's theta (a
    Dirac lobe: no attached term, its gradient 0)."""
    cache = {}

    def get(case):
        if case not in cache:
            integ = {"type": "prb", "max_depth": PRB_DEPTH}
            if case == "materials":
                _variant("rgb")
                d = mt.materials_scene(W, SPP, integ)
                keys = ("large-box.bsdf.alpha", "floor.bsdf.weight.value")
            else:
                _variant("rgb_polarized")
                d = mt.polarimeter_scene(W, SPP, integ)
                keys = ("back.bsdf.diffuse_reflectance.value", "polarizer-sheet.bsdf.theta")
            js = mj.load_dict(d)

            def loss(vals):
                img = mj.render(mj.traverse(js).update(dict(zip(keys, vals))), spp=SPP, seed=0)
                return jnp.mean(img) if case == "materials" else jnp.sum(img[:, :, 0, :])

            p = mj.traverse(js)
            val, g = jax.jit(jax.value_and_grad(loss))(tuple(p[k] for k in keys))
            cache[case] = (d, keys, float(val), [np.asarray(x) for x in g])
        return cache[case]

    return get


@pytest.mark.parametrize("case,variant", [("materials", "rgb"),
                                          ("polarimeter", "rgb_polarized")])
def test_prb_gradients_match_jax(jax_grads, case, variant):
    """The PRB step through the new BSDFs' attached evaluations: the loss
    within 1e-5 and each gradient within GRAD_RTOL of the JAX package's,
    every gradient finite; the polarizer's theta, a Dirac lobe's parameter,
    gets 0 in both (Scene.bsdf_eval_pdf skips BSDFs without smooth flags);
    the PRB image is the forward integrator's (volpath in the polarized
    variant) bitwise."""
    d, keys, want_loss, want = jax_grads(case)
    _variant(variant)
    ts = mt.load_dict(d, device="cpu")
    params = mt.traverse(ts)
    leaves = {k: params[k].clone().requires_grad_() for k in keys}
    img = mt.render(params.update(leaves), spp=SPP, seed=0)
    loss = img.mean() if case == "materials" else img[:, :, 0, :].sum()
    loss.backward()
    assert loss.item() == pytest.approx(want_loss, rel=1e-5)
    for k, g in zip(keys, want):
        got = leaves[k].grad.numpy()
        assert np.isfinite(got).all(), k
        print(k, got, g)
        if k.endswith("theta"):
            assert float(g) == 0.0 and float(got) == 0.0
            continue
        assert np.all(g != 0), k
        np.testing.assert_allclose(got, g, rtol=GRAD_RTOL, err_msg=k)
    fwd = dict(d, integrator={"type": "path", "max_depth": PRB_DEPTH})
    assert torch.equal(mt.render(mt.load_dict(fwd, device="cpu"), spp=SPP, seed=0),
                       img.detach())


def test_reference_errors_and_refusals():
    """The reference's errors, in both packages: stokes outside a polarized
    variant (when it renders), a blendbsdf without two nested BSDFs, a
    wrapper without one (ValueError); the port's refusals of the BSDFs it
    does not port yet (NotImplementedError naming the type)."""
    _variant("rgb")
    d = mt.materials_scene(4, 1, {"type": "stokes"})
    for pkg, kw in ((mt, {"device": "cpu"}), (mj, {})):
        with pytest.raises(ValueError, match="polarized"):
            pkg.render(pkg.load_dict(d, **kw), spp=1)
    bad = [{"type": "blendbsdf", "weight": 0.5, "a": {"type": "diffuse"}},
           {"type": "twosided"}, {"type": "mask", "opacity": 0.5}]
    for spec in bad:
        d = mt.materials_scene(4, 1)
        d["back"]["bsdf"] = spec
        for pkg, kw in ((mt, {"device": "cpu"}), (mj, {})):
            with pytest.raises(ValueError):
                pkg.load_dict(d, **kw)
    for t in ("normalmap", "bumpmap", "plastic", "principled", "principledthin", "measured",
              "measured_polarized", "hair"):
        d = mt.materials_scene(4, 1)
        d["back"]["bsdf"] = {"type": t, "bsdf": {"type": "diffuse"}}
        with pytest.raises(NotImplementedError, match=t):
            mt.load_dict(d, device="cpu")
        d = mt.materials_scene(4, 1)
        d["named"] = {"type": t}
        with pytest.raises(NotImplementedError, match=t):
            mt.load_dict(d, device="cpu")
