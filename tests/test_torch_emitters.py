"""The port's emitters of the material-preview slice against the JAX
package on the CPU: the sphere light, the spot, the projector (a bitmap
texture), the envmap, the fused area lights (AreaEmitterArray) and the
collimated panel (DirectionalAreaEmitter); the emitter dispatch of the
scene (the uniform and the power selection, the environment's pdf and
radiance, a hit's pdf and radiance); the loader's fusion rules and
traverse keys; the checkerboard and bitmap textures.

Inputs are made from numpy seeds; the JAX side goes through jax.jit with
the scene closed over. Each emitter's sample_direction (the sample's
point, direction, distance, pdf and uv, and its weight) is held at rtol
1e-5 (atol 1e-6 times the field's largest magnitude, at least 1: the last
place of sqrt, sin and cos, and XLA's fused multiply-adds, on points as
far as the envmap's 2 scene radii), as are the pdfs and radiances. The sphere light's cone is
held at rtol 2e-4 / atol 1e-4 (SPHERE_TOL): its solid angle 2 pi (1 -
cos_max) cancels, for a small sphere, all but the last few bits of
cos_max = sqrt(1 - sin^2), and PyTorch's sqrt on the CPU is not correctly
rounded on ~0.7% of inputs (XLA's is), so a 1-ulp difference there moves
the pdf by up to ~5e-5 relative; every other step of the cone agrees. Its
uv (arccos and atan2 of the sample point's normal) is held at atol 5e-4:
near the poles arccos multiplies the point's error. The spot's weight is
held at atol 2e-5 (SPOT_TOL; its weights are ~1): its falloff (cos_a -
cos_cutoff) / (cos_beam - cos_cutoff) cancels near the cutoff, where a
1-ulp difference of cos_a moves the weight by ~1e-5 absolute.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mitsuba_tpu as mj
from mitsuba_tpu.render.records import Ray as JRay

import mitsuba_tpu_torch as mt
from mitsuba_tpu_torch.render import emitters as TE
from mitsuba_tpu_torch.render import textures as TX
from mitsuba_tpu_torch.render.records import Ray as TRay

TOL = dict(rtol=1e-5, atol=1e-6)
SPHERE_TOL = dict(rtol=2e-4, atol=5e-4)
SPOT_TOL = dict(rtol=1e-5, atol=2e-5)
N = 512


@pytest.fixture(autouse=True)
def _rgb():
    mj.set_variant("rgb")
    mt.set_variant("rgb")
    yield


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (ROADMAP Queue 3: MKL's first vector-math call
    from two threads can take its low-accuracy kernel on one chunk)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scenes(name):
    d = {"spheres": lambda: mt.spheres_scene(8, 4),
         "manylights": lambda: mt.manylights_scene(8, 4, beam=True),
         "projector": lambda: mt.projector_scene(8, 4)}[name]()
    return mj.load_dict(d), mt.load_dict(d, device="cpu")


def _inputs(seed, lo, hi):
    rng = np.random.default_rng(seed)
    ref_p = (lo + (hi - lo) * rng.random((N, 3))).astype(np.float32)
    u = rng.random((N, 3)).astype(np.float32)
    return ref_p, u


def _close(got, want, what, tol=TOL):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got.detach().numpy(), want, err_msg=what, rtol=tol["rtol"],
                               atol=tol["atol"] * scale)


EMITTER_TYPES = {"spheres": ("SphereAreaEmitter", "SpotEmitter", "EnvmapEmitter"),
                 "manylights": ("DirectionalAreaEmitter", "AreaEmitterArray"),
                 "projector": ("AreaEmitter", "ProjectorEmitter")}


@pytest.mark.parametrize("scene", ["spheres", "manylights", "projector"])
def test_sample_direction_per_emitter(scene):
    js, ts = _scenes(scene)
    assert tuple(type(e).__name__ for e in ts.emitters) == EMITTER_TYPES[scene]
    assert tuple(type(e).__name__ for e in js.emitters) == EMITTER_TYPES[scene]
    ref_p, u = _inputs(1, np.array([-0.9, -0.9, -0.9]), np.array([0.9, 0.9, 0.9]))
    for i, (ej, et) in enumerate(zip(js.emitters, ts.emitters)):
        ds_j, w_j = jax.jit(lambda rp, uu: ej.sample_direction(rp, uu, js.geometry, None, 3, i))(
            ref_p, u[:, :2])
        ds_t, w_t = et.sample_direction(torch.from_numpy(ref_p), torch.from_numpy(u[:, :2]),
                                        ts.geometry, i, 3)
        name = type(et).__name__
        tol = {"SphereAreaEmitter": SPHERE_TOL, "SpotEmitter": SPOT_TOL}.get(name, TOL)
        for f in ("p", "d", "dist", "pdf", "uv"):
            _close(getattr(ds_t, f), getattr(ds_j, f), f"{name}.{f}", tol)
        _close(w_t, w_j, f"{name} weight", tol)
        assert bool((ds_t.delta == et.is_delta).all())
        if name != "DirectionalAreaEmitter":
            assert float(w_t.abs().sum()) > 0, name


@pytest.mark.parametrize("scene,sampler", [("spheres", "uniform"), ("spheres", "power"),
                                           ("manylights", "uniform"), ("projector", "power")])
def test_scene_emitter_dispatch(scene, sampler):
    """Scene-level NEE (the selection, the visibility test), then the pdf
    and radiance of what the sampled directions hit or escape to."""
    d = {"spheres": lambda: mt.spheres_scene(8, 4),
         "manylights": lambda: mt.manylights_scene(8, 4, beam=True),
         "projector": lambda: mt.projector_scene(8, 4)}[scene]()
    d["emitter_sampler"] = sampler
    js, ts = mj.load_dict(d), mt.load_dict(d, device="cpu")
    if sampler == "power":
        np.testing.assert_allclose(ts.emitter_pmf.numpy(), np.asarray(js.emitter_pmf), rtol=1e-6)
    ref_p, u = _inputs(2, np.array([-0.9, -0.9, -0.9]), np.array([0.9, 0.9, 0.9]))
    act = np.ones(N, bool)

    def jax_side(rp, uu, a):
        ds, w = js.sample_emitter_direction(rp, uu[:, 0], uu[:, 1:], None, a)
        ray = JRay.make(rp, ds.d)
        si = js.ray_intersect(ray, a)
        return (ds, w, si.is_valid, js.pdf_emitter_direction_hit(rp, si),
                js.eval_emitter_hit(si, None), js.pdf_emitter_direction_escaped(ds.d),
                js.eval_environment(ds.d, None))

    out_j = jax.jit(jax_side)(ref_p, u, act)
    rp, ut, at = torch.from_numpy(ref_p), torch.from_numpy(u), torch.from_numpy(act)
    ds, w = ts.sample_emitter_direction(rp, ut[:, 0], ut[:, 1:], at)
    si = ts.ray_intersect(TRay.make(rp, ds.d), at)
    out_t = (ds, w, si.is_valid, ts.pdf_emitter_direction_hit(rp, si), ts.eval_emitter_hit(si),
             ts.pdf_emitter_direction_escaped(ds.d), ts.eval_environment(ds.d))
    tol = SPHERE_TOL if scene == "spheres" else TOL
    for f in ("p", "d", "dist", "pdf", "uv", "emitter_index"):
        _close(getattr(out_t[0], f), getattr(out_j[0], f), f"ds.{f}", tol)
    names = ("weight", "hit", "pdf_hit", "eval_hit", "pdf_escaped", "eval_env")
    for name, a, b in zip(names, out_t[1:], out_j[1:]):
        _close(a.to(torch.float32), np.asarray(b, np.float32), name, tol)
    assert float(out_t[1].abs().sum()) > 0


def test_envmap_column_search_is_the_count_below():
    """The envmap's column index (a fixed-depth binary search, no [N, W]
    comparison) equals the JAX package's count of cdf entries below u,
    ties and empty texels included."""
    rng = np.random.default_rng(3)
    w = rng.random((6, 37)).astype(np.float32)
    w[:, 5:9] = 0.0                                 # runs of equal cdf entries
    cdf = np.cumsum(w, axis=1).astype(np.float32)
    rows = rng.integers(0, 6, 4096)
    x = (rng.random(4096) * cdf[rows, -1]).astype(np.float32)
    x[:64] = cdf[rows[:64], rng.integers(0, 37, 64)]  # exact entries
    want = (cdf[rows] < x[:, None]).sum(-1)
    got = TE._lower_bound_rows(torch.from_numpy(cdf), torch.from_numpy(rows), torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


def test_fusion_rules_and_traverse_keys():
    """Fusion as the JAX package's loader fuses: more than four constant
    area lights, or forced either way; every traverse key letter for
    letter, and the remapped radiance keys reach their row."""
    for d in (mt.spheres_scene(8, 4), mt.manylights_scene(8, 4, beam=True),
              mt.projector_scene(8, 4)):
        js, ts = mj.load_dict(d), mt.load_dict(d, device="cpu")
        assert list(mt.traverse(ts).keys()) == list(mj.traverse(js).keys())
    d = mt.manylights_scene(8, 4)
    for fuse, want in ((None, 1), (False, 8), (True, 1)):
        d["fuse_area_lights"] = fuse
        assert len(mt.load_dict(d, device="cpu").emitters) == want
        assert len(mj.load_dict(d).emitters) == want
    d = mt.cornell_box()
    d["fuse_area_lights"] = True          # a single light is never fused
    assert type(mt.load_dict(d, device="cpu").emitters[0]).__name__ == "AreaEmitter"
    ts = mt.load_dict(mt.manylights_scene(8, 4), device="cpu")
    p = mt.traverse(ts)
    s = p.update({"light-3.emitter.radiance.value": [1.0, 2.0, 3.0]})
    np.testing.assert_array_equal(s.emitters[0].values[3].numpy(), [1.0, 2.0, 3.0])
    assert p["light-4.emitter.radiance.value"].shape == (1, 3)
    for key in ("sky.data", "spot.intensity.value", "diffuse-ball.center",
                "diffuse-ball.radius", "bulb.emitter.radiance.value",
                "floor.bsdf.reflectance.color0"):
        assert key in mt.traverse(mt.load_dict(mt.spheres_scene(8, 4), device="cpu"))
    assert "projector.irradiance.data" in mt.traverse(
        mt.load_dict(mt.projector_scene(8, 4), device="cpu"))


def test_textures_match_jax():
    """The checkerboard (with to_uv) and the bilinear bitmap, in rgb, mono
    and the spectral variant (the rgb2spec model at the lanes'
    wavelengths), against the JAX package op by op (its compiled rgb2spec
    fetch rounds some rows differently: tests/test_torch_spectral.py)."""
    from mitsuba_tpu.render.scene_loader import parse_texture as j_parse
    from mitsuba_tpu_torch.render.scene_loader import parse_texture as t_parse

    rng = np.random.default_rng(4)
    uv = (rng.random((N, 2)) * 1.4 - 0.2).astype(np.float32)
    wl = (360 + 470 * rng.random((N, 4))).astype(np.float32)
    specs = [{"type": "checkerboard", "color0": {"type": "rgb", "value": [0.9, 0.2, 0.1]},
              "color1": 0.3, "to_uv": {"type": "scale", "value": [5.0, 3.0, 1.0]}},
             {"type": "bitmap", "data": rng.random((7, 5, 3)).astype(np.float32)},
             rng.random((6, 9)).astype(np.float32)]
    for variant, nc, wls in (("rgb", 3, None), ("mono", 1, None), ("spectral", 4, wl)):
        mj.set_variant(variant)
        mt.set_variant(variant)
        for spec in specs:
            tj, leaf_j = j_parse(spec)
            tt, leaf_t = t_parse(spec, "cpu")
            assert leaf_t == leaf_j
            assert type(tt) in (TX.CheckerboardTexture, TX.BitmapTexture)
            with jax.disable_jit():
                want = tj.eval(jnp.asarray(uv), None if wls is None else jnp.asarray(wls), nc)
            got = tt.eval(torch.from_numpy(uv), nc, None if wls is None else torch.from_numpy(wls))
            _close(got, want, f"{variant} {type(tt).__name__}")
