"""The port's volumetric forward path (volpath over homogeneous and grid
media, the null BSDF and the constant environment) held against the JAX
package on the CPU: module by module, then the whole slice.

Both packages load the same scene dicts, made from numpy seeds. Module
parity is held at rtol 1e-6 (atol 1e-6 where a value can be near 0: XLA
and torch may differ in the last place of log, exp, sin, cos and sqrt, and
XLA on the CPU contracts a*b + c into FMAs). The slice is held per lane:
a real-versus-null collision or a Russian-roulette decision can flip on
one ulp and send a path elsewhere, so at least 99% of the lanes must agree
to rtol 1e-4 / atol 1e-5, and the shallowest scene's image as a whole.
Each JAX render is compiled once per module (module fixtures).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import mitsuba_tpu as mj
from mitsuba_tpu.render import phase as JPH
from mitsuba_tpu.render import shapes as JSH
from mitsuba_tpu.render import volumes as JVOL
from mitsuba_tpu.render.records import MediumInteraction as JMI
from mitsuba_tpu.render.records import Ray as JRay
from mitsuba_tpu.render_api import _render_pass as j_render_pass

import mitsuba_tpu_torch as mt
from mitsuba_tpu_torch.render import phase as TPH
from mitsuba_tpu_torch.render import shapes as TSH
from mitsuba_tpu_torch.render import volumes as TVOL
from mitsuba_tpu_torch.render.records import MediumInteraction as TMI
from mitsuba_tpu_torch.render.records import Ray as TRay
from mitsuba_tpu_torch.render.scene_loader import het_vol_scene as het_vol_dict
from mitsuba_tpu_torch.render.spectrum_ops import get_ops
from mitsuba_tpu_torch.render_api import render_lanes as t_render_lanes

W, SPP, STEPS = 16, 4, 8


@pytest.fixture(autouse=True)
def _rgb():
    mj.set_variant("rgb")
    yield


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: MKL's first vector-math call from two threads
    can run its low-accuracy kernel on one chunk (ROADMAP Queue 3)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(t, j, rtol=1e-6, atol=0.0):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol)


def _sensor(fov, origin, res):
    return {
        "type": "perspective", "fov": fov,
        "to_world": [{"type": "look_at", "origin": origin, "target": [0, 0, 0], "up": [0, 1, 0]}],
        "film": {"type": "hdrfilm", "width": res, "height": res, "rfilter": {"type": "box"}},
        "sampler": {"type": "independent", "sample_count": SPP},
    }


def medium_cube_scene(medium, max_depth=4, fov=10):
    """tests/test_volpath.py's scene: a null-BSDF unit cube holding a named
    medium under a constant environment, at W x W, STEPS tracking steps."""
    return {
        "type": "scene",
        "integrator": {"type": "volpath", "max_depth": max_depth, "rr_depth": 64,
                       "track_steps": STEPS, "nee_steps": STEPS},
        "sensor": _sensor(fov, [0, 0, 6], W),
        "medium1": medium,
        "bounds": {"type": "cube", "bsdf": {"type": "null"},
                   "interior": {"type": "ref", "id": "medium1"}},
        "env": {"type": "constant", "radiance": 1.0},
    }


def het_grid(seed, n):
    return (0.3 + 2.2 * np.random.default_rng(seed).random((n, n, n, 1))).astype(np.float32)


def het_vol_scene():
    """bench.py's heterogeneous-grid scene (BASELINE config 3) at W x W,
    max_depth 4, STEPS tracking steps (the port's copy of the dict)."""
    return het_vol_dict(res=W, spp=SPP, max_depth=4, steps=STEPS)


SCENES = {
    # the shallowest: held as an image too
    "absorb": lambda: medium_cube_scene(
        {"type": "homogeneous", "sigma_t": 0.8, "albedo": 0.0, "phase": {"type": "isotropic"}},
        max_depth=2, fov=3),
    "furnace-hg": lambda: medium_cube_scene(
        {"type": "homogeneous", "sigma_t": 1.0, "albedo": 1.0, "phase": {"type": "hg", "g": 0.7}}),
    "furnace-grid": lambda: medium_cube_scene({
        "type": "heterogeneous",
        "sigma_t": {"type": "gridvolume", "data": het_grid(0, 8) * (1.5 / 2.5),
                    "bbox_min": [-1, -1, -1], "bbox_max": [1, 1, 1]},
        "albedo": 1.0, "phase": {"type": "isotropic"}}),
    "het-vol": het_vol_scene,
}


def _jax_lanes(js, seed=0):
    L, _, _, aux = j_render_pass(js, jnp.uint32(seed), 0, SPP, SPP, 0)
    return np.asarray(L), int(float(aux["n_rays"]))


@pytest.fixture(scope="module")
def jax_renders():
    """(JAX scene, per-lane radiance, n_rays) of each scene, made once."""
    out = {}
    for name, make in SCENES.items():
        js = mj.load_dict(make())
        out[name] = (js, *_jax_lanes(js))
    return out


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def test_grid_volume_eval_matches_jax():
    r = np.random.default_rng(1)
    data = r.random((5, 6, 7, 3)).astype(np.float32)
    bmin, bmax = np.array([-1.0, -0.5, -2.0], np.float32), np.array([1.0, 1.5, 0.5], np.float32)
    # points inside the box, on its faces and outside it
    p = (bmin - 0.3 + (bmax - bmin + 0.6) * r.random((4096, 3))).astype(np.float32)
    p[:64] = np.where(r.random((64, 3)) < 0.5, bmin, bmax)
    jv = JVOL.GridVolume(data=jnp.asarray(data), bbox_min=jnp.asarray(bmin), bbox_max=jnp.asarray(bmax))
    tv = TVOL.GridVolume(data=torch.from_numpy(data), bbox_min=torch.from_numpy(bmin),
                         bbox_max=torch.from_numpy(bmax))
    for nc in (3, 1):
        _close(tv.eval(torch.from_numpy(p), nc), jv.eval(jnp.asarray(p), nc), atol=1e-6)
    one = data[..., :1]
    tv1 = TVOL.GridVolume(torch.from_numpy(one), tv.bbox_min, tv.bbox_max)
    jv1 = JVOL.GridVolume(jnp.asarray(one), jv.bbox_min, jv.bbox_max)
    _close(tv1.eval(torch.from_numpy(p), 3), jv1.eval(jnp.asarray(p), 3), atol=1e-6)
    assert float(tv.max()) == float(jv.max())


def test_vol_file_and_volume_specs(tmp_path):
    """load_vol_file reads the reference's .vol layout; the volume specs
    parse to the same values in both packages."""
    data = np.random.default_rng(2).random((3, 4, 5, 1)).astype(np.float32)
    fn = tmp_path / "g.vol"
    with open(fn, "wb") as f:
        f.write(b"VOL" + bytes([3]) + np.int32(1).tobytes()
                + np.asarray([5, 4, 3, 1], np.int32).tobytes()
                + np.zeros(6, np.float32).tobytes() + data.tobytes())
    np.testing.assert_array_equal(TVOL.load_vol_file(fn), JVOL.load_vol_file(fn))
    specs = [0.5, [0.1, 0.2, 0.3], {"type": "constvolume", "value": 2.0},
             {"type": "rgb", "value": [0.4, 0.5, 0.6]},
             {"type": "gridvolume", "filename": str(fn),
              "to_world": [{"type": "scale", "value": 2.0}]}]
    p = np.random.default_rng(3).random((64, 3)).astype(np.float32) * 2.0
    for spec in specs:
        tvol, tleaf = TVOL.parse_volume(spec, "cpu")
        jvol, jleaf = JVOL.parse_volume(spec, 3)
        assert tleaf == jleaf
        _close(tvol.eval(torch.from_numpy(p), 3), jvol.eval(jnp.asarray(p), 3), atol=1e-6)
    with pytest.raises(NotImplementedError):
        TVOL.parse_volume({"type": "bitmapvolume"}, "cpu")


def _mei(n, seed):
    r = np.random.default_rng(seed)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    p = r.random((n, 3)).astype(np.float32)
    t = np.ones(n, np.float32)
    jm = JMI.make(jnp.asarray(t), jnp.asarray(p), jnp.asarray(d), jnp.zeros(n, jnp.int32))
    tm = TMI.make(torch.from_numpy(t), torch.from_numpy(p), torch.from_numpy(d),
                  torch.zeros(n, dtype=torch.int64))
    u = r.random((n, 3)).astype(np.float32)
    return jm, tm, u


@pytest.mark.parametrize("kind", ["isotropic", "hg", "hg-tiny-g", "sggx"])
def test_phase_sample_and_eval_match_jax(kind):
    n = 4096
    jm, tm, u = _mei(n, 4)
    _close(tm.sh_s, jm.sh_s, atol=1e-6)
    _close(tm.sh_t, jm.sh_t, atol=1e-6)
    if kind == "isotropic":
        jp, tp = JPH.IsotropicPhase(), TPH.IsotropicPhase()
    elif kind.startswith("hg"):
        g = 0.6 if kind == "hg" else 5e-4
        jp, tp = JPH.HGPhase(g=jnp.float32(g)), TPH.HGPhase(g=torch.tensor(g))
    else:
        s6 = [1.0, 0.5, 0.2, 0.1, 0.05, -0.02]
        jp = JPH.SGGXPhase(S=JVOL.ConstVolume(value=jnp.asarray(s6, jnp.float32)))
        tp = TPH.SGGXPhase(S=TVOL.ConstVolume(value=torch.tensor(s6)))
    jwo, jw, jpdf = jp.sample(jm, jnp.asarray(u[:, 0]), jnp.asarray(u[:, 1:]), None, 3)
    two, tw, tpdf = tp.sample(tm, torch.from_numpy(u[:, 0]), torch.from_numpy(u[:, 1:]), 3)
    _close(two, jwo, rtol=1e-5, atol=1e-5)
    _close(tw, jw)
    _close(tpdf, jpdf, rtol=1e-4, atol=1e-6)
    # eval_pdf at the JAX sample's directions
    jv, jpd = jp.eval_pdf(jm, jwo, None, 3)
    tv, tpd = tp.eval_pdf(tm, torch.from_numpy(np.array(jwo)), 3)
    _close(tv, jv, rtol=1e-4, atol=1e-6)
    _close(tpd, jpd, rtol=1e-4, atol=1e-6)
    if kind == "sggx":
        _close(TPH.sggx_projected_area(tm.sh_n, torch.tensor(s6).expand(n, 6)),
               JPH.sggx_projected_area(jm.sh_n, jnp.broadcast_to(jnp.asarray(s6), (n, 6))))


def _two_media_dict():
    """Both medium types and the SGGX phase in one scene: a heterogeneous
    cube inside a homogeneous one whose phase is SGGX."""
    d = medium_cube_scene({"type": "homogeneous", "sigma_t": [0.5, 1.0, 1.5],
                           "albedo": [0.9, 0.8, 0.7], "scale": 2.0,
                           "phase": {"type": "sggx", "S": [1.0, 0.6, 0.3, 0.1, 0.0, 0.05]}})
    d["inner"] = {"type": "cube", "to_world": [{"type": "scale", "value": 0.5}],
                  "bsdf": {"type": "null"},
                  "interior": {"type": "heterogeneous",
                               "sigma_t": {"type": "gridvolume", "data": het_grid(5, 6),
                                           "bbox_min": [-0.5] * 3, "bbox_max": [0.5] * 3},
                               "albedo": {"type": "constvolume", "value": 0.6},
                               "phase": {"type": "hg", "g": -0.3}},
                  "exterior": {"type": "ref", "id": "medium1"}}
    return d


def test_loaded_media_tables_match_jax():
    d = _two_media_dict()
    js, ts = mj.load_dict(d), mt.load_dict(d, device="cpu")
    for k in ("shape_interior_medium", "shape_exterior_medium", "shape_bsdf", "shape_emitter"):
        np.testing.assert_array_equal(getattr(ts, k).numpy(), np.asarray(getattr(js, k)))
    _close(ts.bbox_min, js.bbox_min)
    _close(ts.bbox_max, js.bbox_max)
    _close(ts.bbox_radius, js.bbox_radius)
    assert ts.env_emitter == js.env_emitter and ts.camera_medium == js.camera_medium == -1
    assert [type(m).__name__ for m in ts.media] == [type(m).__name__ for m in js.media]
    assert [type(p).__name__ for p in ts.phases] == [type(p).__name__ for p in js.phases]
    assert [m.phase_index for m in ts.media] == [m.phase_index for m in js.media]
    _close(ts.emitters[ts.env_emitter].scene_radius, js.emitters[js.env_emitter].scene_radius)
    jp, tp = mj.traverse(js), mt.traverse(ts)
    assert set(jp.keys()) == set(tp.keys())
    for k in tp.keys():
        _close(tp[k], jp[k])
    assert [type(b).__name__ for b in ts.bsdfs] == [type(b).__name__ for b in js.bsdfs]


def test_media_majorants_and_coefficients_match_jax():
    d = _two_media_dict()
    js, ts = mj.load_dict(d), mt.load_dict(d, device="cpu")
    r = np.random.default_rng(6)
    n = 4096
    p = (r.random((n, 3)) * 2.4 - 1.2).astype(np.float32)
    dirs = r.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    med = r.integers(-1, 2, n)
    jargs = (jnp.asarray(med, jnp.int32), jnp.asarray(p))
    targs = (torch.from_numpy(med), torch.from_numpy(p))
    _close(ts.medium_majorant(*targs), js.medium_majorant(*jargs))
    _close(ts.medium_majorant_spectrum(*targs), js.medium_majorant_spectrum(*jargs))
    for with_d in (False, True):
        jd = jnp.asarray(dirs) if with_d else None
        td = torch.from_numpy(dirs) if with_d else None
        for tc, jc in zip(ts.medium_coefficients(*targs, td), js.medium_coefficients(*jargs, jd)):
            _close(tc, jc, atol=1e-6)
    np.testing.assert_array_equal(ts.medium_phase_of(targs[0]).numpy(),
                                  np.asarray(js.medium_phase_of(jargs[0])))


def test_aabb_and_transmittance_pdf_match_jax():
    from mitsuba_tpu.render import media as JMED
    from mitsuba_tpu_torch.render import media as TMED

    r = np.random.default_rng(9)
    n = 2048
    o = (r.random((n, 3)) * 6 - 3).astype(np.float32)
    dirs = r.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs[:16, 0] = 0.0          # axis-parallel rays: the slab test's 1e-12 guard
    bmin, bmax = np.array([-1, -0.5, -2], np.float32), np.array([1, 1.5, 0.5], np.float32)
    jr = JRay(o=jnp.asarray(o), d=jnp.asarray(dirs), maxt=jnp.full(n, jnp.inf))
    tr = TRay.make(torch.from_numpy(o), torch.from_numpy(dirs))
    jt = JMED.intersect_aabb(jr, jnp.asarray(bmin), jnp.asarray(bmax))
    tt = TMED.intersect_aabb(tr, torch.from_numpy(bmin), torch.from_numpy(bmax))
    _close(tt[0], jt[0], atol=1e-6)
    _close(tt[1], jt[1], atol=1e-6)
    np.testing.assert_array_equal(tt[2].numpy(), np.asarray(jt[2]))
    mi_t, si_t = r.random(n).astype(np.float32) * 3, r.random(n).astype(np.float32) * 3
    mint, ext = np.float32(0.25), r.random((n, 3)).astype(np.float32) * 2
    for tc, jc in zip(TMED.transmittance_eval_pdf(*map(torch.from_numpy, (mi_t, si_t)),
                                                  torch.tensor(mint), torch.from_numpy(ext)),
                      JMED.transmittance_eval_pdf(*map(jnp.asarray, (mi_t, si_t, mint, ext)))):
        _close(tc, jc, atol=1e-6)


def test_constant_emitter_sample_direction_matches_jax():
    d = _two_media_dict()
    js, ts = mj.load_dict(d), mt.load_dict(d, device="cpu")
    r = np.random.default_rng(7)
    ref_p = (r.random((2048, 3)) * 2 - 1).astype(np.float32)
    u = r.random((2048, 2)).astype(np.float32)
    i = ts.env_emitter
    jds, jw = js.emitters[i].sample_direction(jnp.asarray(ref_p), jnp.asarray(u), js.geometry,
                                               None, 3, i)
    tds, tw = ts.emitters[i].sample_direction(torch.from_numpy(ref_p), torch.from_numpy(u),
                                              ts.geometry, i, 3)
    for k in ("p", "n", "d", "dist", "pdf"):
        _close(getattr(tds, k), getattr(jds, k), atol=1e-6)
    _close(tw, jw)
    np.testing.assert_array_equal(tds.emitter_index.numpy(), np.asarray(jds.emitter_index))
    dd = torch.from_numpy(ref_p / np.linalg.norm(ref_p, axis=-1, keepdims=True))
    _close(ts.eval_environment(dd), js.eval_environment(jnp.asarray(dd.numpy()), None))
    _close(ts.pdf_emitter_direction_escaped(dd),
           js.pdf_emitter_direction_escaped(jnp.asarray(dd.numpy())))


def test_medium_transition_matches_jax():
    """Rays from inside and outside both cubes, in both directions: the
    closest hit's shape and the medium on its other side."""
    d = _two_media_dict()
    js, ts = mj.load_dict(d), mt.load_dict(d, device="cpu")
    r = np.random.default_rng(8)
    n = 2048
    o = (r.random((n, 3)) * 2.4 - 1.2).astype(np.float32)
    dirs = r.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    med = r.integers(-1, 2, n)
    jr = JRay(o=jnp.asarray(o), d=jnp.asarray(dirs), maxt=jnp.full(n, jnp.inf))
    tr = TRay.make(torch.from_numpy(o), torch.from_numpy(dirs))
    jsi = JSH.compute_surface_interaction(js.geometry, jr, JSH.ray_intersect_preliminary(js.geometry, jr))
    tsi = TSH.compute_surface_interaction(ts.geometry, tr, TSH.ray_intersect_preliminary(ts.geometry, tr))
    np.testing.assert_array_equal(tsi.shape_index.numpy(), np.asarray(jsi.shape_index))
    assert (tsi.shape_index.numpy() >= 0).mean() > 0.5
    tm = ts.medium_transition(tsi, torch.from_numpy(dirs), torch.from_numpy(med))
    jm = js.medium_transition(jsi, jnp.asarray(dirs), jnp.asarray(med, jnp.int32))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ts.is_null_bsdf(tsi).numpy(), np.asarray(js.is_null_bsdf(jsi)))


# ---------------------------------------------------------------------------
# the slice: volpath at 16x16 @ 4 spp, max_depth <= 4, 8 tracking steps
# ---------------------------------------------------------------------------

def _lanes_agree(Lt, Lj):
    return np.isclose(Lt, Lj, rtol=1e-4, atol=1e-5).all(axis=-1)


@pytest.mark.parametrize("name", list(SCENES))
def test_volpath_radiance_matches_jax(name, jax_renders):
    js, Lj, rays_j = jax_renders[name]
    ts = mt.load_dict(SCENES[name](), device="cpu")
    n = W * W * SPP
    Lt, aux = t_render_lanes(ts, 0, 0, n, 0, SPP, SPP, 0)
    Lt = Lt.numpy()
    assert np.isfinite(Lt).all() and Lt.mean() > 0
    assert int(aux["n_rays"]) == rays_j
    ok = _lanes_agree(Lt, Lj)
    print(f"{name}: {int((~ok).sum())} of {n} lanes differ")
    assert ok.mean() >= 0.99
    if name == "absorb":
        img_t = mt.render(ts, spp=SPP, seed=0).numpy()
        img_j = Lj.reshape(W, W, SPP, 3).mean(axis=2)
        np.testing.assert_allclose(img_t, img_j, rtol=1e-4, atol=1e-5)
        # the analytic centre: exp(-2 sigma_t) through the unit cube
        assert img_t.mean() == pytest.approx(np.exp(-1.6), rel=0.05)


def test_sigma_t_update_changes_image_as_jax(jax_renders):
    """traverse -> update of the grid's sigma_t re-derives the majorant and
    changes the image as in the JAX package."""
    js, Lj0, _ = jax_renders["het-vol"]
    key = "cloud.interior_medium.sigma_t.data"
    ts = mt.load_dict(het_vol_scene(), device="cpu")
    tp, jp = mt.traverse(ts), mj.traverse(js)
    new = np.asarray(jp[key]) * 0.5
    ts2 = tp.update({key: new})
    js2 = jp.update({key: jnp.asarray(new)})
    _close(ts2.media[0].max_density, js2.media[0].max_density)
    assert float(ts2.media[0].max_density) < float(ts.media[0].max_density)
    Lj, rays_j = _jax_lanes(js2)
    Lt, aux = t_render_lanes(ts2, 0, 0, W * W * SPP, 0, SPP, SPP, 0)
    assert int(aux["n_rays"]) == rays_j
    assert _lanes_agree(Lt.numpy(), Lj).mean() >= 0.99
    # a thinner cloud lets more of the environment through, in both
    assert Lj.mean() > Lj0.mean() and Lt.numpy().mean() > Lj0.mean()
    assert Lt.numpy().mean() == pytest.approx(float(Lj.mean()), rel=1e-3)


def test_volume_scene_refusals():
    d = het_vol_scene()
    d["cloud"]["interior"]["phase"] = {"type": "tabphase", "values": [1.0, 2.0]}
    with pytest.raises(NotImplementedError):
        mt.load_dict(d, device="cpu")
    d = het_vol_scene()
    d["cloud"]["interior"]["type"] = "twostate"
    with pytest.raises(NotImplementedError):
        mt.load_dict(d, device="cpu")
    d = het_vol_scene()
    d["fiber"] = {"type": "linearcurve", "control_points": [[0, 0, 0, 0.1], [0, 1, 0, 0.1]]}
    with pytest.raises(NotImplementedError):
        mt.load_dict(d, device="cpu")
    # the spot light is ported (tests/test_torch_emitters.py)
    d = het_vol_scene()
    d["lamp"] = {"type": "spot", "position": [0, 2, 0]}
    assert type(mt.load_dict(d, device="cpu").emitters[-1]).__name__ == "SpotEmitter"
    assert get_ops(True).polarized
    mt.set_variant("mono_polarized")
    try:
        # polarized regeneration is ported (tests/test_torch_regen_prb.py)
        scene = mt.load_dict(het_vol_dict(res=W, spp=SPP, regenerate=True), device="cpu")
        assert scene.integrator.regenerate and scene.polarized
    finally:
        mt.set_variant("rgb")
