"""The spectral variants of the port held against the JAX package on the
CPU: core/spectrum.py function by function, the hero wavelengths, the
spectral Cornell box (path and prb) at 16x16 @ 4 spp, BASELINE config 4 in
spectral_polarized at a 4x4 film, the specfilm film, the spectra's
traverse keys, the variant names and the reference's errors.

Every JAX value is computed live; the renders and gradients go through
jax.jit with the scene closed over. XLA contracts a*b + c into FMAs on the
CPU and the port does not (ROADMAP Queue 3), so values agree to a few
ulp, not bitwise, except where the port rounds as XLA does: the hero
wavelengths (one rounding of lo + t (hi - lo), as the fused multiply-add),
the monochromatic rgb2spec rows (a correctly rounded square root).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mitsuba_tpu as mj
from mitsuba_tpu.core import spectrum as JS
from mitsuba_tpu.render_api import render_lanes as j_render_lanes

import mitsuba_tpu_torch as mt
from mitsuba_tpu_torch.core import spectrum as TS
from mitsuba_tpu_torch.render_api import make_wavefront as t_make_wavefront
from mitsuba_tpu_torch.render_api import render_lanes as t_render_lanes
from mitsuba_tpu_torch.render.scene_loader import vol32_scene

W, SPP = 16, 4
N = W * W * SPP
GRAD_RTOL = 1e-4     # as tests/test_torch_materials.py holds PRB gradients
LANE_TOL = dict(rtol=1e-4, atol=1e-5)   # tests/test_torch_render.py's cbox bound


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


def _inputs(n=4096, seed=0):
    """Seeded rgb triples (the first 16 grey, one black, one white) and
    wavelengths over [360, 830] nm."""
    r = np.random.default_rng(seed)
    rgb = r.random((n, 3)).astype(np.float32)
    rgb[:16] = rgb[:16, :1]
    rgb[16], rgb[17] = 0.0, 1.0
    wl = (360.0 + 470.0 * r.random((n, 4))).astype(np.float32)
    return rgb, wl


def cbox(integrator, w=W, max_depth=4):
    d = mt.cornell_box()
    d["sensor"]["film"]["width"] = d["sensor"]["film"]["height"] = w
    d["integrator"] = {"type": integrator, "max_depth": max_depth}
    return d


@pytest.fixture(scope="module")
def jax_cbox_lanes():
    """(L [N, 4], wavelengths, wl_pdf, aux) of one pass of the JAX
    package's spectral cbox (path max_depth 4, 16x16 @ 4 spp, seed 0), its
    render_lanes compiled with the scene closed over, shared by the tests
    of this file."""
    mj.set_variant("spectral")
    try:
        js = mj.load_dict(cbox("path"))
        out = jax.jit(lambda s: j_render_lanes(js, s, 0, N, 0, SPP, SPP, 0))(jnp.uint32(0))
        return tuple(np.asarray(x) for x in out[:3]) + (out[3],)
    finally:
        mj.set_variant("rgb")


# ---------------------------------------------------------------------------
# core/spectrum.py
# ---------------------------------------------------------------------------

def test_rgb2spec_matches_jax():
    """The rgb2spec coefficients within 1e-5 relative (the monochromatic
    rows, with their +-inf, exactly) and the model's values within 1e-6 of
    the JAX package's, on 4,096 seeded rgb triples and wavelengths."""
    rgb, wl = _inputs()
    # op by op: the compiled fetch rounds some rows differently
    cj = np.asarray(JS.srgb_to_spectral_coeff(jnp.asarray(rgb)))
    ct = TS.srgb_to_spectral_coeff(torch.from_numpy(rgb)).numpy()
    np.testing.assert_array_equal(ct[:18], cj[:18])
    assert np.isinf(cj[16:18, 2]).all()
    np.testing.assert_allclose(ct[18:], cj[18:], rtol=1e-5, atol=1e-9)
    vj = np.asarray(JS.rgb_reflectance_eval(jnp.asarray(rgb)[:, None, :], jnp.asarray(wl)))
    vt = TS.rgb_reflectance_eval(torch.from_numpy(rgb)[:, None, :], torch.from_numpy(wl))
    np.testing.assert_allclose(vt.numpy(), vj, rtol=0.0, atol=1e-6)
    assert ((vt >= 0) & (vt <= 1)).all()


def test_spectra_match_jax():
    """CIE 1931, D65, the blackbody, rgb_emission_eval and spectrum_to_xyz
    within 1e-6 relative (atol 1e-6 on the emission, whose model factor is
    held to 1e-6 absolute) of the JAX package's."""
    rgb, wl = _inputs(seed=1)
    wt, wj = torch.from_numpy(wl), jnp.asarray(wl)
    tol = dict(rtol=1e-6, atol=0.0)
    np.testing.assert_allclose(TS.cie1931_xyz(wt).numpy(), np.asarray(JS.cie1931_xyz(wj)), **tol)
    np.testing.assert_allclose(TS.cie1931_y(wt).numpy(), np.asarray(JS.cie1931_y(wj)), **tol)
    np.testing.assert_allclose(TS.d65_eval(wt).numpy(), np.asarray(JS.d65_eval(wj)), **tol)
    np.testing.assert_allclose(TS.blackbody_radiance(wt, 5800.0).numpy(),
                               np.asarray(JS.blackbody_radiance(wj, 5800.0)), **tol)
    np.testing.assert_allclose(
        TS.rgb_emission_eval(torch.from_numpy(rgb * 4)[:, None, :], wt).numpy(),
        np.asarray(JS.rgb_emission_eval(jnp.asarray(rgb * 4)[:, None, :], wj)),
        rtol=1e-6, atol=1e-6)
    pdf = np.full(wl.shape, 1.0 / 470.0, np.float32)
    pdf[:8] = 0.0
    np.testing.assert_allclose(
        TS.spectrum_to_xyz(torch.from_numpy(rgb[:, :1] * wl / 500), wt, torch.from_numpy(pdf)),
        np.asarray(JS.spectrum_to_xyz(jnp.asarray(rgb[:, :1] * wl / 500), wj, jnp.asarray(pdf))),
        **tol)
    x = torch.from_numpy(rgb)
    np.testing.assert_allclose(TS.xyz_to_srgb(TS.srgb_to_xyz(x)).numpy(), rgb, atol=1e-5)
    np.testing.assert_allclose(TS.luminance(x).numpy(),
                               np.asarray(JS.luminance(jnp.asarray(rgb))), rtol=1e-6)
    assert TS._D65_Y == JS._D65_Y


def test_rgb2spec_roundtrip_and_cie_spot_values():
    """tests/test_spectral_roundtrip.py in the port: rgb -> spectrum ->
    D65-weighted XYZ -> sRGB recovers rgb to < 5e-3; spot values of the
    standard observer."""
    r = np.random.default_rng(3)
    rgb = torch.from_numpy(r.uniform(0, 1, (256, 3)).astype(np.float32))
    wl = torch.linspace(360.0, 830.0, 471)
    refl = TS.rgb_reflectance_eval(rgb[:, None, :], wl[None, :])
    d65 = TS.d65_eval(wl)
    xyz_w = TS.cie1931_xyz(wl)
    xyz = torch.einsum("nw,w,wc->nc", refl, d65, xyz_w) / torch.sum(d65 * xyz_w[:, 1])
    assert float((TS.xyz_to_srgb(xyz) - rgb).abs().max()) < 5e-3
    got = TS.cie1931_xyz(torch.tensor([445.0, 555.0, 600.0])).numpy()
    np.testing.assert_allclose(got[2, 0], 1.0622, rtol=1e-3)
    np.testing.assert_allclose(got[1, 1], 1.0002, rtol=1e-3)
    np.testing.assert_allclose(got[0, 2], 1.7826, rtol=1e-2)


def test_monochromatic_rgb2spec_gradient_matches_jax():
    """The monochromatic branch's gradient: at rgb exactly 0 and 1 (c2 =
    -inf and +inf, where the sigmoid is replaced by its limit) it is 0 and
    finite in both packages, the clip to [0, 1] and the where() cutting it
    off; inside (0, 1) the two agree to 1e-5."""
    v = np.float32([0.0, 1.0, 0.25, 0.5, 0.9])
    wl = np.float32([550.0])

    def jf(x):
        return JS.rgb_reflectance_eval(jnp.stack([x, x, x], -1)[None, None, :], wl)[0, 0]

    gj = np.asarray(jax.jit(jax.vmap(jax.grad(jf)))(jnp.asarray(v)))
    x = torch.from_numpy(v).requires_grad_()
    TS.rgb_reflectance_eval(torch.stack([x, x, x], -1)[:, None, :],
                            torch.from_numpy(wl)).sum().backward()
    gt = x.grad.numpy()
    assert np.isfinite(gj).all() and np.isfinite(gt).all()
    assert (gj[:2] == 0).all() and (gt[:2] == 0).all()
    np.testing.assert_allclose(gt, gj, rtol=1e-5)


def test_hero_wavelengths_bitwise_jax(jax_cbox_lanes):
    """The hero wavelengths and their pdf of a spectral pass's lanes equal
    the JAX package's bit for bit (its render_lanes compiled, as its
    renders run it); a radiancemeter's wavelength pins all four, pdf 1."""
    _variant("spectral")
    d = cbox("path")
    ts = mt.load_dict(d, device="cpu")
    _, wj, pj, _ = jax_cbox_lanes
    _, _, wt, pt, _ = t_make_wavefront(ts, 0, 0, N, 0, SPP, SPP)
    np.testing.assert_array_equal(wt.numpy(), wj)
    np.testing.assert_array_equal(pt.numpy(), pj)
    assert float(wt.min()) >= 360.0 and float(wt.max()) < 830.0
    _variant("spectral_polarized")
    ts = mt.load_dict(mt.atmo_scene(res=4, spp=4), device="cpu")
    _, _, wt, pt, _ = t_make_wavefront(ts, 5, 0, 64, 0, 4, 4)
    assert bool((wt == 550.0).all()) and bool((pt == 1.0).all())
    _variant("rgb")
    ts = mt.load_dict(d, device="cpu")
    assert t_make_wavefront(ts, 5, 0, N, 0, SPP, SPP)[2:4] == (None, None)


# ---------------------------------------------------------------------------
# the slice: the spectral cbox, its PRB gradient, config 4
# ---------------------------------------------------------------------------

def test_spectral_cbox_matches_jax(jax_cbox_lanes):
    """The spectral cbox at 16x16 @ 4 spp, path max_depth 4: every lane's
    raw spectral radiance [N, 4] within rtol 1e-4, atol 1e-5 of the JAX
    package's (tests/test_torch_render.py's cbox bound; no lane parts),
    n_rays equal, and the sRGB image [16, 16, 3] finite and lit (the
    image against the JAX package's: test_spectral_prb_gradient_matches_jax)."""
    _variant("spectral")
    ts = mt.load_dict(cbox("path"), device="cpu")
    Lj, _, _, aux_j = jax_cbox_lanes
    Lt, aux_t = t_render_lanes(ts, 0, 0, N, 0, SPP, SPP, 0, raw=True)
    assert Lt.shape == (N, 4)
    np.testing.assert_allclose(Lt.numpy(), Lj, **LANE_TOL)
    assert int(aux_t["n_rays"]) == int(float(aux_j["n_rays"]))
    img_t = mt.render(ts, spp=SPP, seed=0).numpy()
    assert img_t.shape == (W, W, 3) and np.isfinite(img_t).all() and img_t.mean() > 0


def test_spectral_prb_gradient_matches_jax():
    """The spectral cbox with prb (16x16 @ 4 spp, max_depth 4): the sRGB
    image [16, 16, 3] within the cbox bound of the JAX package's, the loss,
    the mean of the sRGB image, within 1e-5 and its gradient for
    white.reflectance.value within GRAD_RTOL of jax.jit(jax.value_and_grad)
    of the JAX package's; the gradient goes through the XYZ -> sRGB
    measurement inside the PRB node. jnp.clip's gradient at exactly 0 is
    half torch.clamp's; the lanes whose sRGB sits at exactly 0 here carry
    zero radiance (their paths found no light), so their adjoint meets no
    attached term and the tie moves no gradient."""
    _variant("spectral")
    d = cbox("prb")
    key = "white.reflectance.value"
    js = mj.load_dict(d)

    def loss(v):
        img = mj.render(mj.traverse(js).update({key: v}), spp=SPP, seed=0)
        return jnp.mean(img), img

    (lj, img_j), gj = jax.jit(jax.value_and_grad(loss, has_aux=True))(mj.traverse(js)[key])
    p = mt.traverse(mt.load_dict(d, device="cpu"))
    v = p[key].clone().requires_grad_()
    st = {}
    img_t = mt.render(p.update({key: v}), spp=SPP, seed=0, stats=st)
    img_t.mean().backward()
    np.testing.assert_allclose(float(img_t.detach().mean()), float(lj), rtol=1e-5)
    assert img_t.shape == (W, W, 3)
    np.testing.assert_allclose(img_t.detach().numpy(), np.asarray(img_j), **LANE_TOL)
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(gj), rtol=GRAD_RTOL)
    assert st["n_rays_grad"] > st["n_rays"] > 0


def test_spectral_atmo_matches_jax():
    """BASELINE config 4 in spectral_polarized at a 4x4 film @ 16 spp
    (render_1 of the radiancemeter, whose wavelength pins the four
    channels at 550 nm): the raw Stokes [4, 4] within 1e-5 relative of the
    JAX package's (Q, U, V relative to I), and the four channels equal."""
    _variant("spectral_polarized")
    d = mt.atmo_scene(res=4, spp=16)
    sj = np.asarray(mj.render_1(mj.load_dict(d), spp=16, seed=0))
    st = {}
    stt = mt.render_1(mt.load_dict(d, device="cpu"), spp=16, seed=0, stats=st).numpy()
    assert stt.shape == (4, 4) and st["n_rays"] > 0
    np.testing.assert_allclose(stt, sj, rtol=0.0, atol=1e-5 * abs(sj[0, 0]))
    assert (stt == stt[:, :1]).all()


def test_spectral_render_1_is_raw_and_path_regen_falls_through():
    """render_1 in spectral returns the raw wavelength channels [4] (its
    PRB node too, the raw form); the surface path and prb integrators with
    ``regenerate`` render the plain passes in spectral, as the JAX
    package's render does (no spectral conversion at their flush)."""
    _variant("spectral")
    ts = mt.load_dict(cbox("path", w=8), device="cpu")
    assert mt.render_1(ts, spp=2).shape == (4,)
    p = mt.traverse(mt.load_dict(cbox("prb", w=8), device="cpu"))
    v = p["white.reflectance.value"].clone().requires_grad_()
    m = mt.render_1(p.update({"white.reflectance.value": v}), spp=2)
    assert m.shape == (4,)
    m.sum().backward()
    assert bool(torch.isfinite(v.grad).all()) and float(v.grad.abs().sum()) > 0
    for t in ("path", "prb"):
        d = cbox(t, w=8)
        img = mt.render(mt.load_dict(d, device="cpu"), spp=2, seed=1)
        d["integrator"]["regenerate"] = True
        st = {}
        img_r = mt.render(mt.load_dict(d, device="cpu"), spp=2, seed=1, stats=st)
        assert torch.equal(img, img_r) and "wavefront_iters" not in st


# ---------------------------------------------------------------------------
# specfilm, spectra, variants, errors
# ---------------------------------------------------------------------------

def _env_scene(film):
    return {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 2},
        "env": {"type": "constant", "radiance": {"type": "uniform", "value": 1.0}},
        "sensor": {"type": "perspective", "fov": 45,
                   "to_world": [{"type": "look_at", "origin": [0, 0, 1], "target": [0, 0, 0],
                                 "up": [0, 1, 0]}],
                   "film": film, "sampler": {"type": "independent", "sample_count": 8}},
    }


def test_specfilm_band_integration():
    """tests/test_plugins_extra.py:191-220 in the port: two flat SRFs
    (1 and 0.5) under a uniform emitter both give the emitter's radiance
    (rtol 0.02); a 2-SRF film (a regular green band, a flat one) has the
    JAX package's SRF norms (its render against the JAX package's:
    tests/test_torch_spectral_regen.py)."""
    _variant("spectral")
    film = {"type": "specfilm", "width": 8, "height": 8, "rfilter": {"type": "box"},
            "band_flat": {"type": "uniform", "value": 1.0},
            "band_half": {"type": "uniform", "value": 0.5}}
    img = mt.render(mt.load_dict(_env_scene(film), device="cpu"), spp=32, seed=4).numpy()
    assert img.shape == (8, 8, 2)
    np.testing.assert_allclose(img[..., 0].mean(), 1.0, rtol=0.02)
    np.testing.assert_allclose(img[..., 1].mean(), 1.0, rtol=0.02)
    d = cbox("path", w=8)
    d["sensor"]["film"] = {"type": "specfilm", "width": 8, "height": 8,
                           "band_green": {"type": "regular", "lambda_min": 500.0,
                                          "lambda_max": 600.0, "values": [0.2, 1.0, 0.2]},
                           "band_flat": {"type": "uniform", "value": 1.0}}
    js, ts = mj.load_dict(d), mt.load_dict(d, device="cpu")
    np.testing.assert_allclose(ts.film.srf_norms, js.film.srf_norms, rtol=1e-5)
    img_t = mt.render(ts, spp=SPP, seed=2).numpy()
    assert img_t.shape == (8, 8, 2) and np.isfinite(img_t).all() and img_t.mean() > 0


SPECTRA = {
    "uniform": {"type": "uniform", "value": 0.7},
    "singleton": {"type": "singleton", "value": 2.0, "wavelength": 550.0},
    "d65": {"type": "d65", "scale": 0.5},
    "blackbody": {"type": "blackbody", "temperature": 4000.0, "scale": 1e-6},
    "regular": {"type": "regular", "lambda_min": 400.0, "lambda_max": 700.0,
                "values": [0.1, 0.9, 0.3, 0.6]},
    "irregular": {"type": "irregular", "wavelengths": "380, 500, 520, 800",
                  "values": "0.2, 0.8, 0.4, 0.1"},
}


@pytest.mark.parametrize("variant", ["spectral", "rgb"])
def test_spectra_traverse_and_eval_match_jax(variant):
    """Each spectrum as an emitter's radiance and a BSDF's reflectance: the
    traverse keys and values are the JAX package's letter for letter and
    value for value; evaluated at the same lanes' wavelengths (or,
    outside the spectral variants, as a value, scale or mean) within 1e-6
    relative; an update through traverse moves the same parameter."""
    _variant(variant)
    wl = np.float32([[365.0, 450.0, 550.0, 825.0], [500.5, 549.5, 600.0, 700.0]])
    uv = np.zeros((2, 2), np.float32)
    wt = torch.from_numpy(wl) if variant == "spectral" else None
    wj = jnp.asarray(wl) if variant == "spectral" else None
    for name, sp in SPECTRA.items():
        d = cbox("path", w=4)
        d["light"]["emitter"]["radiance"] = sp
        d["white"]["reflectance"] = sp
        js, ts = mj.load_dict(d), mt.load_dict(d, device="cpu")
        pj, pt = mj.traverse(js), mt.traverse(ts)
        keys = [k for k in pt.keys() if k.startswith(("white.", "light.emitter"))]
        assert keys == [k for k in pj.keys() if k.startswith(("white.", "light.emitter"))], name
        for k in keys:
            np.testing.assert_array_equal(pt[k].numpy(), np.asarray(pj[k]), err_msg=k)
        nc = ts.n_channels
        for jt, tt in ((js.emitters[0].radiance, ts.emitters[0].radiance),
                       (js.bsdfs[0].reflectance, ts.bsdfs[0].reflectance)):
            np.testing.assert_allclose(
                tt.eval(torch.from_numpy(uv), nc, wt).numpy(),
                np.asarray(jt.eval(jnp.asarray(uv), wj, nc)), rtol=1e-6, err_msg=name)
        k = keys[0]
        new = pt[k] * 2
        got_t = mt.traverse(pt.update({k: new}))[k]
        got_j = mj.traverse(pj.update({k: jnp.asarray(new.numpy())}))[k]
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(got_j))


def test_spectral_variant_names_and_errors():
    """Every reference alias of the spectral variants selects C = 4 (and
    the Stokes axis for the polarized ones), as in the JAX package; an rgb
    volume in spectral raises in both packages (it cannot be broadcast to
    the four wavelengths), and so does an unknown name."""
    for name in ("spectral", "scalar_spectral", "llvm_spectral", "llvm_ad_spectral",
                 "spectral_polarized", "scalar_spectral_polarized",
                 "llvm_ad_spectral_polarized"):
        _variant(name)
        v = mt.current_variant()
        assert (v.n_channels, v.is_spectral, v.polarized) == (4, True, "polarized" in name)
        assert mt.variant() == mj.variant()
    assert sorted(mt.variants()) == sorted(mj.variants())
    with pytest.raises(ValueError):
        mt.set_variant("spectral_mono")
    _variant("spectral")
    d = vol32_scene(res=4, spp=2, max_depth=2)
    d["slab"]["interior"]["albedo"] = [0.9, 0.5, 0.2]
    ts = mt.load_dict(d, device="cpu")
    with pytest.raises(ValueError):
        mt.render(ts, spp=2)
    with pytest.raises(Exception):
        mj.render(mj.load_dict(d), spp=2)
