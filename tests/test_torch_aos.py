"""The atmosphere-ocean slice of the PyTorch port against the JAX package on
the CPU: the microfacet functions, the Fresnel reflectance and the GGX
rough dielectric (eval, pdf, sample, the Mueller eval and sample, the
refracted NEE proposal) on random directions that include grazing ones;
volpathaos (render_1 against the JAX package's, the underwater refractive
NEE, the no-interface case against volpath, the regenerative schedule);
and the atmosphere-ocean PRB replay prb_volpathaos (BASELINE config 5's
integrator): its primal, and its gradients for the sea floor's reflectance
through the interface, the sun's irradiance, the atmosphere's albedo and
sigma_t, in the mono and the mono_polarized variants.

Every JAX value is computed live, through jax.jit: the gradients of
sum(render_1) of the ocean under its atmosphere by one
jax.value_and_grad per variant, shared by the tests of this module
(tracing and compiling the JAX package's atmosphere-ocean replay takes
35-65 s a variant on the CPU).

Tolerances are stated at each check.
"""
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mitsuba_tpu as mj
from mitsuba_tpu.render import fresnel as JFR
from mitsuba_tpu.render import microfacet as JMF

import mitsuba_tpu_torch as mt
from mitsuba_tpu_torch.ad.prb_volpathaos import PRBVolpathAOSIntegrator
from mitsuba_tpu_torch.ad.render_ad import derive_seed_grad
from mitsuba_tpu_torch.integrators.volpathaos import VolPathAOSIntegrator
from mitsuba_tpu_torch.render import fresnel as TFR
from mitsuba_tpu_torch.render import microfacet as TMF
from mitsuba_tpu_torch.render.bsdfs import RoughDielectricBSDF

SPP, SEED = 8, 3
KEYS = ("sea_floor.bsdf.reflectance.value", "sun.irradiance.value",
        "atmo_medium.albedo.value.value", "atmo_medium.sigma_t.value.value")
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


@pytest.fixture(scope="module")
def jax_ocean():
    """variant -> (the JAX package's render_1 of ocean("prb_volpathaos"),
    [C] or Stokes [4, C] flattened; its gradients of sum(render_1) for
    KEYS), at spp=SPP, seed=SEED: jax.jit(jax.value_and_grad) of the loss,
    traced once per variant for the module."""
    cache = {}

    def get(variant):
        if variant not in cache:
            mj.set_variant(variant)
            js = mj.load_dict(ocean("prb_volpathaos"))

            def loss(vals):
                v = mj.render_1(mj.traverse(js).update(dict(zip(KEYS, vals))), spp=SPP,
                                seed=SEED)
                return jnp.sum(v), v

            p = mj.traverse(js)
            (_, v), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
                tuple(p[k] for k in KEYS))
            cache[variant] = (np.asarray(v, np.float32).reshape(-1),
                              [float(np.asarray(x).reshape(-1)[0]) for x in g])
        return cache[variant]

    return get


def _variant(name):
    mj.set_variant(name)
    mt.set_variant(name)


def ocean(integrator="volpathaos", with_atmo=True):
    """bench.py's config 5 dict (render/scene_loader.py:aos_scene: a
    rough-dielectric sea surface over a diffuse floor, a directional sun, a
    Rayleigh atmosphere in a null slab, a radiancemeter looking down) at a
    4x4 film; without with_atmo, tests/test_volpathaos.py's refractive-NEE
    scene (the same without the atmosphere)."""
    d = mt.aos_scene(res=4, integrator=integrator)
    if not with_atmo:
        del d["atmo"], d["atmo_medium"]
    return d


def medium_slab(integrator="volpathaos"):
    """tests/test_volpathaos.py's _medium_albedo_config, shrunk: a
    scattering slab (sigma_t 1, albedo 0.5, HG 0.5) over a black floor
    under an area light; no refractive interface."""
    return {
        "type": "scene",
        "integrator": {"type": integrator, "max_depth": 3},
        "a_medium": {"type": "homogeneous", "phase": {"type": "hg", "g": 0.5}, "albedo": 0.5,
                     "sigma_t": 1.0},
        "top": {"type": "rectangle", "bsdf": {"type": "null"},
                "to_world": [{"type": "scale", "value": [1000.0, 1000.0, 1.0]},
                             {"type": "translate", "value": [0.0, 0.0, 1.0]}],
                "interior": {"type": "ref", "id": "a_medium"}},
        "bottom": {"type": "rectangle", "bsdf": {"type": "diffuse", "reflectance": 0.0},
                   "to_world": [{"type": "scale", "value": [1000.0, 1000.0, 1.0]}],
                   "exterior": {"type": "ref", "id": "a_medium"}},
        "light": {"type": "rectangle",
                  "to_world": [{"type": "rotate", "axis": [0, 1, 0], "angle": -180},
                               {"type": "translate", "value": [0.0, 0.0, 5.0]}],
                  "emitter": {"type": "area", "radiance": 3.0}},
        "sensor": {"type": "radiancemeter",
                   "to_world": [{"type": "look_at", "origin": [0, 0, 4], "target": [0, 0, 0],
                                 "up": [0, 1, 0]}],
                   "film": {"type": "hdrfilm", "width": 4, "height": 4,
                            "rfilter": {"type": "box"}},
                   "sampler": {"type": "independent", "sample_count": SPP}},
    }


def _directions(n, seed):
    """Unit vectors [n, 3]: random ones, and a quarter made grazing (|z| of
    1e-2 down to 0) on both sides of the horizon."""
    r = np.random.default_rng(seed)
    v = r.normal(size=(n, 3))
    k = n // 4
    z = np.array([1e-2, -1e-2, 1e-4, -1e-4, 1e-6, -1e-6, 0.0, 3e-3])
    v[:k, 2] = 0.0
    v[:k] /= np.linalg.norm(v[:k], axis=-1, keepdims=True)
    v[:k, 2] = np.resize(z, k)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return v.astype(np.float32)


def _pair(a):
    a = np.asarray(a, np.float32)
    return torch.from_numpy(a), jnp.asarray(a)


def _close(t, j, rtol=1e-5, atol=1e-6):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_allclose(t, np.asarray(j), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# microfacet functions, Fresnel, the rough dielectric
# ---------------------------------------------------------------------------

def test_microfacet_functions_match_jax():
    """GGX and Beckmann D, Smith G1 and G, the VNDF sample and its pdf, the
    GTR1 helpers, isotropic and anisotropic, on grazing and random
    directions (rtol 1e-5, atol 1e-5 of the function's largest value: the
    VNDF's normalisations round differently); every port value finite."""
    n = 256
    wi_t, wi_j = _pair(_directions(n, 1))
    m_t, m_j = _pair(np.abs(_directions(n, 2)) * [1, 1, 1] + [0, 0, 1e-3])
    m_t, m_j = m_t / m_t.norm(dim=-1, keepdim=True), m_j / jnp.linalg.norm(m_j, axis=-1,
                                                                            keepdims=True)
    u1_t, u1_j = _pair(np.random.default_rng(3).random(n))
    u2_t, u2_j = _pair(np.random.default_rng(4).random(n))
    for au, av in ((0.2, 0.2), (0.1, 0.35)):
        cases = [
            (TMF.ggx_d(m_t, au, av), jax.jit(lambda m: JMF.ggx_d(m, au, av))(m_j)),
            (TMF.beckmann_d(m_t, au, av), jax.jit(lambda m: JMF.beckmann_d(m, au, av))(m_j)),
            (TMF.smith_g1_ggx(wi_t, m_t, au, av),
             jax.jit(lambda w, m: JMF.smith_g1_ggx(w, m, au, av))(wi_j, m_j)),
            (TMF.ggx_g(wi_t, m_t, m_t, au, av),
             jax.jit(lambda w, m: JMF.ggx_g(w, m, m, au, av))(wi_j, m_j)),
            (TMF.ggx_sample_vndf(wi_t, u1_t, u2_t, au, av),
             jax.jit(lambda w, a, b: JMF.ggx_sample_vndf(w, a, b, au, av))(wi_j, u1_j, u2_j)),
            (TMF.ggx_pdf_visible(wi_t, m_t, au, av),
             jax.jit(lambda w, m: JMF.ggx_pdf_visible(w, m, au, av))(wi_j, m_j)),
        ]
        for i, (t, j) in enumerate(cases):
            assert bool(torch.isfinite(t).all()), (au, av, i)
            _close(t, j, rtol=1e-5, atol=1e-5 * float(np.abs(np.asarray(j)).max()))
    a = 0.3
    for t, j in ((TMF.gtr1_d(m_t, a), jax.jit(lambda m: JMF.gtr1_d(m, a))(m_j)),
                 (TMF.gtr1_pdf(m_t, a), jax.jit(lambda m: JMF.gtr1_pdf(m, a))(m_j)),
                 (TMF.gtr1_sample(u1_t, u2_t, a), jax.jit(lambda x, y: JMF.gtr1_sample(x, y, a))(
                     u1_j, u2_j)),
                 (TMF.smith_ggx1(wi_t, m_t, a), jax.jit(lambda w, m: JMF.smith_ggx1(w, m, a))(
                     wi_j, m_j))):
        _close(t, j, rtol=1e-5, atol=1e-6)


def test_fresnel_matches_jax():
    """The unpolarized dielectric reflectance, both sides, total internal
    reflection and index matching included (rtol 1e-6, atol 1e-6)."""
    c_t, c_j = _pair(np.concatenate([np.linspace(-1, 1, 201), [1e-7, -1e-7, 0.0]]))
    for eta in (1.33, 1.0 / 1.33, 1.0, 1.5046):
        for t, j in zip(TFR.fresnel(c_t, eta), jax.jit(lambda c: JFR.fresnel(c, eta))(c_j)):
            _close(t, j, rtol=1e-6, atol=1e-6)


def _dielectrics(nc):
    """The port's and the JAX package's rough dielectric of the ocean dict
    (eta 1.33, alpha 0.2), a specular transmittance of 0.9."""
    d = ocean(with_atmo=False)
    d["ocean_surface"]["bsdf"]["specular_transmittance"] = 0.9
    variant = "mono" if nc == 1 else "rgb"
    _variant(variant)
    tb = [b for b in mt.load_dict(d, device="cpu").bsdfs if isinstance(b, RoughDielectricBSDF)]
    jb = [b for b in mj.load_dict(d).bsdfs if type(b).__name__ == "RoughDielectricBSDF"]
    return tb[0], jb[0]


def _si(wi):
    return SimpleNamespace(wi=wi, uv=wi[..., :2] * 0)


@pytest.mark.parametrize("nc", [1, 3])
def test_rough_dielectric_matches_jax(nc):
    """RoughDielectricBSDF against the JAX package's on 256 (wi, wo) pairs
    with grazing ones on both sides: eval and pdf (rtol 1e-4, atol 1e-4 of
    the largest value: the Jacobian 1/(wi.m + eta wo.m)^2 amplifies
    rounding near grazing), the sample (direction, pdf, eta, weight), the
    transmission proposal, and the Mueller eval and sample (C x 4 x 4 per
    lane); every port value finite, and the gradients of eval in eta,
    alpha and the transmittance too."""
    tb, jb = _dielectrics(nc)
    n = 256
    wi_t, wi_j = _pair(_directions(n, 5))
    wo_t, wo_j = _pair(_directions(n, 6))
    ul_t, ul_j = _pair(np.random.default_rng(7).random(n))
    u2_t, u2_j = _pair(np.random.default_rng(8).random((n, 2)))

    # rtol 1e-4 per lane, raised to 1e-7 / |cos_theta_i| where wi grazes
    # (the VNDF pdf's 1 / |cos_theta_i| and the Smith term's tan^2 amplify
    # the rounding of each package there), plus 1e-6 sqrt(|x|): a
    # transmission's Jacobian 1 / (wi.m + eta wo.m)^2 grows as the square
    # of the cancellation that rounds it
    rtol_lane = np.maximum(1e-4, 1e-7 / np.maximum(np.abs(_directions(n, 5)[:, 2]), 1e-30))

    def close(t, j):
        t, j = t.detach().numpy(), np.asarray(j)
        r = rtol_lane.reshape((n,) + (1,) * (j.ndim - 1)) + 1e-6 * np.sqrt(np.abs(j))
        atol = 1e-4 * max(float(np.abs(j).max()), 1e-6)
        bad = np.abs(t - j) > atol + r * np.abs(j)
        assert not bad.any(), (np.argwhere(bad)[:4], t[bad][:4], j[bad][:4])

    ev_t = tb.eval(_si(wi_t), wo_t, nc)
    ev_j = jax.jit(lambda w, o: jb.eval(_si(w), o, None, nc))(wi_j, wo_j)
    pdf_t = tb.pdf(_si(wi_t), wo_t)
    pdf_j = jax.jit(lambda w, o: jb.pdf(_si(w), o))(wi_j, wo_j)
    assert float(np.asarray(ev_j).max()) > 0 and float(np.asarray(pdf_j).max()) > 0
    for t, j in ((ev_t, ev_j), (pdf_t, pdf_j)):
        assert bool(torch.isfinite(t).all())
        close(t, j)

    bs_t, w_t = tb.sample(ul_t, u2_t, _si(wi_t), nc)
    bs_j, w_j = jax.jit(lambda a, b, w: jb.sample(a, b, _si(w), None, nc))(ul_j, u2_j, wi_j)
    for t, j in ((bs_t.wo, bs_j.wo), (bs_t.pdf, bs_j.pdf), (bs_t.eta, bs_j.eta), (w_t, w_j)):
        assert bool(torch.isfinite(t).all())
        close(t, j)
    assert np.array_equal(bs_t.delta.numpy(), np.asarray(bs_j.delta))

    wo_t2, p_t2 = tb.sample_transmission(u2_t, wi_t)
    wo_j2, p_j2 = jax.jit(jb.sample_transmission)(u2_j, wi_j)
    for t, j in ((wo_t2, wo_j2), (p_t2, p_j2)):
        assert bool(torch.isfinite(t).all())
        close(t, j)

    M_t, mp_t = tb.eval_pdf_mueller(_si(wi_t), wo_t, nc)
    M_j, mp_j = jax.jit(lambda w, o: jb.eval_pdf_mueller(_si(w), o, None, nc))(wi_j, wo_j)
    assert M_t.shape == (n, nc, 4, 4)
    for t, j in ((M_t, M_j), (mp_t, mp_j)):
        assert bool(torch.isfinite(t).all())
        close(t, j)
    _, Ms_t = tb.sample_pol(ul_t, u2_t, _si(wi_t), nc)
    _, Ms_j = jax.jit(lambda a, b, w: jb.sample_pol(a, b, _si(w), None, nc))(ul_j, u2_j, wi_j)
    close(Ms_t, Ms_j)

    leaves = [tb.eta.clone().requires_grad_(), tb.alpha.clone().requires_grad_(),
              tb.specular_transmittance.value.clone().requires_grad_()]
    att = RoughDielectricBSDF(eta=leaves[0], alpha=leaves[1],
                              specular_reflectance=tb.specular_reflectance,
                              specular_transmittance=type(tb.specular_transmittance)(leaves[2]))
    (att.eval(_si(wi_t), wo_t, nc).sum() + att.eval_pdf_mueller(_si(wi_t), wo_t, nc)[0].sum()
     ).backward()
    assert all(bool(torch.isfinite(x.grad).all()) and bool((x.grad != 0).any()) for x in leaves)


def test_rough_dielectric_loads_with_the_reference_keys():
    """parse_bsdf's roughdielectric: the IOR presets and the ratio, alpha
    as a value or a dict, its parameters under the JAX package's keys; the
    BSDF types that are not yet ported are still refused."""
    d = ocean(with_atmo=False)
    d["ocean_surface"]["bsdf"] = {"type": "roughdielectric", "int_ior": "water",
                                  "ext_ior": "air", "alpha": {"value": 0.3}}
    _variant("mono")
    p = mt.traverse(mt.load_dict(d, device="cpu"))
    jp = mj.traverse(mj.load_dict(d))
    for k in ("ocean_surface.bsdf.eta", "ocean_surface.bsdf.alpha.value"):
        assert k in p and k in jp
        np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]), rtol=1e-7)
    for t in ("normalmap", "bumpmap", "plastic", "principled", "measured", "hair"):
        d["ocean_surface"]["bsdf"] = {"type": t}
        with pytest.raises(NotImplementedError, match=t):
            mt.load_dict(d, device="cpu")


# ---------------------------------------------------------------------------
# volpathaos
# ---------------------------------------------------------------------------

def test_volpathaos_underwater_refractive_nee_matches_jax():
    """tests/test_volpathaos.py's refractive-NEE scene (the floor under the
    rough sea surface, lit by the sun only through the refraction
    proposal), mono, 4x4 @ 8 spp: render_1 against the JAX package's at the
    same seed (rtol 1e-5), and light reaches the camera."""
    _variant("mono")
    d = ocean(with_atmo=False)
    stats = {}
    got = mt.render_1(mt.load_dict(d, device="cpu"), spp=SPP, seed=0, stats=stats)
    want = jax.jit(lambda s: mj.render_1(s, spp=SPP, seed=0))(mj.load_dict(d))
    _close(got, want, rtol=1e-5, atol=0.0)
    assert float(got[0]) > 1e-3 and stats["n_rays"] > 0


def test_volpathaos_without_interface_is_volpath():
    """Without a refractive interface: volpathaos render_1 of the slab
    against the JAX package's (I to rtol 1e-5, Q/U/V to 1e-5 of I); and
    volpathaos and volpath estimate the same integral (their samples
    differ: volpathaos draws the refraction proposal's numbers and takes no
    MIS): the slab's intensity at 16,384 lanes each, within 3%
    (tests/test_volpathaos.py's test03)."""
    _variant("mono_polarized")
    d = medium_slab()
    got = mt.render_1(mt.load_dict(d, device="cpu"), spp=SPP, seed=0).reshape(-1).numpy()
    want = np.asarray(jax.jit(lambda s: mj.render_1(s, spp=SPP, seed=0))(mj.load_dict(d)))
    want = want.reshape(-1)
    assert want[0] > 0
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1:], want[1:], atol=1e-5 * want[0])
    a = mt.render_1(mt.load_dict(d, device="cpu"), spp=1024, seed=1)
    d["integrator"]["type"] = "volpath"
    b = mt.render_1(mt.load_dict(d, device="cpu"), spp=1024, seed=2)
    np.testing.assert_allclose(a[0].numpy(), b[0].numpy(), rtol=0.03)


def test_volpathaos_regenerate_is_the_wavefront_image():
    """regenerate, in mono and mono_polarized: the same samples in another
    schedule (the refractive-interface memory reset when a lane restarts;
    polarized, each path's Stokes vector rotated into the sensor frame by
    its own camera ray as it is flushed), so the same image up to the order
    of each pixel's sums (rtol 1e-5, atol 1e-6)."""
    for variant, shape in (("mono", (4, 4, 1)), ("mono_polarized", (4, 4, 4, 1))):
        _variant(variant)
        d = ocean()
        img = mt.render(mt.load_dict(d, device="cpu"), spp=SPP, seed=1)
        d["integrator"]["regenerate"] = True
        scene = mt.load_dict(d, device="cpu")
        stats = {}
        img_r = mt.render(scene, spp=SPP, seed=1, stats=stats)
        assert img_r.shape == img.shape == shape
        np.testing.assert_allclose(img_r.numpy(), img.numpy(), rtol=1e-5, atol=1e-6)
        assert stats["wavefront_iters"] > 0


# ---------------------------------------------------------------------------
# prb_volpathaos
# ---------------------------------------------------------------------------

def port_grads(d, keys, stats=None):
    p = mt.traverse(mt.load_dict(d, device="cpu"))
    leaves = {k: p[k].clone().requires_grad_() for k in keys}
    out = mt.render_1(p.update(leaves), spp=SPP, seed=SEED, stats=stats)
    out.sum().backward()
    return out.detach(), [leaves[k].grad for k in keys]


@pytest.mark.parametrize("variant", ["mono", "mono_polarized"])
def test_volpathaos_ocean_matches_jax(variant, jax_ocean):
    """volpathaos render_1 of the ocean under its atmosphere against the JAX
    package's (the primal of its prb_volpathaos gradient): I to rtol 1e-5,
    Q/U/V to 1e-5 of I."""
    _variant(variant)
    want, _ = jax_ocean(variant)
    got = mt.render_1(mt.load_dict(ocean(), device="cpu"), spp=SPP, seed=SEED)
    got = got.reshape(-1).numpy()
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1:], want[1:], atol=1e-5 * want[0])


@pytest.mark.parametrize("variant", ["mono", "mono_polarized"])
def test_prb_volpathaos_gradients_match_jax(variant, jax_ocean):
    """The replay's gradients of sum(render_1) against the JAX package's
    (jax.value_and_grad of the same loss at the same seed): the floor's
    reflectance seen through the interface (the attached BSDF of the bent
    shadow walk and of the sampled direction), the sun's irradiance, the
    atmosphere's albedo and sigma_t (rtol 1e-4); the primal's I to rtol
    1e-5."""
    _variant(variant)
    stats = {}
    out, got = port_grads(ocean("prb_volpathaos"), KEYS, stats)
    assert stats["n_rays_grad"] > stats["n_rays"] > 0
    want_v, want_g = jax_ocean(variant)
    np.testing.assert_allclose(out.reshape(-1).numpy()[0], want_v[0], rtol=1e-5)
    for k, g, want in zip(KEYS, got, want_g):
        assert g.shape == (1,) and want != 0.0, k
        np.testing.assert_allclose(g.numpy(), [want], rtol=GRAD_RTOL, err_msg=k)


@pytest.mark.parametrize("variant", ["mono", "mono_polarized"])
def test_prb_volpathaos_primal_and_linear_gradient(variant):
    """The primal is volpathaos's, bitwise; the gradient of the sun's
    irradiance, on which the measurement is linear, is the measurement at
    the backward pass's seed over the irradiance (rtol 1e-5)."""
    _variant(variant)
    s_prb = mt.load_dict(ocean("prb_volpathaos"), device="cpu")
    assert isinstance(s_prb.integrator, PRBVolpathAOSIntegrator) and s_prb.integrator.is_prb
    s_fwd = mt.load_dict(ocean(), device="cpu")
    assert type(s_fwd.integrator) is VolPathAOSIntegrator
    assert torch.equal(mt.render_1(s_prb, spp=SPP, seed=SEED), mt.render_1(s_fwd, spp=SPP,
                                                                            seed=SEED))
    _, (g,) = port_grads(ocean("prb_volpathaos"), ["sun.irradiance.value"])
    lin = mt.render_1(s_fwd, spp=SPP, seed=derive_seed_grad(SEED)).sum() / 5.0
    np.testing.assert_allclose(g.numpy(), [float(lin)], rtol=1e-5)
