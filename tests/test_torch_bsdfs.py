"""The port's surface BSDFs held against the JAX package on the CPU: the
smooth and thin dielectrics, the smooth and rough conductors, the rough and
polarized plastics, the polarizer, circular polarizer and retarder, and the
two-sided, mask and blend wrappers; eval, pdf, sample, and the polarized
sample_pol and eval_pdf_mueller where a BSDF has them, in the rgb and
mono_polarized variants; the conductor's Fresnel reflectance and the
diffuse Fresnel fit; the loader's parameter keys and values.

Both packages load the same dict, so each BSDF has the same parameters on
both sides. The directions are seeded numpy unit vectors, a quarter of
them grazing on both sides of the horizon (|cos| of 1e-2 down to 0), with
lanes of wo = -wi and of the mirror direction added. Tolerances are stated
at each check.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mitsuba_tpu as mj
from mitsuba_tpu.render import fresnel as JFR

import mitsuba_tpu_torch as mt
from mitsuba_tpu_torch.render import fresnel as TFR

N = 256
VARIANTS = ("rgb", "mono_polarized")
# one named BSDF of each type the slice ports (the wrappers around BSDFs
# with a smooth lobe and around Dirac ones), with non-default parameters
BSDFS = {
    "dielectric": {"type": "dielectric", "int_ior": "bk7", "specular_transmittance": 0.9},
    "dielectric_inside": {"type": "dielectric", "int_ior": 1.0, "ext_ior": 1.33},
    "thindielectric": {"type": "thindielectric", "int_ior": 1.6,
                       "specular_reflectance": {"type": "rgb", "value": [0.9, 0.8, 0.7]}},
    "conductor": {"type": "conductor", "material": "Au"},
    "conductor_eta_k": {"type": "conductor", "eta": 0.2, "k": 3.0},
    "roughconductor": {"type": "roughconductor", "material": "Cu", "alpha": 0.2},
    "roughconductor_aniso": {"type": "roughconductor", "material": "Al", "alpha_u": 0.1,
                             "alpha_v": 0.4},
    "roughplastic": {"type": "roughplastic", "diffuse_reflectance": 0.6, "alpha": 0.1},
    "pplastic": {"type": "pplastic",
                 "diffuse_reflectance": {"type": "rgb", "value": [0.3, 0.5, 0.2]},
                 "alpha": 0.08},
    "polarizer": {"type": "polarizer", "theta": 30.0, "transmittance": 0.9},
    "circular": {"type": "circular"},
    "circular_left": {"type": "circular", "left_handed": True},
    "retarder": {"type": "retarder", "theta": 45.0},
    "retarder_eighth": {"type": "retarder", "theta": -20.0, "delta": 45.0},
    "twosided": {"type": "twosided", "bsdf": {"type": "roughplastic", "alpha": 0.3}},
    "twosided_conductor": {"type": "twosided", "nested": {"type": "conductor",
                                                          "material": "Ag"}},
    "mask": {"type": "mask", "opacity": 0.8, "bsdf": {"type": "roughconductor", "alpha": 0.3}},
    "mask_dirac": {"type": "mask", "opacity": 0.4, "bsdf": {"type": "dielectric"}},
    "blend": {"type": "blendbsdf", "weight": 0.3,
              "a": {"type": "diffuse", "reflectance": 0.7},
              "b": {"type": "conductor", "material": "Ag"}},
    "blend_rough": {"type": "blendbsdf", "weight": {"type": "rgb", "value": [0.2, 0.5, 0.6]},
                    "a": {"type": "roughplastic"},
                    "b": {"type": "roughconductor", "alpha": 0.15}},
}


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


@dataclasses.dataclass
class SI:
    """The two fields of a surface interaction that a BSDF reads, and the
    JAX package's functional replace."""

    wi: object
    uv: object

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _directions(n, seed):
    """Unit vectors [n, 3]: random ones, and a quarter made grazing (|z| of
    1e-2 down to 0) on both sides of the horizon."""
    r = np.random.default_rng(seed)
    v = r.normal(size=(n, 3))
    k = n // 4
    v[:k, 2] = 0.0
    v[:k] /= np.linalg.norm(v[:k], axis=-1, keepdims=True)
    v[:k, 2] = np.resize([1e-2, -1e-2, 1e-4, -1e-4, 1e-6, -1e-6, 0.0, 3e-3], k)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return v.astype(np.float32)


def _inputs():
    """(wi, wo, u_lobe, u2) as numpy: wo = -wi on lanes 64-79 and the
    mirror direction on lanes 80-95."""
    wi = _directions(N, 11)
    wo = _directions(N, 12)
    wo[64:80] = -wi[64:80]
    wo[80:96] = wi[80:96] * np.float32([-1, -1, 1])
    r = np.random.default_rng(13)
    return wi, wo, r.random(N).astype(np.float32), r.random((N, 2)).astype(np.float32)


def _scenes(variant):
    """The port's and the JAX package's BSDFs of BSDFS, by name."""
    mj.set_variant(variant)
    mt.set_variant(variant)
    d = mt.cornell_box()
    d["sensor"]["film"]["width"] = d["sensor"]["film"]["height"] = 4
    d.update(BSDFS)
    ts, js = mt.load_dict(d, device="cpu"), mj.load_dict(d)
    assert len(ts.bsdfs) == len(js.bsdfs)
    names = ["white", "green", "red"] + list(BSDFS)
    return {k: (ts.bsdfs[i], js.bsdfs[i]) for i, k in enumerate(names)}


def _bounds(wi, wo):
    """(rtol, atol) per lane for values at the directions (wi, wo). XLA
    contracts FMAs on the CPU and the port does not (ROADMAP Queue 3), so
    each package rounds a sampled direction its own way: the two agree to
    err = 1e-6 + 1e-7 / |cos_theta_i| (16 ulp of a unit vector's largest
    component, where 2 (wi.m) m - wi cancels toward the horizon, and the
    VNDF's stretch by 1 / |cos_theta_i|), the atol added. A value that
    depends on a direction's cosine (the Smith term's tan^2, the VNDF pdf's
    1 / |cos_theta_i|) moves by err over that cosine: rtol err (1 /
    |cos_theta_i| + 1 / |cos_theta_o|), at least 1e-5."""
    ci = np.abs(wi[:, 2]).astype(np.float64)
    co = np.abs(wo[:, 2]).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        err = 1e-6 + 1e-7 / ci
        rtol = np.nan_to_num(np.maximum(1e-5, err * (1.0 / ci + 1.0 / co)), posinf=1e30)
    return rtol, np.minimum(err, 1.0)


def _close(t, j, bounds, name, lanes=None):
    """|t - j| <= atol + rtol |j| lane by lane, with _bounds' (rtol, atol),
    on the lanes of the mask `lanes` (all by default); atol also covers
    1e-6 of the largest |j|: a Dirac lobe's Mueller weight reaches 1e2
    where its 1e-8 pdf clamp divides it."""
    t, j = t.detach().numpy(), np.asarray(j)
    assert t.shape == j.shape, (name, t.shape, j.shape)
    assert np.isfinite(t).all(), name
    if t.dtype == bool:
        assert np.array_equal(t, j), name
        return
    shape = (N,) + (1,) * (j.ndim - 1)
    rtol, atol = (b.reshape(shape) for b in bounds)
    atol = atol + 1e-6 * max(float(np.abs(j).max()), 1.0)
    bad = np.abs(t - j) > atol + rtol * np.abs(j)
    if lanes is not None:
        bad &= lanes.reshape(shape)
    assert not bad.any(), (name, np.argwhere(bad)[:4].tolist(), t[bad][:4], j[bad][:4])


@pytest.mark.parametrize("variant", VARIANTS)
def test_bsdfs_match_jax(variant):
    """Every BSDF of BSDFS against the JAX package's: eval [N, C] and pdf
    [N] on (wi, wo); the sample (wo, pdf, eta, delta, weight) on (u_lobe,
    u2, wi); sample_pol's and eval_pdf_mueller's Mueller matrices [N, C, 4,
    4] where the BSDF has them. Each within _close's bound (at the sampled
    direction for the sample's values; the direction itself where the
    sample's pdf is not 0); the delta flags equal; every port value finite,
    on the grazing, below-horizon, wo = -wi and mirror lanes too."""
    nc = 1 if variant.startswith("mono") else 3
    wi, wo, ul, u2 = _inputs()
    t_in = [torch.from_numpy(x) for x in (wi, wo, ul, u2)]
    j_in = [jnp.asarray(x) for x in (wi, wo, ul, u2)]
    uv = np.zeros((N, 2), np.float32)
    for name, (tb, jb) in _scenes(variant).items():
        if name in ("white", "green", "red"):
            continue
        assert type(tb).__name__ == type(jb).__name__, name
        assert tb.flags_smooth == jb.flags_smooth, name

        def jax_all(wi_, wo_, ul_, u2_):
            si = SI(wi=wi_, uv=jnp.asarray(uv))
            out = {"eval": jb.eval(si, wo_, None, nc), "pdf": jb.pdf(si, wo_)}
            bs, w = jb.sample(ul_, u2_, si, None, nc)
            out.update(wo=bs.wo, bs_pdf=bs.pdf, eta=bs.eta, delta=bs.delta, weight=w)
            if hasattr(jb, "sample_pol"):
                out["M_sample"] = jb.sample_pol(ul_, u2_, si, None, nc)[1]
            if hasattr(jb, "eval_pdf_mueller"):
                out["M_eval"], out["M_pdf"] = jb.eval_pdf_mueller(si, wo_, None, nc)
            return out

        # eagerly, op by op (as the JAX package's own BSDF tests run):
        # cheaper on the CPU than a compile per BSDF and variant
        want = jax_all(*j_in)
        wi_t, wo_t, ul_t, u2_t = t_in
        si = SI(wi=wi_t, uv=torch.from_numpy(uv))
        got = {"eval": tb.eval(si, wo_t, nc), "pdf": tb.pdf(si, wo_t)}
        bs, w = tb.sample(ul_t, u2_t, si, nc)
        got.update(wo=bs.wo, bs_pdf=bs.pdf, eta=bs.eta, delta=bs.delta, weight=w)
        assert hasattr(tb, "sample_pol") == hasattr(jb, "sample_pol"), name
        assert hasattr(tb, "eval_pdf_mueller") == hasattr(jb, "eval_pdf_mueller"), name
        if hasattr(tb, "sample_pol"):
            got["M_sample"] = tb.sample_pol(ul_t, u2_t, si, nc)[1]
        if hasattr(tb, "eval_pdf_mueller"):
            got["M_eval"], got["M_pdf"] = tb.eval_pdf_mueller(si, wo_t, nc)
        assert set(got) == set(want), name
        at_wo = _bounds(wi, wo)
        at_sample = _bounds(wi, np.asarray(want["wo"]))
        # a sample of pdf 0 ends its path in both packages, its direction
        # unused (a VNDF sample of a wi below the horizon is ill-conditioned)
        used = np.asarray(want["bs_pdf"]) > 0
        for k in got:
            at = at_wo if k in ("eval", "pdf", "M_eval", "M_pdf") else at_sample
            _close(got[k], want[k], at, f"{variant} {name}.{k}", used if k == "wo" else None)


def test_polarization_optics_act_as_their_elements():
    """The optics' Mueller matrices on the port alone: the polarizer passes
    light polarized along theta and blocks the crossed one, the circular
    polarizer gives V = I, the quarter-wave plate at 45 degrees turns
    horizontal linear light into circular; unpolarized variants see 0.5 T
    (the polarizers) and T (the retarder); every one a Dirac transmission
    wo = -wi of pdf 1."""
    mt.set_variant("rgb_polarized")
    d = mt.cornell_box()
    d.update({k: BSDFS[k] for k in ("polarizer", "circular", "retarder")})
    b = {type(x).__name__: x for x in mt.load_dict(d, device="cpu").bsdfs}
    wi = torch.from_numpy(_directions(8, 3)[:, :] * np.float32([1, 1, 1]))
    si = SI(wi=wi, uv=torch.zeros(8, 2))
    u = torch.full((8,), 0.5)
    th = np.deg2rad(30.0)

    def stokes(angle):
        return torch.tensor([1.0, np.cos(2 * angle), np.sin(2 * angle), 0.0], dtype=torch.float32)

    bs, M = b["PolarizerBSDF"].sample_pol(u, torch.full((8, 2), 0.5), si, 3)
    assert torch.equal(bs.wo, -wi) and bool(bs.delta.all()) and bool((bs.pdf == 1).all())
    assert torch.allclose(M[0, 0] @ stokes(th), 0.9 * stokes(th), atol=1e-6)
    assert torch.allclose(M[0, 0] @ stokes(th + np.pi / 2), torch.zeros(4), atol=1e-6)
    _, M = b["CircularPolarizerBSDF"].sample_pol(u, u[:, None].expand(8, 2), si, 3)
    out = M[0, 0] @ torch.tensor([1.0, 0.0, 0.0, 0.0])
    assert torch.allclose(out, torch.tensor([0.5, 0.0, 0.0, 0.5]))
    _, M = b["RetarderBSDF"].sample_pol(u, u[:, None].expand(8, 2), si, 3)
    out = M[0, 0] @ torch.tensor([1.0, 1.0, 0.0, 0.0])
    assert abs(float(out[3].abs()) - 1.0) < 1e-6 and float(out[1:3].abs().max()) < 1e-6
    for name, scale in (("PolarizerBSDF", 0.45), ("CircularPolarizerBSDF", 0.5),
                        ("RetarderBSDF", 1.0)):
        _, w = b[name].sample(u, u[:, None].expand(8, 2), si, 3)
        assert torch.allclose(w, torch.full((8, 3), scale)), name


def test_fresnel_conductor_and_diffuse_fit_match_jax():
    """fresnel_conductor over cos_theta_i in [0, 1] for the presets' (eta,
    k) per channel and a scalar pair, and fresnel_diffuse_reflectance on
    both sides of eta = 1: the same float32 formulas, XLA's FMAs apart
    (ROADMAP Queue 3). The fit within atol 1e-6; the conductor's
    reflectance, in [0, 1], within 2e-6: (term_1 - term_2) cancels as the
    incidence grazes, and a contracted multiply-add rounds it differently
    (1.13e-6 at cos_theta_i 0.01 for Au's blue channel)."""
    c = np.linspace(0.0, 1.0, 101, dtype=np.float32)[:, None]
    for eta, k in (([0.143, 0.375, 1.442], [3.983, 2.386, 1.603]), ([0.2], [3.0]),
                   ([1.345, 0.965, 0.617], [7.47, 6.40, 5.30])):
        e, kk = np.float32(eta), np.float32(k)
        t = TFR.fresnel_conductor(torch.from_numpy(c), torch.from_numpy(e), torch.from_numpy(kk))
        j = jax.jit(JFR.fresnel_conductor)(jnp.asarray(c), jnp.asarray(e), jnp.asarray(kk))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=2e-6)
        assert bool(((t >= 0) & (t <= 1)).all())
    eta = np.float32([0.5, 0.75, 1 / 1.33, 1.0, 1.33, 1.5046, 2.4])
    np.testing.assert_allclose(TFR.fresnel_diffuse_reflectance(torch.from_numpy(eta)).numpy(),
                               np.asarray(JFR.fresnel_diffuse_reflectance(jnp.asarray(eta))),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("variant,scene", [("rgb", "materials_scene"),
                                           ("rgb_polarized", "polarimeter_scene")])
def test_traverse_keys_and_values_match_jax(variant, scene):
    """traverse() of the materials and polarimeter dicts: the JAX package's
    keys, in its order, letter for letter (roughconductor's ``alpha`` is
    alpha_u alone, the polarization optics' ``theta`` in radians, the
    blend's weight, the mask's opacity, the plastics' diffuse reflectance),
    each value equal (rtol 1e-7). The JAX package cannot read the keys of a
    wrapper's nested BSDF (``back.bsdf.diffuse_reflectance.value`` under
    twosided, ``floor.bsdf.a.reflectance.value`` under the blend): their
    paths name a field of the wrapper, which it lacks, and reading one
    raises AttributeError, witnessed here. The port's paths reach the nested
    BSDF; a standing difference (ROADMAP Queue 3)."""
    mj.set_variant(variant)
    mt.set_variant(variant)
    d = getattr(mt, scene)(res=4, spp=1)
    tp = mt.traverse(mt.load_dict(d, device="cpu"))
    jp = mj.traverse(mj.load_dict(d))
    assert list(tp.keys()) == list(jp.keys())
    unreadable = []
    for k in jp.keys():
        try:
            want = np.asarray(jp[k])
        except AttributeError:
            unreadable.append(k)
            continue
        np.testing.assert_allclose(tp[k].numpy(), want, rtol=1e-7, err_msg=k)
    nested = {"floor.bsdf.a.reflectance.value": d["white"]["reflectance"]["value"],
              "green-wall.bsdf.reflectance.value": d["green"]["reflectance"]["value"]}
    if variant == "rgb":
        nested["back.bsdf.diffuse_reflectance.value"] = [0.6]
    assert sorted(unreadable) == sorted(nested)
    for k, v in nested.items():
        np.testing.assert_array_equal(tp[k].numpy(), np.float32(v), err_msg=k)
    if variant == "rgb":
        assert float(tp["large-box.bsdf.alpha"]) == pytest.approx(0.2)
        s = tp.update({"large-box.bsdf.alpha": torch.tensor(0.5),
                       "back.bsdf.diffuse_reflectance.value": torch.tensor([0.1])})
        b = s.bsdfs[[type(x).__name__ for x in s.bsdfs].index("RoughConductorBSDF")]
        assert (float(b.alpha_u), float(b.alpha_v)) == (0.5, pytest.approx(0.2))
        tw = s.bsdfs[[type(x).__name__ for x in s.bsdfs].index("TwoSidedBSDF")]
        assert torch.equal(tw.nested.diffuse_reflectance.value, torch.tensor([0.1]))
    else:
        assert float(tp["polarizer-sheet.bsdf.theta"]) == pytest.approx(np.deg2rad(30.0))
        assert float(tp["retarder-sheet.bsdf.theta"]) == pytest.approx(np.deg2rad(45.0))
