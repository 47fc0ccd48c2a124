"""The polarized slice of the PyTorch port against the JAX package: the
mono and polarized variants, Mueller calculus, the Mie solver, the size
distributions and the baked Mie phase, the tabulated, Rayleigh and blended
phases, the directional sun and the radiancemeter, and BASELINE config 4
(the Rayleigh + Mie atmosphere) through volpath and render_1.

Inputs are made from numpy seeds and go through both packages on the CPU.
The JAX package's config 4 scene (its bake and its render_1) is computed
once per module (module fixtures). Tolerances are stated at each check.
"""
import pathlib
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mitsuba_tpu as mj
from mitsuba_tpu.core.frame import cross as j_cross, normalize as j_normalize
from mitsuba_tpu.render import mueller as JMU
from mitsuba_tpu.render import phase as JPH
from mitsuba_tpu.render import phase_polarized as JPP
from mitsuba_tpu.render import sizedistr as JSD
from mitsuba_tpu.render.fresnel import fresnel_polarized as j_fresnel_polarized
from mitsuba_tpu.render.mie import mie as j_mie, mie_nmax
from mitsuba_tpu.render.records import MediumInteraction as JMI
from mitsuba_tpu.render_api import sensor_stokes_rotation as j_sensor_stokes_rotation

import mitsuba_tpu_torch as mt
from mitsuba_tpu_torch.core.frame import cross as t_cross, normalize as t_normalize
from mitsuba_tpu_torch.render import mueller as TMU
from mitsuba_tpu_torch.render import phase as TPH
from mitsuba_tpu_torch.render import phase_polarized as TPP
from mitsuba_tpu_torch.render import sizedistr as TSD
from mitsuba_tpu_torch.render.fresnel import fresnel_polarized as t_fresnel_polarized
from mitsuba_tpu_torch.render.media import parse_phase as t_parse_phase
from mitsuba_tpu_torch.render.mie import mie as t_mie
from mitsuba_tpu_torch.render.records import MediumInteraction as TMI
from mitsuba_tpu_torch.render_api import sensor_stokes_rotation as t_sensor_stokes_rotation, warn_invalid

REPO = pathlib.Path(__file__).resolve().parents[1]
ATMO_RES, ATMO_SPP = 4, 16


@pytest.fixture(autouse=True)
def _rgb():
    yield
    mj.set_variant("rgb")
    mt.set_variant("rgb")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: MKL's first vector-math call from two threads
    can run its low-accuracy kernel on one chunk (ROADMAP Queue 3)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(t, j, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(_np(t), _np(j), rtol=rtol, atol=atol)


def _unit(n, seed):
    v = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _jit(f, *args):
    """f(*args) through the JAX package as one compiled program (cheaper
    on the CPU than an eager compile of each operation)."""
    return jax.jit(f)(*args)


def _pair(a):
    """(torch, jax) views of one float32 numpy array."""
    a = np.asarray(a, np.float32)
    return torch.from_numpy(a), jnp.asarray(a)


# ---------------------------------------------------------------------------
# variants
# ---------------------------------------------------------------------------

def test_variants_set_the_channel_layout():
    """mono, mono_polarized, rgb_polarized and the spectral variants
    (C = 4 wavelengths) under their reference names."""
    for name, nc, pol in (("mono", 1, False), ("llvm_ad_mono", 1, False),
                          ("mono_polarized", 1, True), ("llvm_ad_mono_polarized", 1, True),
                          ("rgb_polarized", 3, True), ("scalar_rgb", 3, False),
                          ("spectral", 4, False), ("spectral_polarized", 4, True),
                          ("llvm_ad_spectral", 4, False)):
        mt.set_variant(name)
        mj.set_variant(name)
        v = mt.current_variant()
        assert (v.n_channels, v.polarized) == (nc, pol)
        assert mt.variant() == mj.variant()
    with pytest.raises(ValueError):
        mt.set_variant("no_such_variant")


def test_port_sources_import_no_jax():
    """No module of the port imports jax, flax or the JAX package."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|mitsuba_tpu)(\.|\s|$)", re.M)
    hits = [str(p) for p in (REPO / "mitsuba_tpu_torch").rglob("*.py") if pat.search(p.read_text())]
    assert hits == []


# ---------------------------------------------------------------------------
# Mueller calculus: tests/test_polarized.py's units, each through both
# packages on the same inputs (atol 1e-6 unless stated), then the unit's
# own physics check on the port's result
# ---------------------------------------------------------------------------

def _case_rotator(T, J):
    s = [1.0, 1.0, 0.0, 0.0]
    t = T.rotator(torch.tensor(np.deg2rad(45.0), dtype=torch.float32)) @ torch.tensor(s)
    j = _jit(lambda v: J.rotator(jnp.deg2rad(45.0)) @ v, jnp.asarray(s))
    _close(t, j)
    _close(t, [1, 0, -1, 0])


def _case_malus(T, J):
    s = [1.0, 1.0, 0.0, 0.0]
    for theta in (0.0, 30.0, 45.0, 90.0):
        th = np.float32(np.deg2rad(theta))
        t = T.rotated_element(torch.tensor(th), T.linear_polarizer(1.0)) @ torch.tensor(s)
        j = _jit(lambda a, v: J.rotated_element(a, J.linear_polarizer(1.0)) @ v,
                 jnp.asarray(th), jnp.asarray(s))
        _close(t, j)
        assert float(t[0]) == pytest.approx(np.cos(np.deg2rad(theta)) ** 2, abs=1e-6)


def _case_reflection_normal(T, J):
    t = T.specular_reflection(torch.tensor(1.0), 1.5 + 0j)
    j = _jit(lambda c: J.specular_reflection(c, jnp.asarray(1.5 + 0j)), jnp.asarray(1.0))
    _close(t, j)
    assert float(t[0, 0]) == pytest.approx(0.04, abs=1e-4)
    assert abs(float(t[0, 1])) < 1e-6


def _case_brewster(T, J):
    c = np.float32(np.cos(np.arctan(1.5)))
    t = T.specular_reflection(torch.tensor(c), 1.5 + 0j)
    j = _jit(lambda x: J.specular_reflection(x, jnp.asarray(1.5 + 0j)), jnp.asarray(c))
    _close(t, j)
    assert abs(float(t[0, 1])) / float(t[0, 0]) == pytest.approx(1.0, abs=1e-4)


def _case_stokes_roundtrip(T, J):
    f = _unit(50, 0)
    ft, fj = _pair(f)
    b0t = T.stokes_basis(ft)
    b1t = t_normalize(b0t + 0.5 * t_cross(ft, b0t))
    R01t = T.rotate_stokes_basis(ft, b0t, b1t)

    def jax_side(f):
        b0 = J.stokes_basis(f)
        return b0, J.rotate_stokes_basis(f, b0, j_normalize(b0 + 0.5 * j_cross(f, b0)))

    b0j, R01j = _jit(jax_side, fj)
    _close(b0t, b0j)
    _close(R01t, R01j, atol=1e-5)
    I = T.rotate_stokes_basis(ft, b1t, b0t) @ R01t
    _close(I, np.broadcast_to(np.eye(4), I.shape), atol=1e-5)


def _case_rayleigh_90(T, J):
    t = T.rayleigh_scatter(torch.tensor(0.0), torch.tensor(1.0), 0.0)
    j = _jit(J.rayleigh_scatter, jnp.asarray(0.0), jnp.asarray(1.0), jnp.asarray(0.0))
    _close(t, j)
    assert abs(float(t[1, 0])) / float(t[0, 0]) == pytest.approx(1.0, abs=1e-6)


def _case_elements(T, J):
    """The other generators, over random arguments (rtol 1e-5)."""
    r = np.random.default_rng(1)
    x, y = r.random(16).astype(np.float32), r.random(16).astype(np.float32)
    ph = (r.random(16) * 6).astype(np.float32)
    for ft, fj, args in ((T.depolarizer, J.depolarizer, (x,)), (T.absorber, J.absorber, (x,)),
                         (T.linear_polarizer, J.linear_polarizer, (x,)),
                         (T.linear_retarder, J.linear_retarder, (ph,)),
                         (T.diattenuator, J.diattenuator, (x, y)), (T.rotator, J.rotator, (ph,))):
        _close(ft(*(torch.from_numpy(a) for a in args)), _jit(fj, *(jnp.asarray(a) for a in args)),
               rtol=1e-5)
    for left in (False, True):
        _close(T.circular_polarizer(0.7, left), J.circular_polarizer(0.7, left))
    _close(T.right_circular_polarizer(), J.right_circular_polarizer())
    _close(T.left_circular_polarizer(), J.left_circular_polarizer())


def _case_fresnel(T, J):
    """fresnel_polarized and the specular Mueller matrices over both sides
    of a dielectric and a conductor (rtol 1e-5, atol 1e-6)."""
    cos_i = np.linspace(-1.0, 1.0, 41).astype(np.float32)
    ct, cj = _pair(cos_i)
    for eta in (1.5 + 0j, 1.0 / 1.33 + 0j, 0.2 + 3.0j):
        jf, jr = _jit(lambda c: (j_fresnel_polarized(c, eta),
                                 J.specular_reflection(c, jnp.asarray(eta))), cj)
        for a, b in zip(t_fresnel_polarized(ct, eta), jf):
            _close(a, b, rtol=1e-5)
        _close(T.specular_reflection(ct, eta), jr, rtol=1e-5)
    for eta in (1.5, 1.0 / 1.33):
        _close(T.specular_transmission(ct, eta),
               _jit(lambda c: J.specular_transmission(c, eta), cj), rtol=1e-5, atol=1e-5)


def _case_mie_scatter(T, J):
    r = np.random.default_rng(2)
    s1 = (r.normal(size=32) + 1j * r.normal(size=32)).astype(np.complex64)
    s2 = (r.normal(size=32) + 1j * r.normal(size=32)).astype(np.complex64)
    ns = (1.0 + r.random(32)).astype(np.float32)
    _close(T.mie_scatter(torch.from_numpy(s1), torch.from_numpy(s2), torch.from_numpy(ns)),
           _jit(J.mie_scatter, jnp.asarray(s1), jnp.asarray(s2), jnp.asarray(ns)), rtol=1e-5)


def _case_frames(T, J):
    """rotate_mueller_basis, to_world_mueller and unit_angle on random
    directions and matrices (atol 1e-5)."""
    n = 64
    M = np.random.default_rng(3).normal(size=(n, 2, 4, 4)).astype(np.float32)
    a, b = _unit(n, 4), _unit(n, 5)
    (at, aj), (bt, bj), (Mt, Mj) = _pair(a), _pair(b), _pair(M)
    ft = t_normalize(t_cross(at, bt))
    mei_t = TMI.make(torch.zeros(n), torch.zeros(n, 3), bt, torch.zeros(n, dtype=torch.int64))

    def jax_side(a, b, M):
        f = j_normalize(j_cross(a, b))
        mei = JMI.make(jnp.zeros(n), jnp.zeros((n, 3)), b, jnp.zeros(n, jnp.int32))
        mat3 = jnp.stack([mei.sh_s, mei.sh_t, mei.sh_n], axis=-1)
        return (J.unit_angle(a, b),
                J.rotate_mueller_basis(M[:, 0], f, a, J.stokes_basis(f), f, b, J.stokes_basis(f)),
                J.to_world_mueller(M, -a, b, mat3))

    ua, rm, tw = _jit(jax_side, aj, bj, Mj)
    _close(T.unit_angle(at, bt), ua, atol=1e-5)
    _close(T.rotate_mueller_basis(Mt[:, 0], ft, at, T.stokes_basis(ft), ft, bt, T.stokes_basis(ft)),
           rm, atol=1e-5)
    _close(T.to_world_mueller(Mt, -at, bt, mei_t.sh_s, mei_t.sh_t, mei_t.sh_n), tw, atol=1e-5)


MUELLER_CASES = {
    "rotator": _case_rotator, "malus": _case_malus, "reflection_normal": _case_reflection_normal,
    "brewster": _case_brewster, "stokes_roundtrip": _case_stokes_roundtrip,
    "rayleigh_90": _case_rayleigh_90, "elements": _case_elements, "fresnel": _case_fresnel,
    "mie_scatter": _case_mie_scatter, "frames": _case_frames,
}


@pytest.mark.parametrize("case", sorted(MUELLER_CASES))
def test_mueller_units_match_jax(case):
    MUELLER_CASES[case](TMU, JMU)


def test_sensor_stokes_rotation_and_sanitizer():
    """The per-lane rotation into the sensor frame (vertical directions
    included) against JAX (atol 1e-6); the sanitizer clamps a negative I
    but keeps signed Q/U/V."""
    d = np.concatenate([_unit(30, 6), [[0, 0, 1], [0, 0, -1]]]).astype(np.float32)
    dt, dj = _pair(d)
    _close(t_sensor_stokes_rotation(dt), _jit(j_sensor_stokes_rotation, dj))
    L = torch.tensor([[[1.0, -0.5, 0.2, -0.1]], [[-1.0, 0.3, -0.2, 0.0]],
                      [[float("nan"), 0.0, 0.0, 0.0]]])
    Lc, st = warn_invalid(L, polarized=True)
    assert torch.equal(Lc[0], L[0])
    assert torch.equal(Lc[1], torch.tensor([[0.0, 0.3, -0.2, 0.0]]))
    assert torch.equal(Lc[2], torch.zeros(1, 4))
    assert int(st["n_negative"]) == 1 and int(st["n_invalid"]) == 1


# ---------------------------------------------------------------------------
# the Mie solver and the size distributions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("x,m", [(0.5, 1.33 + 0.0j), (5.0, 1.33 + 0.0j), (10.0, 1.50 + 0.0j),
                                 (30.0, 1.33 + 1e-3j), (100.0, 1.33 + 0.0j)])
def test_mie_matches_jax(x, m):
    """S1, S2, Ns, Cs and Ct at tests/test_mie_gold.py's (x, m) points
    over 21 cosines: rtol 1e-4, atol 1e-6 of each quantity's largest
    magnitude (the downward recurrences may differ in the last places)."""
    mus = np.linspace(-0.95, 0.95, 21).astype(np.float32)
    nmax = mie_nmax(x)
    got = t_mie(2.0 * np.pi, torch.from_numpy(mus), x, 1.0 + 0.0j, m, nmax)
    ref = _jit(lambda c: j_mie(2.0 * np.pi, c, x, 1.0 + 0.0j, m, nmax), jnp.asarray(mus))
    for t, j in zip(got, ref):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-4, atol=1e-6 * np.abs(j).max())


SIZEDISTRS = {
    "monodisperse": {"type": "monodisperse", "radius": 800.0},
    "gamma": {"type": "gamma", "a": 600.0, "b": 0.3, "min_radius": 200.0,
              "max_radius": 1500.0, "gauss_points": 24},
    "lognormal": {"type": "lognormal", "mean_radius": 900.0, "std": 1.6, "min_radius": 100.0,
                  "max_radius": 4000.0, "gauss_points": 32},
    "powerlaw": {"type": "powerlaw", "exponent": 3.5, "min_radius": 300.0,
                 "max_radius": 3000.0, "gauss_points": 40},
}


@pytest.mark.parametrize("name", sorted(SIZEDISTRS))
def test_size_distribution_normalisation_matches_jax(name):
    """Nodes, weights and normalized densities against JAX (rtol 1e-5);
    the quadrature of the normalized density is 1 (rtol 1e-5); a write to
    a parameter re-derives the normalization."""
    spec = SIZEDISTRS[name]
    paths = []
    td = TSD.parse_sizedistr(spec, "cpu", paths, "sd", ("sd",))
    jd = JSD.parse_sizedistr(spec)
    for a, b in zip(td.eval_gauss_all(), jd.eval_gauss_all()):
        _close(a, b, rtol=1e-5, atol=0.0)
    r, w, f = td.eval_gauss_all()
    assert float(torch.sum(w * f)) == pytest.approx(1.0, rel=1e-5)
    assert [k for k, _ in paths] == {"monodisperse": ["sd.radius"], "gamma": ["sd.a", "sd.b"],
                                     "lognormal": ["sd.mean_radius", "sd.std"],
                                     "powerlaw": ["sd.exponent"]}[name]
    if name == "gamma":
        td2 = TSD.GammaSizeDistr(**{**td.__dict__, "b": torch.tensor(0.4)}).parameters_changed()
        jd2 = jd.replace(b=jnp.asarray(0.4, jnp.float32)).parameters_changed()
        _close(td2.normalization, jd2.normalization, rtol=1e-5, atol=0.0)


# ---------------------------------------------------------------------------
# config 4: the JAX package's scene, computed once
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_atmo():
    """The JAX package's config 4 scene at 4x4 and its render_1 at 16 spp."""
    mj.set_variant("mono_polarized")
    try:
        scene = mj.load_dict(mt.atmo_scene(ATMO_RES, ATMO_SPP))
        stokes = np.asarray(mj.render_1(scene, spp=ATMO_SPP, seed=0))
    finally:
        mj.set_variant("rgb")
    return scene, stokes


@pytest.fixture(scope="module")
def port_atmo():
    mt.set_variant("mono_polarized")
    try:
        scene = mt.load_dict(mt.atmo_scene(ATMO_RES, ATMO_SPP), device="cpu")
        stats = {}
        stokes = mt.render_1(scene, spp=ATMO_SPP, seed=0, stats=stats)
    finally:
        mt.set_variant("rgb")
    return scene, stokes, stats


def test_atmo_bake_matches_jax(jax_atmo, port_atmo):
    """The Mie phase of config 4, baked by the port on the scene's device,
    against the JAX package's bake: nodes equal, M11/M12/M33/M34 within
    rtol 1e-4, atol 1e-6 max|M11|."""
    tb, jb = port_atmo[0].phases[0].phase_b, jax_atmo[0].phases[0].phase_b
    assert isinstance(tb, TPP.TabPhasePolarized) and tb.nodes.shape == (128,)
    np.testing.assert_array_equal(tb.nodes.numpy(), np.asarray(jb.nodes))
    scale = float(np.abs(np.asarray(jb.m11)).max())
    for k in ("m11", "m12", "m33", "m34"):
        np.testing.assert_allclose(getattr(tb, k).numpy(), np.asarray(getattr(jb, k)),
                                   rtol=1e-4, atol=1e-6 * scale)


def _mei_pair(n, seed):
    d = _unit(n, seed)
    (dt, dj), (pt, pj) = _pair(d), _pair(np.zeros((n, 3), np.float32))
    return (TMI.make(torch.zeros(n), pt, dt, torch.zeros(n, dtype=torch.int64)),
            JMI.make(jnp.zeros(n), pj, dj, jnp.zeros(n, jnp.int32)))


def _phases(jax_atmo):
    """(port, JAX) pairs: the JAX bake of config 4 as a TabPhasePolarized
    in both packages (the same tables), Rayleigh, and their blend."""
    jb = jax_atmo[0].phases[0].phase_b
    tabs = {k: np.asarray(getattr(jb, k)) for k in ("nodes", "m11", "m12", "m33", "m34")}
    tt = TPP.TabPhasePolarized(**{k: torch.from_numpy(v.copy()) for k, v in tabs.items()})
    rt, rj = TPH.RayleighPhase(rho=torch.tensor(0.03)), JPH.RayleighPhase(rho=jnp.asarray(0.03))
    w = np.float32(0.4)
    return {"tabphase_polarized": (tt, jb), "rayleigh": (rt, rj),
            "blendphase": (TPP.BlendPhase(rt, tt, torch.tensor(w)),
                           JPP.BlendPhase(rj, jb, jnp.asarray(w)))}


@pytest.mark.parametrize("name", ["tabphase_polarized", "rayleigh", "blendphase"])
def test_phase_sample_and_eval_match_jax(jax_atmo, name):
    """sample, eval_pdf and eval_pdf_mueller on the same u and directions:
    directions, weights and pdfs within rtol 1e-4 / atol 1e-5, the Mueller
    matrices within atol 1e-5 of their scale; the sampled pdf equals the
    evaluated one (rtol 1e-5)."""
    tp, jp = _phases(jax_atmo)[name]
    n = 4096
    mt_, mj_ = _mei_pair(n, 8)
    u = np.random.default_rng(9).random((n, 3)).astype(np.float32)
    (u1t, u1j), (u2t, u2j) = _pair(u[:, 0]), _pair(u[:, 1:])
    two, tw, tpdf = tp.sample(mt_, u1t, u2t, 1)
    jwo, jw, jpdf = _jit(lambda a, b: jp.sample(mj_, a, b, None, 1), u1j, u2j)
    _close(two, jwo, rtol=1e-4, atol=1e-5)
    _close(tw, jw, rtol=1e-4, atol=1e-5)
    _close(tpdf, jpdf, rtol=1e-4, atol=1e-5)
    _, tpdf2 = tp.eval_pdf(mt_, two, 1)
    _close(tpdf, tpdf2, rtol=1e-5, atol=0.0)
    wo = _unit(n, 10)
    wt, wj = _pair(wo)
    for a, b in zip(tp.eval_pdf(mt_, wt, 1), _jit(lambda w: jp.eval_pdf(mj_, w, None, 1), wj)):
        _close(a, b, rtol=1e-4, atol=1e-6)
    Mt, pt = tp.eval_pdf_mueller(mt_, wt, 1)
    Mj, pj = _jit(lambda w: jp.eval_pdf_mueller(mj_, w, None, 1), wj)
    _close(pt, pj, rtol=1e-4, atol=1e-6)
    _close(Mt, Mj, atol=1e-5 * float(np.abs(np.asarray(Mj)).max()))


def test_tabphase_polarized_from_tables():
    """A tabphase_polarized given as tables in the dict (a comma string
    among them) is parsed as the JAX package parses it."""
    spec = {"type": "tabphase_polarized", "m11": "1.0, 0.5, 2.0", "m12": [0.1, -0.2, 0.3],
            "m33": [0.9, 0.4, 1.8], "m34": [0.0, 0.1, 0.0]}
    paths_t, paths_j = [], []
    tp = t_parse_phase(spec, paths_t, "p", ("phases", 0), "cpu")
    jp = JPP.parse_polarized_phase(spec, paths_j, "p", ("phases", 0))
    assert paths_t == paths_j
    for k in ("nodes", "m11", "m12", "m33", "m34"):
        _close(getattr(tp, k), getattr(jp, k))


def test_directional_emitter_matches_jax(jax_atmo, port_atmo):
    """The sun of config 4: direction samples and weights against JAX
    (atol 1e-5), a delta emitter (pdf 1, delta set) that no ray hits."""
    ts, js = port_atmo[0], jax_atmo[0]
    ref_p = (np.random.default_rng(11).random((256, 3)) * 40 - 20).astype(np.float32)
    (pt, pj), (ut, uj) = _pair(ref_p), _pair(np.zeros((256, 2), np.float32))
    tds, tw = ts.sample_emitter_direction(pt, torch.zeros(256), ut, torch.ones(256, dtype=torch.bool),
                                          test_visibility=False)
    jds, jw = _jit(lambda p, u: js.sample_emitter_direction(
        p, jnp.zeros(256), u, None, jnp.ones(256, bool), test_visibility=False), pj, uj)
    for k in ("p", "n", "d", "dist", "pdf"):
        _close(getattr(tds, k), getattr(jds, k), rtol=1e-6, atol=1e-5)
    _close(tw, jw)
    assert bool(tds.delta.all()) and float(ts.bbox_radius) == pytest.approx(float(js.bbox_radius))
    assert ts.emitters[0].is_delta and ts.env_emitter == -1


def test_atmo_render_1_matches_jax(jax_atmo, port_atmo):
    """Config 4's render_1 at 4x4 @ 16 spp, seed 0: the same samples as
    the JAX package, so I within rtol 1e-3 and Q/U/V within 1e-3 I; the
    light is partially polarized (0 < DoLP < 1); the sun is hit through the
    null slab by K1's plain version."""
    _, js = jax_atmo
    _, ts, stats = port_atmo
    assert tuple(ts.shape) == (4, 1) and js.shape == (4, 1)
    I, Q, U, V = ts[:, 0].tolist()
    assert I == pytest.approx(float(js[0, 0]), rel=1e-3)
    np.testing.assert_allclose(ts[1:, 0].numpy(), js[1:, 0], rtol=0.0, atol=1e-3 * I)
    dolp = np.sqrt(Q * Q + U * U + V * V) / I
    assert 0.0 < dolp < 1.0
    assert stats["n_invalid"] == 0 and stats["n_rays"] > ATMO_RES * ATMO_RES * ATMO_SPP


def test_atmo_render_is_the_film_mean(port_atmo):
    """render on the radiancemeter's film is Stokes-major [H, W, 4, C], and
    its mean over the pixels is render_1's vector (rtol 1e-5)."""
    mt.set_variant("mono_polarized")
    img = mt.render(port_atmo[0], spp=ATMO_SPP, seed=0)
    assert tuple(img.shape) == (ATMO_RES, ATMO_RES, 4, 1)
    _close(img.mean(dim=(0, 1)), port_atmo[1], rtol=1e-5, atol=1e-7)


def test_rgb_polarized_cbox_intensity_is_the_unpolarized_render():
    """tests/test_polarized.py's diffuse-only case in the port: the Cornell
    box through volpath at 16x16 @ 4 spp, rgb_polarized against rgb. The
    depolarizer chains keep the intensity and draw the same numbers, so I
    equals the rgb image (atol 1e-4) and Q/U/V stay below 1e-4."""
    d = mt.cornell_box()
    d["sensor"]["film"]["width"] = d["sensor"]["film"]["height"] = 16
    d["integrator"] = {"type": "volpath", "max_depth": 4}
    mt.set_variant("rgb")
    img_u = mt.render(mt.load_dict(d, device="cpu"), spp=4, seed=4)
    mt.set_variant("rgb_polarized")
    d["integrator"] = {"type": "path", "max_depth": 4}    # path is volpath when polarized
    img_p = mt.render(mt.load_dict(d, device="cpu"), spp=4, seed=4)
    assert tuple(img_p.shape) == (16, 16, 4, 3)
    _close(img_p[:, :, 0, :], img_u, rtol=0.0, atol=1e-4)
    assert float(img_p[:, :, 1:, :].abs().max()) < 1e-4


def test_mono_textures_are_luminance():
    """In mono, an rgb reflectance or radiance becomes its luminance and a
    scalar stays itself, as in the JAX package (rtol 1e-6); the port's mono
    Cornell box renders one channel."""
    from mitsuba_tpu.render.textures import ConstantTexture as JTex
    from mitsuba_tpu_torch.render.textures import ConstantTexture as TTex

    uv = np.zeros((5, 2), np.float32)
    for v in ([0.570068, 0.0430135, 0.0443706], [18.387, 13.9873, 6.75357], [0.25]):
        vt, vj = _pair(v)
        for nc in (1, 3):
            _close(TTex(value=vt).eval(torch.from_numpy(uv), nc),
                   JTex(value=vj).eval(jnp.asarray(uv), None, nc), rtol=1e-6, atol=0.0)
    d = mt.cornell_box()
    d["sensor"]["film"]["width"] = d["sensor"]["film"]["height"] = 8
    mt.set_variant("mono")
    img = mt.render(mt.load_dict(d, device="cpu"), spp=2, seed=1)
    assert tuple(img.shape) == (8, 8, 1) and bool(img.isfinite().all()) and float(img.mean()) > 0


def test_rayleigh_single_scatter_polarization():
    """tests/test_polarized.py's Rayleigh case in the port, at 4x4 @ 256
    spp: an unpolarized sun straight down on an optically thin Rayleigh slab
    (rho 0), seen at 90 degrees, gives strongly linearly polarized light,
    Q-dominant in the sensor's vertical-referenced frame."""
    mt.set_variant("mono_polarized")
    d = {
        "type": "scene",
        "integrator": {"type": "volpath", "max_depth": 2},
        "sun": {"type": "directional", "direction": [0, 0, -1], "irradiance": 10.0},
        "slab": {"type": "cube", "to_world": [{"type": "scale", "value": [20.0, 20.0, 0.5]}],
                 "bsdf": {"type": "null"}, "interior": {"type": "ref", "id": "atmo"}},
        "atmo": {"type": "homogeneous", "sigma_t": 0.05, "albedo": 1.0,
                 "phase": {"type": "rayleigh", "depolarization": 0.0}},
        "sensor": {"type": "radiancemeter",
                   "to_world": [{"type": "look_at", "origin": [-25.0, 0.0, 0.0],
                                 "target": [1, 0, 0], "up": [0, 0, 1]}],
                   "film": {"type": "hdrfilm", "width": 4, "height": 4, "rfilter": {"type": "box"}}},
    }
    I, Q, U, V = mt.render_1(mt.load_dict(d, device="cpu"), spp=256, seed=0)[:, 0].tolist()
    assert I > 0
    dolp = np.sqrt(Q * Q + U * U + V * V) / I
    assert dolp > 0.85, (I, Q, U, V, dolp)
    assert abs(Q) / I > 0.8
    assert abs(U) / I < 0.1 and abs(V) / I < 0.05


def test_atmo_load_without_device_needs_cuda(monkeypatch):
    """Config 4 loads on the card by default: without one, load_dict raises
    before any work (the Mie bake included) instead of falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mt.set_variant("mono_polarized")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.load_dict(mt.atmo_scene())
