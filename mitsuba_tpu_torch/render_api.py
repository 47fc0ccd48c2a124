"""Render entry points (counterpart of mitsuba_tpu/render_api.py, with the
independent sampler).

One pass renders width * height * spp_pass lanes, pixel-major. spp is split
into passes of spp_per_pass samples to bound device memory. Lane RNG
streams are keyed by the global sample index, and the film adds a pixel's
samples in sample order (film.accumulate), so the image is bitwise the same
however spp is split.

Everything runs on ``scene.device``: the card unless the scene was loaded
with another device.

Polarized variants carry Stokes radiance [N, C, 4] per lane; render_lanes
rotates each lane's Stokes vector into the sensor's shared frame before
lanes are summed. ``render`` returns [H, W, 4, C] for them,
``render_1``, the radiometer render, [4, C], and ``render_test``, the
multi-view measurement, [views, 4, C]. ``render_progressive`` yields the
image after every pass; ``render``'s ``timeout`` and ``cancel``
(``CancelToken``) stop it at a pass boundary.

Gradients: with the ``path`` integrator, ``render`` is differentiable by
ordinary autograd through the bounce loop (tape mode: every bounce's
tensors stay alive until the backward pass). With a PRB integrator
(``prb``, ``prb_basic``, ``prbvolpath``, ``prb_polarized``,
``prb_volpathaos``), each pass of ``render`` and ``render_1`` is one
autograd node whose backward replays the paths (ad/render_ad.py), in
O(wavefront + parameters) memory; with ``regenerate`` the node is the
regenerative loop's per-pixel sums, and its backward replays that loop.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from .ad.render_ad import derive_seed_grad, prb_pass, prb_regen_px
from .core import spectrum as spec
from .core.rng import MASK32, RNG
from .core.frame import cross, normalize
from .render import mueller as mu
from .render.film import accumulate, develop_sums, sample_filter_offset, spectral_to_film
from .render.params import traverse


def make_wavefront(scene, seed, lane0, n, pass_base, spp_pass, spp_total, sensor_idx=0):
    """(rng, ray, wavelengths, wl_pdf, jitter) of lanes [lane0, lane0 + n)
    of a pass whose samples start at pass_base, pixel-major over the film's
    lane window (wavefront_for)."""
    lane_local = lane0 + torch.arange(n, dtype=torch.int64, device=scene.device)
    pix = lane_local // spp_pass
    s_local = lane_local % spp_pass
    return wavefront_for(scene, seed, pix, pass_base + s_local, spp_total, sensor_idx)


def wavefront_for(scene, seed, pix, sidx, spp_total, sensor_idx=0):
    """make_wavefront for explicit (lane-window pixel, sample index) pairs:
    each lane's RNG stream (keyed by its pixel in the whole film and its
    sample index), camera ray, wavelengths [N, 4] and their pdf [N, 4], and
    in-pixel film offset [N, 2], as the JAX package's make_wavefront
    returns them. The wavelengths are hero wavelengths drawn uniformly over
    [360, 830] nm in the spectral variants, all four pinned to a sensor's
    ``wavelength`` (pdf 1) where it is set, and None, None in the other
    variants."""
    film = scene.film
    sensor = scene.sensors[sensor_idx]
    fpix = film.film_pixel(pix)
    rng = RNG(seed, (fpix * spp_total + sidx) & MASK32)

    # dims 0-1: film-plane jitter; 2-3: aperture; 4: wavelength
    jx, jy, rng = rng.next_2d()
    ax, ay, rng = rng.next_2d()
    uw, _, rng = rng.next_2d()

    jitter = sample_filter_offset(film.rfilter, torch.stack([jx, jy], dim=-1))
    px = (fpix % film.width).to(torch.float32)
    py = (fpix // film.width).to(torch.float32)
    size = torch.tensor([film.width, film.height], dtype=torch.float32, device=pix.device)
    pos = (torch.stack([px, py], dim=-1) + jitter) / size
    ray = sensor.sample_ray(pos, torch.stack([ax, ay], dim=-1))
    wavelengths = wl_pdf = None
    if scene.n_channels == 4:
        wavelengths = spec.sample_wavelengths_hero(uw, n=4)
        wl_pdf = spec.pdf_uniform_wavelength(wavelengths)
        fixed = getattr(sensor, "wavelength", None)
        if fixed is not None:
            use_pin = fixed > 0
            wavelengths = torch.where(use_pin, fixed, wavelengths)
            wl_pdf = torch.where(use_pin, 1.0, wl_pdf)
    return rng, ray, wavelengths, wl_pdf, jitter


def warn_invalid(L, polarized=False, clamp_negative=True):
    """Sanitize per-lane radiance [N, C] (polarized: Stokes [N, C, 4])
    before it reaches the film: NaN/inf values are dropped and negative
    values clamped, for a Stokes vector in I only (Q, U and V are signed).
    With clamp_negative=False (an integrator's signed output: AOV normals,
    positions) only the non-finite values are dropped. Returns (L_clean,
    stats) with the lane counts {'n_invalid', 'n_negative'} as tensors."""
    bad = ~torch.isfinite(L)
    neg = L < 0.0 if clamp_negative else torch.zeros_like(bad)
    if polarized:
        neg[..., 1:] = False
    lane_dims = tuple(range(1, L.ndim))
    n_invalid = torch.any(bad, dim=lane_dims).sum()
    n_negative = torch.any(neg & ~bad, dim=lane_dims).sum()
    L = torch.where(bad | neg, 0.0, L)
    return L, {"n_invalid": n_invalid, "n_negative": n_negative}


def sensor_stokes_rotation(ray_d):
    """Per-lane [N, 4, 4] rotation from the implicit Stokes basis of the
    light arriving along -ray_d to the sensor's shared basis, perpendicular
    to the vertical (+z) (Chowdhary et al. 2020)."""
    fwd = -ray_d
    current = mu.stokes_basis(fwd)
    vertical = torch.zeros_like(fwd)
    vertical[..., 2] = 1.0
    tmp = cross(fwd, vertical)
    is_vertical = torch.sum(tmp * tmp, dim=-1, keepdim=True) < 1e-24
    fallback = torch.zeros_like(fwd)
    fallback[..., 0] = 1.0
    target = torch.where(is_vertical, fallback,
                         cross(fwd, normalize(torch.where(is_vertical, fallback, tmp))))
    return mu.rotate_stokes_basis(fwd, current, target)


def to_sensor_mueller(ray_d, L):
    """Per-lane Stokes vectors L [N, C, 4] rotated into the sensor's shared
    frame, where Stokes vectors of different rays can be summed."""
    R = sensor_stokes_rotation(ray_d)
    return torch.einsum("nij,ncj->nci", R, L)


def render_lanes(scene, seed, lane0, n, pass_base, spp_pass, spp_total, sensor_idx=0,
                 raw=False):
    """Radiance [n, C] (polarized: [n, C, 4] in the sensor frame) of lanes
    [lane0, lane0 + n) of a pass, and the pass's counters (n_rays,
    n_invalid, n_negative) with the lanes' in-pixel offsets
    ("film_jitter", as the JAX package's aux holds them, for a weighted
    filter's film). In the spectral variants (unpolarized) the
    lanes' spectra become the film's channels (film.spectral_to_film);
    with `raw` they stay the wavelength channels, as render_1 returns them
    (the same flag as prb_pass's)."""
    scene = dataclasses.replace(scene, geometry=scene.geometry.refresh())
    rng, ray, wavelengths, wl_pdf, jitter = make_wavefront(
        scene, seed, lane0, n, pass_base, spp_pass, spp_total, sensor_idx)
    active = torch.ones(n, dtype=torch.bool, device=scene.device)
    L, aux = scene.integrator.sample(scene, rng, ray, active, wavelengths)
    # Stokes radiance; an AOV or depth in a polarized variant is [n, C]
    stokes = scene.polarized and L.ndim == 3
    if stokes:
        L = to_sensor_mueller(ray.d, L)
    L, inv_stats = warn_invalid(
        L, stokes, clamp_negative=not getattr(scene.integrator, "signed_output", False))
    if not raw and wavelengths is not None and not scene.polarized:
        L = spectral_to_film(scene.film, L, wavelengths, wl_pdf)
    return L, {**aux, **inv_stats, "film_jitter": jitter}


def regenerates(scene):
    """Whether render takes the regenerative loop: an integrator with
    ``regenerate``, except the surface path tracers (path, prb, prb_basic)
    in the spectral variants, whose regenerative loop has no spectral
    conversion at the flush; they render in plain passes, as in the JAX
    package."""
    integ = scene.integrator
    return (getattr(integ, "regenerate", False)
            and (hasattr(integ, "_bounce") or scene.n_channels != 4))


class CancelToken:
    """Cooperative cancellation of a render: pass one as render(cancel=...)
    and call cancel(), from a signal handler or another thread, to stop the
    render at its next pass boundary with the mean of the passes done."""

    def __init__(self):
        self.cancelled = False

    def cancel(self):
        self.cancelled = True


def _passes(scene, sensor, seed, spp, spp_per_pass, seed_grad, spp_grad, stats):
    """Generator over the passes of a render: after each pass, (samples
    done, the per-pixel sums of every pass so far [H, W, C] or [H, W, C,
    4], the pass's counters). A PRB integrator's pass is one PRB node
    (ad/render_ad.py) whose backward adds its rays to `stats`."""
    film = scene.film
    use_prb = getattr(scene.integrator, "is_prb", False)
    if use_prb:
        # the triangle tables derived from the vertex buffer, so that a
        # vertex parameter's gradient flows into them
        scene = dataclasses.replace(scene, geometry=scene.geometry.refresh())
    acc = None
    done = 0
    while done < spp:
        this_spp = min(spp_per_pass, spp - done)
        jitter = None
        if use_prb:
            L, aux = prb_pass(scene, seed, seed_grad, done, this_spp, spp, sensor, spp_grad,
                              stats)
        else:
            L, aux = render_lanes(scene, seed, 0, film.n_pixels * this_spp, done, this_spp, spp,
                                  sensor)
            jitter = aux.pop("film_jitter")
        acc = accumulate(film, L, this_spp, acc, jitter)
        done += this_spp
        yield done, acc, aux


def render(scene, params=None, sensor=0, seed=0, spp=None, spp_per_pass=None,
           seed_grad=None, integrator=None, spp_grad=None, timeout=None, cancel=None,
           stats=None):
    """Render to an image tensor [H, W, C] on scene.device ([H, W, 4, C]
    Stokes in a polarized variant; mirrors mi.render). `params` may be a
    SceneParameters whose scene is rendered; `integrator` (an instance or
    a scene-dict spec) replaces the scene's integrator for this render.

    An integrator with ``regenerate`` takes the regenerative loop: one
    lane per pixel, all spp in one pass (spp_per_pass, spp_grad, timeout
    and cancel have no effect), and `stats` also gets wavefront_iters, the
    loop's steps; with a PRB integrator the loop is one PRB node whose
    backward replays it (ad/render_ad.py:prb_regen_px). The particle
    tracer (``ptracer``) and the projective integrators
    (``direct_projective``, ``prb_projective``: ad/projective.py) also
    render all spp in one pass, with the same arguments ignored.

    `timeout` (seconds of wall clock) and `cancel` (a CancelToken) stop
    the passes early, at a pass boundary after the first, and return the
    mean of the samples done; when either is given without spp_per_pass,
    spp is split into passes of max(1, spp // 8) samples, and each pass
    ends in a synchronise of the device, so that the clock sees the work
    done and not its dispatch.

    With a PRB integrator, `seed_grad` seeds the backward pass (by default
    the TEA hash of `seed`; a ValueError if it equals `seed`) and
    `spp_grad` gives the backward pass its own sample count (single-pass
    renders only). When `stats` is a dict, it receives the totals over all
    passes of n_rays (closest-hit plus shadow rays cast) and, for the
    forward integrators, n_invalid and n_negative; a PRB render's backward
    pass adds the rays it casts (its own primal and the replay) to
    n_rays_grad."""
    if params is not None and hasattr(params, "scene"):
        scene = params.scene
    if isinstance(integrator, dict):
        from .integrators import make_integrator

        integrator = make_integrator(integrator)
    if integrator is not None:
        scene = dataclasses.replace(scene, integrator=integrator)
    film = scene.film
    spp = spp or scene.spp
    seed_grad = derive_seed_grad(seed, seed_grad)
    if getattr(scene.integrator, "is_ptracer", False):
        return _render_ptracer(scene, seed, spp, sensor, stats)
    if getattr(scene.integrator, "is_projective", False):
        from .ad.projective import projective_render

        return projective_render(scene, seed, spp, sensor, stats)
    if regenerates(scene):
        if getattr(scene.integrator, "is_prb", False):
            return _render_regen_prb(scene, seed, seed_grad, spp, sensor, stats)
        return _render_regen(scene, seed, spp, sensor, stats)
    timed = timeout is not None or cancel is not None
    if spp_per_pass is None and timed:
        spp_per_pass = max(1, spp // 8)
    spp_per_pass = min(spp_per_pass or spp, spp)
    if spp_grad is not None and spp_grad != spp:
        if not getattr(scene.integrator, "is_prb", False):
            raise ValueError("spp_grad needs a PRB integrator (the tape backward "
                             "reuses the forward lanes)")
        if spp_per_pass != spp:
            raise ValueError("spp_grad requires a single pass (spp_per_pass >= spp)")
        if film.weighted:
            # the film weights depend on each sample's offset: spp_grad's
            # refold of the film adjoint is not exact for them
            raise ValueError("spp_grad is exact only for filter-importance-sampled "
                             f"films (box/tent/gaussian), not {film.rfilter!r}")
    t_start = time.monotonic()
    totals = {}
    for done, acc, aux in _passes(scene, sensor, seed, spp, spp_per_pass, seed_grad, spp_grad,
                                  stats):
        for key in ("n_rays", "n_invalid", "n_negative"):
            if key in aux:
                totals[key] = totals.get(key, 0) + aux[key]
        if timed:
            if scene.device.type == "cuda":
                torch.cuda.synchronize(scene.device)
            if ((cancel is not None and cancel.cancelled)
                    or (timeout is not None and time.monotonic() - t_start > timeout)):
                break
    if stats is not None:
        stats.update({k: int(v) for k, v in totals.items()})
    return develop_sums(film, acc, done)


def render_progressive(scene, sensor=0, seed=0, spp=None, spp_per_pass=None):
    """Generator of (samples done, the image of the samples done) after
    every pass of passes of spp_per_pass samples (by default max(1, spp //
    8)): the last image is render(spp_per_pass=...)'s. A regenerative
    integrator, the particle tracer and the projective integrators render
    all their samples in one go and yield once."""
    spp = spp or scene.spp
    integ = scene.integrator
    if (regenerates(scene) or getattr(integ, "is_ptracer", False)
            or getattr(integ, "is_projective", False)):
        yield spp, render(scene, sensor=sensor, seed=seed, spp=spp)
        return
    spp_per_pass = min(spp_per_pass or max(1, spp // 8), spp)
    for done, acc, _ in _passes(scene, sensor, seed, spp, spp_per_pass, derive_seed_grad(seed),
                                None, None):
        yield done, develop_sums(scene.film, acc, done)


def render_1(scene, params=None, sensor=0, seed=0, spp=None, stats=None):
    """Radiometer render (mirrors mi.render_1): the mean of all film
    samples of one pass of spp samples per pixel, [C], or the Stokes vector
    [4, C] in a polarized variant. `stats` receives the pass's counters as
    render's does. With a PRB integrator the pass is one PRB node, whose
    backward is seeded with derive_seed_grad(seed) and adds its rays to
    stats["n_rays_grad"]."""
    if params is not None and hasattr(params, "scene"):
        scene = params.scene
    spp = spp or scene.spp
    L, aux = _one_pass_lanes(scene, seed, spp, sensor, stats)
    if stats is not None:
        stats.update({k: int(v) for k, v in aux.items()})
    m = torch.mean(L, dim=0)
    return m.T if scene.polarized else m


def _one_pass_lanes(scene, seed, spp, sensor, stats=None):
    """(lanes [n_pixels * spp, C] or [n_pixels * spp, C, 4], counters) of
    one pass of spp samples per pixel: a PRB node, its backward seeded with
    derive_seed_grad(seed), for a PRB integrator."""
    if getattr(scene.integrator, "is_prb", False):
        scene = dataclasses.replace(scene, geometry=scene.geometry.refresh())
        return prb_pass(scene, seed, derive_seed_grad(seed), 0, spp, spp, sensor, stats=stats,
                        raw=True)
    L, aux = render_lanes(scene, seed, 0, scene.film.n_pixels * spp, 0, spp, spp, sensor, raw=True)
    aux.pop("film_jitter")
    return L, aux


def render_test(scene, params=None, sensor=0, seed=0, spp=None, sensor_count=1, stats=None):
    """Multi-view measurement (mirrors mi.render_test): one pass of spp
    samples per pixel over a wide film split into sensor_count views of
    equal width, each view's samples averaged: [sensor_count, C], or the
    Stokes vectors [sensor_count, 4, C] in a polarized variant. `stats`
    receives the pass's counters as render_1's does."""
    if params is not None and hasattr(params, "scene"):
        scene = params.scene
    film = scene.film
    spp = spp or scene.spp
    if film.crop_size is not None:
        raise NotImplementedError("render_test of a cropped film is not yet ported")
    L, aux = _one_pass_lanes(scene, seed, spp, sensor, stats)
    if stats is not None:
        stats.update({k: int(v) for k, v in aux.items()})
    views = L.reshape((film.height, sensor_count, film.width // sensor_count, spp)
                      + L.shape[1:])
    out = views.mean(dim=(0, 2, 3))
    return out.transpose(-1, -2) if scene.polarized else out


def _render_regen_pass(scene, seed, spp, sensor_idx):
    """The regenerative loop's per-pixel sample sums [n_pixels, C] (or
    [n_pixels, C, 4]), sanitized as a pass's lanes are, and its counters
    (n_rays, wavefront_iters, n_invalid, n_negative)."""
    scene = dataclasses.replace(scene, geometry=scene.geometry.refresh())
    L_px, aux = scene.integrator.regen_render(scene, seed, spp, sensor_idx)
    L_px, inv = warn_invalid(L_px, scene.polarized)
    return L_px, {**aux, **inv}


def _regen_image(film, L_px, spp):
    """Per-pixel sample sums over the lane window -> the image [H, W, C] or
    [H, W, 4, C] (a weighted filter's film develops as a box average, as
    the JAX package's does)."""
    _, _, w, h = film.lane_window
    return develop_sums(film, L_px.reshape((h, w) + L_px.shape[1:]), float(spp))


def _render_regen(scene, seed, spp, sensor_idx, stats=None):
    """Regenerative render (``regenerate: True``): one lane per pixel, the
    samples summed in the loop; the image is that of one pass of a
    filter-importance-sampled film."""
    L_px, aux = _render_regen_pass(scene, seed, spp, sensor_idx)
    if stats is not None:
        stats.update({k: int(v) for k, v in aux.items()})
    return _regen_image(scene.film, L_px, spp)


def _render_regen_prb(scene, seed, seed_grad, spp, sensor_idx, stats=None):
    """Differentiable regenerative render: the PRB node sits at the
    per-pixel sample sums (ad/render_ad.py:prb_regen_px)."""
    scene = dataclasses.replace(scene, geometry=scene.geometry.refresh())
    L_px, aux = prb_regen_px(scene, seed, seed_grad, spp, sensor_idx, stats)
    if stats is not None:
        stats.update({k: int(v) for k, v in aux.items()})
    return _regen_image(scene.film, L_px, spp)


def _render_ptracer(scene, seed, spp, sensor_idx, stats=None):
    """Adjoint particle tracing: W * H * spp particles splatted onto the
    film, the image their sums over the particle count (rgb and mono)."""
    if scene.polarized or scene.n_channels == 4:
        raise ValueError("ptracer renders in the rgb and mono variants only")
    film = scene.film
    scene = dataclasses.replace(scene, geometry=scene.geometry.refresh())
    # the whole film (a crop window is ignored, as in the JAX package)
    n = film.width * film.height * spp
    rng = RNG(seed, torch.arange(n, dtype=torch.int64, device=scene.device))
    acc, aux = scene.integrator.trace_particles(scene, rng, n, sensor_idx)
    if stats is not None:
        stats.update({k: int(v) for k, v in aux.items()})
    return (acc / n).reshape(film.height, film.width, -1)


def render_forward(scene, tangent=None, key=None, sensor=0, seed=0, spp=None):
    """Forward-mode derivative of the image along a parameter direction:
    d image / d params[key] . tangent. The reference takes a whole
    scene-tangent pytree as `tangent`; PyTorch has none, so here `tangent`
    is the direction for the one parameter `key` (ones when not given), and
    a call without `key` raises ValueError as the reference's does without
    either argument. The path integrator is differentiated by tape (two
    reverse passes: the derivative of the VJP with respect to its
    cotangent); a PRB integrator implements the reverse replay only and
    raises, as in the JAX package."""
    if getattr(scene.integrator, "is_prb", False):
        raise NotImplementedError(
            "render_forward requires a tape-differentiable integrator (path); "
            "PRB integrators implement the reverse replay only"
        )
    if key is None:
        raise ValueError("render_forward needs `tangent` or `key`" if tangent is None else
                         "render_forward: without a scene-tangent pytree, `tangent` is the "
                         "direction of one parameter and needs its `key`")
    params = traverse(scene)
    value = params[key].detach().clone().requires_grad_()
    img = render(params.update({key: value}), sensor=sensor, seed=seed, spp=spp)
    tangent = torch.ones_like(value) if tangent is None else torch.as_tensor(
        tangent, dtype=torch.float32, device=value.device).expand(value.shape)
    cot = torch.zeros_like(img, requires_grad=True)
    (vjp,) = torch.autograd.grad(img, value, grad_outputs=cot, create_graph=True)
    (jvp,) = torch.autograd.grad(vjp, cot, grad_outputs=tangent)
    return jvp
