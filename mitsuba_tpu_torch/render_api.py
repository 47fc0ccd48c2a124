"""Render entry point (counterpart of mitsuba_tpu/render_api.py, the forward
path with the independent sampler).

One pass renders width * height * spp_pass lanes, pixel-major. spp is split
into passes of spp_per_pass samples to bound device memory. Lane RNG
streams are keyed by the global sample index, and the film adds a pixel's
samples in sample order (film.accumulate), so the image is bitwise the same
however spp is split.

Everything runs on ``scene.device``: the card unless the scene was loaded
with another device.
"""
from __future__ import annotations

import dataclasses

import torch

from .core.rng import MASK32, RNG
from .render.film import accumulate, sample_filter_offset


def make_wavefront(scene, seed, lane0, n, pass_base, spp_pass, spp_total, sensor_idx=0):
    """(rng, ray, jitter): per-lane RNG streams, camera rays and in-pixel
    film offsets for lanes [lane0, lane0 + n) of a pass whose samples start
    at pass_base."""
    lane_local = lane0 + torch.arange(n, dtype=torch.int64, device=scene.device)
    pix = lane_local // spp_pass
    s_local = lane_local % spp_pass
    return wavefront_for(scene, seed, pix, pass_base + s_local, spp_total, sensor_idx)


def wavefront_for(scene, seed, pix, sidx, spp_total, sensor_idx=0):
    """make_wavefront for explicit (pixel, sample index) pairs."""
    film = scene.film
    sensor = scene.sensors[sensor_idx]
    rng = RNG(seed, (pix * spp_total + sidx) & MASK32)

    # dims 0-1: film-plane jitter; 2-3: aperture; 4: wavelength
    jx, jy, rng = rng.next_2d()
    ax, ay, rng = rng.next_2d()
    _, _, rng = rng.next_2d()

    jitter = sample_filter_offset(film.rfilter, torch.stack([jx, jy], dim=-1))
    px = (pix % film.width).to(torch.float32)
    py = (pix // film.width).to(torch.float32)
    size = torch.tensor([film.width, film.height], dtype=torch.float32, device=pix.device)
    pos = (torch.stack([px, py], dim=-1) + jitter) / size
    ray = sensor.sample_ray(pos, torch.stack([ax, ay], dim=-1))
    return rng, ray, jitter


def warn_invalid(L):
    """Sanitize per-lane radiance [N, 3] before it reaches the film: NaN/inf
    values are dropped and negative values clamped. Returns (L_clean,
    stats) with the lane counts {'n_invalid', 'n_negative'} as tensors."""
    bad = ~torch.isfinite(L)
    neg = L < 0.0
    n_invalid = torch.any(bad, dim=1).sum()
    n_negative = torch.any(neg & ~bad, dim=1).sum()
    L = torch.where(bad | neg, 0.0, L)
    return L, {"n_invalid": n_invalid, "n_negative": n_negative}


def render_lanes(scene, seed, lane0, n, pass_base, spp_pass, spp_total, sensor_idx=0):
    """Radiance [n, 3] of lanes [lane0, lane0 + n) of a pass, and the
    pass's counters (n_rays, n_invalid, n_negative)."""
    scene = dataclasses.replace(scene, geometry=scene.geometry.refresh())
    rng, ray, _ = make_wavefront(
        scene, seed, lane0, n, pass_base, spp_pass, spp_total, sensor_idx
    )
    active = torch.ones(n, dtype=torch.bool, device=scene.device)
    L, aux = scene.integrator.sample(scene, rng, ray, active)
    L, inv_stats = warn_invalid(L)
    return L, {**aux, **inv_stats}


def render(scene, params=None, sensor=0, seed=0, spp=None, spp_per_pass=None, stats=None):
    """Render to an image tensor [H, W, 3] on scene.device (mirrors
    mi.render). `params` may be a SceneParameters whose scene is rendered.
    When `stats` is a dict, it receives the totals over all passes of
    n_rays (closest-hit plus shadow rays cast), n_invalid and n_negative."""
    if params is not None and hasattr(params, "scene"):
        scene = params.scene
    film = scene.film
    spp = spp or scene.spp
    spp_per_pass = min(spp_per_pass or spp, spp)
    n_passes = (spp + spp_per_pass - 1) // spp_per_pass
    acc = None
    totals = {}
    for p in range(n_passes):
        this_spp = min(spp_per_pass, spp - p * spp_per_pass)
        L, aux = render_lanes(
            scene, seed, 0, film.n_pixels * this_spp, p * spp_per_pass, this_spp, spp, sensor
        )
        acc = accumulate(film, L, this_spp, acc)
        for key in ("n_rays", "n_invalid", "n_negative"):
            totals[key] = totals.get(key, 0) + aux[key]
    if stats is not None:
        stats.update({k: int(v) for k, v in totals.items()})
    return acc / spp
