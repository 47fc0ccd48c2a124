"""Surface path tracer with NEE and BSDF-sampling MIS (counterpart of
mitsuba_tpu/integrators/path.py).

Wavefront design: a Python loop over bounces with struct-of-arrays path
state and per-lane active masks. The loop always runs max_depth bounces,
as the reference's scan does, and every bounce draws its random numbers
unconditionally and in the same order (4 x next_2d), so each lane consumes
the same (lane, dim) counters as in the JAX package.

With deferred NEE, bounce k's shadow rays are traced in bounce k+1's
intersect launch, one fused launch of 2N rays per bounce, and the last
bounce's shadow rays in one final flush launch. Deferred NEE is off on BVH
geometry, as in the JAX package: there each bounce's shadow rays take
their own any-hit launch, which is cheaper than riding a closest-hit batch.

With ``use_nee=False`` the tracer is the pure BSDF-sampling estimator (no
next-event estimation, no MIS: emitter hits count at full weight), the
semantics of ``prb_basic``; the random numbers are drawn in the same order
either way.

``path_regen_render`` is the regenerative schedule of the same estimator:
one lane per pixel, and a lane whose path ends starts its pixel's next
sample. ``PRBIntegrator.regen_backward`` (ad/prb.py) replays it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..core.rng import lanes_rng, merge_rng
from ..render.records import Ray, spawn_ray


def mis_weight(pdf_a, pdf_b):
    """Power heuristic (beta=2)."""
    a2 = pdf_a * pdf_a
    w = a2 / torch.clamp(a2 + pdf_b * pdf_b, min=1e-30)
    return torch.where(pdf_a > 0, w, 0.0)


@dataclass(frozen=True)
class PathIntegrator:
    max_depth: int = 8
    rr_depth: int = 5
    hide_emitters: bool = False
    # trace bounce k's shadow rays in bounce k+1's fused 2N-ray launch
    # (not on BVH geometry)
    defer_nee: bool = True
    # next-event estimation with MIS; False gives prb_basic's estimator
    use_nee: bool = True
    # path regeneration (path_regen_render; a PRB integrator replays it)
    regenerate: bool = False

    def regen_render(self, scene, seed, spp, sensor_idx, record_samples=False):
        return path_regen_render(self, scene, seed, spp, sensor_idx, record_samples)

    def sample(self, scene, rng, ray, active, wavelengths=None, depth_limit=None):
        """Radiance [N, C] along each ray and {"n_rays": rays cast}: one
        closest-hit per active lane and one shadow ray per NEE-active lane.
        `wavelengths` [N, 4] are the lanes' wavelengths in the spectral
        variants (None elsewhere). `depth_limit` (an int64 tensor [N])
        caps each lane's depth below max_depth: the projective indirect
        pass's radiance probes carry the primal's remaining depth."""
        n = ray.o.shape[0]
        nc = scene.n_channels
        dev = ray.o.device
        max_depth = self.max_depth if self.max_depth > 0 else 1024
        nee = self.use_nee
        defer = nee and self.defer_nee and not scene.geometry.has_bvh

        L = torch.zeros(n, nc, dtype=torch.float32, device=dev)
        beta = torch.ones(n, nc, dtype=torch.float32, device=dev)
        eta = torch.ones(n, dtype=torch.float32, device=dev)
        ray_o, ray_d = ray.o, ray.d
        prev_pdf = torch.ones(n, dtype=torch.float32, device=dev)
        prev_delta = torch.ones(n, dtype=torch.bool, device=dev)
        prev_p = ray.o
        n_rays = torch.zeros((), dtype=torch.int64, device=dev)
        if defer:
            pend = Ray(o=ray.o, d=ray.d, maxt=torch.zeros(n, dtype=torch.float32, device=dev))
            pend_active = torch.zeros(n, dtype=torch.bool, device=dev)
            pend_contrib = torch.zeros(n, nc, dtype=torch.float32, device=dev)

        for depth in range(min(max_depth, 1024)):
            cur_ray = Ray.make(ray_o, ray_d)
            if defer:
                si, occluded = scene.ray_intersect_and_test(cur_ray, pend, active, pend_active)
                L = L + torch.where((pend_active & ~occluded)[..., None], pend_contrib, 0.0)
            else:
                si = scene.ray_intersect(cur_ray, active)
            b = path_bounce(self, scene, si, rng, ray_d, L, beta, eta, active, prev_pdf,
                            prev_delta, prev_p, depth, max_depth, defer, wavelengths,
                            depth_limit)
            if defer:
                # the shadow ray rides the next bounce's fused launch
                pend = spawn_ray(si.p, si.n, b.ds.d, maxt=b.ds.dist * (1.0 - 1e-3))
                pend_active = (b.active_next & (b.ds.pdf > 0)
                               & torch.any(b.contrib != 0.0, dim=-1))
                pend_contrib = b.contrib
            n_rays = n_rays + b.n_rays
            L, beta, eta, rng, active = b.L, b.beta, b.eta, b.rng, b.alive
            ray_o, ray_d = b.new_ray.o, b.new_ray.d
            prev_pdf, prev_delta, prev_p = b.bs.pdf, b.bs.delta, si.p

        if defer:
            # flush the last bounce's pending shadow rays
            occluded = scene.ray_test(pend, pend_active)
            L = L + torch.where((pend_active & ~occluded)[..., None], pend_contrib, 0.0)
        return L, {"n_rays": n_rays}


class Bounce(NamedTuple):
    """What one bounce of path_bounce leaves for the next."""
    L: torch.Tensor
    beta: torch.Tensor
    eta: torch.Tensor
    alive: torch.Tensor        # lanes that go on to the next bounce
    active_next: torch.Tensor  # lanes that hit a surface below max_depth
    new_ray: Ray
    bs: object                 # the BSDF sample (its pdf and delta feed the next MIS)
    rng: object
    n_rays: torch.Tensor       # closest hits and shadow rays of this bounce
    ds: object                 # the emitter sample (None without NEE)
    contrib: torch.Tensor      # its NEE contribution, in L unless deferred


def _lanes(cond, mask):
    """mask & cond, for a cond that is one Python bool for every lane (the
    wavefront's depth) or a per-lane bool tensor (regeneration's)."""
    if isinstance(cond, bool):
        return mask if cond else torch.zeros_like(mask)
    return mask & cond


def path_bounce(integrator, scene, si, rng, ray_d, L, beta, eta, active, prev_pdf, prev_delta,
                prev_p, depth, max_depth, defer, wavelengths=None, depth_limit=None):
    """One bounce of the path tracer after its closest hit `si`: emitter
    hits and escapes with MIS, NEE, the BSDF sample and Russian roulette,
    drawing 4 x next_2d in this order. `depth` is the bounce's index, one
    int for every lane (the wavefront) or an int64 tensor per lane
    (regeneration); `depth_limit` [N], where given, caps it per lane. With
    `defer` the NEE shadow ray is not traced and its contribution is left
    out of L, for the caller to trace later."""
    nee = integrator.use_nee

    # ---- emitter hits and escaped rays, MIS against the BSDF pdf ----
    shown = (depth != 0) | (not integrator.hide_emitters)
    if shown is not False:
        w_env, w_em = emitter_mis_weights(scene, nee, si, ray_d, prev_pdf, prev_delta, prev_p)
        L = L + torch.where(_lanes(shown, active & ~si.is_valid)[..., None],
                            beta * w_env[..., None] * scene.eval_environment(ray_d, wavelengths),
                            0.0)
        L = L + torch.where(_lanes(shown, active & si.is_valid)[..., None],
                            beta * w_em[..., None] * scene.eval_emitter_hit(si, wavelengths),
                            0.0)

    active_next = active & si.is_valid & (depth + 1 < max_depth)
    if depth_limit is not None:
        active_next = active_next & (depth + 1 < depth_limit)

    # ---- random numbers: always 4 x next_2d, in this order ----
    u0, u2a_x, rng = rng.next_2d()
    u2a_y, u_lobe, rng = rng.next_2d()
    u2b_x, u2b_y, rng = rng.next_2d()
    u_rr, _, rng = rng.next_2d()

    # ---- NEE ----
    ds, contrib = None, None
    if nee:
        ds, em_weight = scene.sample_emitter_direction(
            si.p, u0, torch.stack([u2a_x, u2a_y], dim=-1), active_next,
            test_visibility=not defer, ref_n=si.n, wavelengths=wavelengths,
        )
        bsdf_val, bsdf_pdf = scene.bsdf_eval_pdf(si, si.to_local(ds.d), active_next,
                                                 wavelengths)
        w_nee = torch.where(ds.delta, 1.0, mis_weight(ds.pdf, bsdf_pdf))
        contrib = torch.where(
            active_next[..., None], beta * bsdf_val * em_weight * w_nee[..., None], 0.0
        )
        if not defer:
            L = L + contrib

    # ---- BSDF sampling ----
    bs, bsdf_weight = scene.bsdf_sample(
        si, u_lobe, torch.stack([u2b_x, u2b_y], dim=-1), active_next, wavelengths
    )
    new_ray = spawn_ray(si.p, si.n, si.to_world(bs.wo))
    beta = beta * bsdf_weight
    eta = eta * bs.eta
    alive = active_next & (bs.pdf > 0) & torch.any(beta > 0, dim=-1)

    # ---- Russian roulette, on the lanes past rr_depth ----
    rr = depth + 1 >= integrator.rr_depth
    if rr is not False:
        q = torch.clamp(torch.amax(beta, dim=-1) * eta * eta, max=0.95)
        beta = torch.where(_lanes(rr, alive)[..., None],
                           beta / torch.clamp(q, min=1e-6)[..., None], beta)
        alive = alive & (u_rr < q if rr is True else ~rr | (u_rr < q))

    n_rays = active.sum() + (active_next.sum() if nee else 0)
    return Bounce(L, beta, eta, alive, active_next, new_ray, bs, rng, n_rays, ds, contrib)


def emitter_mis_weights(scene, nee, si, ray_d, prev_pdf, prev_delta, prev_p):
    """(w_env, w_em): the MIS weights of an escaped ray and of an emitter
    hit against the previous bounce's BSDF pdf; 1 without NEE."""
    if not nee:
        one = torch.ones_like(prev_pdf)
        return one, one
    env_pdf = torch.where(prev_delta, 0.0, scene.pdf_emitter_direction_escaped(ray_d))
    em_pdf = torch.where(prev_delta, 0.0, scene.pdf_emitter_direction_hit(prev_p, si))
    return mis_weight(prev_pdf, env_pdf), mis_weight(prev_pdf, em_pdf)


def restart(s, regen, rng_new, ray_new, L_new):
    """Path state `s` (a dict) with the lanes of `regen` restarted on the
    camera ray ray_new and the stream rng_new: radiance L_new, unit
    throughput and eta, and the previous vertex reset to the camera. The
    regenerative render (L_new 0) and its PRB replay (L_new the sample's
    primal radiance) share it."""
    r1 = regen[..., None]
    return dict(
        s,
        L=torch.where(r1, L_new, s["L"]),
        beta=torch.where(r1, 1.0, s["beta"]),
        eta=torch.where(regen, 1.0, s["eta"]),
        ray_o=torch.where(r1, ray_new.o, s["ray_o"]),
        ray_d=torch.where(r1, ray_new.d, s["ray_d"]),
        rng=merge_rng(rng_new, s["rng"], regen),
        prev_pdf=torch.where(regen, 1.0, s["prev_pdf"]),
        prev_delta=torch.where(regen, True, s["prev_delta"]),
        prev_p=torch.where(r1, ray_new.o, s["prev_p"]),
        active=s["active"] | regen,
    )


def record_flush(L_samples, cur_sample, mask, L):
    """L_samples[pixel, cur_sample] += L on the lanes of `mask` (one lane
    per pixel, so no two lanes write one row)."""
    pix = torch.arange(L.shape[0], dtype=torch.int64, device=L.device)
    m = mask.reshape(mask.shape + (1,) * (L.ndim - 1))
    L_samples[pix, cur_sample] += torch.where(m, L, 0.0)


def path_regen_render(integrator, scene, seed, spp, sensor_idx, record_samples=False):
    """Regenerative wavefront of the surface path tracer: one lane per
    pixel, and a lane whose path ends starts its pixel's next sample, so
    iterations drop from spp * max_depth to about spp times the mean path
    length. Every sample draws the numbers it draws in the plain wavefront
    (RNG keyed by (pixel, sample), a dimension counter per lane); its shadow
    rays are traced in their own bounce (no deferred NEE). Returns (L_px
    [n_pixels, C], the sum of each pixel's samples, {"n_rays",
    "wavefront_iters"}); with `record_samples` also "L_samples" [n_pixels,
    spp, C], each finished sample's radiance, which the PRB replay starts
    from. The loop reads from the card, once per step, whether any lane has
    work left; it stops there or after spp * max_depth + 1 steps."""
    from ..render_api import wavefront_for

    n = scene.film.n_pixels
    nc = scene.n_channels
    dev = scene.device
    max_depth = integrator.max_depth if integrator.max_depth > 0 else 1024
    pix = torch.arange(n, dtype=torch.int64, device=dev)
    rng0, ray0, _, _, _ = wavefront_for(scene, seed, pix, torch.zeros_like(pix), spp, sensor_idx)
    f32 = dict(dtype=torch.float32, device=dev)
    s = dict(
        n_rays=torch.zeros((), dtype=torch.int64, device=dev),
        s_next=torch.zeros(n, dtype=torch.int64, device=dev),
        cur_sample=torch.zeros(n, dtype=torch.int64, device=dev),
        depth=torch.zeros(n, dtype=torch.int64, device=dev),
        L_px=torch.zeros(n, nc, **f32),
        L=torch.zeros(n, nc, **f32),
        beta=torch.ones(n, nc, **f32),
        eta=torch.ones(n, **f32),
        ray_o=ray0.o,
        ray_d=ray0.d,
        rng=lanes_rng(rng0, n),
        active=torch.zeros(n, dtype=torch.bool, device=dev),
        prev_pdf=torch.ones(n, **f32),
        prev_delta=torch.ones(n, dtype=torch.bool, device=dev),
        prev_p=ray0.o,
    )
    L_samples = torch.zeros(n, spp, nc, **f32) if record_samples else None
    iters = 0
    while iters < spp * max_depth + 1 and bool((s["active"] | (s["s_next"] < spp)).any()):
        # ---- regenerate the lanes whose path ended ----
        regen = ~s["active"] & (s["s_next"] < spp)
        rng_new, ray_new, _, _, _ = wavefront_for(scene, seed, pix, s["s_next"], spp, sensor_idx)
        if record_samples:
            # the flushed radiance is the sample the lane held before
            record_flush(L_samples, s["cur_sample"], regen & (s["s_next"] > 0), s["L"])
        s = dict(
            restart(s, regen, rng_new, ray_new, 0.0),
            L_px=s["L_px"] + torch.where(regen[..., None], s["L"], 0.0),
            depth=torch.where(regen, 0, s["depth"]),
            cur_sample=torch.where(regen, s["s_next"], s["cur_sample"]),
            s_next=torch.where(regen, s["s_next"] + 1, s["s_next"]),
        )

        # ---- one bounce, with per-lane depth ----
        si = scene.ray_intersect(Ray.make(s["ray_o"], s["ray_d"]), s["active"])
        b = path_bounce(integrator, scene, si, s["rng"], s["ray_d"], s["L"], s["beta"], s["eta"],
                        s["active"], s["prev_pdf"], s["prev_delta"], s["prev_p"], s["depth"],
                        max_depth, defer=False)
        s = dict(s, n_rays=s["n_rays"] + b.n_rays, depth=s["depth"] + 1, L=b.L, beta=b.beta,
                 eta=b.eta, ray_o=b.new_ray.o, ray_d=b.new_ray.d, rng=b.rng, active=b.alive,
                 prev_pdf=b.bs.pdf, prev_delta=b.bs.delta, prev_p=si.p)
        iters += 1
    # a lane leaves the loop inactive unless the step cap cut its path
    final = torch.where(s["active"][..., None], 0.0, s["L"])
    aux = {"n_rays": s["n_rays"], "wavefront_iters": iters}
    if record_samples:
        record_flush(L_samples, s["cur_sample"], s["s_next"] > 0, final)
        aux["L_samples"] = L_samples
    return s["L_px"] + final, aux
