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
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

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

    def sample(self, scene, rng, ray, active):
        """Radiance [N, 3] along each ray and {"n_rays": rays cast}: one
        closest-hit per active lane and one shadow ray per NEE-active lane."""
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
            hide = self.hide_emitters and depth == 0

            # ---- emitter hits and escaped rays, MIS against the BSDF pdf ----
            escaped = active & ~si.is_valid
            env_val = scene.eval_environment(ray_d)
            hit_em = active & si.is_valid
            em_val = scene.eval_emitter_hit(si)
            w_env, w_em = emitter_mis_weights(scene, nee, si, ray_d, prev_pdf, prev_delta, prev_p)
            if not hide:
                L = L + torch.where(escaped[..., None], beta * w_env[..., None] * env_val, 0.0)
                L = L + torch.where(hit_em[..., None], beta * w_em[..., None] * em_val, 0.0)

            active_next = active & si.is_valid & (depth + 1 < max_depth)

            # ---- random numbers: always 4 x next_2d, in this order ----
            u0, u2a_x, rng = rng.next_2d()
            u2a_y, u_lobe, rng = rng.next_2d()
            u2b_x, u2b_y, rng = rng.next_2d()
            u_rr, _, rng = rng.next_2d()

            # ---- NEE ----
            if nee:
                ds, em_weight = scene.sample_emitter_direction(
                    si.p, u0, torch.stack([u2a_x, u2a_y], dim=-1), active_next,
                    test_visibility=not defer, ref_n=si.n,
                )
                bsdf_val, bsdf_pdf = scene.bsdf_eval_pdf(si, si.to_local(ds.d), active_next)
                w_nee = torch.where(ds.delta, 1.0, mis_weight(ds.pdf, bsdf_pdf))
                contrib = torch.where(
                    active_next[..., None], beta * bsdf_val * em_weight * w_nee[..., None], 0.0
                )
            if defer:
                # the shadow ray rides the next bounce's fused launch
                pend = spawn_ray(si.p, si.n, ds.d, maxt=ds.dist * (1.0 - 1e-3))
                pend_active = active_next & (ds.pdf > 0) & torch.any(contrib != 0.0, dim=-1)
                pend_contrib = contrib
            elif nee:
                L = L + contrib

            # ---- BSDF sampling ----
            bs, bsdf_weight = scene.bsdf_sample(
                si, u_lobe, torch.stack([u2b_x, u2b_y], dim=-1), active_next
            )
            new_ray = spawn_ray(si.p, si.n, si.to_world(bs.wo))
            beta = beta * bsdf_weight
            eta = eta * bs.eta
            alive = active_next & (bs.pdf > 0) & torch.any(beta > 0, dim=-1)

            # ---- Russian roulette ----
            if depth + 1 >= self.rr_depth:
                beta_max = torch.amax(beta, dim=-1) * eta * eta
                q = torch.clamp(beta_max, max=0.95)
                beta = torch.where(
                    alive[..., None], beta / torch.clamp(q, min=1e-6)[..., None], beta
                )
                alive = alive & (u_rr < q)

            n_rays = n_rays + active.sum() + (active_next.sum() if nee else 0)
            ray_o, ray_d = new_ray.o, new_ray.d
            active = alive
            prev_pdf, prev_delta, prev_p = bs.pdf, bs.delta, si.p

        if defer:
            # flush the last bounce's pending shadow rays
            occluded = scene.ray_test(pend, pend_active)
            L = L + torch.where((pend_active & ~occluded)[..., None], pend_contrib, 0.0)
        return L, {"n_rays": n_rays}


def emitter_mis_weights(scene, nee, si, ray_d, prev_pdf, prev_delta, prev_p):
    """(w_env, w_em): the MIS weights of an escaped ray and of an emitter
    hit against the previous bounce's BSDF pdf; 1 without NEE."""
    if not nee:
        one = torch.ones_like(prev_pdf)
        return one, one
    env_pdf = torch.where(prev_delta, 0.0, scene.pdf_emitter_direction_escaped(ray_d))
    em_pdf = torch.where(prev_delta, 0.0, scene.pdf_emitter_direction_hit(prev_p, si))
    return mis_weight(prev_pdf, env_pdf), mis_weight(prev_pdf, em_pdf)
