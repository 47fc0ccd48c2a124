"""Volumetric path tracer with spectral null-scattering path-integral MIS
(counterpart of mitsuba_tpu/integrators/volpathmis.py; Miller et al.
2019).

Instead of a throughput spectrum, each lane carries two [C, C] weight
matrices P[i, j] = prod over the path's events of pdf_j / f_i, j indexing
the C distance-sampling strategies (the hero channel decides real against
null collisions) and i the contribution channel. A contribution is
weighted by the balance heuristic over the strategies, C / sum_j P[i, j];
an emitter hit against its NEE strategy by C / sum_j (P1 + P2).

The media's majorant is one number (the maximum over the channels), so the
free-flight pdf and transmittance of a tracking step cancel entrywise and
each event multiplies in a closed-form factor matrix:

    null collision:   P_uni *= sigma_n[j] / sigma_n[i],  P_nee *= maj / sigma_n[i]
    real collision:   P_uni *= sigma_t[j] / sigma_s[i]
    phase or BSDF:    P_uni *= pdf / (w[i] pdf),         P_nee *= 1 / (w[i] pdf)

The polarized variants are refused, as in the reference.

Random numbers are drawn in the JAX package's order, so each lane takes
its numbers: a hero channel, then per segment track_steps x next_2d of
tracking, 4 x next_2d, and nee_crossings x nee_steps x next_2d of ratio
tracking. The loops stop early where the rest of a loop changes nothing (a
tracking loop once no lane is tracking, the NEE crossings once no shadow
ray is alive, the segments once no path is alive) and advance the RNG's
dimension by the draws they skip, as integrators/volpath.py does.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.frame import dot
from ..render.records import MediumInteraction, Ray, spawn_ray
from .volpath import _any, _read_pending, index_spectrum, sample_channel


def _upd(P, p, f, mask):
    """P[i, j] *= p[j] / f[i] on the lanes of mask; non-finite ratios and
    NaN products become 0."""
    ratio = p[:, None, :] / f[:, :, None]
    ratio = torch.where(torch.isfinite(ratio), ratio, 0.0)
    Pn = P * ratio
    Pn = torch.where(torch.isnan(Pn), 0.0, Pn)
    return torch.where(mask[:, None, None], Pn, P)


def _upd_scalar(P, p, mask):
    """P *= p (a pdf-only event) on the lanes of mask."""
    return torch.where(mask[:, None, None], P * p[:, None, None], P)


def _upd_mat(P, fac, mask):
    return torch.where(mask[:, None, None], P * fac, P)


def _mis1(P):
    """[N, C] contribution weight C / sum_j P[i, j] (0 where the sum is)."""
    s = torch.sum(P, dim=-1)
    return torch.where(s > 0, P.shape[-1] / torch.where(s > 0, s, 1.0), 0.0)


def _mis2(P1, P2):
    return _mis1(P1 + P2)


def _safe_div_outer(num, den):
    """num[j] / den[i] -> [N, C, C], non-finite -> 0."""
    r = num[:, None, :] / den[:, :, None]
    return torch.where(torch.isfinite(r), r, 0.0)


def _null_nee_factor(maj, sn):
    """maj / sigma_n[i] per row [N, C, 1], non-finite -> 0."""
    r = maj[:, None, None] / sn[:, :, None]
    return torch.where(torch.isfinite(r), r, 0.0)


def track_segment_mis(scene, p0, d, seg_len, medium, channel, rng, active, n_steps):
    """Delta-track one segment at the medium's majorant, gathering the
    uni and NEE factor matrices. Returns (reached_end, real, t_real, fac_u,
    fac_n, rng); lanes still tracking after n_steps are absorbed (their
    matrices 0), lanes in vacuum pass through with matrices of ones."""
    n, nc, dev = p0.shape[0], scene.n_channels, p0.device
    in_medium = active & (medium >= 0)
    ones = torch.ones(n, nc, nc, dtype=torch.float32, device=dev)
    is_real = torch.zeros(n, dtype=torch.bool, device=dev)
    t_real = torch.zeros(n, dtype=torch.float32, device=dev)
    if not _any(in_medium):
        return active, is_real, t_real, ones, ones, rng.skip(2 * n_steps)
    maj = torch.clamp(scene.medium_majorant(medium, p0), min=1e-8)
    t = torch.zeros(n, dtype=torch.float32, device=dev)
    fac_u, fac_n, pending = ones, ones, in_medium
    for step in range(n_steps):
        u_flight, u_event, rng = rng.next_2d()
        dt = -torch.log(torch.clamp(1.0 - u_flight, min=1e-20)) / maj
        t_new = t + dt
        collide = pending & ~(t_new >= seg_len)
        ss, sn, st = scene.medium_coefficients(medium, p0 + t_new[..., None] * d, d)
        prob_real = torch.clamp(index_spectrum(st, channel) / maj, 0.0, 1.0)
        real = collide & (u_event < prob_real)
        null = collide & ~real
        fac_u = _upd_mat(fac_u, _safe_div_outer(sn, sn), null)
        fac_n = _upd_mat(fac_n, _null_nee_factor(maj, sn), null)
        fac_u = _upd_mat(fac_u, _safe_div_outer(st, ss), real)
        t = torch.where(collide, t_new, t)
        pending = pending & null
        is_real = is_real | real
        t_real = torch.where(real, t_new, t_real)
        if _read_pending(step) and step + 1 < n_steps and not _any(pending):
            rng = rng.skip(2 * (n_steps - step - 1))
            break
    dead = pending[:, None, None]
    in3 = in_medium[:, None, None]
    fac_u = torch.where(in3, torch.where(dead, 0.0, fac_u), ones)
    fac_n = torch.where(in3, torch.where(dead, 0.0, fac_n), ones)
    reached_end = torch.where(in_medium, ~is_real & ~pending, active)
    return reached_end, is_real & in_medium, t_real, fac_u, fac_n, rng


def nee_transmittance_mis(scene, p0, ds, medium_idx0, channel, rng, active, max_crossings=4,
                          steps_per_segment=32):
    """Ratio-tracking factor matrices (T_nee, T_uni) of each NEE shadow ray,
    across up to max_crossings null interfaces (one closest hit each); a
    ray that meets an opaque surface, needs more crossings or is still
    tracking after steps_per_segment steps gets 0. Returns (T_n, T_u,
    rng)."""
    n, nc, dev = p0.shape[0], scene.n_channels, p0.device
    d = ds.d
    ones = torch.ones(n, nc, nc, dtype=torch.float32, device=dev)
    p, remaining, medium = p0, ds.dist * (1.0 - 1e-3), medium_idx0
    fac_n, fac_u = ones, ones
    alive = active & (ds.pdf > 0)
    blocked = torch.zeros(n, dtype=torch.bool, device=dev)
    for k in range(max_crossings):
        if not _any(alive):
            rng = rng.skip(2 * steps_per_segment * (max_crossings - k))
            break
        ray = spawn_ray(p, d, d, maxt=remaining)
        si = scene.ray_intersect(ray, alive)
        t_surf = torch.where(si.is_valid, si.t, float("inf"))
        seg_len = torch.minimum(t_surf, remaining)
        maj = torch.clamp(scene.medium_majorant(medium, ray.o), min=1e-8)
        in_med = alive & (medium >= 0)
        t = torch.zeros(n, dtype=torch.float32, device=dev)
        seg_n, seg_u, pending = ones, ones, in_med
        for step in range(steps_per_segment):
            if not _any(pending) and (step == 0 or _read_pending(step - 1)):
                rng = rng.skip(2 * (steps_per_segment - step))
                break
            u_flight, _, rng = rng.next_2d()
            dt = -torch.log(torch.clamp(1.0 - u_flight, min=1e-20)) / maj
            t_new = t + dt
            collide = pending & (t_new < seg_len)
            _, sn, _ = scene.medium_coefficients(medium, ray.o + t_new[..., None] * d, d)
            seg_n = _upd_mat(seg_n, _null_nee_factor(maj, sn), collide)
            seg_u = _upd_mat(seg_u, _safe_div_outer(sn, sn), collide)
            t = torch.where(collide, t_new, t)
            pending = collide
        in3 = in_med[:, None, None]
        fac_n = fac_n * torch.where(in3, seg_n, 1.0)
        fac_u = fac_u * torch.where(in3, seg_u, 1.0)

        hit_surface = alive & si.is_valid & (t_surf < remaining)
        is_null = scene.is_null_bsdf(si)
        blocked = blocked | (hit_surface & ~is_null) | pending
        cross = hit_surface & is_null
        medium = torch.where(cross, scene.medium_transition(si, d, medium), medium)
        adv = torch.where(cross, t_surf, 0.0)
        p = p + (adv + 1e-4)[..., None] * d
        remaining = remaining - adv
        alive = cross & ~blocked
    dead = (blocked | alive | ~active)[:, None, None]   # crossings left over: blocked
    return torch.where(dead, 0.0, fac_n), torch.where(dead, 0.0, fac_u), rng


@dataclass(frozen=True)
class VolPathMisIntegrator:
    """Spectral-MIS volumetric path tracer (plugin name ``volpathmis``)."""

    max_depth: int = 8
    rr_depth: int = 5
    hide_emitters: bool = False
    max_segments: int = 0       # 0: max_depth + 8
    track_steps: int = 32
    nee_crossings: int = 4
    nee_steps: int = 32

    def sample(self, scene, rng, ray, active, wavelengths=None):
        """Radiance [N, C] along each ray and {"n_rays": one closest hit per
        active lane and one shadow ray per NEE-active lane a segment}."""
        if scene.polarized:
            raise ValueError("volpathmis does not support the polarized variants "
                             "(as the reference's volpathmis.cpp)")
        n, nc, dev = ray.o.shape[0], scene.n_channels, ray.o.device
        max_depth = self.max_depth if self.max_depth > 0 else 64
        max_segments = self.max_segments or (max_depth + 8)
        ones_cc = torch.ones(n, nc, nc, dtype=torch.float32, device=dev)
        ones = torch.ones(n, nc, dtype=torch.float32, device=dev)
        wl = wavelengths

        u_ch, _, rng = rng.next_2d()
        channel = sample_channel(u_ch, nc)
        depth = torch.zeros(n, dtype=torch.int64, device=dev)
        L = torch.zeros(n, nc, dtype=torch.float32, device=dev)
        P, Pn = ones_cc, ones_cc
        ray_o, ray_d = ray.o, ray.d
        medium = torch.full((n,), scene.camera_medium, dtype=torch.int64, device=dev)
        prev_delta = torch.ones(n, dtype=torch.bool, device=dev)
        prev_p = ray.o
        n_rays = torch.zeros((), dtype=torch.int64, device=dev)

        for _ in range(max_segments):
            if not _any(active):
                break       # nothing changes L or n_rays any more
            si = scene.ray_intersect(Ray.make(ray_o, ray_d), active)
            t_surf = torch.where(si.is_valid, si.t, float("inf"))
            reached_end, real, t_real, fac_u, fac_n, rng = track_segment_mis(
                scene, ray_o, ray_d, t_surf, medium, channel, rng, active, self.track_steps)
            act3 = active[:, None, None]
            P = torch.where(act3, P * fac_u, P)
            Pn = torch.where(act3, Pn * fac_n, Pn)
            surface_event = active & reached_end & si.is_valid
            escaped = active & reached_end & ~si.is_valid
            p_med = ray_o + t_real[..., None] * ray_d
            mei = MediumInteraction.make(torch.where(real, t_real, float("inf")), p_med, ray_d,
                                         medium)
            phase_idx = scene.medium_phase_of(medium)

            u0, u2a_x, rng = rng.next_2d()
            u2a_y, u_lobe, rng = rng.next_2d()
            u2b_x, u2b_y, rng = rng.next_2d()
            u_rr, _, rng = rng.next_2d()

            # ---- emitter hit or escape: MIS against the NEE strategy ----
            pd1 = prev_delta[:, None]
            Pn_env = _upd_scalar(Pn, scene.pdf_emitter_direction_escaped(ray_d),
                                 escaped & ~prev_delta)
            w_env = torch.where(pd1, _mis1(P), _mis2(P, Pn_env))
            L = L + torch.where(escaped[:, None], w_env * scene.eval_environment(ray_d, wl), 0.0)
            Pn_hit = _upd_scalar(Pn, scene.pdf_emitter_direction_hit(prev_p, si),
                                 surface_event & ~prev_delta)
            w_hit = torch.where(pd1, _mis1(P), _mis2(P, Pn_hit))
            L = L + torch.where(surface_event[:, None], w_hit * scene.eval_emitter_hit(si, wl),
                                0.0)

            depth_ok = depth + 1 < max_depth
            is_null_surf = scene.is_null_bsdf(si)
            null_cross = surface_event & is_null_surf
            scatter_surf = surface_event & ~is_null_surf & depth_ok
            scatter_med = real & depth_ok
            # a real collision resets the NEE matrix to the uni matrix
            Pn = torch.where(real[:, None, None], P, Pn)

            # ---- NEE with the matrices' branches ----
            nee_active = scatter_med | scatter_surf
            ref_p = torch.where(scatter_med[..., None], p_med, si.p)
            ds, em_weight = scene.sample_emitter_direction(
                ref_p, u0, torch.stack([u2a_x, u2a_y], dim=-1), nee_active,
                test_visibility=False, wavelengths=wl)
            emitter_val = em_weight * ds.pdf[..., None]
            nee_medium = torch.where(scatter_surf, scene.medium_transition(si, ds.d, medium),
                                     medium)
            side = torch.sign(dot(si.n, ds.d))
            p_nee = torch.where(scatter_surf[..., None], si.p + side[..., None] * 1e-4 * si.n,
                                p_med)
            T_n, T_u, rng = nee_transmittance_mis(
                scene, p_nee, ds, nee_medium, channel, rng, nee_active,
                max_crossings=self.nee_crossings, steps_per_segment=self.nee_steps)
            na3 = nee_active[:, None, None]
            Pn_end = _upd_scalar(P, ds.pdf, nee_active) * torch.where(na3, T_n, 1.0)
            P_end = P * torch.where(na3, T_u, 1.0)
            ph_val, ph_pdf = scene.phase_eval_pdf(phase_idx, mei, mei.to_local(ds.d), scatter_med)
            b_val, b_pdf = scene.bsdf_eval_pdf(si, si.to_local(ds.d), scatter_surf, wl)
            f_nee = torch.where(scatter_med[..., None], ph_val, b_val)
            pdf_fwd = torch.where(scatter_med, ph_pdf, b_pdf)
            Pn_end = _upd(Pn_end, ones, f_nee, nee_active)
            P_end = _upd(P_end, torch.where(ds.delta, 0.0, pdf_fwd)[:, None] * ones, f_nee,
                         nee_active)
            L = L + torch.where(nee_active[:, None], _mis2(Pn_end, P_end) * emitter_val, 0.0)

            # ---- direction sampling ----
            u2b = torch.stack([u2b_x, u2b_y], dim=-1)
            wo_ph, w_ph, pdf_ph = scene.phase_sample(phase_idx, mei, u_lobe, u2b, scatter_med)
            bs, bw = scene.bsdf_sample(si, u_lobe, u2b, scatter_surf, wl)
            new_d = torch.where(scatter_med[..., None], mei.to_world(wo_ph),
                                torch.where(scatter_surf[..., None], si.to_world(bs.wo), ray_d))
            o_surf = spawn_ray(si.p, si.n, new_d).o
            new_o = torch.where(scatter_med[..., None], p_med,
                                torch.where(surface_event[..., None], o_surf, ray_o))

            # phase event: P *= pdf / (w pdf), Pn *= 1 / (w pdf); a surface
            # event first resets the NEE matrix to P
            f_ph = w_ph * torch.clamp(pdf_ph, min=1e-20)[:, None]
            P = _upd(P, pdf_ph[:, None] * ones, f_ph, scatter_med)
            Pn = _upd(Pn, ones, f_ph, scatter_med)
            Pn = torch.where(scatter_surf[:, None, None], P, Pn)
            f_b = bw * torch.clamp(bs.pdf, min=1e-20)[:, None]
            P = _upd(P, bs.pdf[:, None] * ones, f_b, scatter_surf)
            Pn = _upd(Pn, ones, f_b, scatter_surf)

            scattered = scatter_med | scatter_surf
            new_medium = torch.where(null_cross | scatter_surf,
                                     scene.medium_transition(si, new_d, medium), medium)
            depth = depth + scattered.to(torch.int64)
            prev_delta = torch.where(scatter_med, False,
                                     torch.where(scatter_surf, bs.delta, prev_delta))
            prev_p = torch.where(nee_active[..., None], ref_p, prev_p)

            alive = active & ~escaped
            alive = alive & ~(scatter_surf & (bs.pdf <= 0))
            alive = alive & ~(scatter_med & (pdf_ph <= 0))
            alive = alive & ~(surface_event & ~is_null_surf & ~depth_ok)
            alive = alive & ~(real & ~depth_ok)
            thr = _mis1(P)
            alive = alive & (torch.amax(thr, dim=-1) > 0)

            # ---- Russian roulette on the MIS-weighted throughput ----
            q = torch.clamp(torch.amax(thr, dim=-1), max=0.95)
            rr_active = (depth >= self.rr_depth) & scattered
            rr_continue = u_rr < q
            P = _upd_scalar(P, q, rr_active & alive & rr_continue)
            alive = alive & (~rr_active | rr_continue)

            n_rays = n_rays + active.sum() + nee_active.sum()
            ray_o, ray_d, medium, active = new_o, new_d, new_medium, alive
        return L, {"n_rays": n_rays}
