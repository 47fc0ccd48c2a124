"""Volumetric path-replay backpropagation: prbvolpath / prb_unpolarized
(counterpart of mitsuba_tpu/ad/prbvolpath.py), and the replay that the
polarized and atmosphere-ocean PRB integrators share with it.

The primal is the volumetric path tracer. The backward pass replays its
paths detached (the same counter-based random numbers, drawn in the same
order, the same early stops and the same skips of the RNG's dimension) and
at each segment adds the gradient of the segment's attached terms:

  w_seg   the segment's tracking weight     dL . L_start . (w_att / w_det)
  Le      emitter-hit and escape radiance   dL . beta . mis . Le_att
  C_nee   NEE: phase or BSDF value, emitter radiance and the ratio-tracked
          transmittance attached (sigma_n over the detached majorant),
          geometry detached                 dL . C_att
  w_dir   the phase or BSDF weight of the sampled direction: its attached
          eval over the detached pdf        dL . (w_att / w_det) . L_next

while L, starting at the primal radiance, gives up Le + C_nee at every
segment, so that it holds the radiance of the path's remaining suffix.
Sampling decisions and their pdfs are detached; w_seg's primal value is 1
(the replace_grad(1, w) trick).

Each segment's terms are one ``torch.autograd.grad`` on a copy of the
scene whose parameter tensors are fresh leaves (ad/prb.py's pattern): the
graph lives for one segment, so memory is O(wavefront + parameters). The
tracking and the shadow walk run once, on that copy; their detached values
are the same numbers, detached.

In a polarized variant (prb_polarized) the throughput is a Mueller chain
[N, C, 4, 4] and L a Stokes vector [N, C, 4]: w_seg's scalar ratios act on
every Stokes component, and w_dir takes the per-event intensity ratio of
the Mueller eval (ad/prb_polarized.py).

``regen_backward`` (volumetric_regen_backward) replays path regeneration
(integrators/volpath.py:volpath_regen_render) for all three: each lane
restarts on its pixel's next sample with that sample's primal radiance
and the pixel's adjoint pulled back through the flush, the lane's own.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..integrators.path import mis_weight
from ..integrators.volpath import (
    VolPathIntegrator,
    _any,
    advance,
    emission,
    estimate_transmittance,
    lanes_where,
    nee_eval,
    nee_setup,
    regen_fresh,
    regen_start,
    segment_events,
    track_segment,
    volpath_restart,
)
from ..render.film import spectral_to_film_adjoint
from ..render.records import Ray
from ..render.spectrum_ops import get_ops
from .prb import attach_scene, detach_scene, vjp_into


class VolumeReplay:
    """The detached-sampling volumetric replay, mixed into a volumetric
    integrator: it takes the primal's draws (_draws), its segment events
    and its advance (volpath.py) as they are, and _replay_nee carries the
    attached form of the primal's NEE."""

    is_prb = True
    # w_dir's inverse detached weight is 0 below this (per integrator, as
    # in the reference)
    dir_floor = 1e-20

    def sample_backward(self, scene, leaves, rng, ray, dL, L_primal, active, wavelengths=None):
        """Replay the paths of (rng, ray) (at the lanes' `wavelengths` in the
        spectral variants) from their primal radiance L_primal and return
        (the gradients of sum(dL * L) for each tensor of `leaves`, the rays
        cast: a closest hit per active lane and a shadow walk per
        NEE-active lane of each segment)."""
        ops = get_ops(scene.polarized)
        max_depth, max_segments = self._budgets()
        scene_d = detach_scene(scene)
        scene_att, att = attach_scene(scene, leaves)
        grads = [torch.zeros_like(x) for x in leaves]
        s = self._start(scene_d, ops, rng, ray, active, L_primal.detach(), wavelengths)
        n_rays = torch.zeros((), dtype=torch.int64, device=ray.o.device)
        for _ in range(max_segments):
            if not _any(s["active"]):
                break
            s, cast = self._bwd_bounce(scene_d, scene_att, att, grads, ops, dL.detach(),
                                       max_depth, s)
            n_rays = n_rays + cast
        return grads, n_rays

    def regen_backward(self, scene, leaves, seed, spp, sensor_idx, dL_px, L_samples):
        return volumetric_regen_backward(self, scene, leaves, seed, spp, sensor_idx, dL_px,
                                         L_samples)

    def _replay_nee(self, scene_d, sc, ops, s, ev, beta, u0, u2a, u2r, rng):
        """volpath's NEE, detached and attached: (its detached radiance, its
        attached radiance, nee_active, the reference point, rng). The
        shadow rays' transmittance and the phase or BSDF value are
        evaluated once, attached; the emitter's radiance is attached and
        the rest of its weight (pdf, geometry) a detached ratio."""
        nee_active, ref_p, ds, em_weight_d, nee_medium, p_nee = nee_setup(scene_d, s, ev, u0,
                                                                          u2a)
        zero = torch.zeros_like(s["L"])
        with torch.enable_grad():
            T_a, rng = estimate_transmittance(
                sc, p_nee, ds, nee_medium, s["channel"], rng, nee_active,
                max_crossings=self.nee_crossings, steps_per_segment=self.nee_steps)
            f_a, pdf_fwd = nee_eval(sc, ops, ev, ds.d, ev["scatter_surf"], s["wavelengths"])
            w_nee = torch.where(ds.delta, 1.0, mis_weight(ds.pdf, pdf_fwd.detach()))
            C_det = ops.where_rad(nee_active, ops.contrib_nee(
                beta, f_a.detach(), em_weight_d * T_a.detach() * w_nee[..., None]), zero)
            em_val_d = scene_d.eval_emitter_sample(ds, s["wavelengths"])
            em_ratio = torch.where(em_val_d > 1e-20,
                                   em_weight_d / torch.clamp(em_val_d, min=1e-20), 0.0)
            C_att = ops.where_rad(nee_active, ops.contrib_nee(
                beta, f_a, sc.eval_emitter_sample(ds, s["wavelengths"]) * em_ratio * T_a
                * w_nee[..., None]), zero)
        return C_det, C_att, nee_active, ref_p, rng

    def _bwd_bounce(self, scene_d, sc, att, grads, ops, dL, max_depth, s):
        """One replay segment: adds its VJP into `grads` and returns (the
        next state, the rays cast)."""
        channel, active = s["channel"], s["active"]
        ray_o, ray_d, medium = s["ray_o"], s["ray_d"], s["medium"]
        L_start = s["L"]
        si = scene_d.ray_intersect(Ray.make(ray_o, ray_d), active)
        t_surf = torch.where(si.is_valid, si.t, float("inf"))

        # ---- the segment's tracking, once, attached ----
        with torch.enable_grad():
            reached_end, real, t_real, bf_att, rng = track_segment(
                sc, ray_o, ray_d, t_surf, medium, channel, s["rng"], active, self.track_steps)
        beta_f_det = bf_att.detach()
        seg_mask = active & (medium >= 0)
        beta = ops.mul_scalar(s["beta"], torch.where(active[..., None], beta_f_det, 1.0))
        ev = segment_events(scene_d, s, si, reached_end, real, t_real, max_depth)
        mei, phase_idx, scatter_med, scatter_surf = (ev["mei"], ev["phase_idx"],
                                                     ev["scatter_med"], ev["scatter_surf"])
        u0, u2a, u_lobe, u2b, u2r, u_rr, rng = self._draws(rng)
        wl = s["wavelengths"]

        # ---- emission (detached MIS weights) and NEE ----
        Le_det = emission(scene_d, scene_d, ops, s, ev, beta)
        C_det, C_att, nee_active, ref_p, rng = self._replay_nee(
            scene_d, sc, ops, s, ev, beta, u0, u2a, u2r, rng)
        L_next = L_start - Le_det - C_det

        # ---- the sampled direction: detached sample, attached eval ----
        if ops.polarized:
            wo_ph, _, pdf_ph = scene_d.phase_sample(phase_idx, mei, u_lobe, u2b, scatter_med)
            bs, bw_det = scene_d.bsdf_sample_pol(si, u_lobe, u2b, scatter_surf, wl)
        else:
            wo_ph, w_ph_det, pdf_ph = scene_d.phase_sample(phase_idx, mei, u_lobe, u2b,
                                                           scatter_med)
            bs, bw_det = scene_d.bsdf_sample(si, u_lobe, u2b, scatter_surf, wl)
        pdf_dir = torch.where(scatter_med, pdf_ph, bs.pdf)
        zero = torch.zeros_like(L_start)
        with torch.enable_grad():
            if ops.polarized:
                ph_dir_a, _ = sc.phase_eval_pdf_pol(phase_idx, mei, wo_ph, scatter_med)
                b_dir_a, _ = sc.bsdf_eval_pdf_pol(si, bs.wo, scatter_surf, wl)
                # Scene.phase_sample_pol's weight: the eval over the pdf
                w_ph_det = (ph_dir_a.detach()
                            / torch.clamp(pdf_ph, min=1e-12)[..., None, None, None])
                w_dir_det = torch.where(scatter_med[..., None, None, None], w_ph_det,
                                        bw_det)[..., 0, 0]
                f_dir_a = torch.where(scatter_med[..., None, None, None], ph_dir_a,
                                      b_dir_a)[..., 0, 0]
            else:
                ph_dir_a, _ = sc.phase_eval_pdf(phase_idx, mei, wo_ph, scatter_med)
                b_dir_a, _ = sc.bsdf_eval_pdf(si, bs.wo, scatter_surf, wl)
                w_dir_det = torch.where(scatter_med[..., None], w_ph_det, bw_det)
                f_dir_a = torch.where(scatter_med[..., None], ph_dir_a, b_dir_a)
            inv_dir = torch.where(w_dir_det > self.dir_floor,
                                  1.0 / torch.clamp(w_dir_det, min=self.dir_floor), 0.0)
            ratio_dir = f_dir_a / torch.clamp(pdf_dir, min=1e-12)[..., None] * inv_dir

            # ---- the segment's attached terms and their VJP ----
            inv_seg = torch.where(beta_f_det > 1e-20,
                                  1.0 / torch.clamp(beta_f_det, min=1e-20), 0.0)
            ratio_seg = bf_att * inv_seg
            if ops.polarized:
                ratio_seg, ratio_dir = ratio_seg[..., None], ratio_dir[..., None]
            terms = (ops.where_rad(seg_mask, dL * L_start * ratio_seg, zero),
                     dL * emission(scene_d, sc, ops, s, ev, beta),
                     dL * C_att,
                     ops.where_rad(scatter_med | scatter_surf, dL * L_next * ratio_dir, zero))
            vjp_into(grads, sum(t.sum() for t in terms), att)

        # ---- advance the detached path exactly as the primal does ----
        cast = active.sum() + nee_active.sum()
        return dict(s, L=L_next, rng=rng,
                    **advance(self, scene_d, ops, s, ev, beta, wo_ph, w_ph_det, pdf_ph, bs,
                              bw_det, nee_active, ref_p, u_rr)), cast


def volumetric_regen_backward(integrator, scene, leaves, seed, spp, sensor_idx, dL_px,
                              L_samples):
    """Replay volpath_regen_render at `seed` and return (the gradients of
    sum(dL_px * L_px) for each tensor of `leaves`, {"n_rays": rays cast,
    "wavefront_iters": steps}). A lane restarts as the primal's does (the
    same fresh draws, the integrator's extra state reset) with L = its
    sample's primal radiance from L_samples and dL = the pixel's adjoint
    dL_px pulled back through the flush: the identity; in a polarized
    variant the transpose of the flush's rotation at the sample's camera
    ray; in the spectral variant the VJP of the conversion to the film's
    channels at the sample's primal radiance and wavelengths. The loop
    reads from the card once per step whether any lane has work left, as
    the primal's does."""
    from ..render_api import sensor_stokes_rotation

    n = scene.film.n_pixels
    nc = scene.n_channels
    spectral = nc == 4 and not scene.polarized
    ops = get_ops(scene.polarized)
    max_depth, max_segments = integrator._budgets()
    dev = scene.device
    pix = torch.arange(n, dtype=torch.int64, device=dev)
    scene_d = detach_scene(scene)
    scene_att, att = attach_scene(scene, leaves)
    grads = [torch.zeros_like(x) for x in leaves]
    dL_px, L_samples = dL_px.detach(), L_samples.detach()
    fresh = regen_fresh(scene_d, seed, spp, sensor_idx)
    extra0 = integrator._regen_extra(n, scene)

    def lane_dL(cam_d, L_s, wl, wl_pdf):
        """The film adjoint pulled back through the flush of a sample
        seen along cam_d, of primal radiance L_s at wavelengths wl."""
        if scene.polarized:
            return torch.einsum("nji,ncj->nci", sensor_stokes_rotation(cam_d), dL_px)
        if spectral:
            return spectral_to_film_adjoint(scene.film, dL_px, L_s, wl, wl_pdf)
        return dL_px

    rng0, ray0, ch0, wl0, wlp0 = fresh(torch.zeros(n, dtype=torch.int64, device=dev))
    L0 = torch.zeros_like(L_samples[:, 0])
    s = dict(regen_start(scene_d, ops, ray0, ch0, rng0, L0, extra0, wl0, wlp0), dL=L0)
    n_rays = torch.zeros((), dtype=torch.int64, device=dev)
    iters = 0
    while iters < spp * max_segments + 1 and _any(s["active"] | (s["s_next"] < spp)):
        regen = ~s["active"] & (s["s_next"] < spp)
        rng_new, ray_new, ch_new, wl_new, wlp_new = fresh(s["s_next"])
        L_fresh = L_samples[pix, torch.clamp(s["s_next"], max=spp - 1)]
        s = dict(
            volpath_restart(scene_d, ops, s, regen, rng_new, ray_new, ch_new, L_fresh, extra0,
                            wl_new, wlp_new),
            dL=lanes_where(regen, lane_dL(ray_new.d, L_fresh, wl_new, wlp_new), s["dL"]),
            s_next=torch.where(regen, s["s_next"] + 1, s["s_next"]),
        )
        s, cast = integrator._bwd_bounce(scene_d, scene_att, att, grads, ops, s["dL"], max_depth,
                                         s)
        n_rays = n_rays + cast
        iters += 1
    return grads, {"n_rays": n_rays, "wavefront_iters": iters}


@dataclass(frozen=True)
class PRBVolpathIntegrator(VolumeReplay, VolPathIntegrator):
    """Detached-sampling volumetric PRB (unpolarized variants): the primal
    is VolPathIntegrator.sample; sample_backward replays it."""
