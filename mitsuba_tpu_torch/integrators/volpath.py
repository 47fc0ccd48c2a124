"""Null-scattering volumetric path tracer with NEE and phase/BSDF MIS
(counterpart of mitsuba_tpu/integrators/volpath.py), and its regenerative
schedule.

The structure is the reference's: the media have constant majorants, so one
scene intersection per outer step (a "segment") fixes the segment up to the
next surface, and an inner loop of delta-tracking steps (medium lookups
only) runs until a real collision or the segment's end. Real and null
collisions split on sigma_t[hero]/majorant, with the distance sampled in a
hero channel drawn per path. NEE transmittance is ratio tracking across up
to ``nee_crossings`` null interfaces, one intersection per crossing. Every
``ray_intersect`` here is a closest-hit query through the scene's kernel.

In a polarized variant the throughput is a Mueller matrix [N, C, 4, 4] and
the radiance a Stokes vector [N, C, 4] (spectrum_ops.MuellerOps): the NEE
and the sampled direction are weighted by the world-frame Mueller matrices
of the phase or BSDF, and draw no random number more than the unpolarized
path. The regenerative schedule rotates each finished path's Stokes
vector into the sensor frame by that path's own camera ray.

Random numbers are drawn unconditionally and in a fixed order, so each lane
consumes the same (lane, dim) counters as in the JAX package. The loops are
Python loops of eager PyTorch, and they stop early where the rest of a loop
could change nothing: a tracking loop once no lane is still tracking (read
from the card after steps 1, 2 and every fourth), the NEE crossings once no
shadow ray is alive, the ratio tracking where no lane is in a
heterogeneous medium (homogeneous media take the analytic transmittance),
and the segments once no path is alive. A loop that stops early advances
the RNG's dimension by the draws it skipped, so every later draw is the
JAX package's.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.rng import lanes_rng, merge_rng
from ..render.film import spectral_to_film
from ..render.records import MediumInteraction, Ray, spawn_ray
from ..render.spectrum_ops import get_ops
from .path import mis_weight, record_flush


def sample_channel(u, n_channels):
    """The hero channel of distance sampling."""
    return torch.clamp((u * n_channels).to(torch.int64), 0, n_channels - 1)


def index_spectrum(x, channel):
    """x[..., channel] per lane."""
    return torch.gather(x, -1, channel[..., None])[..., 0]


def _read_pending(step):
    """Whether a tracking loop reads its pending mask from the card after
    `step` (0-based): after the first, the second and every fourth step."""
    return step < 2 or step % 4 == 3


def _any(mask):
    return bool(mask.any())


def track_segment(scene, p0, d, seg_len, medium, channel, rng, active, n_steps):
    """Delta-track one segment of length seg_len through each lane's medium
    (n_steps steps, no scene intersection). Free flight is sampled at the
    hero channel's majorant maj_h, and every step carries the spectral
    ratio exp(-(maj_j - maj_h) dl); sampling decisions and their pdfs are
    detached, the physical coefficients are not.

    Returns (reached_end [N], real [N], t_real [N], beta_f [N, C], rng):
    lanes with real stopped at a real collision at t_real with the weight
    beta_f; lanes that were still tracking after n_steps are absorbed
    (beta_f = 0)."""
    n = p0.shape[0]
    nc = scene.n_channels
    dev = p0.device
    in_medium = active & (medium >= 0)
    t = torch.zeros(n, dtype=torch.float32, device=dev)
    beta_f = torch.ones(n, nc, dtype=torch.float32, device=dev)
    is_real = torch.zeros(n, dtype=torch.bool, device=dev)
    t_real = torch.zeros(n, dtype=torch.float32, device=dev)
    pending = in_medium
    if not _any(in_medium):
        return active, is_real, t_real, beta_f, rng.skip(2 * n_steps)
    maj_vec = torch.clamp(scene.medium_majorant_spectrum(medium, p0), min=1e-8)
    maj_h = index_spectrum(maj_vec, channel).detach()

    for step in range(n_steps):
        u_flight, u_event, rng = rng.next_2d()
        dt = -torch.log(torch.clamp(1.0 - u_flight, min=1e-20)) / maj_h
        t_new = t + dt
        passed = t_new >= seg_len
        collide = pending & ~passed
        finish = pending & passed

        p = p0 + t_new[..., None] * d
        ss, _, st = scene.medium_coefficients(medium, p, d)
        sn = torch.clamp(maj_vec - st, min=0.0)
        prob_real = torch.clamp(index_spectrum(st, channel) / maj_h, 0.0, 1.0).detach()
        real = collide & (u_event < prob_real)
        null = collide & ~real

        step_len = torch.where(
            passed, torch.where(torch.isfinite(seg_len), seg_len - t, 0.0), dt)
        ratio = torch.exp(-(maj_vec - maj_h[..., None]) * step_len[..., None])
        beta_f = torch.where((collide | finish)[..., None], beta_f * ratio, beta_f)
        denom_null = maj_h * torch.clamp(1.0 - prob_real, min=1e-8)
        denom_real = maj_h * torch.clamp(prob_real, min=1e-8)
        beta_f = torch.where(null[..., None], beta_f * (sn / denom_null[..., None]), beta_f)
        beta_f = torch.where(real[..., None], beta_f * (ss / denom_real[..., None]), beta_f)

        t = torch.where(collide, t_new, t)
        pending = pending & null & (torch.amax(beta_f, dim=-1) > 0)
        is_real = is_real | real
        t_real = torch.where(real, t_new, t_real)
        if _read_pending(step) and step + 1 < n_steps and not _any(pending):
            rng = rng.skip(2 * (n_steps - step - 1))
            break

    beta_f = torch.where(pending[..., None], 0.0, beta_f)
    reached_end = ~is_real & ~pending
    reached_end = torch.where(in_medium, reached_end, active)   # vacuum passes through
    beta_f = torch.where(in_medium[..., None], beta_f, 1.0)
    return reached_end, is_real & in_medium, t_real, beta_f, rng


def track_segment_ratio(scene, p0, d, seg_len, medium, channel, rng, active, n_steps):
    """Ratio-tracking transmittance [N, C] over one segment (the NEE
    estimator): the product of sigma_n/maj_h at hero-rate collisions and
    the spectral ratio of each step. Lanes in a homogeneous medium take the
    analytic transmittance exp(-sigma_t len) instead, whose variance is 0;
    lanes still tracking after n_steps get 0."""
    n = p0.shape[0]
    nc = scene.n_channels
    dev = p0.device
    in_medium = active & (medium >= 0)
    hom = torch.zeros(n, dtype=torch.bool, device=dev)
    for i, m in enumerate(scene.media):
        if m.is_homogeneous:
            hom = hom | (medium == i)
    T = torch.ones(n, nc, dtype=torch.float32, device=dev)
    has_het = not all(m.is_homogeneous for m in scene.media)
    if has_het and _any(in_medium & ~hom):
        maj_vec = torch.clamp(scene.medium_majorant_spectrum(medium, p0), min=1e-8)
        maj_h = index_spectrum(maj_vec, channel).detach()
        t = torch.zeros(n, dtype=torch.float32, device=dev)
        pending = in_medium
        for step in range(n_steps):
            u_flight, _, rng = rng.next_2d()
            dt = -torch.log(torch.clamp(1.0 - u_flight, min=1e-20)) / maj_h
            t_new = t + dt
            collide = pending & (t_new < seg_len)
            finish = pending & (t_new >= seg_len)
            p = p0 + t_new[..., None] * d
            _, _, st = scene.medium_coefficients(medium, p, d)
            sn = torch.clamp(maj_vec - st, min=0.0)
            step_len = torch.where(
                finish, torch.where(torch.isfinite(seg_len), seg_len - t, 0.0), dt)
            surv = torch.exp(-(maj_vec - maj_h[..., None]) * step_len[..., None])
            T = torch.where((collide | finish)[..., None], T * surv, T)
            T = torch.where(collide[..., None], T * (sn / maj_h[..., None]), T)
            t = torch.where(collide, t_new, t)
            pending = collide & (torch.amax(T, dim=-1) > 0)
            if _read_pending(step) and step + 1 < n_steps and not _any(pending):
                rng = rng.skip(2 * (n_steps - step - 1))
                break
        T = torch.where(pending[..., None], 0.0, T)
    else:
        rng = rng.skip(2 * n_steps)
    if any(m.is_homogeneous for m in scene.media):
        _, _, st0 = scene.medium_coefficients(medium, p0, d)
        len_c = torch.where(torch.isfinite(seg_len), seg_len, 1e8)
        T_an = torch.exp(-st0 * torch.clamp(len_c, min=0.0)[..., None])
        T = torch.where((hom & in_medium)[..., None], T_an, T)
    T = torch.where(in_medium[..., None], T, 1.0)
    return torch.where(active[..., None], T, 1.0), rng


def estimate_transmittance(scene, p0, ds, medium_idx0, channel, rng, active,
                           max_crossings=4, steps_per_segment=32):
    """Transmittance [N, C] from p0 toward the emitter sample ds, crossing
    up to max_crossings null-BSDF interfaces, one closest-hit query each;
    paths that need more crossings get 0. Returns (T, rng)."""
    d = ds.d
    p = p0
    remaining = ds.dist * (1.0 - 1e-3)
    medium = medium_idx0
    T = torch.ones(p0.shape[0], scene.n_channels, dtype=torch.float32, device=p0.device)
    alive = active & (ds.pdf > 0)
    for k in range(max_crossings):
        if not _any(alive):
            rng = rng.skip(2 * steps_per_segment * (max_crossings - k))
            break
        ray = spawn_ray(p, d, d, maxt=remaining)
        si = scene.ray_intersect(ray, alive)
        t_surf = torch.where(si.is_valid, si.t, float("inf"))
        seg_len = torch.minimum(t_surf, remaining)
        T_seg, rng = track_segment_ratio(scene, ray.o, d, seg_len, medium, channel, rng,
                                         alive, steps_per_segment)
        T = T * torch.where(alive[..., None], T_seg, 1.0)
        hit_surface = alive & si.is_valid & (t_surf < remaining)
        is_null = scene.is_null_bsdf(si)
        T = torch.where((hit_surface & ~is_null)[..., None], 0.0, T)
        cross = hit_surface & is_null
        medium = torch.where(cross, scene.medium_transition(si, d, medium), medium)
        adv = torch.where(cross, t_surf, 0.0)
        p = p + (adv + 1e-4)[..., None] * d
        remaining = remaining - adv
        alive = cross & (torch.amax(T, dim=-1) > 0)
    T = torch.where(alive[..., None], 0.0, T)     # crossings left over: 0
    return torch.where(active[..., None], T, 0.0), rng


def segment_events(scene, s, si, reached_end, real, t_real, max_depth):
    """What ended each lane's tracked segment: a dict of the surface
    interaction, the medium interaction at a real collision (mei, p_med,
    phase_idx) and the event masks."""
    active, ray_o, ray_d, medium = s["active"], s["ray_o"], s["ray_d"], s["medium"]
    surface_event = active & reached_end & si.is_valid
    p_med = ray_o + t_real[..., None] * ray_d
    depth_ok = s["depth"] + 1 < max_depth
    is_null_surf = scene.is_null_bsdf(si)
    return dict(
        si=si, real=real, p_med=p_med, depth_ok=depth_ok, is_null_surf=is_null_surf,
        mei=MediumInteraction.make(torch.where(real, t_real, float("inf")), p_med, ray_d, medium),
        phase_idx=scene.medium_phase_of(medium),
        surface_event=surface_event,
        escaped=active & reached_end & ~si.is_valid,
        null_cross=surface_event & is_null_surf,        # no depth count
        scatter_surf=surface_event & ~is_null_surf & depth_ok,
        scatter_med=real & depth_ok,
    )


def nee_setup(scene, s, ev, u0, u2a):
    """A segment's NEE up to its shadow ray: (nee_active, the reference
    point, the emitter's direction sample and weight, the shadow ray's
    medium and origin), off the surface on the emitter's side."""
    si, scatter_med, scatter_surf = ev["si"], ev["scatter_med"], ev["scatter_surf"]
    medium = s["medium"]
    nee_active = scatter_med | scatter_surf
    ref_p = torch.where(scatter_med[..., None], ev["p_med"], si.p)
    ds, em_weight = scene.sample_emitter_direction(ref_p, u0, u2a, nee_active,
                                                   test_visibility=False,
                                                   wavelengths=s["wavelengths"])
    nee_medium = torch.where(scatter_surf, scene.medium_transition(si, ds.d, medium), medium)
    side = torch.sign(torch.sum(si.n * ds.d, dim=-1))
    p_nee = torch.where(scatter_surf[..., None], si.p + side[..., None] * 1e-4 * si.n,
                        ev["p_med"])
    return nee_active, ref_p, ds, em_weight, nee_medium, p_nee


def nee_eval(scene, ops, ev, d, surf_active, wavelengths=None):
    """(value, pdf) toward the world direction d of each lane's phase
    (where it scattered in a medium) or BSDF (where surf_active): [N, C],
    or the world-frame Mueller matrix [N, C, 4, 4] in a polarized
    variant."""
    si, mei, phase_idx, scatter_med = ev["si"], ev["mei"], ev["phase_idx"], ev["scatter_med"]
    wo_med, wo_surf = mei.to_local(d), si.to_local(d)
    if ops.polarized:
        ph_val, ph_pdf = scene.phase_eval_pdf_pol(phase_idx, mei, wo_med, scatter_med)
        b_val, b_pdf = scene.bsdf_eval_pdf_pol(si, wo_surf, surf_active, wavelengths)
        f = torch.where(scatter_med[..., None, None, None], ph_val, b_val)
    else:
        ph_val, ph_pdf = scene.phase_eval_pdf(phase_idx, mei, wo_med, scatter_med)
        b_val, b_pdf = scene.bsdf_eval_pdf(si, wo_surf, surf_active, wavelengths)
        f = torch.where(scatter_med[..., None], ph_val, b_val)
    return f, torch.where(scatter_med, ph_pdf, b_pdf)


def emission(scene_mis, scene_val, ops, s, ev, beta):
    """Radiance of the escaped rays and of the emitters hit, through beta,
    MIS-weighted against the previous vertex's pdf: the weights from
    scene_mis, the emitted radiance from scene_val (the PRB replay's
    attached copy, or the same scene)."""
    ray_d, si, wl = s["ray_d"], ev["si"], s["wavelengths"]
    zero_L = torch.zeros_like(s["L"])
    env_pdf = torch.where(s["prev_delta"], 0.0, scene_mis.pdf_emitter_direction_escaped(ray_d))
    w_env = mis_weight(s["prev_pdf"], env_pdf)
    em_pdf = torch.where(s["prev_delta"], 0.0,
                         scene_mis.pdf_emitter_direction_hit(s["prev_p"], si))
    w_hit = mis_weight(s["prev_pdf"], em_pdf)
    return (ops.where_rad(ev["escaped"], ops.emit(beta, scene_val.eval_environment(ray_d, wl)
                                                  * w_env[..., None]), zero_L)
            + ops.where_rad(ev["surface_event"],
                            ops.emit(beta, scene_val.eval_emitter_hit(si, wl)
                                     * w_hit[..., None]), zero_L))


def advance(integrator, scene, ops, s, ev, beta, wo_ph, w_ph, pdf_ph, bs, bw, nee_active, ref_p,
            u_rr):
    """The path's state after its segment: the sampled direction taken,
    the throughput weighted, the medium crossed, the depth counted, the
    path ended where it escaped, exhausted its depth or lost its weight,
    and Russian roulette played. Returns the dict of the updated fields."""
    si, mei, p_med = ev["si"], ev["mei"], ev["p_med"]
    scatter_med, scatter_surf = ev["scatter_med"], ev["scatter_surf"]
    surface_event = ev["surface_event"]
    ray_o, ray_d, medium, active = s["ray_o"], s["ray_d"], s["medium"], s["active"]
    new_d = torch.where(scatter_med[..., None], mei.to_world(wo_ph),
                        torch.where(scatter_surf[..., None], si.to_world(bs.wo), ray_d))
    o_surf = spawn_ray(si.p, si.n, new_d).o
    new_o = torch.where(scatter_med[..., None], p_med,
                        torch.where(surface_event[..., None], o_surf, ray_o))
    beta = ops.where_beta(scatter_med, ops.apply(beta, w_ph), beta)
    beta = ops.where_beta(scatter_surf, ops.apply(beta, bw), beta)
    new_medium = torch.where(ev["null_cross"] | scatter_surf,
                             scene.medium_transition(si, new_d, medium), medium)
    scattered = scatter_med | scatter_surf
    new_depth = s["depth"] + scattered.to(torch.int64)
    new_prev_pdf = torch.where(scatter_med, pdf_ph,
                               torch.where(scatter_surf, bs.pdf, s["prev_pdf"]))
    new_prev_delta = torch.where(scatter_med, False,
                                 torch.where(scatter_surf, bs.delta, s["prev_delta"]))
    new_prev_p = torch.where(nee_active[..., None], ref_p, s["prev_p"])

    is_null_surf, depth_ok = ev["is_null_surf"], ev["depth_ok"]
    alive = active & ~ev["escaped"]
    alive = alive & ~(scatter_surf & (bs.pdf <= 0))
    alive = alive & ~(scatter_med & (pdf_ph <= 0))
    beta_int = ops.intensity_beta(beta)
    alive = alive & ~(surface_event & ~is_null_surf & ~depth_ok)
    alive = alive & ~(ev["real"] & ~depth_ok)
    alive = alive & (torch.amax(beta_int, dim=-1) > 0)

    # ---- Russian roulette ----
    beta_max = torch.amax(beta_int, dim=-1)
    rr_active = (new_depth >= integrator.rr_depth) & scattered
    q = torch.clamp(beta_max, max=0.95)
    beta = ops.where_beta(rr_active & alive,
                          ops.mul_scalar(beta, 1.0 / torch.clamp(q, min=1e-6)[..., None]), beta)
    alive = alive & (~rr_active | (u_rr < q))
    return dict(depth=new_depth, beta=beta, ray_o=new_o, ray_d=new_d, medium=new_medium,
                active=alive, prev_pdf=new_prev_pdf, prev_delta=new_prev_delta,
                prev_p=new_prev_p,
                **integrator._advance_extra(scene, si, s, new_d, scatter_surf))


@dataclass(frozen=True)
class VolPathIntegrator:
    max_depth: int = 8
    rr_depth: int = 5
    hide_emitters: bool = False
    max_segments: int = 0       # 0: max_depth + 8
    track_steps: int = 32
    nee_crossings: int = 4
    nee_steps: int = 32
    # path regeneration: a lane whose path ends starts its pixel's next
    # sample (volpath_regen_render)
    regenerate: bool = False

    def _budgets(self):
        max_depth = self.max_depth if self.max_depth > 0 else 64
        return max_depth, self.max_segments or (max_depth + 8)

    def sample(self, scene, rng, ray, active, wavelengths=None):
        """Radiance [N, C] along each ray and {"n_rays": rays cast}: per
        segment one closest hit per active lane and one shadow ray per
        NEE-active lane, counted in int64. `wavelengths` [N, 4]: the lanes'
        wavelengths in the spectral variants, None elsewhere."""
        ops = get_ops(scene.polarized)
        max_depth, max_segments = self._budgets()
        s = self._start(scene, ops, rng, ray, active,
                        ops.zero_radiance(ray.o.shape[0], scene.n_channels, ray.o.device),
                        wavelengths)
        s["n_rays"] = torch.zeros((), dtype=torch.int64, device=ray.o.device)
        for _ in range(max_segments):
            if not _any(s["active"]):
                break       # nothing changes L or n_rays any more
            s = self._bounce(scene, ops, max_depth, s)
        return s["L"], {"n_rays": s["n_rays"]}

    def _start(self, scene, ops, rng, ray, active, L, wavelengths=None):
        """Each lane's path state before its first segment (after the hero
        channel's draw), with radiance L; its wavelengths ride the state."""
        n = ray.o.shape[0]
        nc = scene.n_channels
        dev = ray.o.device
        u_ch, _, rng = rng.next_2d()
        return dict(
            depth=torch.zeros(n, dtype=torch.int64, device=dev),
            L=L,
            beta=ops.one(n, nc, dev),
            ray_o=ray.o,
            ray_d=ray.d,
            medium=torch.full((n,), scene.camera_medium, dtype=torch.int64, device=dev),
            channel=sample_channel(u_ch, nc),
            rng=rng,
            active=active,
            prev_pdf=torch.ones(n, dtype=torch.float32, device=dev),
            prev_delta=torch.ones(n, dtype=torch.bool, device=dev),
            prev_p=ray.o,
            wavelengths=wavelengths,
            **self._regen_extra(n, scene),
        )

    def _draws(self, rng):
        """A segment's fixed-order draws after its tracking: (u0, u2a,
        u_lobe, u2b, u2r, u_rr, rng); u2r is the atmosphere-ocean
        integrators' refraction proposal (None here)."""
        u0, u2a_x, rng = rng.next_2d()
        u2a_y, u_lobe, rng = rng.next_2d()
        u2b_x, u2b_y, rng = rng.next_2d()
        u_rr, _, rng = rng.next_2d()
        return (u0, torch.stack([u2a_x, u2a_y], dim=-1), u_lobe,
                torch.stack([u2b_x, u2b_y], dim=-1), None, u_rr, rng)

    def _nee(self, scene, ops, s, ev, beta, u0, u2a, u2r, rng):
        """The segment's NEE, with MIS against the phase or BSDF pdf:
        (its radiance, nee_active, the reference point, rng)."""
        nee_active, ref_p, ds, em_weight, nee_medium, p_nee = nee_setup(scene, s, ev, u0, u2a)
        T_nee, rng = estimate_transmittance(
            scene, p_nee, ds, nee_medium, s["channel"], rng, nee_active,
            max_crossings=self.nee_crossings, steps_per_segment=self.nee_steps)
        f_nee, pdf_fwd = nee_eval(scene, ops, ev, ds.d, ev["scatter_surf"], s["wavelengths"])
        w_nee = torch.where(ds.delta, 1.0, mis_weight(ds.pdf, pdf_fwd))
        nee_contrib = ops.contrib_nee(beta, f_nee, em_weight * T_nee * w_nee[..., None])
        return (ops.where_rad(nee_active, nee_contrib, torch.zeros_like(s["L"])), nee_active,
                ref_p, rng)

    def _advance_extra(self, scene, si, s, new_d, scatter_surf):
        """State beyond volpath's that a segment advances: none."""
        return {}

    def _bounce(self, scene, ops, max_depth, s):
        """One volumetric step of every lane: the scene intersection, the
        tracking of the segment, emission, NEE and the next direction.
        `s["channel"]` is each lane's hero channel."""
        channel = s["channel"]
        active = s["active"]
        ray_o, ray_d, medium = s["ray_o"], s["ray_d"], s["medium"]
        si = scene.ray_intersect(Ray.make(ray_o, ray_d), active)
        t_surf = torch.where(si.is_valid, si.t, float("inf"))

        # ---- delta-track the segment up to the surface ----
        reached_end, real, t_real, beta_f, rng = track_segment(
            scene, ray_o, ray_d, t_surf, medium, channel, s["rng"], active, self.track_steps)
        # tracking ratios are per-channel scalars: they keep the polarization
        beta = ops.mul_scalar(s["beta"], torch.where(active[..., None], beta_f, 1.0))
        ev = segment_events(scene, s, si, reached_end, real, t_real, max_depth)
        u0, u2a, u_lobe, u2b, u2r, u_rr, rng = self._draws(rng)

        # ---- emitter hit / escape, MIS against the previous pdf ----
        L = s["L"] + emission(scene, scene, ops, s, ev, beta)

        # ---- NEE ----
        nee_L, nee_active, ref_p, rng = self._nee(scene, ops, s, ev, beta, u0, u2a, u2r, rng)
        L = L + nee_L

        # ---- direction sampling ----
        mei, phase_idx, scatter_med, scatter_surf = (ev["mei"], ev["phase_idx"],
                                                     ev["scatter_med"], ev["scatter_surf"])
        wl = s["wavelengths"]
        if ops.polarized:
            wo_ph, w_ph, pdf_ph = scene.phase_sample_pol(phase_idx, mei, u_lobe, u2b, scatter_med)
            bs, bw = scene.bsdf_sample_pol(si, u_lobe, u2b, scatter_surf, wl)
        else:
            wo_ph, w_ph, pdf_ph = scene.phase_sample(phase_idx, mei, u_lobe, u2b, scatter_med)
            bs, bw = scene.bsdf_sample(si, u_lobe, u2b, scatter_surf, wl)
        n_rays = s["n_rays"] + active.sum() + nee_active.sum()
        return dict(s, L=L, rng=rng, n_rays=n_rays,
                    **advance(self, scene, ops, s, ev, beta, wo_ph, w_ph, pdf_ph, bs, bw,
                              nee_active, ref_p, u_rr))

    def _regen_extra(self, n, scene):
        """Per-lane state beyond the common fields that the regenerative
        loop resets when a lane restarts: none here (the reference's
        volpathaos keeps its refractive-interface memory in it)."""
        return {}

    def regen_render(self, scene, seed, spp, sensor_idx, record_samples=False):
        return volpath_regen_render(self, scene, seed, spp, sensor_idx, record_samples)


def regen_fresh(scene, seed, spp, sensor_idx):
    """fresh(sidx) -> (rng, ray, channel, wavelengths, wl_pdf): the stream,
    camera ray, hero channel and wavelengths (None outside the spectral
    variants) of each pixel's sample sidx, drawn as the wavefront draws
    them. The regenerative render and its PRB replay share it."""
    from ..render_api import wavefront_for

    n = scene.film.n_pixels
    pix = torch.arange(n, dtype=torch.int64, device=scene.device)

    def fresh(sidx):
        rng_f, ray_f, wl, wl_pdf, _ = wavefront_for(scene, seed, pix, sidx, spp, sensor_idx)
        u_ch, _, rng_f = lanes_rng(rng_f, n).next_2d()
        return rng_f, ray_f, sample_channel(u_ch, scene.n_channels), wl, wl_pdf

    return fresh


def lanes_where(m, a, b):
    """torch.where with the per-lane mask m [N] broadcast over the lane's
    trailing dimensions (a or b may be a Python number)."""
    nd = max(x.ndim for x in (a, b) if torch.is_tensor(x))
    return torch.where(m.reshape(m.shape + (1,) * (nd - 1)), a, b)


def volpath_restart(scene, ops, s, regen, rng_new, ray_new, ch_new, L_new, extra0,
                    wl_new=None, wlp_new=None):
    """Volumetric path state `s` with the lanes of `regen` restarted on a
    fresh sample: radiance L_new, unit throughput, the camera's medium, the
    new hero channel, wavelengths (spectral) and stream, the previous vertex
    reset, and the integrator's extra state (`extra0`) reset."""
    n, nc = regen.shape[0], scene.n_channels
    if wl_new is not None:
        s = dict(s, wavelengths=lanes_where(regen, wl_new, s["wavelengths"]),
                 wl_pdf=lanes_where(regen, wlp_new, s["wl_pdf"]))
    return dict(
        s,
        L=lanes_where(regen, L_new, s["L"]),
        beta=lanes_where(regen, ops.one(n, nc, regen.device), s["beta"]),
        ray_o=lanes_where(regen, ray_new.o, s["ray_o"]),
        ray_d=lanes_where(regen, ray_new.d, s["ray_d"]),
        medium=torch.where(regen, scene.camera_medium, s["medium"]),
        channel=torch.where(regen, ch_new, s["channel"]),
        rng=merge_rng(rng_new, s["rng"], regen),
        depth=torch.where(regen, 0, s["depth"]),
        prev_pdf=torch.where(regen, 1.0, s["prev_pdf"]),
        prev_delta=torch.where(regen, True, s["prev_delta"]),
        prev_p=lanes_where(regen, ray_new.o, s["prev_p"]),
        active=s["active"] | regen,
        **{k: lanes_where(regen, v, s[k]) for k, v in extra0.items()},
    )


def regen_start(scene, ops, ray0, ch0, rng0, L0, extra0, wl0=None, wlp0=None):
    """The regenerative loops' state before their first step: every lane
    inactive, waiting for its pixel's sample 0."""
    n = ray0.o.shape[0]
    dev = scene.device
    return dict(
        s_next=torch.zeros(n, dtype=torch.int64, device=dev),
        depth=torch.zeros(n, dtype=torch.int64, device=dev),
        L=L0,
        beta=ops.one(n, scene.n_channels, dev),
        ray_o=ray0.o,
        ray_d=ray0.d,
        medium=torch.full((n,), scene.camera_medium, dtype=torch.int64, device=dev),
        channel=ch0,
        rng=rng0,
        active=torch.zeros(n, dtype=torch.bool, device=dev),
        prev_pdf=torch.ones(n, dtype=torch.float32, device=dev),
        prev_delta=torch.ones(n, dtype=torch.bool, device=dev),
        prev_p=ray0.o,
        wavelengths=wl0,
        wl_pdf=wlp0,
        **extra0,
    )


def volpath_regen_render(integrator, scene, seed, spp, sensor_idx, record_samples=False):
    """Regenerative volumetric wavefront: one lane per pixel, and a lane
    whose path ends starts its pixel's next sample in the same step. Every
    sample draws the numbers it draws in the plain wavefront (its RNG is
    keyed by (pixel, sample) and its dimension counter is per lane), so
    only the schedule changes. Returns (L_px, the sum of each pixel's
    samples, {"n_rays", "wavefront_iters"}): [n_pixels, C], or in a
    polarized variant the Stokes vectors [n_pixels, C, 4] in the sensor
    frame, each finished path rotated there by its own camera ray (cam_d)
    as it is flushed, or in the spectral variant the film's channels
    [n_pixels, 3] (specfilm: one per SRF), each finished path converted at
    its own wavelengths as it is flushed. With `record_samples` the aux also
    holds "L_samples" [n_pixels, spp, C] ([n_pixels, spp, C, 4]), each
    sample's radiance in the integrator's frame and wavelengths, which the
    PRB replay starts from.

    The loop reads from the card, once per step, whether any lane has work
    left; it stops there or after spp * max_segments + 1 steps."""
    from ..render_api import to_sensor_mueller

    n = scene.film.n_pixels
    nc = scene.n_channels
    spectral = nc == 4 and not scene.polarized
    ops = get_ops(scene.polarized)
    max_depth, max_segments = integrator._budgets()
    dev = scene.device
    fresh = regen_fresh(scene, seed, spp, sensor_idx)
    extra0 = integrator._regen_extra(n, scene)

    def finish(L, s):
        """A finished path's value on the film."""
        if scene.polarized:
            return to_sensor_mueller(s["cam_d"], L)
        if spectral:
            return spectral_to_film(scene.film, L, s["wavelengths"], s["wl_pdf"])
        return L

    rng0, ray0, ch0, wl0, wlp0 = fresh(torch.zeros(n, dtype=torch.int64, device=dev))
    L0 = ops.zero_radiance(n, nc, dev)
    n_film = (len(scene.film.srfs) or 3) if spectral else nc
    s = dict(regen_start(scene, ops, ray0, ch0, rng0, L0, extra0, wl0, wlp0),
             n_rays=torch.zeros((), dtype=torch.int64, device=dev),
             L_px=torch.zeros((n, n_film) + L0.shape[2:], dtype=torch.float32, device=dev),
             cam_d=ray0.d, cur_sample=torch.zeros(n, dtype=torch.int64, device=dev))
    L_samples = torch.zeros((n, spp) + L0.shape[1:], dtype=torch.float32,
                            device=dev) if record_samples else None
    iters = 0
    while iters < spp * max_segments + 1 and _any(s["active"] | (s["s_next"] < spp)):
        regen = ~s["active"] & (s["s_next"] < spp)
        rng_new, ray_new, ch_new, wl_new, wlp_new = fresh(s["s_next"])
        if record_samples:
            # the flushed radiance is the sample the lane held before
            record_flush(L_samples, s["cur_sample"], regen & (s["s_next"] > 0), s["L"])
        s = dict(
            volpath_restart(scene, ops, s, regen, rng_new, ray_new, ch_new, 0.0, extra0, wl_new,
                            wlp_new),
            # flush the finished path into its pixel
            L_px=s["L_px"] + lanes_where(regen, finish(s["L"], s), 0.0),
            cam_d=lanes_where(regen, ray_new.d, s["cam_d"]),
            cur_sample=torch.where(regen, s["s_next"], s["cur_sample"]),
            s_next=torch.where(regen, s["s_next"] + 1, s["s_next"]),
        )
        s = integrator._bounce(scene, ops, max_depth, s)
        iters += 1
    # every lane ends inactive: flush each lane's last path
    started = s["s_next"] > 0
    L_px = s["L_px"] + lanes_where(started, finish(s["L"], s), 0.0)
    aux = {"n_rays": s["n_rays"], "wavefront_iters": iters}
    if record_samples:
        record_flush(L_samples, s["cur_sample"], started, s["L"])
        aux["L_samples"] = L_samples
    return L_px, aux
