"""Path-replay backpropagation (counterpart of mitsuba_tpu/ad/prb.py).

The primal pass is the ordinary path trace and records nothing. The
backward pass replays the same paths (the same counter-based random
numbers, drawn in the same order as ``PathIntegrator.sample``) and at each
bounce adds the parameter gradient of the bounce's attached terms:

    Le     = beta * mis * emitter radiance at the hit         (emitters)
    Lr_dir = beta * mis_em * bsdf_eval * emitter radiance * ratio
                                                              (BSDFs, emitters)
    Lr_ind = L_remaining * bsdf_eval / detached(bsdf_eval)    (BSDFs)

while L, starting at the primal radiance, gives up Le + Lr_dir at every
bounce, so that it always holds the radiance of the path's remaining suffix.

Each bounce's attached terms are evaluated on a copy of the scene whose
parameter tensors are fresh leaves that require grad, and their VJP is one
``torch.autograd.grad(sum(dL * Lo), leaves)``: the graph lives for one
bounce only, so the backward pass needs O(wavefront + parameters) memory,
not a tape through the bounce loop. The path itself (intersections, NEE
shadow rays, BSDF sampling, Russian roulette) advances detached, exactly as
the primal does.

``regen_backward`` replays path regeneration (integrators/path.py:
path_regen_render): one lane per pixel, each restarted on its pixel's next
sample with that sample's recorded primal radiance, every bounce's tests
on the lane's own depth.

The volumetric replays (prbvolpath, prb_polarized, prb_volpathaos) are
ad/prbvolpath.py's.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..core.rng import lanes_rng
from ..integrators.path import PathIntegrator, _lanes, emitter_mis_weights, mis_weight, restart
from ..render.records import Ray, spawn_ray


def map_tensors(obj, fn):
    """`obj` (a scene or any part of one) with every tensor t replaced by
    fn(t): dataclasses and tuples are rebuilt, everything else is kept."""
    if torch.is_tensor(obj):
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: map_tensors(getattr(obj, f.name), fn)
            for f in dataclasses.fields(obj) if f.init
        })
    if isinstance(obj, tuple):
        return tuple(map_tensors(x, fn) for x in obj)
    return obj


def grad_leaves(scene):
    """The float tensors of `scene` that require grad, each once, in the
    scene's field order: the inputs of the PRB pass's autograd node."""
    found = {}

    def visit(x):
        if x.requires_grad and x.is_floating_point():
            found.setdefault(id(x), x)
        return x

    map_tensors(scene, visit)
    return list(found.values())


def detach_scene(scene):
    return map_tensors(scene, torch.Tensor.detach)


def attach_scene(scene, leaves):
    """(scene copy, fresh leaves): every tensor of `leaves` replaced by a
    detached copy that requires grad, every other tensor detached."""
    fresh = {id(x): x.detach().requires_grad_() for x in leaves}
    scene_att = map_tensors(scene, lambda x: fresh.get(id(x), x.detach()))
    return scene_att, [fresh[id(x)] for x in leaves]


def vjp_into(grads, objective, att):
    """grads += d objective / d att, one autograd.grad (nothing where the
    objective does not depend on att)."""
    if objective.requires_grad:
        for g, ct in zip(grads, torch.autograd.grad(objective, att, allow_unused=True)):
            if ct is not None:
                g += ct


@dataclass
class _Path:
    """The replayed path's state between two bounces."""

    L: torch.Tensor           # [N, 3] remaining (suffix) radiance
    beta: torch.Tensor        # [N, 3]
    eta: torch.Tensor         # [N]
    ray_o: torch.Tensor
    ray_d: torch.Tensor
    rng: object
    active: torch.Tensor      # [N] bool
    prev_pdf: torch.Tensor
    prev_delta: torch.Tensor
    prev_p: torch.Tensor


@dataclass(frozen=True)
class PRBIntegrator(PathIntegrator):
    """Detached-sampling PRB surface integrator: the primal is
    PathIntegrator.sample; sample_backward replays it."""

    is_prb = True

    def sample_backward(self, scene, leaves, rng, ray, dL, L_primal, active, wavelengths=None):
        """Replay the paths of (rng, ray) (at the lanes' `wavelengths` in
        the spectral variants) from their primal radiance L_primal [N, C]
        and return (the gradients of sum(dL * L) with respect to each tensor
        of `leaves`, the rays cast: one closest hit per active lane and,
        with NEE, one shadow ray per NEE-active lane of each bounce)."""
        n = ray.o.shape[0]
        dev = ray.o.device
        max_depth = self.max_depth if self.max_depth > 0 else 1024
        scene_d = detach_scene(scene)
        scene_att, att = attach_scene(scene, leaves)
        grads = [torch.zeros_like(x) for x in leaves]
        dL = dL.detach()
        s = _Path(
            L=L_primal.detach(), beta=torch.ones_like(L_primal), eta=torch.ones(n, device=dev),
            ray_o=ray.o, ray_d=ray.d, rng=rng, active=active,
            prev_pdf=torch.ones(n, device=dev),
            prev_delta=torch.ones(n, dtype=torch.bool, device=dev), prev_p=ray.o,
        )
        n_rays = torch.zeros((), dtype=torch.int64, device=dev)
        for depth in range(min(max_depth, 1024)):
            s, cast = self._bwd_bounce(scene_d, scene_att, att, grads, dL, max_depth, depth, s,
                                       wavelengths)
            n_rays = n_rays + cast
        return grads, n_rays

    def regen_backward(self, scene, leaves, seed, spp, sensor_idx, dL_px, L_samples):
        """Replay path_regen_render at `seed` and return (the gradients of
        sum(dL_px * L_px) for each tensor of `leaves`, {"n_rays": rays
        cast, "wavefront_iters": steps}). Each lane restarts on its pixel's
        next sample with L = that sample's primal radiance from L_samples
        [n_pixels, spp, C], a unit throughput and a fresh stream, drawn as
        the primal drew them; every sample of a pixel takes the pixel's
        adjoint dL_px [n_pixels, C]. The loop reads from the card once per
        step whether any lane has work left, as the primal's does."""
        from ..render_api import wavefront_for

        n = scene.film.n_pixels
        dev = scene.device
        max_depth = self.max_depth if self.max_depth > 0 else 1024
        pix = torch.arange(n, dtype=torch.int64, device=dev)
        scene_d = detach_scene(scene)
        scene_att, att = attach_scene(scene, leaves)
        grads = [torch.zeros_like(x) for x in leaves]
        dL, L_samples = dL_px.detach(), L_samples.detach()
        rng0, ray0, _, _, _ = wavefront_for(scene_d, seed, pix, torch.zeros_like(pix), spp, sensor_idx)
        s = _Path(
            L=torch.zeros_like(L_samples[:, 0]), beta=torch.ones_like(L_samples[:, 0]),
            eta=torch.ones(n, device=dev), ray_o=ray0.o, ray_d=ray0.d, rng=lanes_rng(rng0, n),
            active=torch.zeros(n, dtype=torch.bool, device=dev),
            prev_pdf=torch.ones(n, device=dev),
            prev_delta=torch.ones(n, dtype=torch.bool, device=dev), prev_p=ray0.o,
        )
        s_next = torch.zeros(n, dtype=torch.int64, device=dev)
        depth = torch.zeros(n, dtype=torch.int64, device=dev)
        n_rays = torch.zeros((), dtype=torch.int64, device=dev)
        iters = 0
        while iters < spp * max_depth + 1 and bool((s.active | (s_next < spp)).any()):
            regen = ~s.active & (s_next < spp)
            rng_new, ray_new, _, _, _ = wavefront_for(scene_d, seed, pix, s_next, spp, sensor_idx)
            L_fresh = L_samples[pix, torch.clamp(s_next, max=spp - 1)]
            s = _Path(**restart(vars(s), regen, rng_new, ray_new, L_fresh))
            depth = torch.where(regen, 0, depth)
            s_next = torch.where(regen, s_next + 1, s_next)
            s, cast = self._bwd_bounce(scene_d, scene_att, att, grads, dL, max_depth, depth, s)
            depth = depth + 1
            n_rays = n_rays + cast
            iters += 1
        return grads, {"n_rays": n_rays, "wavefront_iters": iters}

    def _bwd_bounce(self, scene_d, scene_att, att, grads, dL, max_depth, depth, s,
                    wavelengths=None):
        """One replay bounce: adds the bounce's VJP into `grads` and returns
        (the next state, the rays this bounce cast). `depth` is the bounce's
        index, one int for every lane (the wavefront) or an int64 tensor per
        lane (the regenerative replay)."""
        nee = self.use_nee
        rng = s.rng
        si = scene_d.ray_intersect(Ray.make(s.ray_o, s.ray_d), s.active)
        shown = (depth != 0) | (not self.hide_emitters)

        # ---- detached MIS weights of emitter hits and escaped rays ----
        escaped = _lanes(shown, s.active & ~si.is_valid)
        hit_em = _lanes(shown, s.active & si.is_valid)
        w_env, w_em = emitter_mis_weights(scene_d, nee, si, s.ray_d, s.prev_pdf,
                                          s.prev_delta, s.prev_p)

        def emitted(sc):
            return (torch.where(escaped[..., None], s.beta * w_env[..., None]
                                * sc.eval_environment(s.ray_d, wavelengths), 0.0)
                    + torch.where(hit_em[..., None], s.beta * w_em[..., None]
                                  * sc.eval_emitter_hit(si, wavelengths), 0.0))

        Le_det = emitted(scene_d)
        active_next = s.active & si.is_valid & (depth + 1 < max_depth)

        # ---- the draw order of PathIntegrator.sample ----
        u0, u2a_x, rng = rng.next_2d()
        u2a_y, u_lobe, rng = rng.next_2d()
        u2b_x, u2b_y, rng = rng.next_2d()
        u_rr, _, rng = rng.next_2d()

        if nee:
            ds, em_weight_d = scene_d.sample_emitter_direction(
                si.p, u0, torch.stack([u2a_x, u2a_y], dim=-1), active_next,
                test_visibility=True, ref_n=si.n, wavelengths=wavelengths,
            )
            wo_em = si.to_local(ds.d)
            bsdf_val_em_d, bsdf_pdf_em = scene_d.bsdf_eval_pdf(si, wo_em, active_next,
                                                               wavelengths)
            w_nee = torch.where(ds.delta, 1.0, mis_weight(ds.pdf, bsdf_pdf_em))
            Lr_dir_det = torch.where(
                active_next[..., None], s.beta * bsdf_val_em_d * em_weight_d * w_nee[..., None],
                0.0,
            )
            # the detached ratio that carries the NEE weight's pdf,
            # visibility and geometry; the attached term multiplies the
            # emitter's radiance back in
            em_val_d = scene_d.eval_emitter_sample(ds, wavelengths)
            em_ratio = torch.where(
                em_val_d > 1e-20, em_weight_d / torch.clamp(em_val_d, min=1e-20), 0.0
            )
        else:
            Lr_dir_det = torch.zeros_like(s.L)

        bs, bsdf_weight_d = scene_d.bsdf_sample(
            si, u_lobe, torch.stack([u2b_x, u2b_y], dim=-1), active_next, wavelengths
        )
        # inverse of the detached continuing weight
        bsdf_val_det = bsdf_weight_d * bs.pdf[..., None]
        inv_det = torch.where(
            bsdf_val_det > 1e-20, 1.0 / torch.clamp(bsdf_val_det, min=1e-20), 0.0
        )
        # remaining radiance after this vertex
        L_next = s.L - Le_det - Lr_dir_det

        # ---- the bounce's attached terms and their VJP ----
        with torch.enable_grad():
            Lo = emitted(scene_att)
            if nee:
                bsdf_val_em_a, _ = scene_att.bsdf_eval_pdf(si, wo_em, active_next, wavelengths)
                Lo = Lo + torch.where(
                    active_next[..., None],
                    s.beta * bsdf_val_em_a
                    * (scene_att.eval_emitter_sample(ds, wavelengths) * em_ratio)
                    * w_nee[..., None],
                    0.0,
                )
            bsdf_val_a, _ = scene_att.bsdf_eval_pdf(si, bs.wo, active_next, wavelengths)
            Lo = Lo + torch.where(active_next[..., None], L_next * bsdf_val_a * inv_det, 0.0)
            vjp_into(grads, (dL * Lo).sum(), att)

        # ---- advance the detached path exactly as the primal does ----
        new_ray = spawn_ray(si.p, si.n, si.to_world(bs.wo))
        beta = s.beta * bsdf_weight_d
        eta = s.eta * bs.eta
        alive = active_next & (bs.pdf > 0) & torch.any(beta > 0, dim=-1)
        rr = depth + 1 >= self.rr_depth
        if rr is not False:
            q = torch.clamp(torch.amax(beta, dim=-1) * eta * eta, max=0.95)
            beta = torch.where(_lanes(rr, alive)[..., None],
                               beta / torch.clamp(q, min=1e-6)[..., None], beta)
            alive = alive & (u_rr < q if rr is True else ~rr | (u_rr < q))
        cast = s.active.sum() + (active_next.sum() if nee else 0)
        return _Path(
            L=L_next, beta=beta, eta=eta, ray_o=new_ray.o, ray_d=new_ray.d, rng=rng,
            active=alive, prev_pdf=bs.pdf, prev_delta=bs.delta, prev_p=si.p,
        ), cast
