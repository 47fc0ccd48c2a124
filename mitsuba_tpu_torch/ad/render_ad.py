"""The PRB render pass as an autograd node (counterpart of
mitsuba_tpu/ad/render_ad.py).

The per-lane render pass is the boundary: its inputs are the scene's float
parameter tensors that require grad. Its backward runs its own primal pass
and the replay, both seeded with ``seed_grad``, which must differ from the
primal's seed: correlated primal and gradient samples bias the gradient of
any loss that is not linear in the image.

The measurement conversion lives inside the node: in a polarized variant
each lane's Stokes vector is rotated into the sensor frame
(to_sensor_mueller, the ray direction detached), so the incoming cotangent
is the sensor-frame Stokes adjoint, and the backward pulls it back through
the same rotation at the backward pass's own lanes before the replay. In
the spectral variants (unpolarized) the lanes' spectra become the film's
channels inside the node (render/film.py:spectral_to_film, the wavelength
pdf detached), and the backward pulls the cotangent back through that
conversion's VJP at the backward pass's own lanes, their wavelengths and
primal radiance. render_1 and render_test take the ``raw`` form: the
lanes' spectra, with no conversion.

Under filter importance sampling a lane's pixel is lane // spp, so the
incoming cotangent dL is a per-pixel film adjoint that does not depend on
the pass's random numbers, and it is also the adjoint of the backward
pass's fresh lanes. With ``spp_grad`` the backward pass takes its own sample
count: the per-lane adjoint is refolded to it, which is exact for these
mean-develop films.

Under path regeneration (``regenerate``) the boundary is the per-pixel
sample sum instead (``prb_regen_px``): the forward is the integrator's
regenerative render, the backward a fresh regenerative render at
``seed_grad`` that records each sample's radiance, and the regenerative
replay from those radiances. The measurement conversion happens at each
path's flush inside both loops, so the node's cotangent is the film's.
"""
from __future__ import annotations

import torch

from ..core.rng import MASK32, sample_tea_32
from ..render.film import spectral_to_film, spectral_to_film_adjoint
from .prb import detach_scene, grad_leaves


def _postprocess(scene, L, ray_d, wavelengths=None, wl_pdf=None, raw=False):
    """The per-lane measurement: polarized, the Stokes vectors [n, C, 4] in
    the sensor frame; spectral (unpolarized, unless `raw`), the film's
    channels of the lanes' spectra at their wavelengths; otherwise L."""
    if scene.polarized and L.ndim == 3:
        from ..render_api import to_sensor_mueller

        return to_sensor_mueller(ray_d.detach(), L)
    if raw or wavelengths is None or scene.polarized:
        return L
    return spectral_to_film(scene.film, L, wavelengths, wl_pdf)


def _postprocess_adjoint(scene, dL, ray_d, L=None, wavelengths=None, wl_pdf=None, raw=False):
    """The adjoint of _postprocess at the lanes of ray_d whose raw
    radiance is L: the rotation's transpose (it is orthogonal per lane),
    the VJP of the spectral conversion at L, or dL itself."""
    if scene.polarized and dL.ndim == 3:
        from ..render_api import sensor_stokes_rotation

        return torch.einsum("nij,nci->ncj", sensor_stokes_rotation(ray_d), dL)
    if raw or wavelengths is None or scene.polarized:
        return dL
    return spectral_to_film_adjoint(scene.film, dL, L, wavelengths, wl_pdf)


def _primal(scene, seed, lane0, n, pass_base, spp_pass, spp_total, sensor_idx):
    """(rng, ray, wavelengths, wl_pdf, L, aux) of one detached primal pass
    over lanes [lane0, lane0 + n): L is [n, C], or Stokes [n, C, 4] in the
    frame of each lane's path."""
    from ..render_api import make_wavefront

    with torch.no_grad():
        rng, ray, wl, wl_pdf, _ = make_wavefront(scene, seed, lane0, n, pass_base, spp_pass,
                                                 spp_total, sensor_idx)
        active = torch.ones(n, dtype=torch.bool, device=scene.device)
        L, aux = scene.integrator.sample(scene, rng, ray, active, wl)
    return rng, ray, wl, wl_pdf, L, aux


class PRBPassLanes(torch.autograd.Function):
    """Measurement [n, C] (polarized: sensor-frame Stokes [n, C, 4]) of a
    pass's lanes, with PRB gradients for the scene tensors given as inputs.
    `args` holds everything else."""

    @staticmethod
    def forward(ctx, args, *leaves):
        _, ray, wl, wl_pdf, L, aux = _primal(args["scene"], args["seed"], args["lane0"],
                                             args["n"], args["pass_base"], args["spp_pass"],
                                             args["spp_total"], args["sensor_idx"])
        args["aux"] = aux
        ctx.args, ctx.leaves = args, leaves
        return _postprocess(args["scene"], L, ray.d, wl, wl_pdf, args["raw"])

    @staticmethod
    def backward(ctx, dL):
        a = ctx.args
        scene = detach_scene(a["scene"])
        lane0, n, pass_base = a["lane0"], a["n"], a["pass_base"]
        spp_pass, spp_total, spp_grad = a["spp_pass"], a["spp_total"], a["spp_grad"]
        if spp_grad is not None and spp_grad != spp_pass:
            # refold the per-lane adjoint to the backward lane set: each
            # forward lane carries A_px / spp_total, so a pixel's adjoint is
            # its lanes' sum and each of its spp_grad fresh lanes takes
            # A_px / spp_grad
            pixels = n // spp_pass
            dL_px = dL.reshape((pixels, spp_pass) + dL.shape[1:]).sum(dim=1)
            dL = torch.repeat_interleave(dL_px * (spp_total / (spp_pass * spp_grad)), spp_grad, 0)
            n = pixels * spp_grad
            lane0 = (lane0 // spp_pass) * spp_grad
            pass_base, spp_pass, spp_total = 0, spp_grad, spp_grad
        rng, ray, wl, wl_pdf, L, aux = _primal(scene, a["seed_grad"], lane0, n, pass_base,
                                               spp_pass, spp_total, a["sensor_idx"])
        active = torch.ones(n, dtype=torch.bool, device=scene.device)
        dL_raw = _postprocess_adjoint(scene, dL, ray.d, L, wl, wl_pdf, a["raw"])
        grads, n_replay = a["scene"].integrator.sample_backward(
            a["scene"], ctx.leaves, rng, ray, dL_raw, L, active, wl
        )
        stats = a["stats"]
        if stats is not None:
            stats["n_rays_grad"] = (stats.get("n_rays_grad", 0) + int(aux["n_rays"])
                                    + int(n_replay))
        return (None, *grads)


def prb_pass_lanes(scene, seed, seed_grad, lane0, n, pass_base, spp_pass, spp_total,
                   sensor_idx=0, spp_grad=None, stats=None, raw=False):
    """(measurement [n, C] (polarized: [n, C, 4]) of lanes [lane0, lane0 +
    n), {"n_rays": rays cast}) with PRB gradients for the scene's parameter
    tensors that require grad.
    `seed_grad` seeds the backward pass's primal and replay; `spp_grad` sets
    its sample count (None or spp_pass: the forward's lanes). When `stats`
    is a dict, the backward pass adds the rays it casts (its primal and the
    replay) to stats["n_rays_grad"]. With `raw` the spectral variants'
    lanes keep their spectra (render_1's measurement)."""
    args = dict(scene=scene, seed=seed, seed_grad=seed_grad, lane0=lane0, n=n,
                pass_base=pass_base, spp_pass=spp_pass, spp_total=spp_total,
                sensor_idx=sensor_idx, spp_grad=spp_grad, stats=stats, raw=raw)
    L = PRBPassLanes.apply(args, *grad_leaves(scene))
    return L, args["aux"]


class PRBRegenPixels(torch.autograd.Function):
    """The per-pixel sample sums L_px [n_pixels, C] (polarized: sensor-frame
    Stokes [n_pixels, C, 4]) of a regenerative render, with PRB gradients
    for the scene tensors given as inputs. `args` holds everything else."""

    @staticmethod
    def forward(ctx, args, *leaves):
        scene = args["scene"]
        with torch.no_grad():
            L_px, args["aux"] = scene.integrator.regen_render(scene, args["seed"], args["spp"],
                                                              args["sensor_idx"])
        ctx.args, ctx.leaves = args, leaves
        return L_px

    @staticmethod
    def backward(ctx, dL_px):
        a = ctx.args
        scene = a["scene"]
        with torch.no_grad():
            _, aux = scene.integrator.regen_render(detach_scene(scene), a["seed_grad"], a["spp"],
                                                   a["sensor_idx"], record_samples=True)
        grads, rep = scene.integrator.regen_backward(scene, ctx.leaves, a["seed_grad"], a["spp"],
                                                     a["sensor_idx"], dL_px, aux["L_samples"])
        stats = a["stats"]
        if stats is not None:
            stats["n_rays_grad"] = (stats.get("n_rays_grad", 0) + int(aux["n_rays"])
                                    + int(rep["n_rays"]))
            stats["wavefront_iters_grad"] = aux["wavefront_iters"]
            stats["wavefront_iters_replay"] = rep["wavefront_iters"]
        return (None, *grads)


def prb_regen_px(scene, seed, seed_grad, spp, sensor_idx=0, stats=None):
    """(L_px, the per-pixel sample sums of the integrator's regenerative
    render at `seed`, its {"n_rays", "wavefront_iters"}) with PRB gradients
    for the scene's tensors that require grad, replayed at `seed_grad`.
    When `stats` is a dict, the backward pass adds the rays it casts (its
    primal and the replay) to stats["n_rays_grad"] and sets the steps of
    its primal and replay loops (wavefront_iters_grad,
    wavefront_iters_replay)."""
    args = dict(scene=scene, seed=seed, seed_grad=seed_grad, spp=spp, sensor_idx=sensor_idx,
                stats=stats)
    L_px = PRBRegenPixels.apply(args, *grad_leaves(scene))
    return L_px, args["aux"]


def derive_seed_grad(seed, seed_grad=None):
    """The gradient pass's seed: `seed_grad` when given (a ValueError when
    it equals `seed`: the primal and gradient phases must be
    decorrelated), else the TEA hash of the primal seed."""
    if seed_grad is not None:
        if isinstance(seed, int) and isinstance(seed_grad, int) and seed == seed_grad:
            raise ValueError(
                "seed_grad must differ from seed: the primal and differential "
                "phases must be decorrelated"
            )
        return int(seed_grad) & MASK32
    return sample_tea_32(int(seed) & MASK32, 1)[0]


def prb_pass(scene, seed, seed_grad, pass_base, spp_pass, spp_total, sensor_idx=0,
             spp_grad=None, stats=None, raw=False):
    """prb_pass_lanes over every lane of one pass of the film."""
    return prb_pass_lanes(scene, seed, seed_grad, 0, scene.film.n_pixels * spp_pass,
                          pass_base, spp_pass, spp_total, sensor_idx, spp_grad, stats, raw)
