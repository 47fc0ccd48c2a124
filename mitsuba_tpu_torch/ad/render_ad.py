"""The PRB render pass as an autograd node (counterpart of
mitsuba_tpu/ad/render_ad.py, RGB only).

The per-lane render pass is the boundary: its inputs are the scene's float
parameter tensors that require grad. Its backward runs its own primal pass
and the replay, both seeded with ``seed_grad``, which must differ from the
primal's seed: correlated primal and gradient samples bias the gradient of
any loss that is not linear in the image.

Under filter importance sampling a lane's pixel is lane // spp, so the
incoming cotangent dL is a per-pixel film adjoint that does not depend on
the pass's random numbers, and it is also the adjoint of the backward
pass's fresh lanes. With ``spp_grad`` the backward pass takes its own sample
count: the per-lane adjoint is refolded to it, which is exact for these
mean-develop films.

Not ported: the spectral and polarized measurement conversions of
``_postprocess`` and the regenerative ``prb_regen_px`` (with the volume and
polarized slices).
"""
from __future__ import annotations

import torch

from ..core.rng import MASK32, sample_tea_32
from .prb import detach_scene, grad_leaves


def _primal(scene, seed, lane0, n, pass_base, spp_pass, spp_total, sensor_idx):
    """(rng, ray, L [n, 3], aux) of one detached primal pass over lanes
    [lane0, lane0 + n)."""
    from ..render_api import make_wavefront

    with torch.no_grad():
        rng, ray, _ = make_wavefront(scene, seed, lane0, n, pass_base, spp_pass, spp_total,
                                     sensor_idx)
        active = torch.ones(n, dtype=torch.bool, device=scene.device)
        L, aux = scene.integrator.sample(scene, rng, ray, active)
    return rng, ray, L, aux


class PRBPassLanes(torch.autograd.Function):
    """Radiance [n, 3] of a pass's lanes, with PRB gradients for the scene
    tensors given as inputs. `args` holds everything else."""

    @staticmethod
    def forward(ctx, args, *leaves):
        _, _, L, aux = _primal(args["scene"], args["seed"], args["lane0"], args["n"],
                               args["pass_base"], args["spp_pass"], args["spp_total"],
                               args["sensor_idx"])
        args["aux"] = aux
        ctx.args, ctx.leaves = args, leaves
        return L

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
            dL_px = dL.reshape(pixels, spp_pass, dL.shape[-1]).sum(dim=1)
            dL = torch.repeat_interleave(dL_px * (spp_total / (spp_pass * spp_grad)), spp_grad, 0)
            n = pixels * spp_grad
            lane0 = (lane0 // spp_pass) * spp_grad
            pass_base, spp_pass, spp_total = 0, spp_grad, spp_grad
        rng, ray, L, aux = _primal(scene, a["seed_grad"], lane0, n, pass_base, spp_pass,
                                   spp_total, a["sensor_idx"])
        active = torch.ones(n, dtype=torch.bool, device=scene.device)
        grads, n_replay = a["scene"].integrator.sample_backward(
            a["scene"], ctx.leaves, rng, ray, dL, L, active
        )
        stats = a["stats"]
        if stats is not None:
            stats["n_rays_grad"] = (stats.get("n_rays_grad", 0) + int(aux["n_rays"])
                                    + int(n_replay))
        return (None, *grads)


def prb_pass_lanes(scene, seed, seed_grad, lane0, n, pass_base, spp_pass, spp_total,
                   sensor_idx=0, spp_grad=None, stats=None):
    """(radiance [n, 3] of lanes [lane0, lane0 + n), {"n_rays": rays cast})
    with PRB gradients for the scene's parameter tensors that require grad.
    `seed_grad` seeds the backward pass's primal and replay; `spp_grad` sets
    its sample count (None or spp_pass: the forward's lanes). When `stats`
    is a dict, the backward pass adds the rays it casts (its primal and the
    replay) to stats["n_rays_grad"]."""
    args = dict(scene=scene, seed=seed, seed_grad=seed_grad, lane0=lane0, n=n,
                pass_base=pass_base, spp_pass=spp_pass, spp_total=spp_total,
                sensor_idx=sensor_idx, spp_grad=spp_grad, stats=stats)
    L = PRBPassLanes.apply(args, *grad_leaves(scene))
    return L, args["aux"]


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
             spp_grad=None, stats=None):
    """prb_pass_lanes over every lane of one pass of the film."""
    return prb_pass_lanes(scene, seed, seed_grad, 0, scene.film.n_pixels * spp_pass,
                          pass_base, spp_pass, spp_total, sensor_idx, spp_grad, stats)
