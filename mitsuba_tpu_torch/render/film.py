"""Film and filter-importance-sampled reconstruction (counterpart of
mitsuba_tpu/render/film.py).

Each sample's film position is drawn from the normalized reconstruction
filter around its pixel, so every sample adds weight 1 to its own pixel and
developing is a mean over the samples of a pixel. The box, tent and
gaussian filters take this path. The weighted filters with negative lobes
(mitchell, catmullrom, lanczos) and crop windows are not yet ported.

The port sums a pixel's samples one sample index after another, always in
that order (``accumulate``): a render split into several passes then adds
the same numbers in the same order as one pass, and the image is bitwise
independent of the split.

Before a pass's values reach the film, render_api.warn_invalid drops the
non-finite ones and clamps the negative ones to 0, except where the
integrator's output is signed (``signed_output``, the AOV integrator's
normals and positions): the reference's film warns of negative radiance
only.

Polarized variants put the raw Stokes components on the film: per-lane
[N, C, 4] values develop to [H, W, 4, C], Stokes-major, as the reference's
film does; no colour conversion is applied.

In the spectral variants a lane's radiance at its four wavelengths becomes
the film's channels by ``spectral_to_film``: linear sRGB through CIE XYZ
(clipped at 0), or, on a ``specfilm``, one channel per sensor response
function (``srfs``), each the SRF-weighted mean radiance over the range.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..core import spectrum as spec
from ..core.warp import interval_to_tent

FIS_FILTERS = ("box", "tent", "gaussian")


@dataclass(frozen=True)
class Film:
    """hdrfilm configuration."""

    width: int
    height: int
    rfilter: str = "gaussian"
    # specfilm: the sensor response functions (spectra), one per channel,
    # and each one's integral over [360, 830] nm; () on an hdrfilm
    srfs: tuple = ()
    srf_norms: tuple = ()

    def __post_init__(self):
        if self.rfilter not in FIS_FILTERS:
            raise NotImplementedError(
                f"reconstruction filter {self.rfilter!r} is not yet ported; "
                f"ported: {FIS_FILTERS}"
            )

    @property
    def n_pixels(self):
        return self.width * self.height


def sample_filter_offset(rfilter: str, u2):
    """Offset within a pixel, importance-sampled from the reconstruction
    filter, in pixel units from the pixel's lower corner."""
    if rfilter == "box":
        return u2
    if rfilter == "tent":
        # tent of radius 1 px
        return 0.5 + torch.stack(
            [interval_to_tent(u2[..., 0]), interval_to_tent(u2[..., 1])], dim=-1
        )
    if rfilter != "gaussian":
        raise NotImplementedError(f"reconstruction filter {rfilter!r} is not yet ported")
    # gaussian: standard deviation 1/3 px, loosely truncated
    r = torch.sqrt(-2.0 * torch.log(torch.clamp(1.0 - u2[..., 0] * 0.9999, min=1e-9)))
    phi = 2.0 * math.pi * u2[..., 1]
    sigma = 1.0 / 3.0
    return 0.5 + sigma * torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def srf_norms(srfs, device):
    """Each SRF's trapezoid integral over 512 points of [360, 830] nm."""
    lam = torch.linspace(360.0, 830.0, 512, dtype=torch.float32, device=device)
    uv0 = torch.zeros(512, 2, dtype=torch.float32, device=device)
    return tuple(float(torch.trapezoid(srf.eval(uv0, 1, lam[:, None])[:, 0], lam))
                 for srf in srfs)


def spectral_to_film(film: Film, L, wavelengths, wl_pdf):
    """The film's channels [N, 3] (or [N, len(srfs)]) of per-lane spectral
    radiance L [N, 4] at `wavelengths` [N, 4] of pdf `wl_pdf` (detached
    here: the sampling density carries no gradient)."""
    wl_pdf = wl_pdf.detach()
    if film.srfs:
        uv0 = torch.zeros(L.shape[0], 2, dtype=torch.float32, device=L.device)
        inv_pdf = 1.0 / torch.clamp(wl_pdf, min=1e-12)
        return torch.stack([torch.mean(srf.eval(uv0, 4, wavelengths) * L * inv_pdf, -1) / norm
                            for srf, norm in zip(film.srfs, film.srf_norms)], dim=-1)
    return torch.clamp(spec.xyz_to_srgb(spec.spectrum_to_xyz(L, wavelengths, wl_pdf)), min=0.0)


def spectral_to_film_adjoint(film: Film, dL_film, L, wavelengths, wl_pdf):
    """The VJP of spectral_to_film at the lanes' radiance L: the film
    adjoint dL_film [N, channels] pulled back to [N, 4]."""
    with torch.enable_grad():
        Lv = L.detach().requires_grad_()
        (dL,) = torch.autograd.grad(spectral_to_film(film, Lv, wavelengths, wl_pdf), Lv, dL_film)
    return dL


def accumulate(film: Film, values, spp: int, acc=None):
    """Add pixel-major per-lane values [H*W*spp, ...] into the per-pixel
    sums acc [H, W, ...], one sample index after the other."""
    rows = values.reshape((film.height, film.width, spp) + values.shape[1:])
    for s in range(spp):
        acc = rows[:, :, s] if acc is None else acc + rows[:, :, s]
    return acc


def stokes_major(img):
    """A polarized image [H, W, C, 4] -> [H, W, 4, C]; an unpolarized
    [H, W, C] one is returned as it is."""
    return img.transpose(-1, -2) if img.ndim == 4 else img


def develop(film: Film, values, spp: int):
    """Pixel-major per-lane radiance [H*W*spp, C] (or [H*W*spp, C, 4]
    Stokes) -> image [H, W, C] (or [H, W, 4, C])."""
    return stokes_major(accumulate(film, values, spp) / spp)
