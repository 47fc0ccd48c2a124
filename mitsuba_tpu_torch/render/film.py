"""Film and filter-importance-sampled reconstruction (counterpart of
mitsuba_tpu/render/film.py).

With the box, tent and gaussian filters, each sample's film position is
drawn from the normalized reconstruction filter around its pixel, so every
sample adds weight 1 to its own pixel and developing is a mean over the
samples of a pixel. The filters with negative lobes (mitchell, catmullrom,
lanczos) cannot be sampled so: their samples are jittered uniformly in the
pixel, and each adds its filter weight times its value to the numerator
and its weight to the denominator of every pixel within the filter's
radius, as dense shifted images (``accumulate`` with the jitter); the image
is the numerator over the denominator. A render through a PRB node
develops them as a box average, as the JAX package does.

The port sums a pixel's samples one sample index after another, always in
that order (``accumulate``): a render split into several passes then adds
the same numbers in the same order as one pass, and the image is bitwise
independent of the split; the weighted filters keep their numerator and
denominator over the passes and divide once, at the end (``develop_sums``).

A crop window (``crop_offset``, ``crop_size``) renders that window of the
film: the lanes walk the window (``lane_window``: for a weighted filter,
the window grown by the filter's radius within the film, so that its edge
pixels get every sample the full render gives them) pixel-major, each
lane's random numbers keyed by its pixel in the whole film, and the image
is the window's. A crop render is therefore bitwise the full render's
window. (The JAX package keys them by the pixel in the window and samples
the window alone, so its crop render is not its full render's window.)

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
# filters with negative lobes: weighted reconstruction
WEIGHTED_FILTERS = ("mitchell", "catmullrom", "lanczos")


@dataclass(frozen=True)
class Film:
    """hdrfilm configuration, with an optional crop window."""

    width: int
    height: int
    rfilter: str = "gaussian"
    # specfilm: the sensor response functions (spectra), one per channel,
    # and each one's integral over [360, 830] nm; () on an hdrfilm
    srfs: tuple = ()
    srf_norms: tuple = ()
    crop_offset: tuple = (0, 0)
    crop_size: tuple | None = None    # (width, height); None: the whole film

    def __post_init__(self):
        if self.rfilter not in FIS_FILTERS + WEIGHTED_FILTERS:
            raise NotImplementedError(
                f"reconstruction filter {self.rfilter!r} is not yet ported; "
                f"ported: {FIS_FILTERS + WEIGHTED_FILTERS}"
            )
        (x0, y0), w, h = self.crop_offset, self.crop_w, self.crop_h
        if x0 < 0 or y0 < 0 or w < 1 or h < 1 or x0 + w > self.width or y0 + h > self.height:
            raise ValueError(f"crop window {self.crop_offset} + ({w}, {h}) is not inside the "
                             f"{self.width} x {self.height} film")

    @property
    def crop_w(self):
        return self.crop_size[0] if self.crop_size else self.width

    @property
    def crop_h(self):
        return self.crop_size[1] if self.crop_size else self.height

    @property
    def weighted(self):
        return self.rfilter in WEIGHTED_FILTERS

    @property
    def lane_window(self):
        """(x0, y0, width, height) of the pixels whose samples a render
        takes: the crop window, grown by the filter's radius for a weighted
        filter, within the film."""
        (x0, y0), x1, y1 = self.crop_offset, self.crop_offset[0] + self.crop_w, \
            self.crop_offset[1] + self.crop_h
        if self.weighted:
            r = filter_radius(self.rfilter)
            x0, y0 = max(x0 - r, 0), max(y0 - r, 0)
            x1, y1 = min(x1 + r, self.width), min(y1 + r, self.height)
        return x0, y0, x1 - x0, y1 - y0

    @property
    def n_pixels(self):
        """The lanes of one sample per pixel: the lane window's pixels."""
        _, _, w, h = self.lane_window
        return w * h

    def film_pixel(self, pix):
        """The film pixel ids (y * width + x) of lane-window pixel ids: the
        ids themselves where the window starts at the film's first pixel and
        spans its width."""
        x0, y0, w, _ = self.lane_window
        if (x0, y0, w) == (0, 0, self.width):
            return pix
        return (y0 + pix // w) * self.width + x0 + pix % w


def mitchell_1d(x, B=1.0 / 3.0, C=1.0 / 3.0):
    """The Mitchell-Netravali cubic (catmullrom: B = 0, C = 1/2)."""
    x = torch.abs(x)
    x2 = x * x
    x3 = x2 * x
    inner = ((12.0 - 9.0 * B - 6.0 * C) * x3 + (-18.0 + 12.0 * B + 6.0 * C) * x2
             + (6.0 - 2.0 * B)) / 6.0
    outer = ((-B - 6.0 * C) * x3 + (6.0 * B + 30.0 * C) * x2 + (-12.0 * B - 48.0 * C) * x
             + (8.0 * B + 24.0 * C)) / 6.0
    return torch.where(x < 1.0, inner, torch.where(x < 2.0, outer, 0.0))


def lanczos_1d(x, a=3.0):
    """The Lanczos windowed sinc of a lobes."""
    x = torch.abs(x)
    pix = math.pi * torch.clamp(x, min=1e-9)
    out = torch.sin(pix) / pix * (torch.sin(pix / a) / (pix / a))
    return torch.where(x < 1e-9, 1.0, torch.where(x < a, out, 0.0))


def filter_eval_1d(rfilter, x):
    if rfilter == "mitchell":
        return mitchell_1d(x)
    if rfilter == "catmullrom":
        return mitchell_1d(x, B=0.0, C=0.5)
    if rfilter == "lanczos":
        return lanczos_1d(x)
    raise ValueError(rfilter)


def filter_radius(rfilter):
    """The weighted filter's support in whole pixels."""
    return 3 if rfilter == "lanczos" else 2


def sample_filter_offset(rfilter: str, u2):
    """Offset within a pixel, importance-sampled from the reconstruction
    filter, in pixel units from the pixel's lower corner; uniform for the
    weighted filters, whose weights the film applies."""
    if rfilter == "box" or rfilter in WEIGHTED_FILTERS:
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


def accumulate(film: Film, values, spp: int, acc=None, jitter=None):
    """Add pixel-major per-lane values [n_pixels * spp, ...] into the
    per-pixel sums acc [h, w, ...] over the lane window, one sample index
    after the other. With a weighted filter and the lanes' in-pixel
    `jitter` [n_pixels * spp, 2], acc is the pair (numerator [h, w, ...],
    denominator [h, w]) of the filter-weighted sums."""
    _, _, w, h = film.lane_window
    rows = values.reshape((h, w, spp) + values.shape[1:])
    if not (film.weighted and jitter is not None):
        for s in range(spp):
            acc = rows[:, :, s] if acc is None else acc + rows[:, :, s]
        return acc
    num_s, den_s = _weighted_samples(film, rows, jitter.reshape(h, w, spp, 2))
    num, den = (None, None) if acc is None else acc
    for s in range(spp):
        num = num_s[:, :, s] if num is None else num + num_s[:, :, s]
        den = den_s[:, :, s] if den is None else den + den_s[:, :, s]
    return num, den


def _weighted_samples(film: Film, rows, jitter):
    """Each sample index's filter-weighted contributions ([h, w, spp, ...]
    numerators, [h, w, spp] denominators) to the pixels around it: a sample
    at pixel + jitter weighs f(jx - 0.5 - dx) f(jy - 0.5 - dy) at the
    pixel (dx, dy) away, added as an image shifted by (dy, dx)."""
    R = filter_radius(film.rfilter)
    rest = rows.shape[3:]
    num = den = None
    for dy in range(-R, R + 1):
        for dx in range(-R, R + 1):
            wgt = (filter_eval_1d(film.rfilter, jitter[..., 0] - 0.5 - dx)
                   * filter_eval_1d(film.rfilter, jitter[..., 1] - 0.5 - dy))
            n_o = _shift2d(rows * wgt.reshape(wgt.shape + (1,) * len(rest)), dy, dx)
            d_o = _shift2d(wgt, dy, dx)
            num = n_o if num is None else num + n_o
            den = d_o if den is None else den + d_o
    return num, den


def _shift2d(img, dy, dx):
    """img moved by (dy, dx) with zeros shifted in: out[y + dy, x + dx] =
    img[y, x]."""
    h, w = img.shape[0], img.shape[1]
    out = torch.zeros_like(img)
    out[max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)] = \
        img[max(-dy, 0):h - max(dy, 0), max(-dx, 0):w - max(dx, 0)]
    return out


def stokes_major(img):
    """A polarized image [H, W, C, 4] -> [H, W, 4, C]; an unpolarized
    [H, W, C] one is returned as it is."""
    return img.transpose(-1, -2) if img.ndim == 4 else img


def develop_sums(film: Film, acc, n_samples):
    """The developed crop window [ch, cw, C] (or [ch, cw, 4, C]) of the sums
    `acc` of n_samples samples per pixel (accumulate's)."""
    if isinstance(acc, tuple):
        num, den = acc
        den = torch.where(torch.abs(den) < 1e-8, 1.0, den)
        img = num / den.reshape(den.shape + (1,) * (num.ndim - 2))
    else:
        img = acc / n_samples
    x0, y0, _, _ = film.lane_window
    cx, cy = film.crop_offset[0] - x0, film.crop_offset[1] - y0
    return stokes_major(img[cy:cy + film.crop_h, cx:cx + film.crop_w])


def develop(film: Film, values, spp: int, jitter=None):
    """Pixel-major per-lane radiance [n_pixels * spp, C] (or [..., C, 4]
    Stokes), with the lanes' in-pixel jitter for a weighted filter -> the
    image [ch, cw, C] (or [ch, cw, 4, C])."""
    return develop_sums(film, accumulate(film, values, spp, jitter=jitter), spp)
