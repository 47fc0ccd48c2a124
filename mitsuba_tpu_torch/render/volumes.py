"""Volumes: constant and gridded 3D fields (counterpart of
mitsuba_tpu/render/volumes.py).

GridVolume holds a dense [D, H, W, C] grid over a world-space box and
looks it up trilinearly: the 8 corners of the cell are gathered directly
(the reference's corner-packed table is a TPU gather layout and is not
ported) and blended in the reference's order of lerps, x, then y, then z.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.transform import build_transform


def _to_channels(v, n_channels):
    """[..., C] -> [..., n_channels]: a single channel is repeated, RGB
    averaged to one. An rgb volume in a spectral variant raises ValueError:
    the JAX package cannot broadcast it either."""
    c = v.shape[-1]
    if c == 1 and n_channels > 1:
        return v.expand(v.shape[:-1] + (n_channels,))
    if c == 3 and n_channels == 1:
        return v.mean(dim=-1, keepdim=True)
    if c != n_channels:
        raise ValueError(f"a {c}-channel volume cannot be evaluated in a "
                         f"{n_channels}-channel variant")
    return v


@dataclass
class ConstVolume:
    value: torch.Tensor   # [C] or [1]

    def eval(self, p, n_channels):
        v = _to_channels(self.value, n_channels)
        return v.expand(p.shape[:-1] + (v.shape[-1],))

    def max(self):
        return torch.max(self.value)


@dataclass
class GridVolume:
    """Trilinear grid: data [D, H, W, C], local z -> D, y -> H, x -> W over
    the box [bbox_min, bbox_max]; 0 outside the box."""

    data: torch.Tensor      # [D, H, W, C]
    bbox_min: torch.Tensor  # [3]
    bbox_max: torch.Tensor  # [3]

    def eval(self, p, n_channels):
        d, h, w, c = self.data.shape
        q = (p - self.bbox_min) / (self.bbox_max - self.bbox_min)
        x = q[..., 0] * (w - 1)
        y = q[..., 1] * (h - 1)
        z = q[..., 2] * (d - 1)
        # clamped corner indices and clamped fractions, as the reference
        x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, w - 1)
        y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, h - 1)
        z0 = torch.clamp(torch.floor(z).to(torch.int64), 0, d - 1)
        fx = torch.clamp(x - x0, 0.0, 1.0)[..., None]
        fy = torch.clamp(y - y0, 0.0, 1.0)[..., None]
        fz = torch.clamp(z - z0, 0.0, 1.0)[..., None]
        x1 = torch.clamp(x0 + 1, max=w - 1)
        y1 = torch.clamp(y0 + 1, max=h - 1)
        z1 = torch.clamp(z0 + 1, max=d - 1)
        g = self.data.reshape(d * h * w, c)

        def at(zi, yi, xi):
            return g[(zi * h + yi) * w + xi]

        v00 = at(z0, y0, x0) * (1 - fx) + at(z0, y0, x1) * fx
        v01 = at(z0, y1, x0) * (1 - fx) + at(z0, y1, x1) * fx
        v10 = at(z1, y0, x0) * (1 - fx) + at(z1, y0, x1) * fx
        v11 = at(z1, y1, x0) * (1 - fx) + at(z1, y1, x1) * fx
        v0 = v00 * (1 - fy) + v01 * fy
        v1 = v10 * (1 - fy) + v11 * fy
        v = v0 * (1 - fz) + v1 * fz
        inside = torch.all((q >= 0.0) & (q <= 1.0), dim=-1)
        v = torch.where(inside[..., None], v, 0.0)
        return _to_channels(v, n_channels)

    def max(self):
        return torch.max(self.data)


def parse_volume(spec, device):
    """(volume, name of its parameter leaf) from a float, a list, or a
    ``constvolume``/``rgb``/``uniform``/``gridvolume`` dict."""
    def tensor(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(device)

    if isinstance(spec, (int, float)):
        return ConstVolume(value=tensor([float(spec)])), "value"
    if isinstance(spec, (list, tuple, np.ndarray)):
        return ConstVolume(value=tensor(spec)), "value"
    t = spec.get("type")
    if t in ("constvolume", "rgb", "uniform"):
        v = spec.get("value", 1.0)
        if isinstance(v, dict):
            v = v.get("value", 1.0)
        return ConstVolume(value=tensor(np.atleast_1d(np.asarray(v, np.float32)))), "value"
    if t != "gridvolume":
        raise NotImplementedError(f"volume type {t!r} is not yet ported")
    data = np.asarray(spec["data"], np.float32) if "data" in spec else load_vol_file(spec["filename"])
    if data.ndim == 3:
        data = data[..., None]
    bbox_min = np.asarray(spec.get("bbox_min", [0.0, 0.0, 0.0]), np.float32)
    bbox_max = np.asarray(spec.get("bbox_max", [1.0, 1.0, 1.0]), np.float32)
    if "to_world" in spec:
        m = np.asarray(build_transform(spec["to_world"]).m)
        corners = np.array(
            [[x, y, z] for x in (0.0, 1.0) for y in (0.0, 1.0) for z in (0.0, 1.0)], np.float32
        )
        cw = (m[:3, :3] @ corners.T + m[:3, 3:4]).T
        bbox_min, bbox_max = cw.min(0), cw.max(0)
    grid = GridVolume(data=tensor(data), bbox_min=tensor(bbox_min), bbox_max=tensor(bbox_max))
    return grid, "data"


def load_vol_file(fn):
    """A grid in the reference's .vol binary format: 'VOL', version byte,
    int32 dtype (1 = float32), int32 [xres, yres, zres, channels], six
    float32 of bbox, then the data z-major. Returns [zres, yres, xres, C]."""
    with open(fn, "rb") as f:
        if f.read(3) != b"VOL":
            raise ValueError(f"{fn}: not a .vol file")
        f.read(1)  # version
        dtype = np.frombuffer(f.read(4), np.int32)[0]
        if dtype != 1:
            raise ValueError(f"{fn}: only float32 .vol supported")
        xres, yres, zres, ch = np.frombuffer(f.read(16), np.int32)
        f.read(24)  # bbox
        return np.frombuffer(f.read(), np.float32).reshape(zres, yres, xres, ch).copy()
