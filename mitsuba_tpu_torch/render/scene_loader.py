"""Scene-dict loader for the Cornell-box and mesh vocabulary (counterpart
of mitsuba_tpu/render/scene_loader.py).

Accepted plugin types: ``scene``; the ``path``, ``prb``, ``prb_basic``,
``volpath``, ``volpathmis``, ``prbvolpath`` (``prb_unpolarized``),
``prb_polarized``, ``volpathaos``, ``prb_volpathaos``, ``direct``,
``depth``, ``aov``, ``stokes``, ``moment``, ``ptracer``,
``direct_projective`` and ``prb_projective`` integrators; the ``perspective``,
``thinlens``, ``orthographic``, ``radiancemeter`` and ``distant`` (with an
optional ``wavelength``), ``irradiancemeter`` and ``batch`` sensors with an
``independent`` sampler and an ``hdrfilm`` (or a ``specfilm``, whose nested
spectra are its channels' sensor response functions) with a ``gaussian``,
``box``, ``tent``, ``mitchell``, ``catmullrom`` or ``lanczos`` filter and an
optional crop window; the
``diffuse``, ``null``, ``dielectric``, ``thindielectric``, ``roughdielectric``,
``conductor``, ``roughconductor`` (a ``material`` preset or ``eta`` and
``k``), ``roughplastic``, ``pplastic``, ``polarizer``, ``circular``,
``retarder``, ``twosided``, ``mask`` and ``blendbsdf`` BSDFs with ``rgb``,
scalar or spectrum (``uniform``, ``singleton``, ``d65``, ``blackbody``,
``regular``, ``irregular``), ``checkerboard`` and ``bitmap`` (``data``, a
raw [H, W(, C)] array, or a ``.npy`` or ``.pfm`` file) textures
(``normalmap``, ``bumpmap``, ``plastic`` and the principled, measured and
hair BSDFs raise ``NotImplementedError``); ``rectangle``, ``cube``,
``sphere`` (analytic), ``disk`` and ``cylinder`` (tessellated as in the JAX
package), ``obj``, ``ply`` and raw-array ``mesh`` shapes, with an
``interior`` and ``exterior`` medium;
``homogeneous`` and ``heterogeneous`` media (``constvolume``/``gridvolume``
fields, the ``isotropic``, ``hg``, ``sggx``, ``rayleigh``, ``mie`` (with a
``monodisperse``, ``gamma``, ``lognormal`` or ``powerlaw`` size
distribution), ``tabphase_polarized`` and ``blendphase`` phase functions);
``area`` emitters (on a sphere: cone-sampled; more than four of constant
radiance on triangles are fused into one ``AreaEmitterArray``, as in the
JAX package; ``fuse_area_lights`` True or False at the root of the dict
forces it either way) and ``directionalarea`` ones, the ``constant`` and
``envmap`` environment emitters, the ``directional`` sun, ``spot`` and
``projector`` lights and ``point`` lights (more than four with a constant
intensity are fused into one ``PointEmitterArray``; ``fuse_point_lights``
forces it either way); ``emitter_sampler`` "power" at the root selects the
emitters by their power, as in the JAX package; ``ref`` to a named BSDF or
medium. Any other type
raises ``NotImplementedError``: it is not yet ported (``serialized`` and
``blender`` meshes among them).

The scene takes the channel count and polarization of the current variant
(``set_variant``): ``mono`` scenes carry one channel, ``rgb`` three,
``spectral`` four wavelengths a lane.

An ``obj``, ``ply``, ``.npy`` or ``.pfm`` ``filename`` is an absolute path
or one relative to the working directory: the reference's file-resolver
search path is not yet ported.

The scene is built on the host in numpy, with the same operations as the
JAX package's loader, then moved to its device once.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import native
from ..core.transform import Transform, build_transform
from . import bsdfs as B
from ..variant import current_variant
from . import emitters as E
from . import sensors as SEN
from .emitters import (AreaEmitter, ConstantEmitter, DirectionalEmitter, PointEmitter,
                       PointEmitterArray)
from .film import Film, srf_norms
from .media import MEDIUM_TYPES, parse_medium
from .scene import Scene
from . import shapes as SH
from . import textures as TX
from .textures import ConstantTexture

SHAPE_TYPES = ("rectangle", "cube", "sphere", "disk", "cylinder", "obj", "ply", "mesh")
BSDF_TYPES = ("diffuse", "null", "roughdielectric", "dielectric", "thindielectric", "conductor",
              "roughconductor", "roughplastic", "pplastic", "polarizer", "circular", "retarder",
              "twosided", "mask", "blendbsdf")
# the reference's other BSDF plugins, refused with a NotImplementedError
BSDF_TYPES_NOT_PORTED = ("normalmap", "bumpmap", "plastic", "principled", "principledthin",
                         "principled_thin", "measured", "measured_polarized", "hair")
ALL_BSDF_TYPES = BSDF_TYPES + BSDF_TYPES_NOT_PORTED
# the environment and delta emitters
EMITTER_TYPES = ("constant", "point", "directional", "envmap", "spot", "projector")
SENSOR_TYPES = ("perspective", "thinlens", "orthographic", "radiancemeter", "irradiancemeter",
                "distant", "batch")


def resolve_device(device=None):
    """The device a scene lives on: the card unless the caller names
    another. Without a card, only an explicit non-CUDA device is accepted;
    nothing falls back to the CPU quietly."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mitsuba_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    return device


def _not_ported(what):
    return NotImplementedError(f"{what} is not yet ported")


def load_mesh_file(kind, filename, to_world):
    """An ``obj`` or ``ply`` file through the native loaders, in world space:
    positions by to_world, normals by its inverse transpose, renormalized."""
    filename = os.fspath(filename)
    if not os.path.isfile(filename):
        raise FileNotFoundError(f"{kind} shape: no file {filename!r}")
    m = native.load_obj(filename) if kind == "obj" else native.load_ply(filename)
    mm = np.asarray(to_world.m)
    V = m["vertices"]
    out = {"vertices": (mm[:3, :3] @ V.T + mm[:3, 3:4]).T.astype(np.float32),
           "faces": m["faces"]}
    if "normals" in m:
        Nw = (np.asarray(to_world.inv)[:3, :3].T @ m["normals"].T).T
        Nw /= np.maximum(np.linalg.norm(Nw, axis=-1, keepdims=True), 1e-12)
        out["normals"] = Nw.astype(np.float32)
    if "uvs" in m:
        out["uvs"] = m["uvs"]
    return out


def raw_mesh(spec, to_world):
    """A ``mesh`` shape from arrays in the dict (vertex_positions, faces,
    optional uvs and normals), in world space."""
    V = np.asarray(spec["vertex_positions"], np.float32).reshape(-1, 3)
    F = np.asarray(spec["faces"], np.int32).reshape(-1, 3)
    mm = np.asarray(to_world.m)
    m = {"vertices": (mm[:3, :3] @ V.T + mm[:3, 3:4]).T.astype(np.float32), "faces": F}
    if "uvs" in spec or "vertex_texcoords" in spec:
        m["uvs"] = np.asarray(spec.get("uvs", spec.get("vertex_texcoords")), np.float32).reshape(-1, 2)
    if "normals" in spec or "vertex_normals" in spec:
        nrm = np.asarray(spec.get("normals", spec.get("vertex_normals")), np.float32).reshape(-1, 3)
        m["normals"] = (np.linalg.inv(mm[:3, :3]).T @ nrm.T).T.astype(np.float32)
    return m


def _floats(v):
    """A list of numbers, or a string of them separated by commas or
    spaces, as float32."""
    if isinstance(v, str):
        v = [x for x in v.replace(",", " ").split() if x]
    return np.asarray(v, np.float32).reshape(-1)


def parse_texture(spec, device, default=1.0, emissive=False):
    """(texture, name of its parameter leaf) from a float, a list, an rgb
    dict or a spectrum dict (``uniform``, ``singleton``, ``d65``,
    ``blackbody``, ``regular``, ``irregular``). `emissive` marks the rgb
    values of emitters, which the spectral variants upsample with D65."""
    if spec is None:
        spec = default

    def t32(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(device)

    if isinstance(spec, (int, float)):
        value = np.asarray([float(spec)], np.float32)
    elif isinstance(spec, (list, tuple, np.ndarray)):
        value = np.asarray(spec, np.float32)
        if value.ndim >= 2:
            # a raw [H, W(, C)] image is a bitmap
            return TX.BitmapTexture(data=t32(value if value.ndim == 3 else value[..., None])), \
                "data"
    elif spec.get("type") == "bitmap":
        data = np.asarray(spec["data"] if "data" in spec else load_image(spec["filename"]),
                          np.float32)
        return TX.BitmapTexture(data=t32(data if data.ndim == 3 else data[..., None])), "data"
    elif spec.get("type") == "checkerboard":
        uv_scale, uv_offset = [1.0, 1.0], [0.0, 0.0]
        if spec.get("to_uv") is not None:
            m = np.asarray(build_transform(spec["to_uv"]).m)
            uv_scale, uv_offset = [m[0, 0], m[1, 1]], [m[0, 3], m[1, 3]]
        return TX.CheckerboardTexture(
            color0=parse_texture(spec.get("color0", 0.4), device)[0].value,
            color1=parse_texture(spec.get("color1", 0.2), device)[0].value,
            uv_scale=t32(uv_scale), uv_offset=t32(uv_offset)), "color0"
    elif spec.get("type") in ("rgb", "srgb"):
        value = np.asarray(spec["color"] if "color" in spec else spec["value"], np.float32)
    elif spec.get("type") == "uniform":
        return ConstantTexture(value=t32([spec.get("value", 1.0)])), "value"
    elif spec.get("type") == "singleton":
        return TX.SingletonSpectrum(value=t32(spec.get("value", 1.0)),
                                    wavelength=t32(spec.get("wavelength", 550.0))), "value"
    elif spec.get("type") == "d65":
        return TX.D65Spectrum(scale=t32(spec.get("scale", 1.0))), "scale"
    elif spec.get("type") == "blackbody":
        return TX.BlackbodySpectrum(temperature=t32(spec.get("temperature", 6504.0)),
                                    scale=t32(spec.get("scale", 1.0))), "scale"
    elif spec.get("type") == "regular":
        return TX.RegularSpectrum(
            values=t32(_floats(spec["values"])),
            wl_min=t32(spec.get("wavelength_min", spec.get("lambda_min", 360.0))),
            wl_max=t32(spec.get("wavelength_max", spec.get("lambda_max", 830.0)))), "values"
    elif spec.get("type") == "irregular":
        return TX.IrregularSpectrum(wavelengths_nodes=t32(_floats(spec["wavelengths"])),
                                    values=t32(_floats(spec["values"]))), "values"
    else:
        raise _not_ported(f"texture type {spec.get('type')!r}")
    return ConstantTexture(value=torch.from_numpy(value).to(device), emissive=emissive), "value"


def load_image(filename):
    """An image array from a ``.npy`` or ``.pfm`` file (the formats the JAX
    package reads; any other raises its ValueError)."""
    fn = os.fspath(filename)
    if fn.endswith(".npy"):
        return np.load(fn)
    if fn.endswith(".pfm"):
        return read_pfm(fn)
    raise ValueError(
        f"unsupported image format for {fn!r} (npy/pfm supported; pass 'data' directly)"
    )


def read_pfm(fn):
    """A portable float map [H, W, 3 or 1], row 0 at the top."""
    with open(fn, "rb") as f:
        color = f.readline().strip() == b"PF"
        w, h = (int(x) for x in f.readline().split())
        scale = float(f.readline().strip())
        data = np.fromfile(f, "<f4" if scale < 0 else ">f4")
    return data.reshape(h, w, 3 if color else 1)[::-1]


_IOR_PRESETS = {"bk7": 1.5046, "water": 1.3330, "diamond": 2.419, "air": 1.000277}


def _ior(v, default=1.5046):
    """An index of refraction: a number, or a preset's name."""
    if v is None:
        return default
    if isinstance(v, str):
        return _IOR_PRESETS[v.lower()]
    return float(v)


# spectrally averaged (eta, k) of common conductors, as the JAX package's
# scene loader keeps them
_CONDUCTOR_PRESETS = {
    "Au": ([0.143, 0.375, 1.442], [3.983, 2.386, 1.603]),
    "Ag": ([0.156, 0.144, 0.135], [3.60, 3.13, 2.38]),
    "Al": ([1.345, 0.965, 0.617], [7.47, 6.40, 5.30]),
    "Cu": ([0.20, 0.924, 1.102], [3.91, 2.45, 2.14]),
    "none": ([0.0, 0.0, 0.0], [1.0, 1.0, 1.0]),
}


def _nested_bsdf_spec(spec, t):
    """The one nested BSDF of a wrapper (twosided, mask): its ``bsdf``
    child, or else its first child of a BSDF type."""
    nested = spec.get("bsdf")
    if nested is None:
        nested = next((v for v in spec.values()
                       if isinstance(v, dict) and v.get("type") in ALL_BSDF_TYPES), None)
    if nested is None:
        raise ValueError(f"{t!r} needs a nested BSDF (add a 'bsdf' child)")
    return nested


def _parse_nested(spec, name, paths, device, attr):
    """A wrapper's child BSDF, parsed under the wrapper's `name`; its
    parameter paths reach it through the wrapper's field `attr`."""
    local = []
    inst = parse_bsdf(spec, name, local, device)
    paths.extend((key, (attr,) + sub) for key, sub in local)
    return inst


def _scalar(v, device):
    return torch.tensor(float(v), dtype=torch.float32, device=device)


def _iors(spec, int_default):
    """The relative IOR int_ior / ext_ior (numbers or presets' names)."""
    return _ior(spec.get("int_ior"), int_default) / _ior(spec.get("ext_ior"), 1.000277)


def parse_bsdf(spec, name, paths, device):
    """A BSDF instance from its dict; appends its (key, path) pairs to
    `paths`, with the JAX package's keys."""
    t = spec["type"]
    if t in BSDF_TYPES_NOT_PORTED:
        raise _not_ported(f"BSDF type {t!r}")
    if t not in BSDF_TYPES:
        raise ValueError(f"unknown bsdf type {t!r}")
    if t == "null":
        return B.NullBSDF()
    if t == "diffuse":
        tex, leaf = parse_texture(spec.get("reflectance", 0.5), device)
        paths.append((f"{name}.reflectance.{leaf}", ("reflectance", leaf)))
        return B.DiffuseBSDF(reflectance=tex)
    if t == "twosided":
        return B.TwoSidedBSDF(
            nested=_parse_nested(_nested_bsdf_spec(spec, t), name, paths, device, "nested"))
    if t == "mask":
        nested = _parse_nested(_nested_bsdf_spec(spec, t), name, paths, device, "nested")
        op, leaf = parse_texture(spec.get("opacity", 0.5), device)
        paths.append((f"{name}.opacity.{leaf}", ("opacity", leaf)))
        return B.MaskBSDF(nested=nested, opacity=op)
    if t == "blendbsdf":
        nested = [v for v in spec.values()
                  if isinstance(v, dict) and v.get("type") in ALL_BSDF_TYPES]
        if len(nested) != 2:
            raise ValueError("blendbsdf needs exactly two nested BSDFs")
        w, leaf = parse_texture(spec.get("weight", 0.5), device)
        paths.append((f"{name}.weight.{leaf}", ("weight", leaf)))
        return B.BlendBSDF(
            bsdf_a=_parse_nested(nested[0], name + ".a", paths, device, "bsdf_a"),
            bsdf_b=_parse_nested(nested[1], name + ".b", paths, device, "bsdf_b"),
            weight=w,
        )
    if t in ("polarizer", "circular", "retarder"):
        tr, _ = parse_texture(spec.get("transmittance", 1.0), device)
        if t == "circular":
            return B.CircularPolarizerBSDF(transmittance=tr,
                                           left=bool(spec.get("left_handed", False)))
        # theta (and the retarder's delta) in degrees, stored in radians
        paths.append((f"{name}.theta", ("theta",)))
        theta = _scalar(np.deg2rad(float(spec.get("theta", 0.0))), device)
        if t == "polarizer":
            return B.PolarizerBSDF(theta=theta, transmittance=tr)
        return B.RetarderBSDF(theta=theta,
                              delta_phase=_scalar(np.deg2rad(float(spec.get("delta", 90.0))),
                                                  device),
                              transmittance=tr)
    if t in ("roughplastic", "pplastic"):
        dr, leaf = parse_texture(spec.get("diffuse_reflectance", 0.5), device)
        paths.append((f"{name}.diffuse_reflectance.{leaf}", ("diffuse_reflectance", leaf)))
        sr, _ = parse_texture(spec.get("specular_reflectance", 1.0), device)
        cls = B.PPlasticBSDF if t == "pplastic" else B.RoughPlasticBSDF
        return cls(eta=_scalar(_iors(spec, 1.49), device),
                   alpha=_scalar(spec.get("alpha", 0.06 if t == "pplastic" else 0.1), device),
                   diffuse_reflectance=dr, specular_reflectance=sr)
    if t in ("conductor", "roughconductor"):
        if "eta" in spec:
            eta = np.asarray(spec["eta"], np.float32)
            k = np.asarray(spec.get("k", 1.0), np.float32)
        else:
            eta, k = (np.asarray(x, np.float32)
                      for x in _CONDUCTOR_PRESETS[spec.get("material", "none")])
        if eta.ndim == 1 and eta.shape[0] == 3 and current_variant().n_channels != 3:
            eta, k = eta.mean(keepdims=True), k.mean(keepdims=True)
        eta, k = torch.from_numpy(eta).to(device), torch.from_numpy(k).to(device)
        sr, _ = parse_texture(spec.get("specular_reflectance", 1.0), device)
        if t == "conductor":
            return B.SmoothConductorBSDF(eta=eta, k=k, specular_reflectance=sr)
        alpha = float(spec.get("alpha", 0.1))
        # as in the JAX package, <name>.alpha is alpha_u alone
        paths.append((f"{name}.alpha", ("alpha_u",)))
        return B.RoughConductorBSDF(
            eta=eta, k=k, alpha_u=_scalar(spec.get("alpha_u", alpha), device),
            alpha_v=_scalar(spec.get("alpha_v", alpha), device), specular_reflectance=sr)
    # the dielectrics
    sr, _ = parse_texture(spec.get("specular_reflectance", 1.0), device)
    st, _ = parse_texture(spec.get("specular_transmittance", 1.0), device)
    if t == "roughdielectric":
        eta = float(spec["eta"]) if "eta" in spec else _iors(spec, 1.5046)
        alpha = spec.get("alpha", 0.1)
        if isinstance(alpha, dict):
            alpha = float(alpha.get("value", 0.1))
        paths.append((f"{name}.eta", ("eta",)))
        paths.append((f"{name}.alpha.value", ("alpha",)))
        return B.RoughDielectricBSDF(eta=_scalar(eta, device), alpha=_scalar(alpha, device),
                                     specular_reflectance=sr, specular_transmittance=st)
    cls = B.SmoothDielectricBSDF if t == "dielectric" else B.ThinDielectricBSDF
    return cls(eta=_scalar(_iors(spec, 1.5046), device), specular_reflectance=sr,
               specular_transmittance=st)


def parse_sensor(spec, device):
    """(sensor, film, spp) of a sensor dict, with the JAX package's
    conventions: the fov along x (tan_y = tan_x / aspect), a distant
    sensor's disk of radius 1 about the origin (its ``target`` where
    given), a batch's nested sensors each with its own film's aspect."""
    t = spec["type"]
    if t not in SENSOR_TYPES:
        raise _not_ported(f"sensor type {t!r}")
    film_spec = spec.get("film", {})
    if film_spec.get("type", "hdrfilm") not in ("hdrfilm", "specfilm"):
        raise _not_ported(f"film type {film_spec.get('type')!r}")
    w = int(film_spec.get("width", 768))
    h = int(film_spec.get("height", 576))
    rfilter = film_spec.get("rfilter", {"type": "gaussian"})
    srfs = ()
    if film_spec.get("type") == "specfilm":
        # the nested spectra are the channels' sensor response functions
        srfs = tuple(parse_texture(v, device)[0] for v in film_spec.values()
                     if isinstance(v, dict)
                     and v.get("type") in ("regular", "irregular", "uniform", "d65"))
        if not srfs:
            raise ValueError("specfilm needs at least one nested spectrum (SRF)")
    crop_size = None
    if "crop_width" in film_spec or "crop_height" in film_spec:
        crop_size = (int(film_spec.get("crop_width", w)), int(film_spec.get("crop_height", h)))
    film = Film(width=w, height=h,
                rfilter=rfilter["type"] if isinstance(rfilter, dict) else str(rfilter),
                srfs=srfs, srf_norms=srf_norms(srfs, device),
                crop_offset=(int(film_spec.get("crop_offset_x", 0)),
                             int(film_spec.get("crop_offset_y", 0))),
                crop_size=crop_size)
    sampler_spec = spec.get("sampler", {})
    if sampler_spec.get("type", "independent") != "independent":
        raise _not_ported(f"sampler type {sampler_spec.get('type')!r}")
    spp = int(sampler_spec.get("sample_count", 16))
    to_world = build_transform(spec.get("to_world", Transform.identity()))
    aspect = w / h
    to_world_m = torch.from_numpy(np.asarray(to_world.m, np.float32)).to(device)

    def scalar(v):
        return torch.tensor(float(v), dtype=torch.float32, device=device)

    if t in ("radiancemeter", "distant"):
        wl = scalar(spec.get("wavelength", -1.0))
        if t == "radiancemeter":
            return SEN.RadiancemeterSensor(to_world_m=to_world_m, aspect=aspect,
                                           wavelength=wl), film, spp
        dirn = np.asarray(spec.get("direction", [0, 0, -1]), np.float32)
        target = spec.get("target")
        return SEN.DistantSensor(
            direction=torch.from_numpy(dirn / np.linalg.norm(dirn)).to(device),
            target=torch.tensor(target if target is not None else [0.0, 0.0, 0.0],
                                dtype=torch.float32, device=device),
            # the JAX package's loader sets no scene bounds here
            scene_center=torch.zeros(3, dtype=torch.float32, device=device),
            scene_radius=scalar(1.0), wavelength=wl, has_target=target is not None), film, spp
    if t == "orthographic":
        return SEN.OrthographicCamera(to_world_m=to_world_m, aspect=aspect), film, spp
    if t == "irradiancemeter":
        return SEN.IrradiancemeterSensor(to_world_m=to_world_m, aspect=aspect), film, spp
    if t == "batch":
        nested = []
        for v in spec.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                if isinstance(sub, dict) and sub.get("type") in SENSOR_TYPES:
                    nested.append(parse_sensor(sub, device)[0])
        if not nested:
            raise ValueError("batch sensor needs nested sensors")
        return SEN.BatchSensor(sensors=tuple(nested)), film, spp
    fov = float(spec.get("fov", 45.0))
    fov_axis = spec.get("fov_axis", "x")
    tan_half = np.tan(np.deg2rad(fov) / 2)
    # the stored fov is along x; tan_y = tan_x / aspect
    if fov_axis == "y" or (fov_axis == "smaller" and aspect >= 1.0) or (
        fov_axis == "larger" and aspect < 1.0
    ):
        tan_half = tan_half * aspect
    if t == "thinlens":
        return SEN.ThinLensCamera(
            to_world_m=to_world_m, tan_half_fov_x=scalar(tan_half),
            aperture_radius=scalar(spec.get("aperture_radius", 0.1)),
            focus_distance=scalar(spec.get("focus_distance", 1.0)), aspect=aspect), film, spp
    return SEN.PerspectiveCamera(to_world_m=to_world_m, tan_half_fov_x=scalar(tan_half),
                                 aspect=aspect), film, spp


INTEGRATOR_TYPES = ("path", "prb", "prb_basic", "volpath", "volpathmis", "prbvolpath",
                    "prb_unpolarized", "prb_polarized", "volpathaos", "prb_volpathaos", "ptracer",
                    "direct_projective", "prb_projective")


def load_dict(d, device=None, intersector="smem"):
    """Build a Scene from a reference-style nested dict, on `device` (the
    card unless the caller names another).

    `intersector` picks the closest-hit kernel of a triangle-table scene:
    "smem" (K1, the default, as in the JAX package) or "mma" (K3, every
    determinant from one matrix product on the tensor cores). This is the
    JAX package's MI_TPU_MXU_INTERSECT switch made an explicit argument,
    not a new feature; "mma" on a scene above MAX_MXU_TRIS (512) triangles,
    or one that takes the BVH path, raises ValueError."""
    from ..integrators import make_integrator

    device = resolve_device(device)
    d = dict(d)
    if d.pop("type", "scene") != "scene":
        raise ValueError("the root of a scene dict must have type 'scene'")
    fuse_point_lights = d.pop("fuse_point_lights", None)   # None: fuse more than four
    fuse_area_lights = d.pop("fuse_area_lights", None)     # None: fuse more than four
    emitter_sampler = d.pop("emitter_sampler", "uniform")  # or "power"

    named_bsdfs = {}      # id -> index
    bsdf_list = []
    sensor = film = None
    spp = 16
    integrator_spec = {"type": "path"}
    tri_meshes = []
    spheres = []
    shape_records = []    # per shape: dict(name, bsdf, emitter, interior, exterior)
    emitter_specs = []    # (shape index, emitter spec, shape name)
    env_specs = []        # (name, spec) of top-level emitters
    media_list = []
    media_names = {}      # id -> medium index
    phase_list = []
    param_paths = []      # (key, full path tuple)

    def register_bsdf(spec, name):
        local_paths = []
        inst = parse_bsdf(spec, name, local_paths, device)
        idx = len(bsdf_list)
        bsdf_list.append(inst)
        for key, sub in local_paths:
            param_paths.append((key, ("bsdfs", idx) + sub))
        return idx

    def resolve_bsdf(spec, shape_name):
        if spec is None:
            return register_bsdf({"type": "diffuse"}, f"{shape_name}.bsdf")
        if spec.get("type") == "ref":
            if spec["id"] not in named_bsdfs:
                raise ValueError(f"unresolved bsdf ref {spec['id']!r}")
            return named_bsdfs[spec["id"]]
        return register_bsdf(spec, f"{shape_name}.bsdf")

    def register_medium(spec, name):
        idx = len(media_list)
        media_list.append(parse_medium(spec, name, phase_list, param_paths, idx, device))
        return idx

    def resolve_medium(spec, owner_name):
        """A shape's interior or exterior: a ref to a named medium (-1 if
        none has that name, as in the reference), an inline medium dict, or
        None (-1, vacuum)."""
        if spec is None:
            return -1
        if spec.get("type") == "ref":
            return media_names.get(spec["id"], -1)
        return register_medium(spec, owner_name)

    # pass 1: named top-level BSDFs, so that refs resolve
    for name, spec in d.items():
        if isinstance(spec, dict) and spec.get("type") in ALL_BSDF_TYPES:
            named_bsdfs[name] = register_bsdf(spec, name)

    # pass 2: named top-level media, which shapes may refer to
    for name, spec in d.items():
        if isinstance(spec, dict) and spec.get("type") in MEDIUM_TYPES:
            media_names[name] = register_medium(spec, name)

    # pass 3: everything else
    for name, spec in d.items():
        if not isinstance(spec, dict):
            continue
        t = spec.get("type")
        if t in ALL_BSDF_TYPES or t in MEDIUM_TYPES:
            continue
        if name == "integrator" or t in INTEGRATOR_TYPES:
            integrator_spec = spec
        elif t in SENSOR_TYPES:
            sensor, film, spp = parse_sensor(spec, device)
        elif t in EMITTER_TYPES:
            env_specs.append((name, spec))
        elif t in SHAPE_TYPES:
            to_world = build_transform(spec.get("to_world", Transform.identity()))
            if t == "sphere":
                s_i = len(spheres)
                spheres.append({**SH.make_sphere(spec, to_world),
                                "shape_index": len(shape_records)})
                for key in ("center", "radius"):
                    param_paths.append((f"{name}.{key}",
                                        ("geometry", f"sph_{key}", ("slice", s_i, s_i + 1))))
            else:
                if t == "rectangle":
                    m = SH.make_rectangle(to_world)
                elif t == "cube":
                    m = SH.make_cube(to_world)
                elif t == "disk":
                    m = SH.make_disk(to_world)
                elif t == "cylinder":
                    m = SH.make_cylinder(spec, to_world)
                elif t in ("obj", "ply"):
                    m = load_mesh_file(t, spec["filename"], to_world)
                else:
                    m = raw_mesh(spec, to_world)
                m["shape_index"] = len(shape_records)
                tri_meshes.append(m)
            if "emitter" in spec:
                emitter_specs.append((len(shape_records), spec["emitter"], name))
            shape_records.append({
                "name": name, "bsdf": resolve_bsdf(spec.get("bsdf"), name), "emitter": -1,
                "interior": resolve_medium(spec.get("interior"), f"{name}.interior_medium"),
                "exterior": resolve_medium(spec.get("exterior"), f"{name}.exterior_medium"),
            })
        else:
            raise _not_ported(f"scene entry {name!r} of plugin type {t!r}")

    if sensor is None:
        raise _not_ported("a scene without a sensor")

    geometry = SH.build_geometry(tri_meshes, device, intersector, spheres)
    for mesh, (v_start, v_count) in zip(tri_meshes, geometry.mesh_vertex_slices):
        sname = shape_records[mesh["shape_index"]]["name"]
        param_paths.append(
            (f"{sname}.vertex_positions",
             ("geometry", "vertices", ("slice", v_start, v_start + v_count)))
        )

    # the bounding box of the real triangles and the spheres, and its
    # sphere's radius
    real = geometry.tri_shape.cpu().numpy() >= 0
    if real.any():
        v0 = geometry.tri_v0.detach().cpu().numpy()
        pts = np.concatenate([v0, v0 + geometry.tri_e1.detach().cpu().numpy(),
                              v0 + geometry.tri_e2.detach().cpu().numpy()], 0)
        pts = pts[np.concatenate([real] * 3)]
        bbox_min, bbox_max = pts.min(0), pts.max(0)
    else:
        bbox_min, bbox_max = np.full(3, -1.0, np.float32), np.full(3, 1.0, np.float32)
    if spheres:
        sc = np.stack([sp["center"] for sp in spheres])
        sr = np.asarray([sp["radius"] for sp in spheres])
        bbox_min = np.minimum(bbox_min, (sc - sr[:, None]).min(0))
        bbox_max = np.maximum(bbox_max, (sc + sr[:, None]).max(0))
    radius = 0.5 * float(np.linalg.norm(bbox_max - bbox_min)) or 1.0

    emitters = []
    sphere_of_shape = {sp["shape_index"]: i for i, sp in enumerate(spheres)}
    for shape_index, em_spec, shape_name in emitter_specs:
        em_type = em_spec.get("type")
        if em_type not in ("area", "directionalarea"):
            raise _not_ported(f"emitter type {em_type!r}")
        tex, leaf = parse_texture(em_spec.get("radiance", 1.0), device, emissive=True)
        e_idx = len(emitters)
        if shape_index in sphere_of_shape:
            if em_type != "area":
                raise _not_ported("a directionalarea emitter on a sphere")
            emitters.append(E.SphereAreaEmitter(radiance=tex,
                                                sphere_index=sphere_of_shape[shape_index],
                                                shape_index=shape_index))
        else:
            cls = AreaEmitter if em_type == "area" else E.DirectionalAreaEmitter
            emitters.append(cls.attach(tex, shape_index, geometry))
        param_paths.append(
            (f"{shape_name}.emitter.radiance.{leaf}", ("emitters", e_idx, "radiance", leaf))
        )
        shape_records[shape_index]["emitter"] = e_idx
    emitters, param_paths = _fuse_area_lights(emitters, param_paths, shape_records,
                                              fuse_area_lights, geometry, device)
    env_emitter = -1
    scene_radius = torch.tensor(radius, dtype=torch.float32, device=device)
    env_specs = _fuse_point_lights(env_specs, fuse_point_lights, emitters, param_paths, device)
    for name, spec in env_specs:
        e_idx = len(emitters)
        em, paths = _parse_env_or_delta(name, spec, scene_radius, device)
        emitters.append(em)
        param_paths.extend((key, ("emitters", e_idx) + sub) for key, sub in paths)
        if em.is_environment:
            env_emitter = e_idx

    if not bsdf_list:
        bsdf_list.append(B.DiffuseBSDF(reflectance=parse_texture(0.5, device)[0]))
    n_shapes = max(len(shape_records), 1)
    shape_bsdf = np.zeros(n_shapes, np.int64)
    shape_emitter = np.full(n_shapes, -1, np.int64)
    shape_int_med = np.full(n_shapes, -1, np.int64)
    shape_ext_med = np.full(n_shapes, -1, np.int64)
    for i, rec in enumerate(shape_records):
        shape_bsdf[i] = rec["bsdf"]
        shape_emitter[i] = rec["emitter"]
        shape_int_med[i] = rec["interior"]
        shape_ext_med[i] = rec["exterior"]

    def dev(x, dtype=None):
        return torch.from_numpy(np.asarray(x, dtype)).to(device)

    emitter_pmf = None
    if emitter_sampler == "power" and len(emitters) > 1:
        emitter_pmf = dev([emitter_power(em, radius, geometry) for em in emitters], np.float32)
    var = current_variant()
    return Scene(
        geometry=geometry,
        bsdfs=tuple(bsdf_list),
        emitters=tuple(emitters),
        sensors=(sensor,),
        integrator=make_integrator(integrator_spec),
        film=film,
        shape_bsdf=dev(shape_bsdf),
        shape_emitter=dev(shape_emitter),
        spp=spp,
        device=device,
        param_paths=tuple(param_paths),
        media=tuple(media_list),
        phases=tuple(phase_list),
        shape_interior_medium=dev(shape_int_med),
        shape_exterior_medium=dev(shape_ext_med),
        bbox_min=dev(bbox_min, np.float32),
        bbox_max=dev(bbox_max, np.float32),
        medium_phase=dev([m.phase_index for m in media_list], np.int64),
        env_emitter=env_emitter,
        n_channels=var.n_channels,
        polarized=var.polarized,
        emitter_pmf=emitter_pmf,
    )


def _parse_env_or_delta(name, spec, scene_radius, device):
    """(emitter, [(key, path within it)]) of a top-level emitter dict:
    constant, envmap, point, directional, spot or projector."""
    t = spec["type"]

    def t32(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(device)

    def texture(key):
        tex, leaf = parse_texture(spec.get(key, 1.0), device, emissive=True)
        return tex, [(f"{name}.{key}.{leaf}", (key, leaf))]

    if t == "constant":
        tex, paths = texture("radiance")
        return ConstantEmitter(radiance=tex, scene_radius=scene_radius), paths
    if t == "point":
        tex, paths = texture("intensity")
        return PointEmitter(intensity=tex, position=_point_position(spec, device)), paths
    if t == "directional":
        tex, paths = texture("irradiance")
        dirn = np.asarray(spec.get("direction", [0, 0, -1]), np.float32)
        return DirectionalEmitter(irradiance=tex, scene_radius=scene_radius,
                                  direction=t32(dirn / np.linalg.norm(dirn))), paths
    if t == "envmap":
        data = np.asarray(spec["data"] if "data" in spec else load_image(spec["filename"]),
                          np.float32)
        row_cdf, cond_cdf = E.build_envmap_tables(data)
        rot = np.asarray(build_transform(spec.get("to_world", Transform.identity())).m)[:3, :3]
        return E.EnvmapEmitter(data=t32(data), row_cdf=t32(row_cdf), cond_cdf=t32(cond_cdf),
                               scale=t32(float(spec.get("scale", 1.0))),
                               scene_radius=scene_radius, to_world_rot=t32(rot)), \
            [(f"{name}.data", ("data",))]
    m = np.asarray(build_transform(spec.get("to_world", Transform.identity())).m)
    if t == "spot":
        tex, paths = texture("intensity")
        cutoff = np.deg2rad(float(spec.get("cutoff_angle", 20.0)))
        # as in the JAX package, the default beam width is 0.75 of the
        # cutoff in radians, taken for degrees
        beam = np.deg2rad(float(spec.get("beam_width", cutoff * 0.75)))
        return E.SpotEmitter(intensity=tex, position=t32(m[:3, 3]), direction=t32(m[:3, 2]),
                             cos_cutoff=t32(np.cos(cutoff)), cos_beam_width=t32(np.cos(beam))), \
            paths
    tex, paths = texture("irradiance")
    return E.ProjectorEmitter(
        irradiance=tex, scale=t32(float(spec.get("scale", 1.0))), position=t32(m[:3, 3]),
        to_world_r=t32(m[:3, :3]),
        tan_half_fov_x=t32(np.tan(np.deg2rad(float(spec.get("fov", 45.0))) / 2))), paths


def _fuse_area_lights(emitters, param_paths, shape_records, fuse, geometry, device):
    """(emitters, param_paths) with the area lights of constant radiance on
    triangles fused into one AreaEmitterArray, appended after the others,
    when there are more than four of them (or more than one, when `fuse`
    is True; never when it is False), as the JAX package's loader does:
    the shapes' emitter slots and the parameter paths are remapped (a fused
    light's radiance is its row of the array's ``values``)."""
    area_idx = [i for i, em in enumerate(emitters)
                if type(em) is AreaEmitter and type(em.radiance) is ConstantTexture
                and em.tri_index.shape[0] > 0]
    if not (len(area_idx) > 4 if fuse is None else (fuse and len(area_idx) > 1)):
        return emitters, param_paths
    fused = {i: k for k, i in enumerate(area_idx)}
    kept = [i for i in range(len(emitters)) if i not in fused]
    remap = {i: j for j, i in enumerate(kept)}
    g_idx = len(kept)
    values, tri_ids, tri_light = [], [], []
    shape_to_light = np.full(max(len(shape_records), 1), -1, np.int64)
    for k, i in enumerate(area_idx):
        em = emitters[i]
        v = em.radiance.value.detach().cpu().numpy().astype(np.float32)
        values.append(np.repeat(v, 3) if v.shape == (1,) else v)
        tri_ids.append(em.tri_index.cpu().numpy())
        tri_light.append(np.full(em.tri_index.shape[0], k, np.int64))
        shape_to_light[em.shape_index] = k
    values = np.stack(values)
    tri_ids, tri_light = np.concatenate(tri_ids), np.concatenate(tri_light)
    cdf, area_pdf, power = E.fused_area_tables(values, tri_ids, tri_light, geometry)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    array = E.AreaEmitterArray(values=t(values), tri_index=t(tri_ids), tri_light=t(tri_light),
                               tri_cdf=t(cdf), area_pdf=t(area_pdf),
                               shape_to_light=t(shape_to_light), total_power=power)
    for rec in shape_records:
        if rec["emitter"] >= 0:
            rec["emitter"] = g_idx if rec["emitter"] in fused else remap[rec["emitter"]]
    paths = []
    for key, path in param_paths:
        if path and path[0] == "emitters":
            old = path[1]
            path = (("emitters", g_idx, "values", ("slice", fused[old], fused[old] + 1))
                    if old in fused else ("emitters", remap[old]) + tuple(path[2:]))
        paths.append((key, path))
    return [emitters[i] for i in kept] + [array], paths


def emitter_power(em, scene_radius, geometry):
    """The relative power of an emitter, for the "power" emitter selection
    (the JAX package's heuristic: only the ratios matter)."""
    def tex_mean(tex):
        v = getattr(tex, "value", None)
        return 1.0 if v is None else float(torch.mean(v.detach()))

    r = float(scene_radius)
    if isinstance(em, PointEmitterArray):
        return 4.0 * np.pi * float(torch.sum(torch.mean(em.values.detach(), dim=-1)))
    if isinstance(em, AreaEmitter):        # and DirectionalAreaEmitter
        return float(np.pi * float(em.total_area) * tex_mean(em.radiance))
    if isinstance(em, E.AreaEmitterArray):
        return float(em.total_power)
    if isinstance(em, E.SphereAreaEmitter):
        r_s = float(geometry.sph_radius[em.sphere_index])
        return float(np.pi * (4.0 * np.pi * r_s ** 2) * tex_mean(em.radiance))
    if isinstance(em, PointEmitter):
        return 4.0 * np.pi * tex_mean(em.intensity)
    if isinstance(em, ConstantEmitter):
        return 4.0 * np.pi ** 2 * r * r * tex_mean(em.radiance)
    if isinstance(em, E.EnvmapEmitter):
        return 4.0 * np.pi ** 2 * r * r * float(em.data.detach().mean() * em.scale)
    if isinstance(em, DirectionalEmitter):
        return float(np.pi * r * r * tex_mean(em.irradiance))
    if isinstance(em, E.SpotEmitter):
        return 2.0 * np.pi * (1.0 - float(em.cos_cutoff)) * tex_mean(em.intensity)
    if isinstance(em, E.ProjectorEmitter):
        return float(np.pi * tex_mean(em.irradiance) * float(em.scale))
    return 1.0


def _point_position(spec, device):
    """A point light's position: the translation of its to_world, else
    `position` (the origin by default)."""
    p = spec.get("position", [0, 0, 0])
    if "to_world" in spec:
        p = np.asarray(build_transform(spec["to_world"]).m)[:3, 3]
    return torch.from_numpy(np.asarray(p, np.float32)).to(device)


def _bakeable_intensity(spec):
    """The rgb intensity [3] of a point light with a constant one, else
    None."""
    i = spec.get("intensity", 1.0)
    if isinstance(i, (int, float)):
        return [float(i)] * 3
    if isinstance(i, (list, tuple)) and len(i) in (1, 3):
        v = [float(x) for x in i]
        return v * 3 if len(v) == 1 else v
    if isinstance(i, dict) and i.get("type") in ("rgb", "uniform"):
        v = i.get("value", 1.0)
        return [float(v)] * 3 if isinstance(v, (int, float)) else [float(x) for x in v]
    return None


def _fuse_point_lights(env_specs, fuse, emitters, param_paths, device):
    """Append one PointEmitterArray of the point lights with a constant
    intensity to `emitters` when there are more than four of them (or any,
    when `fuse` is True; none when it is False), as the JAX package's
    loader does; returns the entries left to load one by one."""
    group = [(name, spec, _bakeable_intensity(spec)) for name, spec in env_specs
             if spec["type"] == "point" and _bakeable_intensity(spec) is not None]
    if not (len(group) > 4 if fuse is None else (fuse and group)):
        return env_specs
    names = {name for name, _, _ in group}
    e_idx = len(emitters)
    emitters.append(PointEmitterArray(
        values=torch.from_numpy(np.asarray([v for _, _, v in group], np.float32)).to(device),
        positions=torch.stack([_point_position(spec, device) for _, spec, _ in group])))
    param_paths.append(("point_lights.values", ("emitters", e_idx, "values")))
    return [(name, spec) for name, spec in env_specs if name not in names]


def cornell_box():
    """The canonical Cornell box scene dict (mirrors mi.cornell_box)."""
    return {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 8},
        "sensor": {
            "type": "perspective",
            "fov_axis": "smaller",
            "near_clip": 0.001,
            "far_clip": 100.0,
            "focus_distance": 1000,
            "fov": 39.3077,
            "to_world": [
                {"type": "look_at", "origin": [0, 0, 3.90], "target": [0, 0, 0], "up": [0, 1, 0]}
            ],
            "sampler": {"type": "independent", "sample_count": 64},
            "film": {
                "type": "hdrfilm",
                "width": 256,
                "height": 256,
                "rfilter": {"type": "gaussian"},
                "pixel_format": "rgb",
                "component_format": "float32",
            },
        },
        "white": {"type": "diffuse", "reflectance": {"type": "rgb", "value": [0.885809, 0.698859, 0.666422]}},
        "green": {"type": "diffuse", "reflectance": {"type": "rgb", "value": [0.105421, 0.37798, 0.076425]}},
        "red": {"type": "diffuse", "reflectance": {"type": "rgb", "value": [0.570068, 0.0430135, 0.0443706]}},
        "light": {
            "type": "rectangle",
            "to_world": [
                {"type": "scale", "value": [0.23, 0.19, 0.19]},
                {"type": "rotate", "axis": [1, 0, 0], "angle": 90},
                {"type": "translate", "value": [0.0, 0.99, 0.01]},
            ],
            "bsdf": {"type": "ref", "id": "white"},
            "emitter": {"type": "area", "radiance": {"type": "rgb", "value": [18.387, 13.9873, 6.75357]}},
        },
        "floor": {
            "type": "rectangle",
            "to_world": [
                {"type": "rotate", "axis": [1, 0, 0], "angle": -90},
                {"type": "translate", "value": [0.0, -1.0, 0.0]},
            ],
            "bsdf": {"type": "ref", "id": "white"},
        },
        "ceiling": {
            "type": "rectangle",
            "to_world": [
                {"type": "rotate", "axis": [1, 0, 0], "angle": 90},
                {"type": "translate", "value": [0.0, 1.0, 0.0]},
            ],
            "bsdf": {"type": "ref", "id": "white"},
        },
        "back": {
            "type": "rectangle",
            "to_world": [{"type": "translate", "value": [0.0, 0.0, -1.0]}],
            "bsdf": {"type": "ref", "id": "white"},
        },
        "green-wall": {
            "type": "rectangle",
            "to_world": [
                {"type": "rotate", "axis": [0, 1, 0], "angle": -90},
                {"type": "translate", "value": [1.0, 0.0, 0.0]},
            ],
            "bsdf": {"type": "ref", "id": "green"},
        },
        "red-wall": {
            "type": "rectangle",
            "to_world": [
                {"type": "rotate", "axis": [0, 1, 0], "angle": 90},
                {"type": "translate", "value": [-1.0, 0.0, 0.0]},
            ],
            "bsdf": {"type": "ref", "id": "red"},
        },
        "small-box": {
            "type": "cube",
            "to_world": [
                {"type": "scale", "value": 0.3},
                {"type": "rotate", "axis": [0, 1, 0], "angle": -17},
                {"type": "translate", "value": [0.335, -0.7, 0.38]},
            ],
            "bsdf": {"type": "ref", "id": "white"},
        },
        "large-box": {
            "type": "cube",
            "to_world": [
                {"type": "scale", "value": [0.3, 0.61, 0.3]},
                {"type": "rotate", "axis": [0, 1, 0], "angle": 18.25},
                {"type": "translate", "value": [-0.33, -0.4, -0.28]},
            ],
            "bsdf": {"type": "ref", "id": "white"},
        },
    }


def materials_scene(res=256, spp=64, integrator=None):
    """The Cornell box in other materials: the large box a rough conductor
    (gold, alpha 0.2), the small box smooth glass (bk7), the back wall a
    two-sided rough plastic (diffuse reflectance 0.6, alpha 0.1), the
    floor a blend of the white diffuse (0.7) and smooth silver (0.3), the
    green wall a mask of opacity 0.8 over the green diffuse; a res x res
    film at spp, `integrator` (a spec dict) or the cbox's path tracer."""
    d = cornell_box()
    film = d["sensor"]["film"]
    film["width"] = film["height"] = res
    d["sensor"]["sampler"]["sample_count"] = spp
    d["large-box"]["bsdf"] = {"type": "roughconductor", "material": "Au", "alpha": 0.2}
    d["small-box"]["bsdf"] = {"type": "dielectric", "int_ior": "bk7"}
    d["back"]["bsdf"] = {"type": "twosided", "bsdf": {
        "type": "roughplastic", "diffuse_reflectance": 0.6, "alpha": 0.1}}
    d["floor"]["bsdf"] = {"type": "blendbsdf", "weight": 0.3,
                          "diffuse": dict(d["white"]),
                          "metal": {"type": "conductor", "material": "Ag"}}
    d["green-wall"]["bsdf"] = {"type": "mask", "opacity": 0.8, "bsdf": dict(d["green"])}
    if integrator is not None:
        d["integrator"] = integrator
    return d


def polarimeter_scene(res=256, spp=64, integrator=None):
    """What a polarization camera sees of materials_scene with a polarized
    plastic back wall (diffuse reflectance 0.3, alpha 0.08) and a smooth
    gold large box, through two filter sheets at z = 2.5 between the camera
    (z = 3.9) and the box, each covering half the view: a linear polarizer
    (theta 30 degrees) over x in [-1, 0] and a quarter-wave retarder (theta
    45 degrees) over x in [0, 1]. For the polarized variants; by default
    the stokes integrator over volpath at max_depth 8."""
    d = materials_scene(res, spp)
    d["back"]["bsdf"] = {"type": "pplastic", "diffuse_reflectance": 0.3, "alpha": 0.08}
    d["large-box"]["bsdf"] = {"type": "conductor", "material": "Au"}
    for name, x, bsdf in (("polarizer-sheet", -0.5, {"type": "polarizer", "theta": 30.0}),
                          ("retarder-sheet", 0.5, {"type": "retarder", "theta": 45.0})):
        d[name] = {"type": "rectangle", "bsdf": bsdf,
                   "to_world": [{"type": "scale", "value": [0.5, 1, 1]},
                                {"type": "translate", "value": [x, 0, 2.5]}]}
    d["integrator"] = integrator or {"type": "stokes",
                                     "integrator": {"type": "volpath", "max_depth": 8}}
    return d


SKY_SEED = 7
PROJECTOR_SEED = 5


def sky_envmap(h=128, w=256):
    """A smooth sky [h, w, 3] float32 for an envmap: a zenith-to-horizon
    blue, a darker ground below the horizon, slow brightness waves whose
    phases come from numpy's default_rng(SKY_SEED), and one bright sun
    patch (peak radiance 60) 35 degrees above the horizon at an azimuth
    drawn from the same generator."""
    rng = np.random.default_rng(SKY_SEED)
    theta = ((np.arange(h) + 0.5) / h * np.pi)[:, None]           # from +y
    phi = (((np.arange(w) + 0.5) / w - 0.5) * 2 * np.pi)[None, :]
    up = np.cos(theta)
    t = np.sqrt(np.clip(up, 0.0, 1.0))[..., None]
    sky = (1 - t) * np.array([0.9, 0.9, 1.0]) + t * np.array([0.25, 0.45, 0.9])
    ground = np.array([0.25, 0.22, 0.2])
    blend = np.clip(up * 8.0 + 0.5, 0.0, 1.0)[..., None]
    img = blend * sky + (1 - blend) * ground
    k, ph = rng.integers(1, 4, 3), rng.uniform(0, 2 * np.pi, 3)
    waves = sum(np.cos(k[i] * phi + ph[i]) for i in range(3)) * np.sin(theta)
    img = img * (1.0 + 0.08 * waves)[..., None]
    sun_phi, sun_theta = rng.uniform(-np.pi, np.pi), np.deg2rad(55.0)
    d = np.stack([-np.sin(theta) * np.sin(phi), np.cos(theta) + 0 * phi,
                  np.sin(theta) * np.cos(phi)], -1)
    s = np.array([-np.sin(sun_theta) * np.sin(sun_phi), np.cos(sun_theta),
                  np.sin(sun_theta) * np.cos(sun_phi)])
    ang = np.arccos(np.clip(d @ s, -1.0, 1.0))
    img = img + (60.0 * np.exp(-(ang / 0.06) ** 2))[..., None] * np.array([1.0, 0.95, 0.85])
    return img.astype(np.float32)


def spheres_scene(res=256, spp=64, integrator=None):
    """The material preview: three analytic spheres of radius 0.33 on a
    checkerboard floor (a diffuse red one in the middle, gold rough
    conductor (alpha 0.2) on the left, bk7 glass on the right) beside a
    blue diffuse cube, lit by a small sphere light, a spot (cutoff 25
    degrees) and an envmap (sky_envmap), seen through a thin lens
    (aperture 0.05) focused on the middle sphere, with a mitchell filter;
    a res x res film at spp, `integrator` (a spec dict) or path max_depth 8."""
    eye, ball = np.array([0.0, 0.4, 3.2]), np.array([0.0, -0.67, 0.0])
    return {
        "type": "scene",
        "integrator": integrator or {"type": "path", "max_depth": 8},
        "sensor": {
            "type": "thinlens", "fov": 40.0, "aperture_radius": 0.05,
            "focus_distance": float(np.linalg.norm(ball - eye)),
            "to_world": [{"type": "look_at", "origin": eye.tolist(), "target": [0.0, -0.5, 0.0],
                          "up": [0, 1, 0]}],
            "film": {"type": "hdrfilm", "width": res, "height": res,
                     "rfilter": {"type": "mitchell"}},
            "sampler": {"type": "independent", "sample_count": spp},
        },
        "floor": {
            "type": "rectangle",
            "to_world": [{"type": "scale", "value": [3.0, 3.0, 1.0]},
                         {"type": "rotate", "axis": [1, 0, 0], "angle": -90},
                         {"type": "translate", "value": [0.0, -1.0, 0.0]}],
            "bsdf": {"type": "diffuse", "reflectance": {
                "type": "checkerboard", "color0": {"type": "rgb", "value": [0.8, 0.8, 0.75]},
                "color1": {"type": "rgb", "value": [0.15, 0.15, 0.2]},
                "to_uv": {"type": "scale", "value": [6.0, 6.0, 1.0]}}},
        },
        "cube": {
            "type": "cube",
            "to_world": [{"type": "scale", "value": 0.25},
                         {"type": "rotate", "axis": [0, 1, 0], "angle": 30},
                         {"type": "translate", "value": [1.1, -0.75, -0.9]}],
            "bsdf": {"type": "diffuse", "reflectance": {"type": "rgb", "value": [0.2, 0.4, 0.7]}},
        },
        "diffuse-ball": {"type": "sphere", "center": ball.tolist(), "radius": 0.33,
                         "bsdf": {"type": "diffuse",
                                  "reflectance": {"type": "rgb", "value": [0.7, 0.25, 0.2]}}},
        "gold-ball": {"type": "sphere", "center": [-0.8, -0.67, 0.0], "radius": 0.33,
                      "bsdf": {"type": "roughconductor", "material": "Au", "alpha": 0.2}},
        "glass-ball": {"type": "sphere", "center": [0.8, -0.67, 0.0], "radius": 0.33,
                       "bsdf": {"type": "dielectric", "int_ior": "bk7"}},
        "bulb": {"type": "sphere", "center": [-0.5, 0.6, 0.7], "radius": 0.08,
                 "emitter": {"type": "area",
                             "radiance": {"type": "rgb", "value": [40.0, 36.0, 30.0]}}},
        "spot": {"type": "spot", "cutoff_angle": 25.0,
                 "intensity": {"type": "rgb", "value": [12.0, 12.0, 10.0]},
                 "to_world": {"type": "look_at", "origin": [1.6, 1.6, 1.2],
                              "target": [0.8, -0.67, 0.0], "up": [0, 1, 0]}},
        "sky": {"type": "envmap", "data": sky_envmap()},
    }


def manylights_scene(res=256, spp=64, integrator=None, beam=False):
    """The Cornell box with its ceiling light split into 8 panels of
    constant radiance (a 4 x 2 grid of the light's rectangle, radiances
    0.8-1.15 of the cbox's), which the loader fuses into one
    AreaEmitterArray; with `beam`, also a collimated (directionalarea)
    panel under the ceiling shining down. A res x res film at spp,
    `integrator` or the cbox's path tracer."""
    d = cornell_box()
    d["sensor"]["film"]["width"] = d["sensor"]["film"]["height"] = res
    d["sensor"]["sampler"]["sample_count"] = spp
    base = np.array(d.pop("light")["emitter"]["radiance"]["value"])
    for k in range(8):
        x, z = -0.1725 + 0.115 * (k % 4), 0.01 - 0.095 + 0.19 * (k // 4)
        d[f"light-{k}"] = {
            "type": "rectangle",
            "to_world": [{"type": "scale", "value": [0.0575, 0.095, 1.0]},
                         {"type": "rotate", "axis": [1, 0, 0], "angle": 90},
                         {"type": "translate", "value": [x, 0.99, z]}],
            "bsdf": {"type": "ref", "id": "white"},
            "emitter": {"type": "area", "radiance": {
                "type": "rgb", "value": (base * (0.8 + 0.05 * k)).tolist()}},
        }
    if beam:
        d["beam"] = {
            "type": "rectangle",
            "to_world": [{"type": "scale", "value": 0.12},
                         {"type": "rotate", "axis": [1, 0, 0], "angle": 90},
                         {"type": "translate", "value": [-0.45, 0.95, 0.3]}],
            "bsdf": {"type": "ref", "id": "white"},
            "emitter": {"type": "directionalarea",
                        "radiance": {"type": "rgb", "value": [6.0, 5.0, 4.0]}},
        }
    if integrator is not None:
        d["integrator"] = integrator
    return d


def projector_scene(res=256, spp=64):
    """The Cornell box with a projector at (0, 0, 1.5) throwing a 64 x 64
    bitmap (a smooth colour pattern with a seeded numpy texture,
    default_rng(PROJECTOR_SEED)) on the back wall through a 40 degree frustum, scale
    2, beside the ceiling light."""
    d = cornell_box()
    d["sensor"]["film"]["width"] = d["sensor"]["film"]["height"] = res
    d["sensor"]["sampler"]["sample_count"] = spp
    y, x = np.mgrid[0:64, 0:64] / 63.0
    noise = np.random.default_rng(PROJECTOR_SEED).random((64, 64))
    img = np.stack([0.5 + 0.5 * np.cos(6 * x), 0.5 + 0.5 * np.sin(5 * y), 0.3 + 0.7 * noise], -1)
    d["projector"] = {"type": "projector", "fov": 40.0, "scale": 2.0,
                      "irradiance": {"type": "bitmap", "data": img.astype(np.float32)},
                      "to_world": {"type": "look_at", "origin": [0.0, 0.0, 1.5],
                                   "target": [0.0, 0.0, -1.0], "up": [0, 1, 0]}}
    return d


def spherified_cube(k=130):
    """(v0, e1, e2) [12 k^2, 3] float32 of a sphere tessellated as a
    spherified cube (a copy of the JAX package's scripts/bench_bvh.py)."""
    verts, faces = [], []
    for axis in range(3):
        for sgn in (-1.0, 1.0):
            base = len(verts)
            for i in range(k + 1):
                for j in range(k + 1):
                    uv = [-1 + 2 * i / k, -1 + 2 * j / k]
                    p = [0.0, 0.0, 0.0]
                    p[axis] = sgn
                    p[(axis + 1) % 3] = uv[0]
                    p[(axis + 2) % 3] = uv[1]
                    p = np.asarray(p)
                    verts.append(p / np.linalg.norm(p))
                    if i < k and j < k:
                        a = base + i * (k + 1) + j
                        b, c, d = a + 1, a + (k + 1), a + (k + 1) + 1
                        faces.append([a, b, d])
                        faces.append([a, d, c])
    V = np.asarray(verts, np.float32)
    F = np.asarray(faces, np.int32)
    v0 = V[F[:, 0]]
    return v0, V[F[:, 1]] - v0, V[F[:, 2]] - v0


def mesh_scene(obj_path, k=130, res=256):
    """The large-mesh scene of the JAX package's scripts/bench_mesh.py: the
    Cornell box without its small box, holding a spherified-cube sphere of
    12 k^2 triangles (202,800 at k=130), written as an OBJ file at
    `obj_path`, scaled by 0.35 and moved to (0.2, -0.1, 0.2). Returns the
    scene dict; the film is res x res."""
    v0, e1, e2 = spherified_cube(k)
    verts = np.concatenate([v0, v0 + e1, v0 + e2], axis=0) * 0.35
    n = v0.shape[0]
    faces = np.stack([np.arange(n), np.arange(n) + n, np.arange(n) + 2 * n], -1)
    with open(obj_path, "w") as f:
        for p in verts:
            f.write(f"v {p[0]} {p[1]} {p[2]}\n")
        for a, b, c in faces + 1:
            f.write(f"f {a} {b} {c}\n")
    d = cornell_box()
    d["sensor"]["film"]["width"] = res
    d["sensor"]["film"]["height"] = res
    del d["small-box"]
    d["mesh"] = {
        "type": "obj",
        "filename": str(obj_path),
        "to_world": {"type": "translate", "value": [0.2, -0.1, 0.2]},
        "bsdf": {"type": "diffuse", "reflectance": {"type": "rgb", "value": [0.6, 0.55, 0.5]}},
    }
    return d


def het_vol_scene(res=96, spp=16, max_depth=12, steps=16, regenerate=False):
    """bench.py's heterogeneous-medium scene (BASELINE config 3, the
    het_vol_fwd_mrays cell): a 32^3 grid of sigma_t in [0.3, 2.5) made from
    numpy's default_rng(3), albedo 0.9 and an HG phase (g 0.5), inside a
    null cube of half-size 1.2 under a constant white environment; volpath
    with `steps` delta-tracking and NEE ratio-tracking steps, a box filter."""
    grid = (0.3 + 2.2 * np.random.default_rng(3).random((32, 32, 32, 1))).astype(np.float32)
    return {
        "type": "scene",
        "integrator": {"type": "volpath", "max_depth": max_depth, "track_steps": steps,
                       "nee_steps": steps, "regenerate": regenerate},
        "sensor": _vol_sensor(res, spp),
        "light": {"type": "constant", "radiance": {"type": "rgb", "value": [1.0, 1.0, 1.0]}},
        "cloud": {
            "type": "cube",
            "to_world": [{"type": "scale", "value": [1.2, 1.2, 1.2]}],
            "bsdf": {"type": "null"},
            "interior": {
                "type": "heterogeneous",
                "sigma_t": {"type": "gridvolume", "data": grid,
                            "bbox_min": [-1, -1, -1], "bbox_max": [1, 1, 1]},
                "albedo": 0.9,
                "phase": {"type": "hg", "g": 0.5},
            },
        },
    }


def vol32_scene(res=128, spp=16, max_depth=32, steps=16, regenerate=False):
    """bench.py's deep-volume scene (the vol32_regen_speedup cell): a
    homogeneous slab (sigma_t 4, albedo 0.95, HG g 0.6) in the same null
    cube and environment as het_vol_scene, volpath at max_depth 32."""
    return {
        "type": "scene",
        "integrator": {"type": "volpath", "max_depth": max_depth, "track_steps": steps,
                       "nee_steps": steps, "regenerate": regenerate},
        "sensor": _vol_sensor(res, spp),
        "light": {"type": "constant", "radiance": {"type": "rgb", "value": [1.0, 1.0, 1.0]}},
        "slab": {
            "type": "cube",
            "to_world": [{"type": "scale", "value": [1.2, 1.2, 1.2]}],
            "bsdf": {"type": "null"},
            "interior": {
                "type": "homogeneous",
                "sigma_t": [4.0, 4.0, 4.0],
                "albedo": [0.95, 0.95, 0.95],
                "phase": {"type": "hg", "g": 0.6},
            },
        },
    }


def _vol_sensor(res, spp):
    return {
        "type": "perspective", "fov": 45,
        "to_world": [{"type": "look_at", "origin": [0, 0, 4], "target": [0, 0, 0],
                      "up": [0, 1, 0]}],
        "film": {"type": "hdrfilm", "width": res, "height": res, "rfilter": {"type": "box"}},
        "sampler": {"type": "independent", "sample_count": spp},
    }


def atmo_scene(res=64, spp=64, max_depth=8):
    """bench.py's polarized atmosphere (BASELINE config 4, the
    atmo_msamples cell), for the mono_polarized variant: a directional sun
    (irradiance 10, propagating along (0.3, 0, -1)) over a null slab (a cube
    scaled 50 x 50 x 1) holding a homogeneous medium (sigma_t 0.1, albedo
    0.95) whose phase blends Rayleigh (depolarization 0.03, weight 0.6) with
    a Mie aerosol (550 nm, n 1.33, gamma size distribution a 600 nm, b 0.3,
    radii 200-1500 nm over 24 Gauss points, baked on 128 cosines); a
    radiancemeter at (-60, 0, 0) looking along +x, pinned to 550 nm, with a
    res x res box film; volpath at max_depth."""
    return {
        "type": "scene",
        "integrator": {"type": "volpath", "max_depth": max_depth},
        "sun": {"type": "directional", "direction": [0.3, 0, -1], "irradiance": 10.0},
        "slab": {
            "type": "cube",
            "to_world": [{"type": "scale", "value": [50.0, 50.0, 1.0]}],
            "bsdf": {"type": "null"},
            "interior": {"type": "ref", "id": "atmo"},
        },
        "atmo": {
            "type": "homogeneous", "sigma_t": 0.1, "albedo": 0.95,
            "phase": {
                "type": "blendphase", "weight": 0.4,
                "rayleigh_part": {"type": "rayleigh", "depolarization": 0.03},
                "aerosol": {
                    "type": "mie", "wavelength": 550.0, "ior_sph": 1.33,
                    "size_distr": {
                        "type": "gamma", "a": 600.0, "b": 0.3,
                        "min_radius": 200.0, "max_radius": 1500.0,
                        "gauss_points": 24,
                    },
                    "bake_nodes": 128,
                },
            },
        },
        "sensor": {
            "type": "radiancemeter", "wavelength": 550.0,
            "to_world": [{"type": "look_at", "origin": [-60.0, 0.0, 0.0],
                          "target": [1, 0, 0], "up": [0, 0, 1]}],
            "film": {"type": "hdrfilm", "width": res, "height": res,
                     "rfilter": {"type": "box"}},
            "sampler": {"type": "independent", "sample_count": spp},
        },
    }


def aos_scene(res=32, max_depth=4, integrator="prb_volpathaos"):
    """bench.py's atmosphere-ocean retrieval scene (BASELINE config 5, the
    aos cell), for the mono_polarized variant: a rough-dielectric ocean
    surface (int_ior 1.33, ext_ior 1, alpha 0.2) over a diffuse sea floor
    (reflectance 0.5) 2 below, a directional sun (irradiance 5, propagating
    along (-0.3, 0, -0.954)), a Rayleigh atmosphere (sigma_t 0.2, albedo
    0.8) in a null slab 0.8 thick centred at z = 1, and a radiancemeter at
    (0, 0, 4) looking down with a res x res box film; `integrator`
    (bench.py: prb_volpathaos) at max_depth. bench.py renders it with
    render_1 at 64 spp and differentiates the sum for the atmosphere's
    sigma_t."""
    return {
        "type": "scene",
        "integrator": {"type": integrator, "max_depth": max_depth},
        "ocean_surface": {
            "type": "rectangle",
            "to_world": [{"type": "scale", "value": [1000.0, 1000.0, 1.0]}],
            "bsdf": {"type": "roughdielectric", "int_ior": 1.33, "ext_ior": 1.0, "alpha": 0.2},
        },
        "sea_floor": {
            "type": "rectangle",
            "to_world": [
                {"type": "scale", "value": [1000.0, 1000.0, 1.0]},
                {"type": "translate", "value": [0.0, 0.0, -2.0]},
            ],
            "bsdf": {"type": "diffuse", "reflectance": 0.5},
        },
        "sun": {"type": "directional", "direction": [-0.3, 0, -0.954], "irradiance": 5.0},
        "atmo_medium": {"type": "homogeneous", "phase": {"type": "rayleigh"},
                        "albedo": 0.8, "sigma_t": 0.2},
        "atmo": {
            "type": "cube", "bsdf": {"type": "null"},
            "to_world": [
                {"type": "scale", "value": [1000.0, 1000.0, 0.4]},
                {"type": "translate", "value": [0.0, 0.0, 1.0]},
            ],
            "interior": {"type": "ref", "id": "atmo_medium"},
        },
        "sensor": {
            "type": "radiancemeter",
            "to_world": [{"type": "look_at", "origin": [0, 0, 4], "target": [0, 0, 0],
                          "up": [0, 1, 0]}],
            "film": {"type": "hdrfilm", "rfilter": {"type": "box"}, "width": res, "height": res},
        },
    }
