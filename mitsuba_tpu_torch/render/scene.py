"""Scene: the geometry and every plugin instance, on one device
(counterpart of mitsuba_tpu/render/scene.py).

Dispatch over plugin instances is a Python loop with lane masks, the
wavefront analog of the reference's vectorized virtual calls. The shape ->
BSDF / emitter / medium maps are small index tensors read by plain
indexing. Medium index -1 is vacuum, where the camera sits (camera_medium
is -1, as in the reference).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import warp
from ..core.frame import dot
from ..core.math import INV_PI
from . import mueller as mu
from . import shapes as shapes_mod
from .phase import local_wi, sggx_projected_area
from .phase_polarized import phase_eval_pdf_mueller
from .bsdfs import DiffuseBSDF, NullBSDF, _invalid_sample
from .spectrum_ops import depolarizer_weight, identity_weight
from .records import BSDFSample, DirectionSample, PreliminaryIntersection, Ray, spawn_ray
from .textures import ConstantTexture


def _unit_z(n, device):
    """[n, 3] of (0, 0, 1), made on the device (no copy from the host)."""
    z = torch.zeros(n, 3, dtype=torch.float32, device=device)
    z[:, 2] = 1.0
    return z


@dataclass
class Scene:
    geometry: shapes_mod.Geometry
    bsdfs: tuple                 # BSDF instances
    emitters: tuple              # emitter instances
    sensors: tuple               # sensor instances
    integrator: object
    film: object
    shape_bsdf: torch.Tensor     # [n_shapes] int64 index into bsdfs
    shape_emitter: torch.Tensor  # [n_shapes] int64 index into emitters, -1 none
    spp: int
    device: torch.device
    n_channels: int = 3
    # (key, path) pairs for traverse()/SceneParameters
    param_paths: tuple = ()
    media: tuple = ()            # medium instances
    phases: tuple = ()           # phase function instances
    shape_interior_medium: torch.Tensor = None   # [n_shapes] int64, -1 none
    shape_exterior_medium: torch.Tensor = None   # [n_shapes] int64, -1 none
    bbox_min: torch.Tensor = None   # [3] of the geometry
    bbox_max: torch.Tensor = None   # [3]
    medium_phase: torch.Tensor = None   # [n_media] int64 phase index of each medium
    env_emitter: int = -1           # index of the environment emitter or -1
    # Mueller throughput and Stokes radiance (the *_polarized variants)
    polarized: bool = False
    # the emitters' selection weights [E] (the scene dict's
    # "emitter_sampler": "power", render/scene_loader.py:emitter_power), or
    # None for the uniform selection
    emitter_pmf: torch.Tensor = None
    # the camera sits in vacuum
    camera_medium = -1

    # -- intersection -------------------------------------------------------
    def ray_intersect(self, ray: Ray, active=None):
        pi = shapes_mod.ray_intersect_preliminary(self.geometry, ray, active)
        return shapes_mod.compute_surface_interaction(self.geometry, ray, pi)

    def ray_test(self, ray: Ray, active=None):
        return shapes_mod.ray_test(self.geometry, ray, active)

    def ray_intersect_and_test(self, ray: Ray, sray: Ray, active, s_active):
        """Closest hit of `ray` and occlusion of `sray` in ONE kernel launch
        over the concatenated 2N-ray batch (the deferred-NEE path: bounce k's
        shadow rays ride bounce k+1's intersect launch)."""
        n = ray.o.shape[0]
        batch = Ray(
            o=torch.cat([ray.o, sray.o]),
            d=torch.cat([ray.d, sray.d]),
            maxt=torch.cat([ray.maxt, sray.maxt]),
        )
        pi = shapes_mod.ray_intersect_preliminary(
            self.geometry, batch, torch.cat([active, s_active])
        )
        pi_hit = PreliminaryIntersection(
            t=pi.t[:n], prim_index=pi.prim_index[:n], prim_uv=pi.prim_uv[:n]
        )
        si = shapes_mod.compute_surface_interaction(self.geometry, ray, pi_hit)
        occluded = pi.is_valid[n:] & s_active
        return si, occluded

    # -- emitters -----------------------------------------------------------
    @property
    def n_emitters(self):
        return len(self.emitters)

    def _emitter_at(self, si):
        shape_idx = torch.clamp(si.shape_index, min=0).to(torch.int64)
        return torch.where(si.shape_index >= 0, self.shape_emitter[shape_idx], -1)

    def sample_emitter_direction(self, ref_p, u0, u2, active, test_visibility=True, ref_n=None,
                                 wavelengths=None):
        """Pick an emitter (uniformly, or by emitter_pmf), sample a
        direction toward it and, with test_visibility, shadow-test it. The
        weight (radiance / pdf) and the pdf include the selection's
        probability."""
        n_lanes = ref_p.shape[0]
        E = self.n_emitters
        if E == 0:
            zero3 = torch.zeros_like(ref_p)
            zero = torch.zeros(n_lanes, dtype=torch.float32, device=ref_p.device)
            ds = DirectionSample(
                p=ref_p, n=zero3, d=zero3, dist=zero, pdf=zero,
                delta=torch.zeros(n_lanes, dtype=torch.bool, device=ref_p.device),
                emitter_index=torch.full((n_lanes,), -1, dtype=torch.int32, device=ref_p.device),
                uv=torch.zeros(n_lanes, 2, dtype=torch.float32, device=ref_p.device),
            )
            return ds, torch.zeros(n_lanes, self.n_channels, dtype=torch.float32, device=ref_p.device)

        if self.emitter_pmf is None:
            sel = torch.clamp((u0 * E).to(torch.int32), 0, E - 1)
        else:
            cdf = torch.cumsum(self.emitter_pmf, 0)
            sel = torch.clamp(torch.searchsorted(cdf / cdf[-1], u0.contiguous(), right=True),
                              0, E - 1).to(torch.int32)
        ds_out = w_out = None
        for i, em in enumerate(self.emitters):
            ds_i, w_i = em.sample_direction(ref_p, u2, self.geometry, i, self.n_channels,
                                            wavelengths)
            m = sel == i
            if ds_out is None:
                ds_out, w_out = ds_i, torch.where(m[..., None], w_i, 0.0)
                continue
            m3 = m[..., None]
            ds_out = DirectionSample(
                p=torch.where(m3, ds_i.p, ds_out.p),
                n=torch.where(m3, ds_i.n, ds_out.n),
                d=torch.where(m3, ds_i.d, ds_out.d),
                dist=torch.where(m, ds_i.dist, ds_out.dist),
                pdf=torch.where(m, ds_i.pdf, ds_out.pdf),
                delta=torch.where(m, ds_i.delta, ds_out.delta),
                emitter_index=torch.where(m, ds_i.emitter_index, ds_out.emitter_index),
                uv=torch.where(m3, ds_i.uv, ds_out.uv),
            )
            w_out = torch.where(m3, w_i, w_out)
        if self.emitter_pmf is None:
            # uniform selection probability 1/E
            ds_out.pdf = ds_out.pdf / E
            w_out = w_out * E
        else:
            sel_p = self._emitter_sel_pmf()[sel.to(torch.int64)]
            ds_out.pdf = ds_out.pdf * sel_p
            w_out = w_out / torch.clamp(sel_p, min=1e-20)[..., None]

        if test_visibility:
            sray = spawn_ray(
                ref_p, ref_n if ref_n is not None else ds_out.d, ds_out.d,
                maxt=ds_out.dist * (1.0 - 1e-3),
            )
            occluded = self.ray_test(sray, active & (ds_out.pdf > 0))
            w_out = torch.where(occluded[..., None], 0.0, w_out)

        w_out = torch.where(active[..., None], w_out, 0.0)
        return ds_out, w_out

    def pdf_emitter_direction_hit(self, ref_p, si):
        """Solid-angle NEE pdf of the emitter hit at si (0 where no emitter
        was hit), for MIS at emitter hits."""
        pdf = torch.zeros(ref_p.shape[:-1], dtype=torch.float32, device=ref_p.device)
        E = self.n_emitters
        if E == 0:
            return pdf
        em_idx = self._emitter_at(si)
        for i, em in enumerate(self.emitters):
            if em.is_environment or em.is_delta:
                continue
            if getattr(em, "needs_geometry", False):
                p_i = em.pdf_direction(ref_p, si, self.geometry)
            else:
                p_i = em.pdf_direction(ref_p, si)
            pdf = torch.where(em_idx == i, p_i * self._sel_p(i), pdf)
        return pdf

    def _emitter_sel_pmf(self):
        """The selection probabilities [E] of the emitters (emitter_pmf
        normalized)."""
        return self.emitter_pmf / torch.sum(self.emitter_pmf)

    def _sel_p(self, i):
        """The selection probability of emitter i."""
        if self.emitter_pmf is None:
            return 1.0 / max(self.n_emitters, 1)
        return self._emitter_sel_pmf()[i]

    def eval_emitter_hit(self, si, wavelengths=None):
        """Radiance of the emitter (if any) at surface hit si."""
        out = torch.zeros(si.p.shape[0], self.n_channels, dtype=torch.float32, device=si.p.device)
        if self.n_emitters == 0:
            return out
        em_idx = self._emitter_at(si)
        for i, em in enumerate(self.emitters):
            if em.is_environment or em.is_delta:
                continue
            out = torch.where((em_idx == i)[..., None], em.eval(si, self.n_channels, wavelengths),
                              out)
        return out

    def eval_emitter_sample(self, ds, wavelengths=None):
        """Radiance value [N, C] of the emitter recorded in each direction
        sample, without its geometric factors (1/dist^2, pdf): the PRB
        replay evaluates it attached and carries the rest of the NEE weight
        as a detached ratio."""
        nc = self.n_channels
        out = torch.zeros(ds.d.shape[0], nc, dtype=torch.float32, device=ds.d.device)
        for i, em in enumerate(self.emitters):
            if hasattr(em, "eval_sample_value"):
                v = em.eval_sample_value(ds, nc, wavelengths)
            elif em.is_environment:
                v = em.eval_escaped(ds.d, nc, wavelengths)
            elif hasattr(em, "radiance"):
                v = em.radiance.eval(ds.uv, nc, wavelengths)
            elif hasattr(em, "intensity"):
                v = em.intensity.eval(ds.uv, nc, wavelengths)
            else:   # directional, projector
                v = em.irradiance.eval(ds.uv, nc, wavelengths)
            out = torch.where((ds.emitter_index == i)[..., None], v, out)
        return out

    def eval_environment(self, d, wavelengths=None):
        """Radiance of escaped rays along d: the environment emitter's, or 0."""
        if self.env_emitter < 0:
            return torch.zeros(d.shape[:-1] + (self.n_channels,), dtype=torch.float32,
                               device=d.device)
        return self.emitters[self.env_emitter].eval_escaped(d, self.n_channels, wavelengths)

    def pdf_emitter_direction_escaped(self, d):
        """NEE pdf of an escaped ray's direction on the environment emitter."""
        if self.env_emitter < 0 or self.n_emitters == 0:
            return torch.zeros(d.shape[:-1], dtype=torch.float32, device=d.device)
        em = self.emitters[self.env_emitter]
        return em.pdf_direction_escaped(d) * self._sel_p(self.env_emitter)

    # -- BSDF dispatch ------------------------------------------------------
    def bsdf_index_at(self, si):
        shape_idx = torch.clamp(si.shape_index, min=0).to(torch.int64)
        return torch.where(si.shape_index >= 0, self.shape_bsdf[shape_idx], -1)

    def _fused_diffuse_idxs(self):
        """Indices of the Lambertian BSDFs with a constant reflectance. When
        there are several (the cbox has white, red and green), one closed
        form with a per-lane reflectance row replaces a masked evaluation
        per instance. The spectral variants evaluate every instance at the
        lanes' own wavelengths and take no shortcut."""
        idxs = tuple(
            i for i, b in enumerate(self.bsdfs)
            if type(b) is DiffuseBSDF and type(b.reflectance) is ConstantTexture
        )
        return idxs if len(idxs) >= 2 else ()

    def _fused_diffuse_refl(self, idxs, b_idx):
        """(in_group mask [N], per-lane reflectance [N, C]) of the fused group."""
        uv0 = torch.zeros(1, 2, dtype=torch.float32, device=b_idx.device)
        refl = torch.zeros(b_idx.shape + (self.n_channels,), dtype=torch.float32, device=b_idx.device)
        in_group = torch.zeros(b_idx.shape, dtype=torch.bool, device=b_idx.device)
        for i in idxs:
            hit = b_idx == i
            refl = torch.where(hit[..., None],
                               self.bsdfs[i].reflectance.eval(uv0, self.n_channels)[0], refl)
            in_group = in_group | hit
        return in_group, refl

    def bsdf_eval_pdf(self, si, wo, active, wavelengths=None):
        """eval and pdf of the BSDF at each lane's hit, fused."""
        n_lanes = si.p.shape[0]
        val = torch.zeros(n_lanes, self.n_channels, dtype=torch.float32, device=si.p.device)
        pdf = torch.zeros(n_lanes, dtype=torch.float32, device=si.p.device)
        b_idx = self.bsdf_index_at(si)
        fused = self._fused_diffuse_idxs() if wavelengths is None else ()
        if fused:
            in_group, refl = self._fused_diffuse_refl(fused, b_idx)
            cos_o = wo[..., 2]
            ok = (si.wi[..., 2] > 0) & (cos_o > 0)
            m = in_group & active
            val = torch.where(
                (m & ok)[..., None],
                refl * (INV_PI * torch.clamp(cos_o, min=0.0))[..., None],
                val,
            )
            pdf = torch.where(m & ok, warp.square_to_cosine_hemisphere_pdf(wo), pdf)
        for i, b in enumerate(self.bsdfs):
            if i in fused or not b.flags_smooth:
                continue
            m = (b_idx == i) & active
            val = torch.where(m[..., None], b.eval(si, wo, self.n_channels, wavelengths), val)
            pdf = torch.where(m, b.pdf(si, wo), pdf)
        return val, pdf

    def bsdf_sample(self, si, u_lobe, u2, active, wavelengths=None):
        n_lanes = si.p.shape[0]
        dev = si.p.device
        b_idx = self.bsdf_index_at(si)
        bs = _invalid_sample(n_lanes, dev)
        weight = torch.zeros(n_lanes, self.n_channels, dtype=torch.float32, device=dev)
        fused = self._fused_diffuse_idxs() if wavelengths is None else ()
        if fused:
            in_group, refl = self._fused_diffuse_refl(fused, b_idx)
            wo_c = warp.square_to_cosine_hemisphere(u2)
            pdf_c = warp.square_to_cosine_hemisphere_pdf(wo_c)
            ok = si.wi[..., 2] > 0
            m = in_group & active
            bs = BSDFSample(
                wo=torch.where(m[..., None], wo_c, bs.wo),
                pdf=torch.where(m & ok, pdf_c, bs.pdf),
                eta=bs.eta,
                delta=bs.delta,
            )
            weight = torch.where((m & ok)[..., None], refl, weight)
        for i, b in enumerate(self.bsdfs):
            if i in fused:
                continue
            m = (b_idx == i) & active
            bs_i, w_i = b.sample(u_lobe, u2, si, self.n_channels, wavelengths)
            bs = BSDFSample(
                wo=torch.where(m[..., None], bs_i.wo, bs.wo),
                pdf=torch.where(m, bs_i.pdf, bs.pdf),
                eta=torch.where(m, bs_i.eta, bs.eta),
                delta=torch.where(m, bs_i.delta, bs.delta),
            )
            weight = torch.where(m[..., None], w_i, weight)
        return bs, weight

    # -- polarized dispatch: Mueller weights in the world's implicit bases --
    def bsdf_eval_pdf_pol(self, si, wo, active, wavelengths=None):
        """Polarized eval: the world-frame Mueller weight [N, C, 4, 4] (f *
        cos) and the pdf. A BSDF without a polarized eval depolarizes."""
        n_lanes, nc = si.p.shape[0], self.n_channels
        b_idx = self.bsdf_index_at(si)
        M = torch.zeros(n_lanes, nc, 4, 4, dtype=torch.float32, device=si.p.device)
        pdf = torch.zeros(n_lanes, dtype=torch.float32, device=si.p.device)
        for i, b in enumerate(self.bsdfs):
            if not b.flags_smooth:
                continue
            m = (b_idx == i) & active
            if hasattr(b, "eval_pdf_mueller"):
                M_i, p_i = b.eval_pdf_mueller(si, wo, nc, wavelengths)
            else:
                M_i, p_i = depolarizer_weight(b.eval(si, wo, nc, wavelengths)), b.pdf(si, wo)
            M = torch.where(m[..., None, None, None], M_i, M)
            pdf = torch.where(m, p_i, pdf)
        M = mu.to_world_mueller(M, -wo, si.wi, si.sh_s, si.sh_t, si.sh_n)
        return M, pdf

    def bsdf_sample_pol(self, si, u_lobe, u2, active, wavelengths=None):
        """Polarized sample: (BSDFSample, world-frame weight [N, C, 4, 4]).
        A BSDF without a polarized sample depolarizes, except the null BSDF,
        which passes the polarization on."""
        n_lanes, nc, dev = si.p.shape[0], self.n_channels, si.p.device
        b_idx = self.bsdf_index_at(si)
        bs = _invalid_sample(n_lanes, dev)
        M = torch.zeros(n_lanes, nc, 4, 4, dtype=torch.float32, device=dev)
        for i, b in enumerate(self.bsdfs):
            m = (b_idx == i) & active
            if hasattr(b, "sample_pol"):
                bs_i, M_i = b.sample_pol(u_lobe, u2, si, nc, wavelengths)
            else:
                bs_i, w_i = b.sample(u_lobe, u2, si, nc, wavelengths)
                M_i = identity_weight(w_i) if isinstance(b, NullBSDF) else depolarizer_weight(w_i)
            bs = BSDFSample(
                wo=torch.where(m[..., None], bs_i.wo, bs.wo),
                pdf=torch.where(m, bs_i.pdf, bs.pdf),
                eta=torch.where(m, bs_i.eta, bs.eta),
                delta=torch.where(m, bs_i.delta, bs.delta),
            )
            M = torch.where(m[..., None, None, None], M_i, M)
        M = mu.to_world_mueller(M, -bs.wo, si.wi, si.sh_s, si.sh_t, si.sh_n)
        return bs, M

    def phase_eval_pdf_pol(self, phase_idx, mei, wo, active):
        """Polarized phase eval: the world-frame Mueller matrix [N, C, 4, 4]
        and the pdf toward local wo. A phase without a polarized form
        depolarizes."""
        n, nc, dev = phase_idx.shape[0], self.n_channels, phase_idx.device
        M = torch.zeros(n, nc, 4, 4, dtype=torch.float32, device=dev)
        pdf = torch.zeros(n, dtype=torch.float32, device=dev)
        for i, ph in enumerate(self.phases):
            m = (phase_idx == i) & active
            M_i, p_i = phase_eval_pdf_mueller(ph, mei, wo, nc)
            M = torch.where(m[..., None, None, None], M_i, M)
            pdf = torch.where(m, p_i, pdf)
        M = mu.to_world_mueller(M, -wo, local_wi(wo), mei.sh_s, mei.sh_t, mei.sh_n)
        return M, pdf

    def phase_sample_pol(self, phase_idx, mei, u1, u2, active):
        """(wo local, world-frame weight M / pdf [N, C, 4, 4], pdf): the
        unpolarized sample's direction, weighted by the Mueller matrix."""
        wo, _, pdf = self.phase_sample(phase_idx, mei, u1, u2, active)
        M, _ = self.phase_eval_pdf_pol(phase_idx, mei, wo, active)
        return wo, M / torch.clamp(pdf, min=1e-12)[..., None, None, None], pdf

    # -- media ---------------------------------------------------------------
    @property
    def bbox_radius(self):
        return 0.5 * torch.sqrt(torch.sum((self.bbox_max - self.bbox_min) ** 2))

    def medium_majorant(self, medium_idx, p):
        """Majorant [N] at p of each lane's medium (-1 = vacuum: 0)."""
        out = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
        for i, m in enumerate(self.media):
            out = torch.where(medium_idx == i, m.get_majorant(p, self.n_channels), out)
        return out

    def medium_majorant_spectrum(self, medium_idx, p):
        """Per-channel majorant [N, C] of each lane's medium."""
        out = torch.zeros(p.shape[:-1] + (self.n_channels,), dtype=torch.float32, device=p.device)
        for i, m in enumerate(self.media):
            out = torch.where((medium_idx == i)[..., None],
                              m.get_majorant_spectrum(p, self.n_channels), out)
        return out

    def medium_coefficients(self, medium_idx, p, d=None):
        """(sigma_s, sigma_n, sigma_t) [N, C] of each lane's medium. With
        the propagation direction d, a medium whose phase is a microflake
        distribution has sigma_t and sigma_s scaled by the projected area
        sigma(-d), and its null density makes up the difference."""
        z = torch.zeros(p.shape[0], self.n_channels, dtype=torch.float32, device=p.device)
        ss, sn, st = z, z, z
        for i, m in enumerate(self.media):
            sel = (medium_idx == i)[..., None]
            ss_i, sn_i, st_i = m.get_scattering_coefficients(p, self.n_channels)
            ph = self.phases[m.phase_index]
            if d is not None and getattr(ph, "is_microflake", False):
                pa = sggx_projected_area(-d, ph.S.eval(p, 6))[..., None]
                st_pa = st_i * pa
                sn_i = torch.clamp(sn_i + st_i - st_pa, min=0.0)
                ss_i = ss_i * pa
                st_i = st_pa
            ss = torch.where(sel, ss_i, ss)
            sn = torch.where(sel, sn_i, sn)
            st = torch.where(sel, st_i, st)
        return ss, sn, st

    def medium_phase_of(self, medium_idx):
        """Phase index [N] of each lane's medium, -1 in vacuum."""
        if not self.media:
            return torch.full_like(medium_idx, -1)
        safe = torch.clamp(medium_idx, 0, len(self.media) - 1)
        return torch.where(medium_idx >= 0, self.medium_phase[safe], -1)

    def phase_sample(self, phase_idx, mei, u1, u2, active):
        """(wo local [N, 3], weight [N, C], pdf [N]) of each lane's phase."""
        n, dev = phase_idx.shape[0], phase_idx.device
        wo = _unit_z(n, dev)
        weight = torch.zeros(n, self.n_channels, dtype=torch.float32, device=dev)
        pdf = torch.zeros(n, dtype=torch.float32, device=dev)
        for i, ph in enumerate(self.phases):
            m = (phase_idx == i) & active
            wo_i, w_i, p_i = ph.sample(mei, u1, u2, self.n_channels)
            wo = torch.where(m[..., None], wo_i, wo)
            weight = torch.where(m[..., None], w_i, weight)
            pdf = torch.where(m, p_i, pdf)
        return wo, weight, pdf

    def phase_eval_pdf(self, phase_idx, mei, wo, active):
        """(value [N, C], pdf [N]) of each lane's phase toward local wo."""
        n, dev = phase_idx.shape[0], phase_idx.device
        val = torch.zeros(n, self.n_channels, dtype=torch.float32, device=dev)
        pdf = torch.zeros(n, dtype=torch.float32, device=dev)
        for i, ph in enumerate(self.phases):
            m = (phase_idx == i) & active
            v_i, p_i = ph.eval_pdf(mei, wo, self.n_channels)
            val = torch.where(m[..., None], v_i, val)
            pdf = torch.where(m, p_i, pdf)
        return val, pdf

    def is_null_bsdf(self, si):
        """Lanes whose hit surface has a null (medium-boundary) BSDF."""
        b_idx = self.bsdf_index_at(si)
        out = torch.zeros(b_idx.shape, dtype=torch.bool, device=b_idx.device)
        for i, b in enumerate(self.bsdfs):
            if isinstance(b, NullBSDF):
                out = out | (b_idx == i)
        return out

    def medium_transition(self, si, d, medium_idx):
        """Each lane's medium after crossing surface si along d: the
        shape's interior when entering (d against the normal), its exterior
        when leaving; unchanged where the shape separates no two media."""
        shape_idx = torch.clamp(si.shape_index, min=0).to(torch.int64)
        interior = self.shape_interior_medium[shape_idx]
        exterior = self.shape_exterior_medium[shape_idx]
        entering = dot(d, si.n) < 0.0
        new_med = torch.where(entering, interior, exterior)
        is_transition = (si.shape_index >= 0) & (interior != exterior)
        return torch.where(is_transition, new_med, medium_idx)
