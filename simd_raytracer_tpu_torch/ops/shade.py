"""Wavefront shading: the reference's recursive Whitted+GI shader
(render/render.hpp:133-308) as one branchless bounce step.

Every material's output is `direct + sum_i w_i * color(child_i)`, so each
ray carries a throughput `weight` and a `miss_is_bg` flag; a hit emits its
direct term at once and spawns up to K children with scaled weights.
Counterpart of `simd_raytracer_tpu.ops.shade`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..config import RenderConfig
from ..models.scene import (MAT_CONSTANT, MAT_DIFFUSE, MAT_REFLECTIVE,
                            MAT_REFRACTIVE, MAT_TEXTURE, Geometry, Scene,
                            cross3, dot3, safe_normalize)
from ..models.textures import sample_texture
from ..utils.profiling import span, spanned
from .intersect import HitRecord, make_select_fn, mt_refine

FOUR_PI = 4.0 * math.pi


@spanned("occlusion")
def occluded(o: torch.Tensor, d: torch.Tensor, max_t: torch.Tensor,
             scene: Scene, geom: Geometry, cfg: RenderConfig,
             accel=None) -> torch.Tensor:
    """Batched is_occluded (render.hpp:110-131).  o, d (N, 3); max_t (N,).
    No gradients flow: visibility is piecewise constant.

    "fast": one any-hit query over the non-transmissive triangles with the
    inclusive window t <= max_t.  "march": two any-hit probes, over the
    solid and over the glass triangles, decide every ray that crosses no
    glass inside its window; the rays that do cross glass march hop by hop
    through it (`_march`)."""
    select = make_select_fn(cfg.intersector, accel, geom)
    solid = geom.tri_valid & ~geom.tri_transmissive
    with torch.no_grad():
        o, d, max_t = o.detach(), d.detach(), max_t.detach()
        _, occ = select(o, d, geom.v0, geom.e1, geom.e2, cfg.epsilon, False,
                        solid, t_max=max_t, any_hit=True)
        if cfg.occlusion_mode == "fast":
            return occ
        _, crossed = select(o, d, geom.v0, geom.e1, geom.e2, cfg.epsilon,
                            False, geom.tri_valid & geom.tri_transmissive,
                            t_max=max_t, any_hit=True)
        with span("wait"):
            rows = crossed.nonzero()[:, 0]
        if rows.numel():
            occ = occ.index_put((rows,), _march(
                select, o[rows], d[rows], max_t[rows], geom, cfg))
    return occ


@spanned("march")
def _march(select, o, d, max_t, geom: Geometry, cfg: RenderConfig):
    """The reference's re-origining shadow march (render.hpp:110-131) for
    rays whose window crosses glass -> (N,) bool.

    Each hop is a closest-hit select inside the remaining window, then the
    winner's refined t: a solid winner occludes, a transmissive one moves
    the origin past it by shadow_bias and shrinks the window, at most
    max(1, max_shadow_march) hops.  Rays leave the hop set once decided
    (exact compaction, values unchanged)."""
    occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    rows = torch.arange(o.shape[0], device=o.device)
    for _ in range(max(1, cfg.max_shadow_march)):
        if rows.numel() == 0:
            break
        d_c = d[rows]
        idx, hit = select(o, d_c, geom.v0, geom.e1, geom.e2, cfg.epsilon,
                          False, geom.tri_valid, t_max=max_t)
        gidx = idx.long()
        t, _, _ = mt_refine(o, d_c, geom.v0[gidx], geom.e1[gidx],
                            geom.e2[gidx], cfg.epsilon)
        # A window miss may still carry the closest winner beyond the
        # window as idx (the brute-force kernel's contract), so the
        # winner's material is read only inside the window.
        within = hit & (t <= max_t)
        transmissive = within & geom.tri_transmissive[gidx]
        occ[rows[within & ~transmissive]] = True
        pos = o + t[:, None] * d_c
        o = pos + cfg.shadow_bias * d_c
        max_t = max_t - t
        # Loop guard `while (0 < max_t)` (render.hpp:115).
        with span("wait"):
            keep = (transmissive & (max_t > 0.0)).nonzero()[:, 0]
        rows, o, max_t = rows[keep], o[keep], max_t[keep]
    return occ


def direct_light_factor(scene: Scene, geom: Geometry, hit: HitRecord,
                        cfg: RenderConfig, accel=None) -> torch.Tensor:
    """Sum over lights of visibility * intensity / (4 pi r^2) * cos_law
    (render.hpp:184-206): (N,) factor for the caller's albedo or texel."""
    n_rays = hit.position.shape[0]
    nl = scene.light_pos.shape[0]

    ldir_un = scene.light_pos[None, :, :] - hit.position[:, None, :]  # N,L,3
    r = torch.sqrt(dot3(ldir_un, ldir_un).clamp_min(1e-24))
    ldir = ldir_un / r[..., None]
    area = FOUR_PI * r * r

    shade_n = torch.where(hit.smooth[:, None], hit.hit_n, hit.face_n)
    cos_law = dot3(ldir, shade_n[:, None, :]).clamp_min(0.0)          # N,L

    shadow_o = hit.position[:, None, :] + cfg.shadow_bias * ldir
    # A pair facing away from its light contributes nothing whatever the
    # visibility, so its shadow query gets a zero-length window.
    max_t = torch.where(cos_law > 0.0, r, 0.0)
    # Light-major batching: consecutive shadow rays share one light, which
    # keeps a sweep ray tile's direction box tight.
    occ = occluded(shadow_o.transpose(0, 1).reshape(-1, 3),
                   ldir.transpose(0, 1).reshape(-1, 3),
                   max_t.T.reshape(-1), scene, geom, cfg, accel
                   ).reshape(nl, n_rays).T

    falloff = scene.light_intensity[None, :] / area.clamp_min(1e-20)
    terms = torch.where(occ, 0.0, falloff * cos_law)
    total = terms[:, 0]
    for li in range(1, nl):
        total = total + terms[:, li]
    return total


@spanned("shade")
def shade(scene: Scene, geom: Geometry, hit: HitRecord,
          d_in: torch.Tensor, weight: torch.Tensor, cfg: RenderConfig,
          accel=None, rnd_coin: Optional[torch.Tensor] = None,
          rnd_gi: Optional[torch.Tensor] = None,
          ) -> Tuple[torch.Tensor, Tuple]:
    """One bounce of shading for N rays.

    hit: their records (mask False = miss); d_in (N, 3) incoming
    directions; weight (N,) throughputs, 0 for dead rays.  rnd_coin (N,)
    are the roulette uniforms and rnd_gi (N, gi, 2) the diffuse GI
    uniforms, drawn by the caller per wavefront slot.
    Returns (contrib (N, 3), children (o (N*K, 3), d (N*K, 3),
    weight (N*K,), miss_bg (N*K,)))."""
    n = d_in.shape[0]
    k = cfg.child_slots
    gi_count = cfg.diffuse_reflection_ray_count
    dtype = weight.dtype

    live = weight * hit.mask.to(dtype)
    tag = hit.mat_tag
    is_diffuse = tag == MAT_DIFFUSE
    is_reflective = tag == MAT_REFLECTIVE
    is_refractive = tag == MAT_REFRACTIVE
    is_constant = tag == MAT_CONSTANT
    is_texture = tag == MAT_TEXTURE

    # ---- direct light: shadow queries only for live diffuse/texture hits,
    # gathered exactly with nonzero (render.hpp:184-206) -----------------
    lit = is_diffuse | is_texture
    with span("wait"):
        need = (lit & hit.mask & (weight > 0.0)).nonzero()[:, 0]
    factor = torch.zeros_like(weight)
    if need.numel():
        sub = hit.map(lambda a: a[need])
        factor = factor.index_put((need,), direct_light_factor(
            scene, geom, sub, cfg, accel))
    tex_color = sample_texture(scene, hit.tex, hit.u, hit.v, hit.w, hit.uvs)
    surf_color = torch.where(is_texture[:, None], tex_color, hit.albedo)
    # Diffuse divides its total (direct + GI) by gi + 1 (render.hpp:208);
    # texture does not (render.hpp:211-238).
    direct_scale = torch.ones_like(weight).masked_fill(
        is_diffuse, 1.0 / (gi_count + 1))
    contrib = (live * factor * direct_scale)[:, None] * surf_color
    contrib = contrib + (live * is_constant.to(dtype))[:, None] * hit.albedo

    # ---- reflective child (render.hpp:239-250) ---------------------------
    refl_dir = d_in - 2.0 * dot3(d_in, hit.hit_n)[:, None] * hit.hit_n
    refl_org = hit.position + cfg.reflection_bias * refl_dir

    # ---- refractive children (render.hpp:251-301) ------------------------
    n_geo = torch.where(hit.smooth[:, None], hit.hit_n, hit.face_n)
    nrm = safe_normalize(n_geo)
    i_dir = safe_normalize(d_in)
    entering_flip = dot3(i_dir, nrm) > 0.0
    nrm = torch.where(entering_flip[:, None], -nrm, nrm)
    eta_i = torch.where(entering_flip, hit.ior, 1.0)
    eta_r = torch.where(entering_flip, 1.0, hit.ior)
    cos_i = -dot3(i_dir, nrm)
    # sqrt arguments clamped above 0 so the masked-out branches stay finite.
    sin_i = torch.sqrt((1.0 - cos_i * cos_i).clamp_min(1e-12))
    tir = (eta_r / eta_i.clamp_min(1e-20)) < sin_i
    r_refl_dir = i_dir - 2.0 * dot3(i_dir, nrm)[:, None] * nrm
    r_refl_org = hit.position + cfg.reflection_bias * r_refl_dir
    sin_r = sin_i * eta_i / eta_r.clamp_min(1e-20)
    cos_r = torch.sqrt((1.0 - sin_r * sin_r).clamp_min(1e-12))
    perp = safe_normalize(i_dir + cos_i[:, None] * nrm)
    refr_dir = cos_r[:, None] * (-nrm) + sin_r[:, None] * perp
    refr_org = hit.position + cfg.refraction_bias * refr_dir
    # Pseudo-Fresnel 0.5 * (1 + i.n)^5 (render.hpp:300), i.n == -cos_i.
    base = 1.0 - cos_i
    base2 = base * base
    fresnel = 0.5 * (base2 * base2 * base)

    # ---- diffuse GI children (render.hpp:151-182) ------------------------
    if gi_count > 0:
        if rnd_gi is None:
            raise ValueError("diffuse GI shading needs rnd_gi")
        # The frame is built from the un-normalised incoming direction.
        right = safe_normalize(cross3(d_in, hit.hit_n))
        up = hit.hit_n
        fwd = cross3(right, up)
        theta = math.pi * rnd_gi[..., 0]
        phi = 2.0 * math.pi * rnd_gi[..., 1]
        # (cos t, sin t, 0) rotated about Y by phi (render.hpp:160-170).
        vx = torch.cos(phi) * torch.cos(theta)
        vy = torch.sin(theta)
        vz = torch.sin(phi) * torch.cos(theta)
        # mat3(right, up, fwd) * v: the rows-dot-vector products
        # (render.hpp:157, :173; mat3.hpp:53-60).
        gi_dir = torch.stack([
            right[:, None, 0] * vx + right[:, None, 1] * vy
            + right[:, None, 2] * vz,
            up[:, None, 0] * vx + up[:, None, 1] * vy + up[:, None, 2] * vz,
            fwd[:, None, 0] * vx + fwd[:, None, 1] * vy
            + fwd[:, None, 2] * vz,
        ], dim=-1)                                     # (N, gi, 3)
        gi_org = (hit.position + cfg.reflection_bias * hit.hit_n)[:, None, :]
        gi_org = gi_org.expand(gi_dir.shape)

    hit_live = hit.mask & (weight > 0.0)
    if cfg.bounce_mode == "roulette":
        # One child per ray, chosen with probability proportional to its
        # branch weight, so the weight carries over unchanged; a diffuse
        # ray picks one GI ray uniformly with the same coin.
        if rnd_coin is None:
            raise ValueError("roulette shading needs rnd_coin")
        c_o = hit.position
        c_d = torch.zeros((n, 3), dtype=dtype, device=weight.device)
        c_d[:, 2] = -1.0
        c_w = torch.zeros_like(weight)
        c_bg = torch.zeros_like(hit.mask)

        def pick(sel, o_s, d_s, w_s, bg_s: bool):
            nonlocal c_o, c_d, c_w, c_bg
            c_o = torch.where(sel[:, None], o_s, c_o)
            c_d = torch.where(sel[:, None], d_s, c_d)
            c_w = torch.where(sel, w_s, c_w)
            if bg_s:
                c_bg = c_bg | sel

        pick(hit_live & is_reflective, refl_org, refl_dir, weight, True)
        take_reflect = tir | (rnd_coin < fresnel)
        pick(hit_live & is_refractive & take_reflect, r_refl_org, r_refl_dir,
             weight, False)
        pick(hit_live & is_refractive & ~take_reflect, refr_org, refr_dir,
             weight, False)
        if gi_count > 0:
            j = (rnd_coin * gi_count).long().clamp(0, gi_count - 1)
            rows = torch.arange(n, device=weight.device)
            pick(hit_live & is_diffuse, gi_org[rows, j], gi_dir[rows, j],
                 weight * gi_count / (gi_count + 1), False)
        return contrib, (c_o, c_d, c_w, c_bg)

    # ---- K child slots (full deterministic split) ------------------------
    child_o = torch.zeros((n, k, 3), dtype=dtype, device=weight.device)
    child_d = torch.zeros((n, k, 3), dtype=dtype, device=weight.device)
    child_d[..., 2] = -1.0
    child_w = torch.zeros((n, k), dtype=dtype, device=weight.device)
    child_bg = torch.zeros((n, k), dtype=torch.bool, device=weight.device)

    def put(slot, sel, o_s, d_s, w_s, bg_s: bool):
        child_o[:, slot] = torch.where(sel[:, None], o_s, child_o[:, slot])
        child_d[:, slot] = torch.where(sel[:, None], d_s, child_d[:, slot])
        child_w[:, slot] = torch.where(sel, w_s, child_w[:, slot])
        if bg_s:
            child_bg[:, slot] = child_bg[:, slot] | sel

    # slot 0: mirror reflection, the refractive reflection ray or the first
    # GI ray; slot 1: the refraction ray, skipped under total internal
    # reflection; GI ray s in slot s.  For gi = 1 slot 1 of a diffuse ray
    # stays empty (K = max(2, gi)).
    put(0, hit_live & is_reflective, refl_org, refl_dir, weight, True)
    put(0, hit_live & is_refractive, r_refl_org, r_refl_dir,
        torch.where(tir, weight, weight * fresnel), False)
    put(1, hit_live & is_refractive & ~tir, refr_org, refr_dir,
        weight * (1.0 - fresnel), False)
    if gi_count > 0:
        gi_w = weight / (gi_count + 1)
        for s in range(gi_count):
            put(s, hit_live & is_diffuse, gi_org[:, s], gi_dir[:, s], gi_w,
                False)
    return contrib, (child_o.reshape(n * k, 3), child_d.reshape(n * k, 3),
                     child_w.reshape(n * k), child_bg.reshape(n * k))
