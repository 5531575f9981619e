"""Wavefront shading: the reference's recursive Whitted+GI shader
(render/render.hpp:133-308) as one branchless bounce step.

Every material's output is `direct + sum_i w_i * color(child_i)`, so each
ray carries a throughput `weight` and a `miss_is_bg` flag; a hit emits its
direct term at once and spawns up to K children with scaled weights.
Counterpart of `simd_raytracer_tpu.ops.shade`.

`shade` takes one of two paths with the same results.  On CUDA tensors,
which must be float32, it is `shade_fused`: the shading math in three
launches of `csrc/shade.cu` around the occlusion query, bit for bit the
torch ops of the plain version (a frame's shade call otherwise enqueues
some 300 small kernels).  Where a gradient is wanted (training) the last
launch runs as an autograd node whose backward is `csrc/shade_grad.cu`:
two launches from the call's own rows, visibility and factor, and the
deterministic segmented sum of `ops/gather.py::row_sums` for the texture
and light tables (the plain version's gradients up to rounding).  On CPU
tensors it is `shade_reference`, those torch ops.  While tracing, counters
`shade.fused.calls`, `shade.fused.rows`, `shade.fused.grad_calls` and
`shade.plain.calls` say which path ran, `shade.launches` counts the
forward kernels' launches, and `shade.backward.calls`,
`shade.backward.rows` and `shade.backward.launches` the backward's.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from .. import kernels
from ..config import RenderConfig
from ..kernels import data_ptr
from ..models.scene import (MAT_CONSTANT, MAT_DIFFUSE, MAT_REFLECTIVE,
                            MAT_REFRACTIVE, MAT_TEXTURE, Geometry, Scene,
                            cross3, dot3, safe_normalize)
from ..models.textures import sample_texture
from ..utils import profiling
from ..utils.profiling import span, spanned
from .gather import row_sums
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


def need_rows(hit: HitRecord, weight: torch.Tensor) -> torch.Tensor:
    """The rows that need direct light, live diffuse and textured hits
    (render.hpp:184-206), gathered exactly with nonzero."""
    tag = hit.mat_tag
    lit = (tag == MAT_DIFFUSE) | (tag == MAT_TEXTURE)
    with span("wait"):
        return (lit & hit.mask & (weight > 0.0)).nonzero()[:, 0]


def direct_light_factor(scene: Scene, geom: Geometry, hit: HitRecord,
                        cfg: RenderConfig, accel=None,
                        occ: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum over lights of visibility * intensity / (4 pi r^2) * cos_law
    (render.hpp:184-206): (N,) factor for the caller's albedo or texel.
    `occ`, light-major (L * N,), is the visibility of an earlier query of
    the same shadow rays; without it the rays are queried here."""
    n_rays = hit.position.shape[0]
    nl = scene.light_pos.shape[0]

    ldir_un = scene.light_pos[None, :, :] - hit.position[:, None, :]  # N,L,3
    r = torch.sqrt(dot3(ldir_un, ldir_un).clamp_min(1e-24))
    ldir = ldir_un / r[..., None]
    area = FOUR_PI * r * r

    shade_n = torch.where(hit.smooth[:, None], hit.hit_n, hit.face_n)
    cos_law = dot3(ldir, shade_n[:, None, :]).clamp_min(0.0)          # N,L

    if occ is None:
        shadow_o = hit.position[:, None, :] + cfg.shadow_bias * ldir
        # A pair facing away from its light contributes nothing whatever
        # the visibility, so its shadow query gets a zero-length window.
        max_t = torch.where(cos_law > 0.0, r, 0.0)
        # Light-major batching: consecutive shadow rays share one light,
        # which keeps a sweep ray tile's direction box tight.
        occ = occluded(shadow_o.transpose(0, 1).reshape(-1, 3),
                       ldir.transpose(0, 1).reshape(-1, 3),
                       max_t.T.reshape(-1), scene, geom, cfg, accel)
    occ = occ.reshape(nl, n_rays).T

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
    weight (N*K,), miss_bg (N*K,))).

    `shade_fused` on CUDA tensors, `shade_reference` on CPU tensors: the
    same values either way."""
    args = (scene, geom, hit, d_in, weight, cfg, accel, rnd_coin, rnd_gi)
    if fused_applies(weight):
        if profiling.tracing():
            profiling.count("shade.fused.calls")
            profiling.count("shade.fused.rows", weight.shape[0])
        return shade_fused(*args)
    if profiling.tracing():
        profiling.count("shade.plain.calls")
    return shade_reference(*args)


def fused_applies(weight: torch.Tensor) -> bool:
    """Whether `shade` runs the kernels: on CUDA tensors, which the
    kernels take in float32 only (another dtype there is refused)."""
    if not weight.is_cuda:
        return False
    if weight.dtype != torch.float32:
        raise ValueError(f"shade: CUDA tensors must be float32 (the dtype "
                         f"of csrc/shade.cu), got {weight.dtype}")
    return True


# The inputs of a shade call that autograd may differentiate: the hit
# record's fields, then d_in, weight, rnd_coin and rnd_gi, then the scene's
# tables (`_grad_inputs`).
_GRAD_HIT = ("position", "hit_n", "face_n", "u", "v", "w", "uvs", "albedo",
             "ior")
_GRAD_SCENE = ("tex_color_a", "tex_color_b", "tex_param", "atlas",
               "light_pos", "light_intensity")


def _grad_inputs(scene: Scene, hit: HitRecord, d_in: torch.Tensor,
                 weight: torch.Tensor, rnd_coin: Optional[torch.Tensor],
                 rnd_gi: Optional[torch.Tensor]) -> list:
    return ([getattr(hit, k) for k in _GRAD_HIT]
            + [d_in, weight, rnd_coin, rnd_gi]
            + [getattr(scene, k) for k in _GRAD_SCENE])


def wants_grad(scene: Scene, hit: HitRecord, d_in: torch.Tensor,
               weight: torch.Tensor, rnd_coin: Optional[torch.Tensor],
               rnd_gi: Optional[torch.Tensor]) -> bool:
    """Whether a shade call must be differentiable: grad mode on, and some
    input of the call (`_grad_inputs`) requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad
        for t in _grad_inputs(scene, hit, d_in, weight, rnd_coin, rnd_gi))


def shade_reference(scene: Scene, geom: Geometry, hit: HitRecord,
                    d_in: torch.Tensor, weight: torch.Tensor,
                    cfg: RenderConfig, accel=None,
                    rnd_coin: Optional[torch.Tensor] = None,
                    rnd_gi: Optional[torch.Tensor] = None,
                    lights: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    ) -> Tuple[torch.Tensor, Tuple]:
    """`shade` as torch ops: the plain version of `shade_fused`, which
    autograd differentiates on the CPU.  `lights` (need, occ) are
    `need_rows` and the light-major visibility of their shadow rays from
    an earlier query; without it both are computed here."""
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

    # ---- direct light: shadow queries only for the rows that need light
    # (render.hpp:184-206) -----------------------------------------------
    need, occ = (need_rows(hit, weight), None) if lights is None else lights
    factor = torch.zeros_like(weight)
    if need.numel():
        sub = hit.map(lambda a: a[need])
        factor = factor.index_put((need,), direct_light_factor(
            scene, geom, sub, cfg, accel, occ))
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


# The pointer fields of BounceArgs (csrc/shade.cuh), in its order.
_BOUNCE_POINTERS = (
    "mask", "tag", "weight", "d_in", "position", "hit_n", "face_n", "smooth",
    "ior", "albedo", "tex", "u", "v", "w", "uvs", "factor", "rnd_coin",
    "rnd_gi", "tex_tag", "tex_color_a", "tex_color_b", "tex_param",
    "tex_offset", "tex_width", "tex_height", "atlas", "contrib", "child_o",
    "child_d", "child_w", "child_bg")


class BounceArgs(ctypes.Structure):
    """csrc/shade.cuh's BounceArgs, field for field."""
    _fields_ = ([(name, ctypes.c_void_p) for name in _BOUNCE_POINTERS]
                + [("n", ctypes.c_int64), ("atlas_rows", ctypes.c_int64),
                   ("gi", ctypes.c_int), ("k", ctypes.c_int),
                   ("roulette", ctypes.c_int)]
                + [(name, ctypes.c_float) for name in (
                    "direct_scale", "gi_count", "gi_inv", "pi", "two_pi",
                    "reflection_bias", "refraction_bias")])


# The row gradients csrc/shade_grad.cu writes, in BounceGradArgs's order:
# the hit record's fields of _GRAD_HIT that have one, then d_in and weight.
_ROW_GRADS = ("position", "hit_n", "face_n", "albedo", "d_in", "ior",
              "weight")


class BounceGradArgs(ctypes.Structure):
    """csrc/shade_grad.cu's BounceGradArgs, field for field."""
    _fields_ = ([("f", BounceArgs)]
                + [(f"g_{name}", ctypes.c_void_p) for name in (
                    "contrib", "child_o", "child_d", "child_w", *_ROW_GRADS,
                    "factor", "rnd_gi")]
                + [("tex_key", ctypes.c_void_p), ("tex_grad", ctypes.c_void_p),
                   ("n_tex", ctypes.c_int64)])


class _Call(NamedTuple):
    """One fused shade call after its occlusion query: `shade`'s arguments,
    the rows that need light, their light-major visibility and the summed
    light factor of every row (None where no row needs light)."""
    scene: Scene
    geom: Geometry
    hit: HitRecord
    d_in: torch.Tensor
    weight: torch.Tensor
    cfg: RenderConfig
    accel: object
    rnd_coin: Optional[torch.Tensor]
    rnd_gi: Optional[torch.Tensor]
    need: torch.Tensor
    occ: Optional[torch.Tensor]
    factor: Optional[torch.Tensor]


def shade_fused(scene: Scene, geom: Geometry, hit: HitRecord,
                d_in: torch.Tensor, weight: torch.Tensor, cfg: RenderConfig,
                accel=None, rnd_coin: Optional[torch.Tensor] = None,
                rnd_gi: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, Tuple]:
    """`shade` through csrc/shade.cu, float32 CUDA tensors: `need_rows` as
    in the plain version, then `_shadow` (shade_lights, `occluded` as it
    is, shade_factor: the lights' sum into each needed row) and `_bounce`
    (shade_bounce: textures, contributions, children).  Equal to
    `shade_reference` bit for bit.  Where `wants_grad`, `_bounce` runs as
    the autograd node `_BounceGrad`."""
    gi = cfg.diffuse_reflection_ray_count
    if gi > 0 and rnd_gi is None:
        raise ValueError("diffuse GI shading needs rnd_gi")
    if cfg.bounce_mode == "roulette" and rnd_coin is None:
        raise ValueError("roulette shading needs rnd_coin")
    need = need_rows(hit, weight)
    occ, factor = _shadow(scene, geom, hit, cfg, accel, need)
    call = _Call(scene, geom, hit, d_in, weight, cfg, accel, rnd_coin,
                 rnd_gi, need, occ, factor)
    if wants_grad(scene, hit, d_in, weight, rnd_coin, rnd_gi):
        profiling.count("shade.fused.grad_calls")
        contrib, *children = _BounceGrad.apply(call, *_grad_inputs(
            scene, hit, d_in, weight, rnd_coin, rnd_gi))
        return contrib, tuple(children)
    return _bounce(call)


def _shadow(scene: Scene, geom: Geometry, hit: HitRecord,
            cfg: RenderConfig, accel, need: torch.Tensor):
    """shade_lights over the rows `need`, `occluded` on its shadow rays,
    then shade_factor: (occ, factor), the visibility light-major (L * M,)
    and the lights' sum into each row (N,), or (None, None) where no row
    needs light."""
    m = need.numel()
    if not m:
        return None, None
    n = hit.position.shape[0]
    dev = hit.position.device
    f32 = torch.float32
    row3 = (n, 3)
    nl = scene.light_pos.shape[0]
    pairs = nl * m
    shadow_o = torch.empty((pairs, 3), dtype=f32, device=dev)
    shadow_d = torch.empty((pairs, 3), dtype=f32, device=dev)
    max_t = torch.empty(pairs, dtype=f32, device=dev)
    term = torch.empty(pairs, dtype=f32, device=dev)
    lib = kernels.library()
    kernels.check(lib.srt_shade_lights(
        need.data_ptr(), m, nl, data_ptr(hit.position, f32, row3, dev),
        data_ptr(hit.hit_n, f32, row3, dev),
        data_ptr(hit.face_n, f32, row3, dev),
        data_ptr(hit.smooth, torch.bool, (n,), dev),
        data_ptr(scene.light_pos, f32, (nl, 3), dev),
        data_ptr(scene.light_intensity, f32, (nl,), dev),
        np.float32(cfg.shadow_bias), np.float32(FOUR_PI),
        shadow_o.data_ptr(), shadow_d.data_ptr(), max_t.data_ptr(),
        term.data_ptr(), kernels.stream(dev)), "shade_lights")
    profiling.count("shade.launches")
    occ = occluded(shadow_o, shadow_d, max_t, scene, geom, cfg, accel)
    factor = torch.zeros(n, dtype=f32, device=dev)
    kernels.check(lib.srt_shade_factor(
        need.data_ptr(), m, nl, data_ptr(occ, torch.bool, (pairs,), dev),
        term.data_ptr(), factor.data_ptr(), kernels.stream(dev)),
        "shade_factor")
    profiling.count("shade.launches")
    return occ, factor


class _BounceGrad(torch.autograd.Function):
    """`_bounce` as an autograd node over `_grad_inputs`.  The forward is
    the kernel; the backward is `_bounce_grad` (csrc/shade_grad.cu), which
    takes the call's own `need`, `occ` and factor, so no shadow ray is
    traced again and no torch op of the shading is recomputed."""

    @staticmethod
    def forward(ctx, call: _Call, *inputs):
        ctx.call = call
        # Saved only for autograd's check that no input was changed in
        # place before the backward, which reads them through `call`.
        ctx.save_for_backward(*inputs)
        ctx.set_materialize_grads(False)
        contrib, children = _bounce(call)
        ctx.mark_non_differentiable(children[3])
        return (contrib, *children)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        ctx.saved_tensors
        return (None, *_bounce_grad(ctx.call, grads[:4],
                                    ctx.needs_input_grad[1:]))


def _bounce_args(call: _Call, **outputs) -> BounceArgs:
    """The BounceArgs of `call` (its rows, uniforms and texture tables,
    checked) with the output pointers given, null where not given."""
    scene, hit, d_in, weight, cfg = (call.scene, call.hit, call.d_in,
                                     call.weight, call.cfg)
    n = weight.shape[0]
    k = cfg.child_slots
    gi = cfg.diffuse_reflection_ray_count
    roulette = cfg.bounce_mode == "roulette"
    dev = weight.device
    f32, i32 = torch.float32, torch.int32
    row3 = (n, 3)
    x = scene.tex_tag.shape[0]
    return BounceArgs(
        mask=data_ptr(hit.mask, torch.bool, (n,), dev),
        tag=data_ptr(hit.mat_tag, i32, (n,), dev),
        weight=data_ptr(weight, f32, (n,), dev),
        d_in=data_ptr(d_in, f32, row3, dev),
        position=data_ptr(hit.position, f32, row3, dev),
        hit_n=data_ptr(hit.hit_n, f32, row3, dev),
        face_n=data_ptr(hit.face_n, f32, row3, dev),
        smooth=data_ptr(hit.smooth, torch.bool, (n,), dev),
        ior=data_ptr(hit.ior, f32, (n,), dev),
        albedo=data_ptr(hit.albedo, f32, row3, dev),
        tex=data_ptr(hit.tex, i32, (n,), dev),
        u=data_ptr(hit.u, f32, (n,), dev), v=data_ptr(hit.v, f32, (n,), dev),
        w=data_ptr(hit.w, f32, (n,), dev),
        uvs=data_ptr(hit.uvs, f32, (n, 3, 2), dev),
        factor=(None if call.factor is None
                else data_ptr(call.factor, f32, (n,), dev)),
        rnd_coin=(data_ptr(call.rnd_coin, f32, (n,), dev) if roulette
                  else None),
        rnd_gi=(data_ptr(call.rnd_gi, f32, (n, gi, 2), dev) if gi > 0
                else None),
        tex_tag=data_ptr(scene.tex_tag, i32, (x,), dev),
        tex_color_a=data_ptr(scene.tex_color_a, f32, (x, 3), dev),
        tex_color_b=data_ptr(scene.tex_color_b, f32, (x, 3), dev),
        tex_param=data_ptr(scene.tex_param, f32, (x,), dev),
        tex_offset=data_ptr(scene.tex_offset, i32, (x,), dev),
        tex_width=data_ptr(scene.tex_width, i32, (x,), dev),
        tex_height=data_ptr(scene.tex_height, i32, (x,), dev),
        atlas=data_ptr(scene.atlas, f32, (scene.atlas.shape[0], 3), dev),
        n=n, atlas_rows=scene.atlas.shape[0], gi=gi, k=k,
        roulette=int(roulette),
        # Python scalars as torch rounds them: a double to float; a
        # division by (gi + 1) on the card multiplies by the float
        # reciprocal.
        direct_scale=np.float32(1.0 / (gi + 1)), gi_count=np.float32(gi),
        gi_inv=np.float32(1.0) / np.float32(gi + 1),
        pi=np.float32(math.pi), two_pi=np.float32(2.0 * math.pi),
        reflection_bias=np.float32(cfg.reflection_bias),
        refraction_bias=np.float32(cfg.refraction_bias),
        **{name: t.data_ptr() for name, t in outputs.items()})


def _bounce(call: _Call) -> Tuple[torch.Tensor, Tuple]:
    """shade_bounce, where there is a row: contrib (N, 3) and the
    children, as `shade` returns them."""
    n = call.weight.shape[0]
    k = call.cfg.child_slots
    dev = call.weight.device
    f32 = torch.float32
    out = dict(contrib=torch.empty((n, 3), dtype=f32, device=dev),
               child_o=torch.empty((n * k, 3), dtype=f32, device=dev),
               child_d=torch.empty((n * k, 3), dtype=f32, device=dev),
               child_w=torch.empty(n * k, dtype=f32, device=dev),
               child_bg=torch.empty(n * k, dtype=torch.bool, device=dev))
    if n:
        args = _bounce_args(call, **out)
        kernels.check(kernels.library().srt_shade_bounce(
            ctypes.byref(args), kernels.stream(dev)), "shade_bounce")
        profiling.count("shade.launches")
    return out["contrib"], (out["child_o"], out["child_d"], out["child_w"],
                            out["child_bg"])


def _bounce_grad(call: _Call, grads, wanted) -> list:
    """The backward of `_bounce` through csrc/shade_grad.cu: from the
    gradients of contrib and the children's origins, directions and
    weights (None where none came) to those of `_grad_inputs`, None where
    `wanted` is False or the input does not reach the outputs.

    shade_bounce_grad writes every row's gradients, its factor's and its
    texture table row's; shade_lights_grad, where a row needs light, adds
    the lights' part to the needed rows and writes each (light, row)
    pair's light gradients; `row_sums` adds the texture and light tables'
    gradients by row in a fixed order."""
    scene, hit, weight, cfg = call.scene, call.hit, call.weight, call.cfg
    n = weight.shape[0]
    profiling.count("shade.backward.calls")
    profiling.count("shade.backward.rows", n)
    names = (*_GRAD_HIT, "d_in", "weight", "rnd_coin", "rnd_gi",
             *_GRAD_SCENE)
    want = dict(zip(names, wanted))
    if n == 0 or all(g is None for g in grads):
        return [None] * len(names)
    k = cfg.child_slots
    gi = cfg.diffuse_reflection_ray_count
    dev = weight.device
    f32 = torch.float32
    row3 = (n, 3)
    # What the kernels read and write, by BounceGradArgs's field names.
    bufs = {}
    for name, g, shape in zip(("contrib", "child_o", "child_d", "child_w"),
                              grads, (row3, (n * k, 3), (n * k, 3),
                                      (n * k,))):
        if g is not None:
            bufs[f"g_{name}"] = g = g.contiguous()
            data_ptr(g, f32, shape, dev)
    for name in _ROW_GRADS:
        bufs[f"g_{name}"] = torch.empty(
            (n,) if name in ("ior", "weight") else row3, dtype=f32,
            device=dev)
    if gi > 0 and want["rnd_gi"]:
        bufs["g_rnd_gi"] = torch.empty((n, gi, 2), dtype=f32, device=dev)
    m = call.need.numel()
    if m:
        bufs["g_factor"] = torch.empty(n, dtype=f32, device=dev)
    n_tex, texels = scene.tex_tag.shape[0], scene.atlas.shape[0]
    if want["tex_color_a"] or want["tex_color_b"] or want["atlas"]:
        bufs["tex_key"] = torch.empty(n, dtype=torch.int64, device=dev)
        bufs["tex_grad"] = torch.empty(row3, dtype=f32, device=dev)
    args = BounceGradArgs(f=_bounce_args(call), n_tex=n_tex,
                          **{key: t.data_ptr() for key, t in bufs.items()})
    lib = kernels.library()
    kernels.check(lib.srt_shade_bounce_grad(ctypes.byref(args),
                                            kernels.stream(dev)),
                  "shade_bounce_grad")
    profiling.count("shade.backward.launches")
    result = {name: bufs[f"g_{name}"] for name in _ROW_GRADS}
    result["rnd_gi"] = bufs.get("g_rnd_gi")

    if m:
        nl = scene.light_pos.shape[0]
        if want["light_pos"] or want["light_intensity"]:
            bufs["light_key"] = torch.empty(nl * m, dtype=torch.int64,
                                            device=dev)
            bufs["light_grad"] = torch.empty((nl * m, 4), dtype=f32,
                                             device=dev)
        kernels.check(lib.srt_shade_lights_grad(
            call.need.data_ptr(), m, nl,
            data_ptr(hit.position, f32, row3, dev),
            data_ptr(hit.hit_n, f32, row3, dev),
            data_ptr(hit.face_n, f32, row3, dev),
            data_ptr(hit.smooth, torch.bool, (n,), dev),
            data_ptr(scene.light_pos, f32, (nl, 3), dev),
            data_ptr(scene.light_intensity, f32, (nl,), dev),
            data_ptr(call.occ, torch.bool, (nl * m,), dev),
            bufs["g_factor"].data_ptr(), np.float32(FOUR_PI),
            *(bufs[key].data_ptr() for key in ("g_position", "g_hit_n",
                                               "g_face_n")),
            *(bufs[key].data_ptr() if key in bufs else None
              for key in ("light_key", "light_grad")),
            kernels.stream(dev)), "shade_lights_grad")
        profiling.count("shade.backward.launches")
        if "light_key" in bufs:
            sums = row_sums(bufs["light_key"], bufs["light_grad"], nl,
                            launches="shade.backward.launches")
            result["light_pos"] = sums[:, :3]
            result["light_intensity"] = sums[:, 3]
    if "tex_key" in bufs:
        sums = row_sums(bufs["tex_key"], bufs["tex_grad"],
                        2 * n_tex + texels + 1,
                        launches="shade.backward.launches")
        result["tex_color_a"] = sums[:n_tex]
        result["tex_color_b"] = sums[n_tex:2 * n_tex]
        result["atlas"] = sums[2 * n_tex:2 * n_tex + texels]
    return [result.get(name) if want[name] else None for name in names]
