"""The plain reference: a straightforward path tracer in plain PyTorch.

It reads the same `.crtscene` document the program is handed and renders
the reference renderer's semantics (simd-raytracer's render.hpp:
`color_hit`, `is_occluded`, the texture samplers, the smooth normals of
mesh.hpp) with brute-force Moller-Trumbore over every triangle.  It
imports nothing of the program and takes nothing the program made: the
geometry, the ray order, the slots of the split wavefront and the
accelerator's answers are all worked out here again.  Only the uniforms
are shared, through `uniforms.Source`, which the benchmark owns.

Everything is computed in `dtype` (float32 as the configurations state;
the control of `perfbench/controls.py` asks for bfloat16).  Gradients flow
as in any differentiable render: the choice of the winning triangle is
discrete and made without gradients, the winner's t, u, v are recomputed
from its vertices with gradients.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

DIFFUSE, REFLECTIVE, REFRACTIVE, CONSTANT, TEXTURED = range(5)
T_ALBEDO, T_EDGES, T_CHECKER = range(3)
PAIRS = 1 << 24          # (rays x triangles) elements per select block


def _f(x, device, dtype):
    return torch.as_tensor(np.asarray(x, np.float32), device=device).to(dtype)


def _i(x, device):
    return torch.as_tensor(np.asarray(x, np.int64), device=device)


class RefScene:
    """A `.crtscene` document as tensors on `device` in `dtype`:
    `params` holds the leaves a gradient can reach, the rest is fixed."""

    def __init__(self, doc: dict, device, dtype=torch.float32):
        self.device, self.dtype = torch.device(device), dtype
        st = doc["settings"]
        img = st["image_settings"]
        self.height, self.width = int(img["height"]), int(img["width"])
        self.bucket = int(img.get("bucket_size", 64))
        tex_index, tags, col_a, col_b, tparam = {}, [], [], [], []
        for t in doc.get("textures", []):
            kind = t["type"]
            tex_index[t["name"]] = len(tags)
            if kind == "albedo":
                tags.append(T_ALBEDO)
                col_a.append(t["albedo"])
                col_b.append([0, 0, 0])
                tparam.append(1.0)
            elif kind == "edges":
                tags.append(T_EDGES)
                col_a.append(t["edge_color"])
                col_b.append(t["inner_color"])
                tparam.append(t["edge_width"])
            elif kind == "checker":
                tags.append(T_CHECKER)
                col_a.append(t["color_A"])
                col_b.append(t["color_B"])
                tparam.append(t["square_size"])
            else:
                raise ValueError(f"the reference reads no {kind!r} texture")
        if not tags:
            tags, col_a, col_b, tparam = [T_ALBEDO], [[0] * 3], [[0] * 3], [1]
        kinds, albedo, ior, smooth, mtex = [], [], [], [], []
        for m in doc["materials"]:
            a, k, tex = m.get("albedo", [0, 0, 0]), m["type"], 0
            if k == "diffuse" and isinstance(a, str):
                kinds.append(TEXTURED)
                tex, a = tex_index[a], [0, 0, 0]
            else:
                kinds.append({"diffuse": DIFFUSE, "reflective": REFLECTIVE,
                              "refractive": REFRACTIVE,
                              "constant": CONSTANT}[k])
            albedo.append(a)
            ior.append(m.get("ior", 1.0))
            smooth.append(bool(m["smooth_shading"]))
            mtex.append(tex)
        verts, tris, uvs, tmat = [], [], [], []
        base = 0
        for ob in doc["objects"]:
            v = np.asarray(ob["vertices"], np.float32).reshape(-1, 3)
            t = np.asarray(ob["triangles"], np.int64).reshape(-1, 3)
            if "uvs" in ob:
                uv = np.asarray(ob["uvs"], np.float32).reshape(-1, 3)[:, :2]
                uvs.append(uv[t])
            else:
                uvs.append(np.zeros((len(t), 3, 2), np.float32))
            verts.append(v)
            tris.append(t + base)
            tmat.append(np.full(len(t), ob["material_index"], np.int64))
            base += len(v)
        lights = doc["lights"]
        cam = doc["camera"]
        dev = self.device
        self.tri_vidx = _i(np.concatenate(tris), dev)
        self.tri_mat = _i(np.concatenate(tmat), dev)
        self.mat_kind = _i(kinds, dev)
        self.mat_smooth = torch.as_tensor(smooth, device=dev)
        self.mat_tex = _i(mtex, dev)
        self.tex_tag = _i(tags, dev)
        self.cam_pos = _f(cam["position"], dev, dtype)
        self.cam_mat = _f(cam["matrix"], dev, dtype).reshape(3, 3)
        self.params = {
            "vertices": _f(np.concatenate(verts), dev, dtype),
            "uv": _f(np.concatenate(uvs), dev, dtype),
            "mat_albedo": _f(albedo, dev, dtype),
            "mat_ior": _f(ior, dev, dtype),
            "tex_color_a": _f(col_a, dev, dtype),
            "tex_color_b": _f(col_b, dev, dtype),
            "tex_param": _f(tparam, dev, dtype),
            "atlas": torch.zeros((1, 3), device=dev, dtype=dtype),
            "light_pos": _f([l["position"] for l in lights], dev, dtype),
            "light_intensity": _f([l["intensity"] for l in lights], dev,
                                  dtype),
            "background": _f(st["background_color"], dev, dtype),
        }
        self.transmissive = self.mat_kind[self.tri_mat] == REFRACTIVE


def _dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _unit(v):
    # The clamp keeps a zero vector's gradient finite.
    return v / torch.sqrt(_dot(v, v).clamp_min(1e-18))[..., None]


class Geometry:
    """Triangle edges, face normals and smooth vertex normals (the
    normalised sum of the unit face normals around a vertex)."""

    def __init__(self, scene: RefScene, params: Dict[str, torch.Tensor]):
        v = params["vertices"]
        idx = scene.tri_vidx
        p = [v[idx[:, k]] for k in range(3)]
        self.v0, self.e1, self.e2 = p[0], p[1] - p[0], p[2] - p[0]
        self.face_n = _unit(_cross(self.e1, self.e2))
        acc = torch.zeros_like(v)
        for k in range(3):
            acc = acc.index_add(0, idx[:, k], self.face_n)
        self.vn = _unit(acc)[idx]
        self.uv = params["uv"]


def _pairs(o, d, v0, e1, e2, eps, cull):
    """Moller-Trumbore of rays (R, 1) against triangles (1, B) -> t, ok."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    ax, ay, az = v0[None, :, 0], v0[None, :, 1], v0[None, :, 2]
    bx, by, bz = e1[None, :, 0], e1[None, :, 1], e1[None, :, 2]
    cx, cy, cz = e2[None, :, 0], e2[None, :, 1], e2[None, :, 2]
    px, py, pz = dy * cz - dz * cy, dz * cx - dx * cz, dx * cy - dy * cx
    det = bx * px + by * py + bz * pz
    ok = det > eps if cull else det.abs() > eps
    inv = 1.0 / det
    tx, ty, tz = ox - ax, oy - ay, oz - az
    u = (tx * px + ty * py + tz * pz) * inv
    qx, qy, qz = ty * bz - tz * by, tz * bx - tx * bz, tx * by - ty * bx
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (cx * qx + cy * qy + cz * qz) * inv
    ok = ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > eps)
    return t, ok


def _blocks(n_rays, n_tris):
    tb = min(n_tris, 16384)
    rb = max(1, min(n_rays, PAIRS // max(tb, 1)))
    return rb, tb


@torch.no_grad()
def closest(geom: Geometry, o, d, eps, cull, tri_mask):
    """Closest accepted triangle of each ray, ties to the lowest index ->
    (index, hit)."""
    o, d = o.detach(), d.detach()
    v0, e1, e2 = geom.v0.detach(), geom.e1.detach(), geom.e2.detach()
    n, nt = o.shape[0], v0.shape[0]
    best_t = torch.full((n,), math.inf, device=o.device, dtype=o.dtype)
    best_i = torch.zeros(n, dtype=torch.long, device=o.device)
    rb, tb = _blocks(n, nt)
    for r in range(0, n, rb):
        bt, bi = best_t[r:r + rb], best_i[r:r + rb]
        for s in range(0, nt, tb):
            t, ok = _pairs(o[r:r + rb], d[r:r + rb], v0[s:s + tb],
                           e1[s:s + tb], e2[s:s + tb], eps, cull)
            ok = ok & tri_mask[None, s:s + tb]
            t = torch.where(ok, t, math.inf)
            j = t.argmin(1)
            tj = t.gather(1, j[:, None])[:, 0]
            better = tj < bt
            bt = torch.where(better, tj, bt)
            bi = torch.where(better, j + s, bi)
        best_t[r:r + rb], best_i[r:r + rb] = bt, bi
    return best_i, torch.isfinite(best_t)


@torch.no_grad()
def any_within(geom: Geometry, o, d, eps, tri_mask, t_max):
    """Whether any accepted triangle lies at t <= t_max (no culling)."""
    o, d = o.detach(), d.detach()
    v0, e1, e2 = geom.v0.detach(), geom.e1.detach(), geom.e2.detach()
    n, nt = o.shape[0], v0.shape[0]
    out = torch.zeros(n, dtype=torch.bool, device=o.device)
    rb, tb = _blocks(n, nt)
    for r in range(0, n, rb):
        hit = out[r:r + rb]
        for s in range(0, nt, tb):
            t, ok = _pairs(o[r:r + rb], d[r:r + rb], v0[s:s + tb],
                           e1[s:s + tb], e2[s:s + tb], eps, False)
            hit = hit | (ok & tri_mask[None, s:s + tb]
                         & (t <= t_max[r:r + rb, None])).any(1)
        out[r:r + rb] = hit
    return out


def refine(geom: Geometry, idx, o, d, eps):
    """The winner's t, u, v, with gradients (no accept tests; the
    determinant held away from 0 so a record stays finite)."""
    v0, e1, e2 = geom.v0[idx], geom.e1[idx], geom.e2[idx]
    p = _cross(d, e2)
    det = _dot(e1, p)
    det = torch.where(det.abs() > eps, det, torch.full_like(det, eps))
    tv = o - v0
    q = _cross(tv, e1)
    return _dot(e2, q) / det, _dot(tv, p) / det, _dot(d, q) / det


class Settings:
    """The render settings the reference reads (the field names of the
    program's configuration, with its defaults)."""

    def __init__(self, **kw):
        self.fov_degrees = kw.get("fov_degrees", 90.0)
        self.epsilon = kw.get("epsilon", 1e-6)
        self.shadow_bias = kw.get("shadow_bias", 1e-4)
        self.reflection_bias = kw.get("reflection_bias", 1e-4)
        self.refraction_bias = kw.get("refraction_bias", 1e-4)
        self.spp = kw.get("samples_per_pixel", 1)
        self.max_depth = kw.get("max_ray_depth", 5)
        self.gi = kw.get("diffuse_reflection_ray_count", 0)
        self.chunk = kw.get("chunk_size", 16384)
        self.occlusion = kw.get("occlusion_mode", "fast")
        self.max_march = kw.get("max_shadow_march", 8)
        self.intersector = kw.get("intersector", "jnp")
        self.bounce = kw.get("bounce_mode", "split")
        self.ray_order = kw.get("ray_order", "auto")
        self.slots = 1 if self.bounce == "roulette" else max(2, self.gi)


def ray_order(scene: RefScene, s: Settings, scheduling: Optional[str]):
    """Every (pixel, sample) ray id of the frame in the order the frame's
    chunks take them, padded with the invalid id H*W*spp: bucket tiles
    row-major ("bucket_tiles"), whole 32x32 screen blocks ("tiled", the
    sweep's default), or ids ascending."""
    h, w, spp = scene.height, scene.width, s.spp
    total = h * w * spp
    if scheduling == "bucket_tiles":
        b = max(1, scene.bucket)
        parts = []
        for y in range(0, h, b):
            for x in range(0, w, b):
                ys = np.arange(y, min(y + b, h))
                xs = np.arange(x, min(x + b, w))
                parts.append((ys[:, None] * w + xs[None, :]).reshape(-1))
        pix = np.concatenate(parts)
        ids = (pix[:, None] * spp + np.arange(spp)).reshape(-1)
    elif scheduling is None and (s.ray_order == "tiled" or (
            s.ray_order == "auto" and s.intersector == "sweep")):
        blk = 32
        by, bx, iy, ix = np.ogrid[0:-(-h // blk), 0:-(-w // blk), 0:blk,
                                  0:blk]
        y, x = by * blk + iy, bx * blk + ix
        inside = (y < h) & (x < w)
        ids = (y * w + x)[..., None] * spp + np.arange(spp)
        ids = np.where(inside[..., None], ids, total).reshape(-1)
    elif scheduling is None:
        ids = np.arange(total)
    else:
        raise ValueError(f"the reference knows no scheduling {scheduling!r}")
    pad = -len(ids) % s.chunk
    return np.concatenate([ids, np.full(pad, total)]).astype(np.int64)


def positions(order: np.ndarray, total: int) -> np.ndarray:
    """(total,) index of each valid ray id in `order`."""
    pos = np.empty(total, np.int64)
    keep = order < total
    pos[order[keep]] = np.nonzero(keep)[0]
    return pos


class Draws:
    """Uniform lookup for a batch of primary rays: ray r belongs to group
    groups[r] (a (unit, chunk) pair, whose source is source_of(unit,
    chunk)) at position pos[r] of a chunk of `width` primary rays."""

    def __init__(self, source_of: Callable, keys, group, pos, width: int):
        self.sources = [source_of(u, c) for u, c in keys]
        self.group, self.pos, self.width = group, pos, width

    def _take(self, fetch, group, slot):
        out = None
        for g in torch.unique(group).tolist():
            rows = (group == g).nonzero()[:, 0]
            vals = fetch(self.sources[g])[slot[rows]]
            if out is None:
                out = vals.new_zeros((group.shape[0],) + vals.shape[1:])
            out[rows] = vals
        return out

    def jitter(self):
        return self._take(lambda s: s.jitter(self.width), self.group,
                          self.pos)

    def coin(self, depth, group, slot, slots):
        n = self.width * slots ** depth
        return self._take(lambda s: s.coin(depth, n), group, slot)

    def gi(self, depth, group, slot, slots, count):
        n = self.width * slots ** depth
        return self._take(lambda s: s.gi(depth, n, count), group, slot)


def _texture(scene: RefScene, params, tex, u, v, w, uvs):
    tag = scene.tex_tag[tex]
    a, b = params["tex_color_a"][tex], params["tex_color_b"][tex]
    p = params["tex_param"][tex]
    fu = w * uvs[:, 0, 0] + u * uvs[:, 1, 0] + v * uvs[:, 2, 0]
    fv = w * uvs[:, 0, 1] + u * uvs[:, 1, 1] + v * uvs[:, 2, 1]
    edge = (u < p) | (v < p) | (w < p)
    # C++ truncation and truncated remainder (checker.hpp).
    iu = torch.trunc(fu / p).long()
    iv = torch.trunc(fv / p).long()
    even = torch.fmod(iu + iv, 2) == 0
    out = a
    out = torch.where(((tag == T_EDGES) & ~edge)[:, None], b, out)
    out = torch.where(((tag == T_CHECKER) & ~even)[:, None], b, out)
    return out


def _occluded(scene: RefScene, geom: Geometry, s: Settings, o, d, max_t):
    """is_occluded (render.hpp:110-131): "fast" asks whether any solid
    triangle lies inside the window; "march" walks the closest hits,
    passing through glass, at most max_shadow_march hops."""
    solid = ~scene.transmissive
    if s.occlusion == "fast":
        return any_within(geom, o, d, s.epsilon, solid, max_t)
    o, d, max_t = o.detach(), d.detach(), max_t.detach()
    occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    rows = torch.arange(o.shape[0], device=o.device)
    everything = torch.ones_like(scene.transmissive)
    for _ in range(max(1, s.max_march)):
        if rows.numel() == 0:
            break
        idx, hit = closest(geom, o, d[rows], s.epsilon, False, everything)
        with torch.no_grad():
            t, _, _ = refine(geom, idx, o, d[rows], s.epsilon)
        inside = hit & (t <= max_t)
        glass = inside & scene.transmissive[idx]
        occ[rows[inside & ~glass]] = True
        o = o + t[:, None] * d[rows] + s.shadow_bias * d[rows]
        max_t = max_t - t
        go = glass & (max_t > 0)
        rows, o, max_t = rows[go], o[go], max_t[go]
    return occ


def _direct(scene, params, geom, s, pos, n_shade):
    """Sum over lights of visibility * I / (4 pi r^2) * max(0, cos)."""
    total = 0.0
    for li in range(params["light_pos"].shape[0]):
        to = params["light_pos"][li][None, :] - pos
        r = torch.sqrt(_dot(to, to))
        ldir = to / r[:, None]
        cos = _dot(ldir, n_shade).clamp_min(0.0)
        occ = _occluded(scene, geom, s, pos + s.shadow_bias * ldir, ldir, r)
        term = params["light_intensity"][li] / (4.0 * math.pi * r * r) * cos
        total = total + torch.where(occ, torch.zeros_like(term), term)
    return total


def trace_rays(scene: RefScene, params, geom: Geometry, s: Settings,
               o, d, draws: Draws):
    """Colors (N, 3) of N primary rays through the reference's recursion,
    unrolled into a wavefront: each ray carries its root, weight, slot and
    whether a miss shows the background."""
    n = o.shape[0]
    dev, dt = o.device, o.dtype
    bg = params["background"]
    accum = torch.zeros((n, 3), device=dev, dtype=dt)
    root = torch.arange(n, device=dev)
    slot = draws.pos.clone()
    weight = torch.ones(n, device=dev, dtype=dt)
    show_bg = torch.ones(n, dtype=torch.bool, device=dev)
    valid = torch.ones_like(scene.transmissive)
    k = s.slots
    for depth in range(s.max_depth + 1):
        live = (weight > 0).nonzero()[:, 0]
        if live.numel() == 0:
            break
        root, slot, o, d = root[live], slot[live], o[live], d[live]
        weight, show_bg = weight[live], show_bg[live]
        group = draws.group[root]
        idx, hit = closest(geom, o, d, s.epsilon, depth == 0, valid)
        missed = (~hit & show_bg).to(dt)
        contrib = (weight * missed)[:, None] * bg
        if depth == s.max_depth:
            contrib = contrib + (weight * hit.to(dt))[:, None] * bg
            accum = accum.index_add(0, root, contrib)
            break
        h = hit.nonzero()[:, 0]
        accum = accum.index_add(0, root, contrib)
        if h.numel() == 0:
            break
        idx, o, d, w_in = idx[h], o[h], d[h], weight[h]
        root, slot, group = root[h], slot[h], group[h]
        t, u, v = refine(geom, idx, o, d, s.epsilon)
        bary_w = 1.0 - u - v
        pos = o + t[:, None] * d
        vn = geom.vn[idx]
        hit_n = _unit(u[:, None] * vn[:, 1] + v[:, None] * vn[:, 2]
                      + bary_w[:, None] * vn[:, 0])
        face_n = geom.face_n[idx]
        mat = scene.tri_mat[idx]
        kind = scene.mat_kind[mat]
        smooth = scene.mat_smooth[mat]
        albedo = params["mat_albedo"][mat]
        n_shade = torch.where(smooth[:, None], hit_n, face_n)

        lit = ((kind == DIFFUSE) | (kind == TEXTURED)).nonzero()[:, 0]
        factor = torch.zeros_like(w_in)
        if lit.numel():
            factor = factor.index_put(
                (lit,), _direct(scene, params, geom, s, pos[lit],
                                n_shade[lit]))
        tex_col = _texture(scene, params, scene.mat_tex[mat], u, v, bary_w,
                           geom.uv[idx])
        contrib = torch.where(
            (kind == DIFFUSE)[:, None],
            (w_in * factor / (s.gi + 1))[:, None] * albedo,
            torch.zeros_like(albedo))
        contrib = torch.where((kind == TEXTURED)[:, None],
                              (w_in * factor)[:, None] * tex_col, contrib)
        contrib = torch.where((kind == CONSTANT)[:, None],
                              w_in[:, None] * albedo, contrib)
        accum = accum.index_add(0, root, contrib)

        # Children: (origin, direction, weight, shows background, slot).
        mirror_d = d - 2.0 * _dot(d, hit_n)[:, None] * hit_n
        mirror_o = pos + s.reflection_bias * mirror_d
        nrm = _unit(n_shade)
        i_dir = _unit(d)
        inside = _dot(i_dir, nrm) > 0
        nrm = torch.where(inside[:, None], -nrm, nrm)
        ior = params["mat_ior"][mat]
        eta_i = torch.where(inside, ior, torch.ones_like(ior))
        eta_r = torch.where(inside, torch.ones_like(ior), ior)
        cos_i = -_dot(i_dir, nrm)
        sin_i = torch.sqrt((1.0 - cos_i * cos_i).clamp_min(1e-12))
        tir = eta_r / eta_i < sin_i
        rr_d = i_dir - 2.0 * _dot(i_dir, nrm)[:, None] * nrm
        rr_o = pos + s.reflection_bias * rr_d
        sin_r = sin_i * eta_i / eta_r
        cos_r = torch.sqrt((1.0 - sin_r * sin_r).clamp_min(1e-12))
        perp = _unit(i_dir + cos_i[:, None] * nrm)
        rf_d = cos_r[:, None] * -nrm + sin_r[:, None] * perp
        rf_o = pos + s.refraction_bias * rf_d
        fresnel = 0.5 * (1.0 - cos_i) ** 5
        kids = []
        is_mirror = kind == REFLECTIVE
        is_glass = kind == REFRACTIVE
        is_diffuse = kind == DIFFUSE
        if s.gi > 0:
            right = _unit(_cross(d, hit_n))
            fwd = _cross(right, hit_n)
            rnd = draws.gi(depth, group, slot, k, s.gi)
            a1, a2 = math.pi * rnd[..., 0], 2.0 * math.pi * rnd[..., 1]
            rv = torch.stack([torch.cos(a2) * torch.cos(a1), torch.sin(a1),
                              torch.sin(a2) * torch.cos(a1)], -1)
            gi_d = torch.stack([_dot(right[:, None], rv),
                                _dot(hit_n[:, None], rv),
                                _dot(fwd[:, None], rv)], -1)
            gi_o = (pos + s.reflection_bias * hit_n)[:, None].expand(
                gi_d.shape)
        if s.bounce == "roulette":
            coin = draws.coin(depth, group, slot, k)
            take_refl = tir | (coin < fresnel)
            kids.append((is_mirror, mirror_o, mirror_d, w_in, True, 0))
            kids.append((is_glass & take_refl, rr_o, rr_d, w_in, False, 0))
            kids.append((is_glass & ~take_refl, rf_o, rf_d, w_in, False, 0))
            if s.gi > 0:
                j = (coin * s.gi).long().clamp(0, s.gi - 1)
                rows = torch.arange(j.shape[0], device=dev)
                kids.append((is_diffuse, gi_o[rows, j], gi_d[rows, j],
                             w_in * s.gi / (s.gi + 1), False, 0))
        else:
            kids.append((is_mirror, mirror_o, mirror_d, w_in, True, 0))
            kids.append((is_glass, rr_o, rr_d,
                         torch.where(tir, w_in, w_in * fresnel), False, 0))
            kids.append((is_glass & ~tir, rf_o, rf_d, w_in * (1 - fresnel),
                         False, 1))
            for g in range(s.gi):
                kids.append((is_diffuse, gi_o[:, g], gi_d[:, g],
                             w_in / (s.gi + 1), False, g))
        sel = [kid[0].nonzero()[:, 0] for kid in kids]
        root = torch.cat([root[r] for r in sel])
        slot = torch.cat([slot[r] * k + kid[5] for r, kid in zip(sel, kids)])
        o = torch.cat([kid[1][r] for r, kid in zip(sel, kids)])
        d = torch.cat([kid[2][r] for r, kid in zip(sel, kids)])
        weight = torch.cat([kid[3][r] for r, kid in zip(sel, kids)])
        show_bg = torch.cat([torch.full((r.numel(),), kid[4],
                                        device=dev) for r, kid in
                             zip(sel, kids)])
    return accum


def camera_rays(scene: RefScene, s: Settings, ids, jitter):
    """Camera rays of ray ids (N,) with subpixel offsets (N, 2)."""
    h, w = scene.height, scene.width
    pix = ids // s.spp
    x = (pix % w).to(scene.dtype) + jitter[:, 0]
    y = (pix // w).to(scene.dtype) + jitter[:, 1]
    tan_half = math.tan(math.radians(s.fov_degrees) / 2.0)
    sx = (2.0 * (x / w) - 1.0) * (w / h) * tan_half
    sy = (1.0 - 2.0 * (y / h)) * tan_half
    m = scene.cam_mat
    d = sx[:, None] * m[0] + sy[:, None] * m[1] - m[2]
    d = d / torch.sqrt(_dot(d, d))[:, None]
    return scene.cam_pos.expand(d.shape), d


def render_ids(scene: RefScene, params, s: Settings, ids, draws: Draws):
    """Colors (N, 3) of ray ids (N,) under `params`."""
    geom = Geometry(scene, params)
    if s.spp == 1:
        jit = torch.full((ids.shape[0], 2), 0.5, device=ids.device,
                         dtype=scene.dtype)
    else:
        jit = draws.jitter().to(scene.dtype)
    o, d = camera_rays(scene, s, ids, jit)
    return trace_rays(scene, params, geom, s, o, d, draws)
