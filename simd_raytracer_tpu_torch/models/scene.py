"""Scene model: flat structure-of-arrays tensors.

Counterpart of `simd_raytracer_tpu.models.scene`: every mesh's triangles in
one global soup, the five material variants as an integer tag plus a dense
parameter table, the four texture variants as a tag table plus one flat
texel atlas.  The derived geometry (edges, face and vertex normals,
reference scene/object/mesh.hpp:23-44) is recomputed from the raw vertices
by `derive_geometry`, so gradients can reach them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..ops.gather import gather_rows

# Material tags (reference scene/material/material.hpp:11-12 order).
MAT_DIFFUSE = 0
MAT_REFLECTIVE = 1
MAT_REFRACTIVE = 2
MAT_CONSTANT = 3
MAT_TEXTURE = 4

# Texture tags (scene/texture/texture.hpp:10-11 order).
TEX_ALBEDO = 0
TEX_EDGES = 1
TEX_CHECKER = 2
TEX_BITMAP = 3

# Triangle count padding, kept so that shapes equal the JAX package's.
TRI_PAD = 128


class TensorStruct:
    """Dataclass mixin: map every tensor field at once."""

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]):
        return dataclasses.replace(self, **{
            f.name: fn(getattr(self, f.name))
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    def to(self, device):
        return self.map(lambda t: t.to(device))

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class Scene(TensorStruct):
    """Flattened scene.  V vertices, T triangles (padded to TRI_PAD),
    M materials, L lights (>= 1), X textures (>= 1), P atlas texels."""

    vertices: torch.Tensor         # (V, 3) float
    tri_vidx: torch.Tensor         # (T, 3) int32 indices into vertices
    uv: torch.Tensor               # (T, 3, 2) per-corner UVs
    tri_mat: torch.Tensor          # (T,) int32 material index
    tri_mesh: torch.Tensor         # (T,) int32 owning mesh
    tri_valid: torch.Tensor        # (T,) bool, False on padding

    mat_tag: torch.Tensor          # (M,) int32
    mat_albedo: torch.Tensor       # (M, 3)
    mat_ior: torch.Tensor          # (M,)
    mat_smooth: torch.Tensor       # (M,) bool
    mat_tex: torch.Tensor          # (M,) int32

    tex_tag: torch.Tensor          # (X,) int32
    tex_color_a: torch.Tensor      # (X, 3)
    tex_color_b: torch.Tensor      # (X, 3)
    tex_param: torch.Tensor        # (X,)
    tex_offset: torch.Tensor       # (X,) int32 first texel in the atlas
    tex_width: torch.Tensor        # (X,) int32
    tex_height: torch.Tensor       # (X,) int32
    atlas: torch.Tensor            # (P, 3) bitmap texels, row-major

    light_pos: torch.Tensor        # (L, 3)
    light_intensity: torch.Tensor  # (L,)

    cam_pos: torch.Tensor          # (3,)
    cam_mat: torch.Tensor          # (3, 3) row-major orientation
    background: torch.Tensor       # (3,)

    height: int
    width: int
    bucket_size: int
    num_meshes: int

    @property
    def num_triangles(self) -> int:
        return int(self.tri_vidx.shape[0])


@dataclasses.dataclass
class Geometry(TensorStruct):
    """Per-triangle derived arrays read by intersection and shading."""

    v0: torch.Tensor                # (T, 3)
    e1: torch.Tensor                # (T, 3)
    e2: torch.Tensor                # (T, 3)
    face_n: torch.Tensor            # (T, 3) unit geometric normal
    vn: torch.Tensor                # (T, 3, 3) per-corner vertex normals
    uv: torch.Tensor                # (T, 3, 2)
    tri_mat: torch.Tensor           # (T,) int32
    tri_mesh: torch.Tensor          # (T,) int32
    tri_valid: torch.Tensor         # (T,) bool
    tri_transmissive: torch.Tensor  # (T,) bool, material is refractive
    # The scene's vertices and corner indices, which a refitted sweep
    # reads (accel/sweep.py::refit_sweep).
    vertices: torch.Tensor          # (V, 3)
    tri_vidx: torch.Tensor          # (T, 3) int32
    # The selects bound to these triangles (ops/intersect.py::
    # make_select_fn); a Geometry made from this one starts with none.
    selects: dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False, compare=False)


SCENE_TENSOR_FIELDS = tuple(
    f.name for f in dataclasses.fields(Scene)
    if f.name not in ("height", "width", "bucket_size", "num_meshes"))


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the last axis (size 3), written out component by
    component so the CPU and CUDA results round identically."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis, one multiply per term (no fused
    multiply-add, unlike torch.cross on some CPUs)."""
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def safe_normalize(v: torch.Tensor) -> torch.Tensor:
    """v / |v| with the squared norm clamped before the square root, so a
    zero vector (padding triangles) has a zero, not NaN, gradient
    (models/scene.py:121-127 of the JAX package)."""
    sq = dot3(v, v).clamp_min(1e-18)[..., None]
    return v * torch.sqrt(sq).reciprocal()


def pack_triangles(v0, e1, e2) -> torch.Tensor:
    """(T, 3) x 3 -> (9, T) float32, one row per component."""
    return torch.cat([v0.T, e1.T, e2.T], dim=0).float().contiguous()


def vertex_sums(n_vertices: int, idx: torch.Tensor, valid: torch.Tensor,
                rows: torch.Tensor) -> torch.Tensor:
    """(V, 3) sums of each valid triangle's row of `rows` (T, 3) into its
    three corner vertices, added in the order of index_add over corner 0,
    1, then 2 with triangles ascending, as the CPU adds them, but through
    gathers: index_add on CUDA adds with atomics in no fixed order, and
    the vertex normals (then the shading) would change in the last bits
    from run to run."""
    t = idx.shape[0]
    dev = rows.device
    vid = idx.T.reshape(-1)                    # corner-major: c * T + tri
    pos = torch.arange(3 * t, device=dev)[valid.repeat(3)]
    vid = vid[pos]
    order = torch.argsort(vid, stable=True)
    vid, src = vid[order], rows[pos[order] % t]
    counts = torch.bincount(vid, minlength=n_vertices)
    starts = torch.cumsum(counts, 0) - counts
    out = torch.zeros((n_vertices, rows.shape[1]), dtype=rows.dtype,
                      device=dev)
    for j in range(int(counts.max()) if vid.numel() else 0):
        has = counts > j
        take = src[(starts + j).clamp_max(vid.numel() - 1)]
        out = out + torch.where(has[:, None], take, 0.0)
    return out


def derive_geometry(scene: Scene) -> Geometry:
    """Edges, face normals and area-unweighted vertex normals (the
    normalised sum of adjacent unit face normals, mesh.hpp:33-43)."""
    v = scene.vertices
    idx = scene.tri_vidx.long()
    p0, p1, p2 = (gather_rows(v, idx[:, k]) for k in range(3))
    e1 = p1 - p0
    e2 = p2 - p0
    face_n = safe_normalize(cross3(e1, e2))

    vn_accum = vertex_sums(v.shape[0], idx, scene.tri_valid, face_n)
    vn = gather_rows(safe_normalize(vn_accum), idx)   # (T, 3, 3)

    tri_transmissive = scene.mat_tag[scene.tri_mat.long()] == MAT_REFRACTIVE
    return Geometry(v0=p0, e1=e1, e2=e2, face_n=face_n, vn=vn, uv=scene.uv,
                    tri_mat=scene.tri_mat, tri_mesh=scene.tri_mesh,
                    tri_valid=scene.tri_valid,
                    tri_transmissive=tri_transmissive, vertices=v,
                    tri_vidx=scene.tri_vidx)


def scene_from_arrays(arrays, *, height: int, width: int, bucket_size: int,
                      num_meshes: int, device="cpu") -> Scene:
    """Scene from NumPy arrays named like the Scene fields (for instance a
    JAX Scene's fields through np.asarray).  Floating fields take the dtype
    of `vertices`, integer fields int32."""
    fdtype = torch.from_numpy(np.array(arrays["vertices"])).dtype
    out = {}
    for name in SCENE_TENSOR_FIELDS:
        t = torch.from_numpy(np.array(arrays[name]))
        if t.dtype == torch.bool:
            pass
        elif t.is_floating_point():
            t = t.to(fdtype)
        else:
            t = t.to(torch.int32)
        out[name] = t.to(device)
    return Scene(**out, height=int(height), width=int(width),
                 bucket_size=int(bucket_size), num_meshes=int(num_meshes))


def build_scene(*, mesh_vertices: list, mesh_tri_vidx: list, mesh_uvs: list,
                mesh_material: list, materials: list, textures: list,
                lights: list, cam_pos, cam_mat, background,
                height: int, width: int, bucket_size: int) -> Scene:
    """Assemble the flat Scene from per-mesh host data (NumPy), on the CPU.

    Same layout as the JAX build_scene: padding triangles are degenerate
    (all corners at vertex 0, determinant 0) and invalid; missing lights,
    materials and textures get one zero-valued entry."""
    all_v, all_idx, all_uv, all_mat, all_mesh = [], [], [], [], []
    voffset = 0
    for mi, (verts, tidx) in enumerate(zip(mesh_vertices, mesh_tri_vidx)):
        verts = np.asarray(verts, np.float32).reshape(-1, 3)
        tidx = np.asarray(tidx, np.int64).reshape(-1, 3)
        all_v.append(verts)
        all_idx.append(tidx + voffset)
        uvs = mesh_uvs[mi]
        if uvs is not None and len(uvs):
            uvs = np.asarray(uvs, np.float32).reshape(-1, 2)
            all_uv.append(uvs[tidx])
        else:
            all_uv.append(np.zeros((len(tidx), 3, 2), np.float32))
        all_mat.append(np.full(len(tidx), mesh_material[mi], np.int32))
        all_mesh.append(np.full(len(tidx), mi, np.int32))
        voffset += len(verts)

    vertices = np.concatenate(all_v) if all_v else np.zeros((1, 3), np.float32)
    tri_vidx = (np.concatenate(all_idx) if all_idx
                else np.zeros((0, 3), np.int64)).astype(np.int32)
    uv = np.concatenate(all_uv) if all_uv else np.zeros((0, 3, 2), np.float32)
    tri_mat = np.concatenate(all_mat) if all_mat else np.zeros(0, np.int32)
    tri_mesh = np.concatenate(all_mesh) if all_mesh else np.zeros(0, np.int32)

    t = len(tri_vidx)
    t_pad = max(TRI_PAD, -(-t // TRI_PAD) * TRI_PAD)
    pad = t_pad - t
    tri_valid = np.concatenate([np.ones(t, bool), np.zeros(pad, bool)])
    tri_vidx = np.concatenate([tri_vidx, np.zeros((pad, 3), np.int32)])
    uv = np.concatenate([uv, np.zeros((pad, 3, 2), np.float32)])
    tri_mat = np.concatenate([tri_mat, np.zeros(pad, np.int32)])
    tri_mesh = np.concatenate([tri_mesh, np.zeros(pad, np.int32)])

    m = max(1, len(materials))
    mat_tag = np.zeros(m, np.int32)
    mat_albedo = np.zeros((m, 3), np.float32)
    mat_ior = np.ones(m, np.float32)
    mat_smooth = np.zeros(m, bool)
    mat_tex = np.zeros(m, np.int32)
    for i, md in enumerate(materials):
        mat_tag[i] = md["tag"]
        mat_albedo[i] = md.get("albedo", (0, 0, 0))
        mat_ior[i] = md.get("ior", 1.0)
        mat_smooth[i] = md.get("smooth", False)
        mat_tex[i] = md.get("tex", 0)

    x = max(1, len(textures))
    tex_tag = np.zeros(x, np.int32)
    tex_color_a = np.zeros((x, 3), np.float32)
    tex_color_b = np.zeros((x, 3), np.float32)
    tex_param = np.ones(x, np.float32)
    tex_offset = np.zeros(x, np.int32)
    tex_width = np.ones(x, np.int32)
    tex_height = np.ones(x, np.int32)
    atlas_parts = []
    texel_count = 0
    for i, td in enumerate(textures):
        tex_tag[i] = td["tag"]
        tex_color_a[i] = td.get("color_a", (0, 0, 0))
        tex_color_b[i] = td.get("color_b", (0, 0, 0))
        tex_param[i] = td.get("param", 1.0)
        bmp = td.get("bitmap")
        if bmp is not None:
            bmp = np.asarray(bmp, np.float32)       # (Hb, Wb, 3) in [0, 1]
            hb, wb = bmp.shape[:2]
            tex_offset[i] = texel_count
            tex_width[i] = wb
            tex_height[i] = hb
            atlas_parts.append(bmp.reshape(-1, 3))
            texel_count += hb * wb
    atlas = (np.concatenate(atlas_parts) if atlas_parts
             else np.zeros((1, 3), np.float32))

    nl = max(1, len(lights))
    light_pos = np.zeros((nl, 3), np.float32)
    light_intensity = np.zeros(nl, np.float32)
    light_pos[:, 1] = 1.0      # a padded light sits off the origin
    for i, (pos, inten) in enumerate(lights):
        light_pos[i] = pos
        light_intensity[i] = inten

    return scene_from_arrays(dict(
        vertices=vertices, tri_vidx=tri_vidx, uv=uv, tri_mat=tri_mat,
        tri_mesh=tri_mesh, tri_valid=tri_valid, mat_tag=mat_tag,
        mat_albedo=mat_albedo, mat_ior=mat_ior, mat_smooth=mat_smooth,
        mat_tex=mat_tex, tex_tag=tex_tag, tex_color_a=tex_color_a,
        tex_color_b=tex_color_b, tex_param=tex_param, tex_offset=tex_offset,
        tex_width=tex_width, tex_height=tex_height, atlas=atlas,
        light_pos=light_pos, light_intensity=light_intensity,
        cam_pos=np.asarray(cam_pos, np.float32),
        cam_mat=np.asarray(cam_mat, np.float32).reshape(3, 3),
        background=np.asarray(background, np.float32)),
        height=height, width=width, bucket_size=bucket_size,
        num_meshes=len(mesh_vertices))
