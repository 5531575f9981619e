"""`.crtscene` JSON scene loader (`simd_raytracer_tpu.models.loader`,
reference io/json/loader.hpp:236-265): the Python parser, and the C++ one
of `native/loader.cpp` through `..native`, which give the same Scene.

Same quirks as the reference: `bucket_size` defaults to 64; a diffuse
material whose `albedo` is a string becomes a texture material; UVs come as
three floats per vertex and only x, y are kept; missing mandatory keys and
malformed arrays raise ValueError.  Bitmap paths resolve against the scene
file's directory, then the working directory.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np

from .scene import (MAT_CONSTANT, MAT_DIFFUSE, MAT_REFLECTIVE, MAT_REFRACTIVE,
                    MAT_TEXTURE, TEX_ALBEDO, TEX_BITMAP, TEX_CHECKER,
                    TEX_EDGES, Scene, build_scene)


def _load_bitmap(path: str) -> np.ndarray:
    """Decode an image to (H, W, 3) float32 in [0, 1] (bitmap.hpp:12-37).
    PIL is imported here, so scenes without bitmaps never need it."""
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"), dtype=np.float32)
    return arr * np.float32(1.0 / 255.0)


def _require(obj: Dict[str, Any], key: str, ctx: str):
    if key not in obj:
        raise ValueError(f"missing required key {key!r} in {ctx}")
    return obj[key]


def _resolve_bitmap_path(fp: str, base_dir: str) -> str:
    parts = fp.replace("\\", "/").split("/")
    candidates = [fp] + [os.path.join(base_dir, *parts[i:])
                         for i in range(len(parts))]
    return next((c for c in candidates if os.path.exists(c)), fp)


def parse_scene_dict(doc: Dict[str, Any], base_dir: str = ".") -> Scene:
    settings = _require(doc, "settings", "scene")
    image_settings = _require(settings, "image_settings", "settings")
    background = _require(settings, "background_color", "settings")
    height = int(_require(image_settings, "height", "image_settings"))
    width = int(_require(image_settings, "width", "image_settings"))
    bucket_size = int(image_settings.get("bucket_size", 64))

    cam = _require(doc, "camera", "scene")
    cam_pos = np.asarray(_require(cam, "position", "camera"), np.float32)
    cam_mat = np.asarray(_require(cam, "matrix", "camera"), np.float32)

    lights = [(np.asarray(l["position"], np.float32), float(l["intensity"]))
              for l in _require(doc, "lights", "scene")]

    tex_by_name: Dict[str, int] = {}
    textures = []
    for tj in doc.get("textures", []):
        name = _require(tj, "name", "texture")
        ttype = _require(tj, "type", "texture")
        if ttype == "albedo":
            td = {"tag": TEX_ALBEDO, "color_a": tj["albedo"]}
        elif ttype == "edges":
            td = {"tag": TEX_EDGES, "color_a": tj["edge_color"],
                  "color_b": tj["inner_color"],
                  "param": float(tj["edge_width"])}
        elif ttype == "checker":
            td = {"tag": TEX_CHECKER, "color_a": tj["color_A"],
                  "color_b": tj["color_B"],
                  "param": float(tj["square_size"])}
        elif ttype == "bitmap":
            path = _resolve_bitmap_path(tj["file_path"], base_dir)
            td = {"tag": TEX_BITMAP, "bitmap": _load_bitmap(path)}
        else:
            raise ValueError(f"texture type unknown: {ttype!r}")
        tex_by_name[name] = len(textures)
        textures.append(td)

    materials = []
    for mj in _require(doc, "materials", "scene"):
        mtype = _require(mj, "type", "material")
        if mtype == "diffuse":
            albedo = _require(mj, "albedo", "diffuse material")
            if isinstance(albedo, str):
                if albedo not in tex_by_name:
                    raise ValueError(f"unknown texture name {albedo!r}")
                materials.append({"tag": MAT_TEXTURE,
                                  "tex": tex_by_name[albedo],
                                  "smooth": bool(mj["smooth_shading"])})
            elif isinstance(albedo, (list, tuple)):
                materials.append({"tag": MAT_DIFFUSE, "albedo": albedo,
                                  "smooth": bool(mj["smooth_shading"])})
            else:
                raise ValueError("albedo neither array nor string")
        elif mtype == "reflective":
            materials.append({"tag": MAT_REFLECTIVE, "albedo": mj["albedo"],
                              "smooth": bool(mj["smooth_shading"])})
        elif mtype == "refractive":
            materials.append({"tag": MAT_REFRACTIVE, "ior": float(mj["ior"]),
                              "smooth": bool(mj["smooth_shading"])})
        elif mtype == "constant":
            materials.append({"tag": MAT_CONSTANT, "albedo": mj["albedo"],
                              "smooth": bool(mj["smooth_shading"])})
        else:
            raise ValueError(f"material type unknown: {mtype!r}")

    mesh_vertices, mesh_tri_vidx, mesh_uvs, mesh_material = [], [], [], []
    for obj in _require(doc, "objects", "scene"):
        mesh_material.append(int(_require(obj, "material_index", "object")))
        verts = np.asarray(_require(obj, "vertices", "object"), np.float32)
        if verts.size % 3 != 0:
            raise ValueError("vertex coordinates not multiple of 3")
        mesh_vertices.append(verts.reshape(-1, 3))
        uvs = None
        if "uvs" in obj:
            uv_raw = np.asarray(obj["uvs"], np.float32)
            if uv_raw.size % 3 != 0:
                raise ValueError("uv coordinates not multiple of 3")
            uvs = uv_raw.reshape(-1, 3)[:, :2]
        mesh_uvs.append(uvs)
        tris = np.asarray(_require(obj, "triangles", "object"), np.int64)
        if tris.size % 3 != 0:
            raise ValueError("triangle indices not multiple of 3")
        mesh_tri_vidx.append(tris.reshape(-1, 3))

    return build_scene(
        mesh_vertices=mesh_vertices, mesh_tri_vidx=mesh_tri_vidx,
        mesh_uvs=mesh_uvs, mesh_material=mesh_material,
        materials=materials, textures=textures, lights=lights,
        cam_pos=cam_pos, cam_mat=cam_mat, background=background,
        height=height, width=width, bucket_size=bucket_size)


def _scene_from_native(raw: Dict[str, Any], base_dir: str) -> Scene:
    """Assemble a Scene from the C++ loader's host arrays."""
    textures = []
    for td in raw["textures"]:
        entry = {"tag": td["tag"], "color_a": td["color_a"],
                 "color_b": td["color_b"], "param": td["param"]}
        if td["tag"] == TEX_BITMAP:
            entry["bitmap"] = _load_bitmap(
                _resolve_bitmap_path(td["file_path"], base_dir))
        textures.append(entry)
    return build_scene(
        mesh_vertices=[o["vertices"] for o in raw["objects"]],
        mesh_tri_vidx=[o["triangles"] for o in raw["objects"]],
        mesh_uvs=[o["uvs"] for o in raw["objects"]],
        mesh_material=[o["material_index"] for o in raw["objects"]],
        materials=raw["materials"], textures=textures,
        lights=list(zip(raw["light_pos"], raw["light_intensity"].tolist())),
        cam_pos=raw["cam_pos"], cam_mat=raw["cam_mat"],
        background=raw["background"], height=raw["height"],
        width=raw["width"], bucket_size=raw["bucket_size"])


def parse_scene_file(path: str, use_native: Optional[bool] = None) -> Scene:
    """Parse a `.crtscene` file into a CPU Scene.

    use_native: True forces the C++ loader (raising where its library
    cannot be built), False the Python one; None takes the C++ loader when
    its library builds.  Both give the same Scene."""
    base_dir = os.path.dirname(os.path.abspath(path))
    if use_native is None or use_native:
        from ..native import native_parse_scene
        raw = native_parse_scene(path)
        if raw is not None:
            return _scene_from_native(raw, base_dir)
        if use_native:
            raise RuntimeError("native loader requested, but its library "
                               "could not be built")
    with open(path, "r") as f:
        doc = json.load(f)
    return parse_scene_dict(doc, base_dir=base_dir)
