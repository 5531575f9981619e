"""Generated `.crtscene` documents for the PyTorch port's tests and for
`chip_smoke.py`.

NumPy only (no jax, no torch), so both packages and the smoke script can
import it.  Every generator returns a plain, JSON-serialisable dict in the
`.crtscene` layout that both `parse_scene_dict` implementations read, except
`bitmap_scene_kwargs`, which returns `build_scene` keyword arguments because a
bitmap texture in a `.crtscene` file is an image path.
"""

from __future__ import annotations

import numpy as np

# Camera tilted ~20.6 degrees down the -z axis (scripts/scale_bench.py).
TERRAIN_CAM_POS = [0.0, 2.5, 1.0]
TERRAIN_CAM_MAT = [1.0, 0.0, 0.0,
                   0.0, 0.9363, -0.3515,
                   0.0, 0.3515, 0.9363]
BACKGROUND = [0.2, 0.3, 0.5]


def _settings(h: int, w: int) -> dict:
    return {"background_color": BACKGROUND,
            "image_settings": {"width": int(w), "height": int(h),
                               "bucket_size": 32}}


def _obj(material: int, verts: np.ndarray, tris: np.ndarray,
         uvs: np.ndarray = None) -> dict:
    o = {"material_index": int(material),
         "vertices": np.asarray(verts, np.float32).reshape(-1).tolist(),
         "triangles": np.asarray(tris, np.int64).reshape(-1).tolist()}
    if uvs is not None:
        uv3 = np.zeros((len(uvs), 3), np.float32)
        uv3[:, :2] = uvs
        o["uvs"] = uv3.reshape(-1).tolist()
    return o


def terrain_mesh(g: int):
    """Heightfield over x in [-10, 10], z in [-20, 0] with rolling hills:
    2*g^2 triangles wound to face +y (scripts/scale_bench.py:34-68)."""
    xs = np.linspace(-10, 10, g + 1, dtype=np.float32)
    zs = np.linspace(-20, 0, g + 1, dtype=np.float32)
    gx, gz = np.meshgrid(xs, zs, indexing="xy")
    gy = (np.sin(gx * 0.9) * np.cos(gz * 0.7) * 0.8
          + np.sin(gx * 2.3 + gz * 1.7) * 0.3 - 2.0).astype(np.float32)
    verts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    ii, jj = np.meshgrid(np.arange(g), np.arange(g), indexing="ij")
    v00 = (ii * (g + 1) + jj).ravel()
    v01 = v00 + 1
    v10 = v00 + (g + 1)
    v11 = v10 + 1
    tris = np.concatenate([np.stack([v00, v10, v01], axis=1),
                           np.stack([v01, v10, v11], axis=1)])
    return verts, tris.astype(np.int64)


def terrain_doc(g: int, h: int, w: int) -> dict:
    """The scaling-bench terrain (2*g^2 triangles) as a `.crtscene` doc."""
    verts, tris = terrain_mesh(g)
    return {
        "settings": _settings(h, w),
        "camera": {"position": TERRAIN_CAM_POS, "matrix": TERRAIN_CAM_MAT},
        "lights": [{"position": [0.0, 6.0, -10.0], "intensity": 900.0}],
        "materials": [{"type": "diffuse", "albedo": [0.55, 0.5, 0.4],
                       "smooth_shading": True}],
        "objects": [_obj(0, verts, tris)],
    }


def _outward(verts: np.ndarray, tris: np.ndarray, center) -> np.ndarray:
    """Flip triangles whose e1 x e2 normal points toward `center`."""
    p = verts[tris]
    n = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    inward = np.einsum("ij,ij->i", n, p.mean(axis=1) - center) < 0
    tris = tris.copy()
    tris[inward] = tris[inward][:, [0, 2, 1]]
    return tris


def icosphere(subdiv: int, center, radius: float):
    """Unit icosahedron subdivided `subdiv` times (20*4^subdiv faces),
    projected to the sphere, wound outward."""
    t = (1.0 + 5.0 ** 0.5) / 2.0
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                  [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                  [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]],
                 np.float64)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                  [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                  [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                  [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
                 np.int64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    for _ in range(subdiv):
        edges = np.sort(np.stack([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]],
                                 axis=1).reshape(-1, 2), axis=1)
        uniq, inv = np.unique(edges, axis=0, return_inverse=True)
        mid = v[uniq].mean(axis=1)
        mid /= np.linalg.norm(mid, axis=1, keepdims=True)
        m01, m12, m20 = (inv.reshape(-1, 3) + len(v)).T
        a, b, c = f.T
        f = np.concatenate([np.stack([a, m01, m20], 1),
                            np.stack([b, m12, m01], 1),
                            np.stack([c, m20, m12], 1),
                            np.stack([m01, m12, m20], 1)])
        v = np.concatenate([v, mid])
    verts = (v * radius + np.asarray(center)).astype(np.float32)
    return verts, _outward(verts, f, np.asarray(center, np.float32))


def box(center, half: float):
    """Axis-aligned cube, 12 triangles wound outward."""
    c = np.asarray(center, np.float32)
    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                        for z in (-1, 1)], np.float32) * half + c
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    tris = np.array([t for a, b, cc, d in quads
                     for t in ((a, b, cc), (a, cc, d))], np.int64)
    return corners, _outward(corners, tris, c)


def quad(center, half: float):
    """Square in the plane z = center.z facing +z, with (0..1) UVs."""
    cx, cy, cz = center
    verts = np.array([[cx - half, cy - half, cz], [cx + half, cy - half, cz],
                      [cx + half, cy + half, cz], [cx - half, cy + half, cz]],
                     np.float32)
    tris = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return verts, tris, uvs


def mixed_doc(h: int, w: int, g: int = 181, subdiv: int = 5) -> dict:
    """All five material tags and three file-free texture tags over the
    terrain: 2*g^2 + 2*20*4^subdiv + 28 triangles (106,510 at the
    defaults, 417 slices of 256), two lights."""
    terrain_v, terrain_t = terrain_mesh(g)
    glass_v, glass_t = icosphere(subdiv, (-2.2, -0.6, -7.0), 1.3)
    mirror_v, mirror_t = icosphere(subdiv, (2.4, -0.5, -9.0), 1.4)
    checker_v, checker_t, checker_uv = quad((-4.5, 0.5, -13.0), 2.0)
    albedo_v, albedo_t, albedo_uv = quad((4.5, 0.5, -14.0), 2.0)
    edges_v, edges_t = box((0.3, -0.9, -5.5), 0.5)
    const_v, const_t = box((-0.2, 0.3, -12.0), 0.7)
    return {
        "settings": _settings(h, w),
        "camera": {"position": TERRAIN_CAM_POS, "matrix": TERRAIN_CAM_MAT},
        # High lights: no terrain face is near-parallel to a shadow ray, so
        # shadow-ray self-hits do not hinge on the last ulp of a position.
        "lights": [{"position": [0.0, 14.0, -6.0], "intensity": 2500.0},
                   {"position": [-6.0, 12.0, 2.0], "intensity": 1800.0}],
        "textures": [
            {"name": "checker", "type": "checker", "color_A": [0.9, 0.9, 0.9],
             "color_B": [0.1, 0.1, 0.4], "square_size": 0.125},
            {"name": "edges", "type": "edges", "edge_color": [0.05, 0.05, 0.05],
             "inner_color": [0.2, 0.8, 0.3], "edge_width": 0.06},
            {"name": "albedo", "type": "albedo", "albedo": [0.8, 0.3, 0.6]},
        ],
        "materials": [
            {"type": "diffuse", "albedo": [0.55, 0.5, 0.4],
             "smooth_shading": True},
            {"type": "refractive", "ior": 1.5, "smooth_shading": True},
            {"type": "reflective", "albedo": [0.9, 0.9, 0.9],
             "smooth_shading": True},
            {"type": "diffuse", "albedo": "checker", "smooth_shading": False},
            {"type": "diffuse", "albedo": "edges", "smooth_shading": False},
            {"type": "diffuse", "albedo": "albedo", "smooth_shading": False},
            {"type": "constant", "albedo": [1.0, 0.6, 0.2],
             "smooth_shading": False},
        ],
        "objects": [
            _obj(0, terrain_v, terrain_t),
            _obj(1, glass_v, glass_t),
            _obj(2, mirror_v, mirror_t),
            _obj(3, checker_v, checker_t, checker_uv),
            _obj(4, edges_v, edges_t),
            _obj(5, albedo_v, albedo_t, albedo_uv),
            _obj(6, const_v, const_t),
        ],
    }


class SeededUniforms:
    """A render chunk's uniforms from NumPy, seeded per (seed, chunk,
    bounce): the `jitter(n)` / `coin(depth, n)` / `gi(depth, n, count)`
    source that the port's `render_chunk` takes, equal on every device.  Pass
    `lambda c: SeededUniforms(seed, c)` as `render_frame(uniforms=...)`."""

    def __init__(self, seed: int, chunk: int):
        self.seed, self.chunk = seed, chunk

    def jitter(self, n: int) -> np.ndarray:
        rng = np.random.default_rng([self.seed, self.chunk, 0])
        return rng.random((n, 2), dtype=np.float32)

    def coin(self, depth: int, n: int) -> np.ndarray:
        rng = np.random.default_rng([self.seed, self.chunk, depth + 1])
        return rng.random(n, dtype=np.float32)

    def gi(self, depth: int, n: int, count: int) -> np.ndarray:
        rng = np.random.default_rng([self.seed, self.chunk, depth + 1, 1])
        return rng.random((n, count, 2), dtype=np.float32)


def grid_doc(g: int = 8):
    """A flat g x g grid of triangle pairs at z = -3 that share edges and
    vertices -> (doc, vertices, triangles)."""
    xs = np.linspace(-2.0, 2.0, g + 1, dtype=np.float32)
    gx, gy = np.meshgrid(xs, xs, indexing="xy")
    verts = np.stack([gx, gy, np.full_like(gx, -3.0)], -1).reshape(-1, 3)
    ii, jj = np.meshgrid(np.arange(g), np.arange(g), indexing="ij")
    v00 = (ii * (g + 1) + jj).ravel()
    tris = np.concatenate([np.stack([v00, v00 + 1, v00 + g + 2], 1),
                           np.stack([v00, v00 + g + 2, v00 + g + 1], 1)])
    doc = {"settings": {"background_color": [0, 0, 0],
                        "image_settings": {"width": 4, "height": 4}},
           "camera": {"position": [0, 0, 0],
                      "matrix": [1, 0, 0, 0, 1, 0, 0, 0, 1]},
           "lights": [{"position": [0, 0, 1], "intensity": 1.0}],
           "materials": [{"type": "diffuse", "albedo": [1, 1, 1],
                          "smooth_shading": False}],
           "objects": [{"material_index": 0,
                        "vertices": verts.reshape(-1).tolist(),
                        "triangles": tris.reshape(-1).tolist()}]}
    return doc, verts, tris


def bitmap_scene_kwargs(h: int = 256, w: int = 256, seed: int = 0) -> dict:
    """`build_scene` kwargs covering all four texture tags, the bitmap one
    given as a seeded (8, 8, 3) array so no image file or PIL is needed."""
    rng = np.random.default_rng(seed)
    bitmap = rng.random((8, 8, 3)).astype(np.float32)
    meshes = [quad((-1.1, 1.1, -4.0), 1.0), quad((1.1, 1.1, -4.0), 1.0),
              quad((-1.1, -1.1, -4.0), 1.0), quad((1.1, -1.1, -4.0), 1.0),
              quad((0.0, 0.0, -6.0), 4.0)]
    return dict(
        mesh_vertices=[m[0] for m in meshes],
        mesh_tri_vidx=[m[1] for m in meshes],
        mesh_uvs=[m[2] for m in meshes],
        mesh_material=[0, 1, 2, 3, 4],
        materials=[{"tag": 4, "tex": 0, "smooth": False},
                   {"tag": 4, "tex": 1, "smooth": False},
                   {"tag": 4, "tex": 2, "smooth": False},
                   {"tag": 4, "tex": 3, "smooth": False},
                   {"tag": 0, "albedo": (0.5, 0.5, 0.5), "smooth": False}],
        textures=[{"tag": 0, "color_a": (0.8, 0.2, 0.2)},
                  {"tag": 1, "color_a": (0.0, 0.0, 0.0),
                   "color_b": (0.9, 0.8, 0.1), "param": 0.05},
                  {"tag": 2, "color_a": (1.0, 1.0, 1.0),
                   "color_b": (0.1, 0.1, 0.1), "param": 0.2},
                  {"tag": 3, "bitmap": bitmap}],
        lights=[((0.0, 2.0, -1.0), 60.0)],
        cam_pos=(0.0, 0.0, 0.0), cam_mat=np.eye(3, dtype=np.float32),
        background=(0.05, 0.05, 0.1), height=h, width=w, bucket_size=32,
    )


def shade_rows(n: int, seed: int, n_tex: int, gi: int, lo, hi) -> dict:
    """Random inputs of one shade call over n rows, as NumPy arrays named
    by the HitRecord fields (plus d_in, weight, rnd_coin, rnd_gi): every
    material tag, any of n_tex textures, misses and dead rays among them,
    unnormalised incoming directions, grazing and total-internal-reflection
    refractions (ior 1 to 2.5), corner UVs in [-3, 3) (negative checker
    coordinates, bitmap rows and columns clamped at both edges), positions
    in the box [lo, hi)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def unit(k):
        v = rng.normal(size=(k, 3))
        return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(f32)

    u = rng.random(n, dtype=f32)
    v = (rng.random(n, dtype=f32) * (1 - u)).astype(f32)
    weight = rng.random(n, dtype=f32)
    weight[rng.random(n) < 0.1] = 0.0
    d_in = unit(n) * rng.uniform(0.5, 2.0, (n, 1)).astype(f32)
    return {
        "mask": rng.random(n) < 0.85,
        "idx": np.zeros(n, np.int32),
        "t": rng.uniform(0.1, 20.0, n).astype(f32),
        "u": u, "v": v, "w": (f32(1) - u - v).astype(f32),
        "position": rng.uniform(lo, hi, (n, 3)).astype(f32),
        "hit_n": unit(n), "face_n": unit(n),
        "uvs": rng.uniform(-3.0, 3.0, (n, 3, 2)).astype(f32),
        "mat_tag": rng.integers(0, 5, n).astype(np.int32),
        "albedo": rng.random((n, 3), dtype=f32),
        "ior": rng.uniform(1.0, 2.5, n).astype(f32),
        "smooth": rng.random(n) < 0.5,
        "tex": rng.integers(0, n_tex, n).astype(np.int32),
        "mesh_idx": np.zeros(n, np.int32),
        "d_in": d_in.astype(f32), "weight": weight,
        "rnd_coin": rng.random(n, dtype=f32),
        "rnd_gi": rng.random((n, gi, 2), dtype=f32),
    }
