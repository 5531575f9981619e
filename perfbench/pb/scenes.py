"""Scene documents of the benchmark's configurations, found by name.

A configuration's `scene` names either a generator, the file
`perfbench/scenes/<generator>.py` whose `doc(h, w, **args)` returns a
`.crtscene` document, or a `.crtscene` file under `perfbench/` (`file`).
The generators are frozen here, apart from the port and its tests, so the
yardstick does not move when the program's own helpers change;
`perfbench/tests` pins each configuration's triangle count and a hash of
its arrays.  A new scene is a new file: nothing here changes.

The geometry below is what the generators share.  NumPy only.
"""

from __future__ import annotations

import json
import os

import numpy as np

from . import spec

# Camera tilted ~20.6 degrees down the -z axis (scripts/scale_bench.py).
TERRAIN_CAM_POS = [0.0, 2.5, 1.0]
TERRAIN_CAM_MAT = [1.0, 0.0, 0.0,
                   0.0, 0.9363, -0.3515,
                   0.0, 0.3515, 0.9363]
BACKGROUND = [0.2, 0.3, 0.5]


def settings(h: int, w: int, bucket: int = 32, background=BACKGROUND) -> dict:
    return {"background_color": list(background),
            "image_settings": {"width": int(w), "height": int(h),
                               "bucket_size": int(bucket)}}


def obj(material: int, verts: np.ndarray, tris: np.ndarray,
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




def grid(corner, edge_u, edge_v, g: int):
    """A flat g x g grid of quads spanning corner + [0,1] edge_u + [0,1]
    edge_v: 2*g^2 triangles wound to face edge_u x edge_v, with UVs."""
    s = np.linspace(0.0, 1.0, g + 1, dtype=np.float32)
    su, sv = np.meshgrid(s, s, indexing="ij")
    verts = (np.asarray(corner, np.float32)
             + su.reshape(-1, 1) * np.asarray(edge_u, np.float32)
             + sv.reshape(-1, 1) * np.asarray(edge_v, np.float32))
    ii, jj = np.meshgrid(np.arange(g), np.arange(g), indexing="ij")
    v00 = (ii * (g + 1) + jj).ravel()
    v10 = v00 + (g + 1)
    tris = np.concatenate([np.stack([v00, v10, v10 + 1], axis=1),
                           np.stack([v00, v10 + 1, v00 + 1], axis=1)])
    uvs = np.stack([su.reshape(-1), sv.reshape(-1)], axis=1)
    return verts, tris.astype(np.int64), uvs


def scene_doc(config: dict) -> dict:
    """The `.crtscene` document of a configuration file, at its image
    size (`image_rows`, `image_cols`): from `scene.generator`'s file,
    called with the size and `scene.args`, or read from `scene.file`."""
    scene = config["scene"]
    h, w = int(config["image_rows"]), int(config["image_cols"])
    if "file" in scene:
        with open(os.path.join(spec.ROOT, scene["file"])) as f:
            doc = json.load(f)
        doc["settings"]["image_settings"].update(height=h, width=w)
        return doc
    gen = spec.module("scenes", scene["generator"])
    return gen.doc(h, w, **scene.get("args", {}))
