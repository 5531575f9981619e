"""The generated stand-in scene PRs 1-8 measured the port on: a terrain
heightfield, a glass and a mirror icosphere, textured quads and boxes,
with all five material tags, three file-free texture tags and two lights
(2*g^2 + 2*20*4^subdiv + 28 triangles).  Frozen: `perfbench/tests` pins
its triangle count and hash at each configuration that uses it."""

from pb.scenes import (TERRAIN_CAM_MAT, TERRAIN_CAM_POS, box, icosphere,
                       obj, quad, settings, terrain_mesh)


def doc(h: int, w: int, g: int = 181, subdiv: int = 5) -> dict:
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
        "settings": settings(h, w),
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
            obj(0, terrain_v, terrain_t),
            obj(1, glass_v, glass_t),
            obj(2, mirror_v, mirror_t),
            obj(3, checker_v, checker_t, checker_uv),
            obj(4, edges_v, edges_t),
            obj(5, albedo_v, albedo_t, albedo_uv),
            obj(6, const_v, const_t),
        ],
    }
