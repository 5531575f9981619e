"""A stand-in for the reference's hw15/scene2, the scene of its GI renders
(README.md:46-48), whose file is not in the repository.  It keeps the
counts measured from that scene's file: 2,012 triangles, one light, 12
materials (refractive and constant among them), three file-free texture
tags, bucket 24.  The geometry is an open room: a checkered floor, three
walls, a glass, a mirror and a diffuse icosphere, boxes and wall panels.
Frozen: `perfbench/tests` pins its triangle count and hash."""

from pb.scenes import box, grid, icosphere, obj, quad, settings

# Looking down the -z axis, tilted about 8 degrees down.
CAM_POS = [0.0, 1.0, 0.5]
CAM_MAT = [1.0, 0.0, 0.0,
           0.0, 0.9903, -0.1392,
           0.0, 0.1392, 0.9903]


def doc(h: int, w: int) -> dict:
    floor = grid((-4.0, -1.0, -2.0), (8.0, 0.0, 0.0), (0.0, 0.0, -8.0), 4)
    back = grid((-4.0, -1.0, -10.0), (8.0, 0.0, 0.0), (0.0, 5.0, 0.0), 2)
    left = grid((-4.0, -1.0, -2.0), (0.0, 0.0, -8.0), (0.0, 5.0, 0.0), 2)
    right = grid((4.0, -1.0, -10.0), (0.0, 0.0, 8.0), (0.0, 5.0, 0.0), 1)
    glass = icosphere(3, (-1.6, 0.25, -6.0), 1.2)
    mirror = icosphere(2, (1.8, 0.0, -7.5), 1.0)
    ball = icosphere(2, (0.4, -0.45, -4.6), 0.55)
    lamp_v, lamp_t, _ = quad((0.0, 3.2, -9.95), 0.3)
    poster_v, poster_t, poster_uv = quad((-2.0, 2.4, -9.95), 0.9)
    panel_v, panel_t, _ = quad((2.2, 2.4, -9.95), 0.9)
    return {
        "settings": settings(h, w, bucket=24),
        "camera": {"position": CAM_POS, "matrix": CAM_MAT},
        "lights": [{"position": [0.0, 3.4, -5.5], "intensity": 250.0}],
        "textures": [
            {"name": "checker", "type": "checker", "color_A": [0.85, 0.85, 0.8],
             "color_B": [0.15, 0.15, 0.2], "square_size": 0.125},
            {"name": "edges", "type": "edges", "edge_color": [0.05, 0.05, 0.05],
             "inner_color": [0.9, 0.7, 0.2], "edge_width": 0.06},
            {"name": "albedo", "type": "albedo", "albedo": [0.3, 0.4, 0.8]},
        ],
        "materials": [
            {"type": "diffuse", "albedo": "checker", "smooth_shading": False},
            {"type": "diffuse", "albedo": [0.75, 0.75, 0.72],
             "smooth_shading": False},
            {"type": "diffuse", "albedo": [0.7, 0.15, 0.12],
             "smooth_shading": False},
            {"type": "diffuse", "albedo": [0.15, 0.55, 0.2],
             "smooth_shading": False},
            {"type": "refractive", "ior": 1.5, "smooth_shading": True},
            {"type": "reflective", "albedo": [0.9, 0.9, 0.9],
             "smooth_shading": True},
            {"type": "diffuse", "albedo": [0.8, 0.65, 0.3],
             "smooth_shading": True},
            {"type": "constant", "albedo": [1.0, 0.85, 0.6],
             "smooth_shading": False},
            {"type": "diffuse", "albedo": "edges", "smooth_shading": False},
            {"type": "diffuse", "albedo": [0.5, 0.55, 0.7],
             "smooth_shading": False},
            {"type": "diffuse", "albedo": "albedo", "smooth_shading": False},
            {"type": "reflective", "albedo": [0.6, 0.8, 0.9],
             "smooth_shading": False},
        ],
        "objects": [
            obj(0, floor[0], floor[1], floor[2]),
            obj(1, back[0], back[1]),
            obj(2, left[0], left[1]),
            obj(3, right[0], right[1]),
            obj(4, *glass),
            obj(5, *mirror),
            obj(6, *ball),
            obj(7, *box((2.8, -0.6, -4.0), 0.4)),
            obj(8, *box((-2.9, -0.5, -8.2), 0.5)),
            obj(9, *box((0.2, -0.3, -8.8), 0.7)),
            obj(10, poster_v, poster_t, poster_uv),
            obj(11, panel_v, panel_t),
            obj(7, lamp_v, lamp_t),
        ],
    }
