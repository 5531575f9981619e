"""Camera ray generation (reference render/render.hpp:36-62): raster ->
NDC -> screen with aspect and fov, direction =
normalized(transpose(camera.matrix) * [sx, sy, -1]).

Also the camera movement API of scene/camera.hpp:13-66 (truck, pedestal,
dolly, pan, tilt, roll), as in `simd_raytracer_tpu.models.camera`; each
move returns a new Scene whose camera tensors keep the scene's device and
dtype."""

from __future__ import annotations

import math

import torch

from .scene import Scene, dot3


def primary_rays(scene: Scene, fov_degrees: float,
                 pix_x: torch.Tensor, pix_y: torch.Tensor,
                 jitter_x: torch.Tensor, jitter_y: torch.Tensor):
    """Camera rays for pixel coords (N,) plus subpixel jitter (N,).
    Returns (origins (N, 3), unit directions (N, 3))."""
    h, w = scene.height, scene.width
    dtype = scene.vertices.dtype
    aspect = w / h
    tan_half = math.tan(math.radians(fov_degrees) / 2.0)

    raster_x = pix_x.to(dtype) + jitter_x
    raster_y = pix_y.to(dtype) + jitter_y
    screen_x = (2.0 * (raster_x / w) - 1.0) * aspect * tan_half
    screen_y = (1.0 - 2.0 * (raster_y / h)) * tan_half

    # transpose(M) @ v as an explicit multiply-add over the three rows, as
    # in the JAX package (no matmul for a K=3 contraction).
    m = scene.cam_mat
    dirs = torch.stack([
        screen_x * m[0, 0] + screen_y * m[1, 0] - m[2, 0],
        screen_x * m[0, 1] + screen_y * m[1, 1] - m[2, 1],
        screen_x * m[0, 2] + screen_y * m[1, 2] - m[2, 2],
    ], dim=-1)
    dirs = dirs / torch.sqrt(dot3(dirs, dirs))[:, None]
    origins = scene.cam_pos.expand(dirs.shape)
    return origins, dirs


def _rot(axis: str, degrees: float, like: torch.Tensor) -> torch.Tensor:
    """3x3 rotation about `axis` ("y" pan, "x" tilt, "z" roll), rounded to
    float32 as the JAX package builds it, then in `like`'s dtype and
    device."""
    r = math.radians(degrees)
    c, s = math.cos(r), math.sin(r)
    rows = {"y": [[c, 0, s], [0, 1, 0], [-s, 0, c]],
            "x": [[1, 0, 0], [0, c, -s], [0, s, c]],
            "z": [[c, -s, 0], [s, c, 0], [0, 0, 1]]}
    if axis not in rows:
        raise ValueError(axis)
    return torch.tensor(rows[axis], dtype=torch.float32).to(like)


def translate(scene: Scene, translation) -> Scene:
    """camera.hpp:13-15: position += translation expressed in the camera
    frame (the row-vector product translation @ matrix)."""
    t = torch.as_tensor(translation, dtype=torch.float32).to(scene.cam_mat)
    return scene.replace(cam_pos=scene.cam_pos + t @ scene.cam_mat)


def truck(scene: Scene, dist: float) -> Scene:
    return translate(scene, [dist, 0, 0])


def pedestal(scene: Scene, dist: float) -> Scene:
    return translate(scene, [0, dist, 0])


def dolly(scene: Scene, dist: float) -> Scene:
    return translate(scene, [0, 0, dist])


def pan(scene: Scene, degrees: float) -> Scene:
    return scene.replace(cam_mat=_rot("y", degrees, scene.cam_mat)
                         @ scene.cam_mat)


def tilt(scene: Scene, degrees: float) -> Scene:
    return scene.replace(cam_mat=_rot("x", degrees, scene.cam_mat)
                         @ scene.cam_mat)


def roll(scene: Scene, degrees: float) -> Scene:
    return scene.replace(cam_mat=_rot("z", degrees, scene.cam_mat)
                         @ scene.cam_mat)
