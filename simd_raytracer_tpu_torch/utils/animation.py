"""Animation rendering: camera paths -> frame sequences.

Counterpart of `simd_raytracer_tpu.utils.animation`: the camera movement
API of models/camera.py (scene/camera.hpp:13-66) drives frame sequences.
The paths work on the scene's tensors and keep their device and dtype.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Iterable, List, Optional

import torch

from ..config import RenderConfig
from ..models import camera as cam
from ..models.scene import Scene


def orbit_path(scene: Scene, n_frames: int,
               degrees_per_frame: Optional[float] = None) -> Iterable[Scene]:
    """Turntable: pan the camera around the vertical axis through the
    scene's vertex centroid, keeping its distance."""
    if degrees_per_frame is None:
        degrees_per_frame = 360.0 / n_frames
    center = scene.vertices.detach().mean(dim=0)
    for i in range(n_frames):
        ang = math.radians(degrees_per_frame * i)
        c, s = math.cos(ang), math.sin(ang)
        rot_t = torch.tensor([[c, 0, s], [0, 1, 0], [-s, 0, c]],
                             dtype=torch.float32).T.to(scene.cam_mat)
        pos = center + (scene.cam_pos - center) @ rot_t
        yield scene.replace(cam_pos=pos, cam_mat=scene.cam_mat @ rot_t)


def dolly_path(scene: Scene, n_frames: int, total_dist: float
               ) -> Iterable[Scene]:
    """Dolly in or out along the view axis (camera.hpp:31-33)."""
    step = total_dist / max(1, n_frames - 1)
    s = scene
    for _ in range(n_frames):
        yield s
        s = cam.dolly(s, step)


def render_animation(
    frames: Iterable[Scene],
    cfg: RenderConfig = RenderConfig(),
    out_dir: Optional[str] = None,
    prefix: str = "frame",
    accel=None,
    on_frame: Optional[Callable[[int, torch.Tensor], None]] = None,
    *,
    device="cuda",
) -> List[torch.Tensor]:
    """Render a scene sequence on `device` (the card unless the caller
    asks for "cpu") -> the (H, W, 3) images; with out_dir, also write
    `{prefix}_{i:04d}.ppm` files.  The camera moves, the geometry does
    not, so one accel (built from the first frame when None) serves every
    frame."""
    from ..ops.render import build_accel, render_frame
    from .ppm import save_ppm

    out = []
    for i, scene in enumerate(frames):
        if accel is None:
            accel = build_accel(scene, cfg)
        img = render_frame(scene, cfg, device=device, accel=accel)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            save_ppm(img, os.path.join(out_dir, f"{prefix}_{i:04d}.ppm"))
        if on_frame:
            on_frame(i, img)
        out.append(img)
    return out
