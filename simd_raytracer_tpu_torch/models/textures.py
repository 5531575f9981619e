"""Texture sampling: every ray evaluates all four samplers on its gathered
texture parameters and selects by tag (reference texture/*.hpp):

  * albedo  - constant color (albedo.hpp:8-14)
  * edges   - any barycentric below edge_width -> edge color (edge.hpp)
  * checker - truncated (u/sq + v/sq) parity with C++ truncating division
              and remainder (checker.hpp:7-27)
  * bitmap  - nearest texel with v flipped and clamped (bitmap.hpp:46-60)
"""

from __future__ import annotations

import torch

from ..ops.gather import gather_rows
from .scene import TEX_BITMAP, TEX_CHECKER, TEX_EDGES, Scene


def sample_texture(scene: Scene, tex_id: torch.Tensor,
                   u: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                   uvs: torch.Tensor) -> torch.Tensor:
    """tex_id (N,) int; u, v, w (N,) barycentrics; uvs (N, 3, 2) corner
    UVs.  Returns (N, 3) colors."""
    tex_id = tex_id.long()
    tag = scene.tex_tag[tex_id]
    color_a = gather_rows(scene.tex_color_a, tex_id)
    color_b = gather_rows(scene.tex_color_b, tex_id)
    param = gather_rows(scene.tex_param, tex_id)

    fu = w * uvs[:, 0, 0] + u * uvs[:, 1, 0] + v * uvs[:, 2, 0]
    fv = w * uvs[:, 0, 1] + u * uvs[:, 1, 1] + v * uvs[:, 2, 1]

    edge = (u < param) | (v < param) | (w < param)
    edge_color = torch.where(edge[:, None], color_a, color_b)

    # Float -> int32 truncates toward zero and torch.fmod is the truncated
    # remainder, both as in C++ (torch.remainder and % follow the divisor's
    # sign and would flip the parity of negative UVs).
    safe_sq = param.clamp_min(1e-20)
    u2 = (fu / safe_sq).to(torch.int32)
    v2 = (fv / safe_sq).to(torch.int32)
    checker_even = torch.fmod(u2 + v2, 2) == 0
    checker_color = torch.where(checker_even[:, None], color_a, color_b)

    th = scene.tex_height[tex_id]
    tw = scene.tex_width[tex_id]
    row = torch.clamp(((1.0 - fv) * th.to(torch.float32)).to(torch.int32),
                      torch.zeros_like(th), th - 1)
    col = torch.clamp((fu * tw.to(torch.float32)).to(torch.int32),
                      torch.zeros_like(tw), tw - 1)
    flat = (scene.tex_offset[tex_id] + row * tw + col).clamp(
        0, scene.atlas.shape[0] - 1)
    bitmap_color = gather_rows(scene.atlas, flat.long())

    out = color_a
    out = torch.where((tag == TEX_EDGES)[:, None], edge_color, out)
    out = torch.where((tag == TEX_CHECKER)[:, None], checker_color, out)
    out = torch.where((tag == TEX_BITMAP)[:, None], bitmap_color, out)
    return out
