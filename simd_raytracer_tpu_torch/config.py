"""Render configuration.

The same frozen dataclass as `simd_raytracer_tpu.config.RenderConfig`: the
same fields, defaults and validation, so one configuration means the same
render on both sides.  Fields that only steered XLA compilation
(`compact_factor`, `shadow_compact`, `bounce_skip`) are kept for API parity;
the eager PyTorch render compacts exactly with `nonzero` whatever they say.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render parameters.  Defaults mirror reference config.hpp:6-17."""

    fov_degrees: float = 90.0
    epsilon: float = 1e-6
    shadow_bias: float = 1e-4
    reflection_bias: float = 1e-4
    refraction_bias: float = 1e-4

    samples_per_pixel: int = 1
    max_ray_depth: int = 5
    diffuse_reflection_ray_count: int = 0

    # Seeds the render's torch.Generator; None draws from 0.
    rng_seed: Optional[int] = 42

    # Primary (pixel, sample) rays per chunk of the bounce loop.
    chunk_size: int = 16384
    # Shadow rays: "fast" is one any-hit query over the non-transmissive
    # triangles; "march" re-origins hop by hop through glass.
    occlusion_mode: str = "fast"
    max_shadow_march: int = 8
    # Select backend.  "jnp" and "pallas" both run the brute-force select
    # (the hand-written CUDA kernel on a GPU), "sweep" the block-sparse
    # slice sweep, "kdtree" the kd-tree walk (a CUDA kernel on a GPU; the
    # t_max window emulated through refine), "fast" the division-free
    # bilinear select (plain torch).  "mxu" is not ported.
    intersector: str = "jnp"
    # "split" follows the reference's full recursion tree; "roulette"
    # keeps one stochastically chosen child per ray.
    bounce_mode: str = "split"
    compact_factor: int = 4
    shadow_compact: bool = True
    # Ray-id order within a frame: "tiled" walks 32x32 pixel blocks so a
    # sweep ray tile covers a compact screen region; "auto" picks tiled for
    # the sweep and linear otherwise.
    ray_order: str = "auto"
    bounce_skip: bool = True

    def __post_init__(self):
        if self.occlusion_mode not in ("fast", "march"):
            raise ValueError(f"bad occlusion_mode {self.occlusion_mode!r}")
        if self.intersector not in ("jnp", "fast", "pallas", "mxu",
                                    "kdtree", "sweep"):
            raise ValueError(f"bad intersector {self.intersector!r}")
        if self.bounce_mode not in ("split", "roulette"):
            raise ValueError(f"bad bounce_mode {self.bounce_mode!r}")
        if self.ray_order not in ("auto", "linear", "tiled"):
            raise ValueError(f"bad ray_order {self.ray_order!r}")

    @property
    def child_slots(self) -> int:
        """Secondary-ray slots one ray keeps after a bounce: split keeps
        max(2, gi rays) (render.hpp:151-182, :278-301), roulette 1."""
        if self.bounce_mode == "roulette":
            return 1
        return max(2, self.diffuse_reflection_ray_count)


DEFAULT_CONFIG = RenderConfig()
