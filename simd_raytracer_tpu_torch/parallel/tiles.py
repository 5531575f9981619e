"""Tile scheduling: the reference's three schedules (NumPy).

Counterpart of `simd_raytracer_tpu.parallel.tiles`.  The reference builds
a queue of pixel-rect tiles and drains it with a thread pool (reference:
include/raytracer/render/tile/tile.hpp:5-16, single.hpp:7-13,
region.hpp:9-28, bucket.hpp:7-21, queue.hpp:9-51).  Here a schedule is an
ordered list of tiles whose (pixel, sample) ray ids stream into the
fixed-size chunks of the render loop (ops/render.py::make_ray_chunks);
the render is stateless per ray id, so the order changes which ids share
a chunk, not the estimator.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import List, Optional

import numpy as np


class SchedulingType(enum.Enum):
    """Mirror of the reference's scheduling_type enum (tile/tile.hpp:5-9)."""

    SINGLE = "single"
    REGION_GRID = "region_grid"
    BUCKET_TILES = "bucket_tiles"


@dataclasses.dataclass(frozen=True)
class RenderTile:
    """Half-open pixel rect [x0, x1) x [y0, y1) (tile/tile.hpp:11-16)."""

    x0: int
    y0: int
    x1: int
    y1: int

    @property
    def pixels(self) -> int:
        return (self.x1 - self.x0) * (self.y1 - self.y0)


def single_schedule(height: int, width: int) -> List[RenderTile]:
    """Whole image as one tile (tile/single.hpp:7-13)."""
    return [RenderTile(0, 0, width, height)]


def region_schedule(height: int, width: int,
                    workers: Optional[int] = None) -> List[RenderTile]:
    """sqrt(workers) x sqrt(workers) grid (tile/region.hpp:9-28).

    The reference uses hardware_concurrency(); here `workers` defaults to
    the CUDA device count (1 where there is no card), one region a card.
    """
    if workers is None:
        import torch
        workers = torch.cuda.device_count() or 1
    side = max(1, int(math.sqrt(workers)))
    tile_w = -(-width // side)
    tile_h = -(-height // side)
    return [RenderTile(x, y, min(x + tile_w, width), min(y + tile_h, height))
            for y in range(0, height, tile_h)
            for x in range(0, width, tile_w)]


def bucket_schedule(height: int, width: int, bucket: int
                    ) -> List[RenderTile]:
    """bucket x bucket tiles, row-major (tile/bucket.hpp:7-21) — the
    schedule main() always selects (src/main.cpp:17)."""
    bucket = max(1, bucket)
    return [RenderTile(x, y, min(x + bucket, width), min(y + bucket, height))
            for y in range(0, height, bucket)
            for x in range(0, width, bucket)]


def make_schedule(kind: SchedulingType, height: int, width: int,
                  bucket: int = 64,
                  workers: Optional[int] = None) -> List[RenderTile]:
    if kind == SchedulingType.SINGLE:
        return single_schedule(height, width)
    if kind == SchedulingType.REGION_GRID:
        return region_schedule(height, width, workers)
    if kind == SchedulingType.BUCKET_TILES:
        return bucket_schedule(height, width, bucket)
    raise ValueError(kind)


def tile_ray_ids(tile: RenderTile, width: int, spp: int) -> np.ndarray:
    """All (pixel, sample) ray ids of a tile, in pixel-major order.

    Global ray id convention matches ops.render: id = pixel * spp + s
    with pixel = y * width + x.
    """
    xs = np.arange(tile.x0, tile.x1)
    ys = np.arange(tile.y0, tile.y1)
    pix = (ys[:, None] * width + xs[None, :]).reshape(-1)
    ids = pix[:, None] * spp + np.arange(spp)[None, :]
    return ids.reshape(-1).astype(np.int32)


def schedule_to_chunks(tiles: List[RenderTile], width: int, spp: int,
                       chunk_size: int, total: int) -> np.ndarray:
    """Pack a tile schedule into a (C, chunk_size) int32 ray-id array.

    Tiles stream into fixed-size chunks in schedule order (the queue
    drain at render.hpp:95-101); the tail pads with `total` (an
    always-invalid id).
    """
    ids = np.concatenate([tile_ray_ids(t, width, spp) for t in tiles])
    c = -(-len(ids) // chunk_size)
    out = np.full(c * chunk_size, total, np.int32)
    out[:len(ids)] = ids
    return out.reshape(c, chunk_size)
