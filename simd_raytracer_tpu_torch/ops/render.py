"""Frame rendering: chunked wavefront path tracing in eager PyTorch.

Counterpart of `simd_raytracer_tpu.ops.render`.  (pixel, sample) pairs are
flattened into one ray-id axis and cut into chunks of `chunk_size`; each
chunk runs the bounce loop over a flat ray buffer.  Under "split" the buffer
widens by the child-slot factor K per bounce and the children of slot s sit
at s*K .. s*K+K-1, so a bounce's contribution folds back to its primary ray
with a reshape-sum.  Each bounce runs only on the live rays, gathered
exactly with `nonzero`; dead rays contribute nothing, so this changes cost,
not values.

Randomness comes from an injectable source (see `TorchUniforms`): the spp
jitter (r0, 2), each roulette bounce's coin (n,) and each bounce's diffuse
GI uniforms (n, gi, 2) are drawn at the full wavefront width and indexed
by slot, so compaction cannot change them.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..config import RenderConfig
from ..models.camera import primary_rays
from ..models.scene import Geometry, Scene, derive_geometry
from .intersect import make_select_fn, trace
from .select_keys import check_eps
from .shade import shade

# Screen-block edge of the tiled ray order: a 512-ray sweep tile stays in
# one 32x32 block at spp <= 2.
TILE_BLOCK = 32


class TorchUniforms:
    """Uniforms for a render, drawn from one torch.Generator on the
    render's device.  An injected source has the same three methods."""

    def __init__(self, generator: torch.Generator, device, dtype):
        self.generator = generator
        self.device = device
        self.dtype = dtype

    def jitter(self, n: int) -> torch.Tensor:
        """(n, 2) subpixel offsets for spp > 1."""
        return torch.rand((n, 2), generator=self.generator,
                          device=self.device, dtype=self.dtype)

    def coin(self, depth: int, n: int) -> torch.Tensor:
        """(n,) roulette coins of bounce `depth`."""
        return torch.rand((n,), generator=self.generator,
                          device=self.device, dtype=self.dtype)

    def gi(self, depth: int, n: int, count: int) -> torch.Tensor:
        """(n, count, 2) diffuse GI uniforms of bounce `depth`."""
        return torch.rand((n, count, 2), generator=self.generator,
                          device=self.device, dtype=self.dtype)


def resolve_device(device) -> torch.device:
    """torch.device(device), raising where it names CUDA and there is no
    card: the entry points default to "cuda" and never fall back to the
    CPU (CPU callers pass device="cpu")."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r}: no CUDA device here; "
                           f"pass device='cpu' to run on the CPU")
    return dev


def check_supported(cfg: RenderConfig) -> None:
    """Raise NotImplementedError for configurations not ported yet, and
    ValueError for a negative epsilon (the selects' key merge needs t >= 0)
    on every device."""
    check_eps(cfg.epsilon)
    if cfg.intersector not in ("sweep", "kdtree"):
        make_select_fn(cfg.intersector)   # raises for the unported ones


def _scatter_rows(n: int, idx: torch.Tensor, vals: torch.Tensor,
                  fill=0.0) -> torch.Tensor:
    out = torch.full((n,) + tuple(vals.shape[1:]), fill, dtype=vals.dtype,
                     device=vals.device)
    return out.index_put((idx,), vals)


def render_chunk(scene: Scene, geom: Geometry, cfg: RenderConfig,
                 ray_ids: torch.Tensor, uniforms, accel=None,
                 occupancy: Optional[list] = None) -> torch.Tensor:
    """Render one chunk of global (pixel, sample) ray ids -> (R0, 3) colors.

    Ids >= H*W*spp are padding and contribute zero.  `uniforms` has
    `jitter(n)`, `coin(depth, n)` and `gi(depth, n, count)` (TorchUniforms
    or an injected source).  occupancy: a list that receives the number of
    live rays entering each bounce (utils/profiling.py::
    wavefront_occupancy).
    """
    check_supported(cfg)
    r0 = ray_ids.shape[0]
    spp = cfg.samples_per_pixel
    h, w = scene.height, scene.width
    total = h * w * spp
    dtype = scene.vertices.dtype
    dev = scene.vertices.device

    ray_ids = ray_ids.to(dev)
    valid = ray_ids < total
    ids = ray_ids.clamp_max(total - 1).long()
    pix = ids // spp
    pix_y = pix // w
    pix_x = pix % w
    if spp == 1:
        jx = jy = torch.full((r0,), 0.5, dtype=dtype, device=dev)
    else:
        jxy = torch.as_tensor(uniforms.jitter(r0), dtype=dtype, device=dev)
        jx, jy = jxy[:, 0], jxy[:, 1]

    o, d = primary_rays(scene, cfg.fov_degrees, pix_x, pix_y, jx, jy)
    weight = valid.to(dtype)
    miss_bg = torch.ones(r0, dtype=torch.bool, device=dev)
    accum = torch.zeros((r0, 3), dtype=dtype, device=dev)
    bg = scene.background
    gi_count = cfg.diffuse_reflection_ray_count

    for depth in range(cfg.max_ray_depth + 1):
        last = depth == cfg.max_ray_depth
        n_cur = weight.shape[0]
        coin = rnd_gi = None
        if cfg.bounce_mode == "roulette" and not last:
            coin = torch.as_tensor(uniforms.coin(depth, n_cur), dtype=dtype,
                                   device=dev)
        if gi_count > 0 and not last:
            rnd_gi = torch.as_tensor(uniforms.gi(depth, n_cur, gi_count),
                                     dtype=dtype, device=dev)
        alive = (weight > 0.0).nonzero()[:, 0]
        if occupancy is not None:
            occupancy.append(alive.numel())
        if alive.numel() == 0:
            break

        o_c, d_c, w_c, bg_c = o[alive], d[alive], weight[alive], miss_bg[alive]
        hit = trace(o_c, d_c, scene, geom, cfg.epsilon, cull=(depth == 0),
                    intersector=cfg.intersector, accel=accel)
        contrib = (w_c * (~hit.mask & bg_c).to(dtype))[:, None] * bg
        if last:
            # Depth cutoff returns the background (render.hpp:138-139).
            contrib = contrib + (w_c * hit.mask.to(dtype))[:, None] * bg
        else:
            shade_c, (co, cd, cw, cbg) = shade(
                scene, geom, hit, d_c, w_c, cfg, accel,
                rnd_coin=None if coin is None else coin[alive],
                rnd_gi=None if rnd_gi is None else rnd_gi[alive])
            contrib = contrib + shade_c
        accum = accum + _scatter_rows(n_cur, alive, contrib).reshape(
            r0, -1, 3).sum(dim=1)
        if last:
            break

        # Children back into the slot layout; the slots of dead rays stay
        # zero-weight and are never traced.
        k = cfg.child_slots
        cidx = (alive[:, None] * k + torch.arange(k, device=dev)).reshape(-1)
        o = _scatter_rows(n_cur * k, cidx, co)
        d = _scatter_rows(n_cur * k, cidx, cd)
        weight = _scatter_rows(n_cur * k, cidx, cw)
        miss_bg = _scatter_rows(n_cur * k, cidx, cbg, fill=False)
    return accum


def resolved_ray_order(cfg: RenderConfig) -> str:
    if cfg.ray_order != "auto":
        return cfg.ray_order
    return "tiled" if cfg.intersector == "sweep" else "linear"


def _tiled_ids(h: int, w: int, spp: int, block: int = TILE_BLOCK
               ) -> np.ndarray:
    """Ray ids ordered by whole (padded) screen blocks; out-of-image
    pixels carry the invalid id h*w*spp."""
    nby, nbx = -(-h // block), -(-w // block)
    by, bx, iy, ix = np.ogrid[0:nby, 0:nbx, 0:block, 0:block]
    y = by * block + iy
    x = bx * block + ix
    pix = (y * w + x).astype(np.int64)
    valid = (y < h) & (x < w)
    ids = pix[..., None] * spp + np.arange(spp, dtype=np.int64)
    ids = np.where(valid[..., None], ids, h * w * spp)
    return ids.reshape(-1)


def make_ray_chunks(scene: Scene, cfg: RenderConfig,
                    scheduling=None) -> np.ndarray:
    """(C, R0) int32 ray ids covering H*W*spp, padded with invalid ids.

    scheduling: None (cfg.ray_order: linear pixel order or 32x32-block
    tiled order) or a parallel.tiles.SchedulingType, the reference's tile
    orders (single, region grid, bucket tiles; tile/*.hpp) with the scene's
    bucket size.  A region grid has one region per CUDA device when the
    scene lies on a card, one otherwise.  The estimator is the same in
    every order; the order moves which ids share a chunk."""
    total = scene.height * scene.width * cfg.samples_per_pixel
    r0 = cfg.chunk_size
    if scheduling is not None:
        from ..parallel.tiles import make_schedule, schedule_to_chunks
        workers = (torch.cuda.device_count() if scene.vertices.is_cuda
                   else 1)
        tiles = make_schedule(scheduling, scene.height, scene.width,
                              bucket=scene.bucket_size, workers=workers)
        return schedule_to_chunks(tiles, scene.width,
                                  cfg.samples_per_pixel, r0, total)
    if resolved_ray_order(cfg) == "tiled":
        ids = _tiled_ids(scene.height, scene.width, cfg.samples_per_pixel)
        c = -(-ids.size // r0)
        pad = np.full(c * r0 - ids.size, total, np.int64)
        return np.concatenate([ids, pad]).astype(np.int32).reshape(c, r0)
    c = -(-total // r0)
    return np.arange(c * r0, dtype=np.int32).reshape(c, r0)


def build_accel(scene: Scene, cfg: RenderConfig):
    """The accelerator cfg.intersector needs, built from the scene on the
    host (CPU tensors): a KdTree for "kdtree" (the reference builds its
    kd_tree_simd_accel once per run, src/main.cpp:41), SweepData for
    "sweep", None otherwise."""
    if cfg.intersector == "kdtree":
        from ..accel.build import build_kdtree_for_scene
        return build_kdtree_for_scene(scene)
    if cfg.intersector == "sweep":
        from ..accel.sweep import build_sweep_for_scene
        return build_sweep_for_scene(scene)
    return None


def render_frame(scene: Scene, cfg: RenderConfig = RenderConfig(), *,
                 device="cuda", accel=None,
                 uniforms: Optional[Callable[[int], object]] = None,
                 scheduling=None) -> torch.Tensor:
    """Full-frame render on `device` (the card unless the caller asks for
    "cpu") -> (H, W, 3) linear color.

    accel: KdTree for intersector="kdtree", SweepData for "sweep" (built
    from the scene when None).  uniforms: chunk index -> uniform source
    for that chunk; by default one torch.Generator on `device`, seeded
    with cfg.rng_seed, serves every chunk in order.  scheduling: a
    parallel.tiles.SchedulingType to walk the image in the reference's
    tile order (see make_ray_chunks)."""
    check_supported(cfg)
    dev = resolve_device(device)
    scene = scene.to(dev)
    if accel is None:
        accel = build_accel(scene, cfg)
    if accel is not None:
        accel = accel.to(dev)
    geom = derive_geometry(scene)
    dtype = scene.vertices.dtype
    if uniforms is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(cfg.rng_seed if cfg.rng_seed is not None else 0)
        source = TorchUniforms(gen, dev, dtype)
        uniforms = lambda chunk: source   # noqa: E731

    h, w, spp = scene.height, scene.width, cfg.samples_per_pixel
    total = h * w * spp
    ids = torch.from_numpy(make_ray_chunks(scene, cfg, scheduling)).to(dev)
    accum = torch.zeros((h * w, 3), dtype=dtype, device=dev)
    for c in range(ids.shape[0]):
        chunk = ids[c]
        colors = render_chunk(scene, geom, cfg, chunk, uniforms(c), accel)
        valid = (chunk < total).nonzero()[:, 0]
        accum.index_add_(0, chunk[valid].long() // spp, colors[valid])
    return (accum / spp).reshape(h, w, 3)
