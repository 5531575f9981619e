"""Data-parallel rendering and SGD steps over torch.distributed.

Counterpart of `simd_raytracer_tpu.parallel.sharding`, which shards the
chunk axis over a 1-D `data` device mesh with shard_map.  Here each rank is
one process on one device (NCCL between cards, gloo between CPU
processes), the scene and the accelerator are replicated, and:

  * a frame deals its ray-id chunks round-robin, chunk c to rank c % n, as
    the JAX package does; chunk c draws its uniforms from a source keyed by
    c alone, so no chunk's estimator depends on the rank that renders it.
    The chunks' colors are gathered to every rank and folded into the
    image in chunk order by `ops/render.py::fold_chunk`: a pixel split
    between chunks adds its partial sums in one order whatever the number
    of ranks, so the sharded frame equals `render_frame` with the same
    per-chunk sources bit for bit (an all-reduce of per-rank pixel sums
    would add them in an order the collective sets);
  * an SGD step gives rank s row s of the (n, N) ray ids, all-reduces the
    loss and every gradient and divides them by n (JAX's pmean: a mean,
    not a sum), and applies the same update on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..config import RenderConfig
from ..models.scene import Scene
from ..ops.grad import loss_and_grad
from ..ops.render import (TorchUniforms, fold_frame, frame_setup,
                          render_chunk, resolve_device)
from ..utils.checkpoint import batch_seed


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The 1-D data axis: this process's rank among `size` ranks of the
    default process group, and the device it renders on."""

    rank: int
    size: int
    device: torch.device


def init_distributed(device="cuda", **kwargs) -> None:
    """torch.distributed.init_process_group with the backend of `device`:
    NCCL on the card (rank r on card r % cards), gloo on the CPU
    (device="cpu").  kwargs go to init_process_group (init_method,
    world_size, rank, ...; by default the env:// rendezvous of
    MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK)."""
    dev = resolve_device(device)
    kwargs.setdefault("backend", "nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(**kwargs)
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """The mesh of every rank of the initialised process group, on `device`
    (the card unless the caller asks for "cpu"); n_devices, where given,
    must be that group's size."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed first")
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a mesh spans the {size} ranks of the process "
                         f"group, not {n_devices}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(rank=dist.get_rank(), size=size, device=dev)


def chunk_uniforms(cfg: RenderConfig, device, dtype
                   ) -> Callable[[int], TorchUniforms]:
    """The default uniforms of a sharded frame: chunk c draws from a
    torch.Generator on `device` seeded from (cfg.rng_seed, c) alone
    (utils/checkpoint.py::batch_seed).  Pass it to render_frame's
    `uniforms=` to render the same frame in one process."""
    seed = cfg.rng_seed if cfg.rng_seed is not None else 0
    return lambda c: TorchUniforms.seeded(batch_seed(seed, c), device, dtype)


def render_frame_sharded(scene: Scene, cfg: RenderConfig,
                         mesh: Optional[Mesh] = None, *, device="cuda",
                         accel=None,
                         uniforms: Optional[Callable[[int], object]] = None
                         ) -> torch.Tensor:
    """Full-frame render with the chunks dealt over the mesh's ranks ->
    the (H, W, 3) image on every rank.

    mesh: by default every rank of the initialised group, on `device`.
    accel: as render_frame's (built from the scene on every rank when
    None).  uniforms: chunk index -> uniform source (chunk_uniforms by
    default)."""
    if mesh is None:
        mesh = make_mesh(device=device)
    scene, accel, geom, ids = frame_setup(scene, cfg, mesh.device, accel)
    if uniforms is None:
        uniforms = chunk_uniforms(cfg, mesh.device, scene.vertices.dtype)
    n_chunks, r0 = ids.shape
    n = mesh.size
    # Slot j of rank s holds chunk j * n + s; slots past the last chunk
    # stay zero (all_gather takes equal shapes) and are never folded.
    mine = torch.zeros((-(-n_chunks // n), r0, 3),
                       dtype=scene.vertices.dtype, device=mesh.device)
    for j in range(mine.shape[0]):
        c = j * n + mesh.rank
        if c < n_chunks:
            mine[j] = render_chunk(scene, geom, cfg, ids[c], uniforms(c),
                                   accel)
    parts = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(parts, mine)
    return fold_frame(scene, cfg, ids, lambda c: parts[c % n][c // n])


def train_step_sharded(params, skeleton: Scene, cfg: RenderConfig,
                       mesh: Optional[Mesh], ids, target, seeds,
                       lr: float = 1e-2, accel=None, *,
                       uniforms: Optional[Callable[[int], object]] = None):
    """One data-parallel SGD step -> (new params, mean loss), the same on
    every rank.

    ids (n, N) ray ids, target (n, N, 3) colors and seeds (n, 1): rank s
    takes row s and draws from uniforms(seeds[s, 0]) (by default a
    torch.Generator seeded with that seed).  Params and skeleton lie on
    the mesh's device, replicated.  The loss and every gradient are
    all-reduced and divided by n before the update p - lr * g."""
    if mesh is None:
        mesh = make_mesh(device=params["vertices"].device)
    if len(ids) != mesh.size:
        raise ValueError(f"ids has {len(ids)} rows for {mesh.size} ranks")
    s, dev = mesh.rank, mesh.device
    seed = int(seeds[s][0])
    source = (uniforms(seed) if uniforms is not None else
              TorchUniforms.seeded(seed, dev, params["vertices"].dtype))
    loss, grads = loss_and_grad(
        params, skeleton, cfg, torch.as_tensor(ids[s], device=dev),
        torch.as_tensor(target[s], device=dev), source, accel)
    grads = {k: g.contiguous() for k, g in grads.items()}
    for t in (loss, *grads.values()):
        dist.all_reduce(t)
    with torch.no_grad():
        new = {k: p - lr * (grads[k] / mesh.size) for k, p in params.items()}
    return new, loss / mesh.size
