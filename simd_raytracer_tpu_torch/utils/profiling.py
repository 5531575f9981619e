"""Per-phase timing, device traces and wavefront occupancy.

Counterpart of `simd_raytracer_tpu.utils.profiling`.  The reference times
one thing, the whole frame (src/main.cpp:16-21); this module reports
per-phase wall time (load, accel build, first call, render), primary rays
per second, per-bounce live-ray counts, and wraps any phase in a
torch.profiler trace.  On the card every timed phase ends in
torch.cuda.synchronize(), so it measures the work and not its enqueue.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


class PhaseTimer:
    """Collects named wall-time phases; re-entering a name accumulates."""

    def __init__(self) -> None:
        self.seconds: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t0)

    def report(self) -> str:
        width = max((len(k) for k in self.seconds), default=0)
        return "\n".join(f"{k.ljust(width)}  {v:10.4f} s"
                         for k, v in self.seconds.items())


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """torch.profiler over the block (CPU, and CUDA where there is a
    card), written as a Chrome trace to `log_dir`/trace.json; a no-op
    when log_dir is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def wavefront_occupancy(scene, cfg, ray_ids, uniforms=None, accel=None, *,
                        device="cuda"):
    """Per-bounce live-ray counts of one chunk of ray ids: entry d is how
    many rays enter bounce d with nonzero throughput (max_ray_depth + 1
    entries; zeros once the wavefront has died).  uniforms: the chunk's
    uniform source (by default a torch.Generator seeded with
    cfg.rng_seed)."""
    from ..models.scene import derive_geometry
    from ..ops.render import (TorchUniforms, build_accel, render_chunk,
                              resolve_device)

    dev = resolve_device(device)
    scene = scene.to(dev)
    if accel is None:
        accel = build_accel(scene, cfg)
    if accel is not None:
        accel = accel.to(dev)
    if uniforms is None:
        uniforms = TorchUniforms.seeded(
            cfg.rng_seed if cfg.rng_seed is not None else 0, dev,
            scene.vertices.dtype)
    counts: list = []
    render_chunk(scene, derive_geometry(scene), cfg,
                 torch.as_tensor(ray_ids, device=dev), uniforms, accel,
                 occupancy=counts)
    return counts + [0] * (cfg.max_ray_depth + 1 - len(counts))


def profile_render(scene_path: str, cfg=None, scale: float = 1.0,
                   repeats: int = 3, trace_dir: Optional[str] = None,
                   backward: bool = False, *,
                   device="cuda") -> Dict[str, float]:
    """Phase-timed render of a scene file on `device` (the card unless the
    caller asks for "cpu") -> a metrics dict.

    Phases: load, accel_build (kdtree and sweep), first_call (the kernel
    build and a first frame), render (the best of `repeats` warm frames,
    under device_trace when trace_dir is given).  rays_per_sec = H*W*spp /
    render seconds.  With backward=True, one loss_and_grad step on the
    first min(H*W, chunk_size) ray ids against a zero target is timed too:
    grad_compile (the first, cold step), grad_seconds (the best of
    `repeats` warm steps) and grad_rays_per_sec (ids / grad_seconds)."""
    from ..config import RenderConfig
    from ..models.loader import parse_scene_file
    from ..ops.render import (TorchUniforms, build_accel, render_frame,
                              resolve_device)

    cfg = cfg or RenderConfig()
    dev = resolve_device(device)
    timer = PhaseTimer()

    with timer.phase("load"):
        scene = parse_scene_file(scene_path)
        if scale != 1.0:
            scene = scene.replace(height=max(8, int(scene.height * scale)),
                                  width=max(8, int(scene.width * scale)))

    accel = None
    if cfg.intersector in ("kdtree", "sweep"):
        with timer.phase("accel_build"):
            accel = build_accel(scene, cfg)

    scene = scene.to(dev)
    with timer.phase("first_call"):
        render_frame(scene, cfg, device=dev, accel=accel)
        _sync(dev)

    best = float("inf")
    with device_trace(trace_dir):
        for _ in range(repeats):
            t0 = time.perf_counter()
            render_frame(scene, cfg, device=dev, accel=accel)
            _sync(dev)
            best = min(best, time.perf_counter() - t0)
    timer.seconds["render"] = best

    metrics = dict(timer.seconds)
    metrics["rays_per_sec"] = (scene.height * scene.width
                               * cfg.samples_per_pixel / best)
    metrics["height"] = scene.height
    metrics["width"] = scene.width
    metrics["spp"] = cfg.samples_per_pixel

    if backward:
        from ..ops.grad import loss_and_grad, split_params

        params, skeleton = split_params(scene)
        n = min(scene.height * scene.width, cfg.chunk_size)
        ids = torch.arange(n, dtype=torch.int32, device=dev)
        target = torch.zeros((n, 3), dtype=scene.vertices.dtype, device=dev)
        acc = None if accel is None else accel.to(dev)

        def step():
            loss_and_grad(params, skeleton, cfg, ids, target,
                          TorchUniforms.seeded(0, dev, scene.vertices.dtype),
                          acc)
            _sync(dev)

        with timer.phase("grad_compile"):
            step()
        best_g = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            step()
            best_g = min(best_g, time.perf_counter() - t0)
        metrics["grad_seconds"] = best_g
        metrics["grad_rays_per_sec"] = n / best_g
        metrics["grad_compile"] = timer.seconds["grad_compile"]
    return metrics
