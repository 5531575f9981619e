"""Whole frames back to back: `ops/render.py::render_frame` with the
traffic's render settings, frame f drawing its uniforms from (seed, f,
chunk).

The check: for each of the traffic's `check.pixels` seeded pixels, a
seeded frame of the window, rendered again by the plain reference with
the same uniforms.  `pixels_off_pct` is the share of those pixels whose
largest channel differs by more than PIXEL_TOL.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pb import reference as ref
from pb.faults import patched
from pb.program import Work as Base
from pb.program import check_rng, label, render_settings, sync
from pb.uniforms import Source

BACKWARD = False
PIXEL_TOL = 1e-3      # linear color units
RAY_BLOCK = 8192      # primary rays the reference traces at once


class Work(Base):
    def setup(self) -> None:
        self._load()
        sched = self.traffic.get("scheduling")
        if sched is not None:
            from simd_raytracer_tpu_torch.parallel.tiles import SchedulingType
            sched = SchedulingType(sched)
        self.scheduling = sched
        h, w = self.scene.height, self.scene.width
        self.rays_per_unit = h * w * self.cfg.samples_per_pixel
        rng = check_rng(self.seed, 1)
        n = min(h * w, int(self.traffic["check"]["pixels"]))
        self.pixels = np.sort(rng.choice(h * w, size=n, replace=False))
        self._pix = torch.as_tensor(self.pixels, device=self.device)
        self.samples = {}
        with self.span("warm"):
            for _ in range(int(self.traffic.get("warm_units", 1))):
                self.unit()
        self.first_unit = self.next_unit
        self.begin()

    def begin(self) -> None:
        """Forget the answers and number the frames from the first after
        the warm-up."""
        self.samples = {}
        self.next_unit = self.first_unit

    def frame(self, f: int) -> torch.Tensor:
        from simd_raytracer_tpu_torch.ops.render import render_frame
        return render_frame(self.scene, self.cfg, device=self.device,
                            accel=self.accel, scheduling=self.scheduling,
                            uniforms=lambda c: self.source(f, c))

    def unit(self) -> float:
        f = self.next_unit
        self.next_unit += 1
        sync(self.device)
        t0 = time.perf_counter()
        with label("pb.frame"):
            img = self.frame(f)
        sync(self.device)
        dt = time.perf_counter() - t0
        self.samples[f] = img.reshape(-1, 3)[self._pix]
        return dt

    def answers(self) -> dict:
        """A seeded frame of the window for each sampled pixel, and the
        colors the program gave it there."""
        units = sorted(self.samples)
        pick = check_rng(self.seed, 2).integers(0, len(units),
                                                size=len(self.pixels))
        stack = torch.stack([self.samples[u] for u in units])
        rows = torch.arange(len(self.pixels), device=stack.device)
        got = stack[torch.as_tensor(pick, device=stack.device), rows]
        return {"pixels": self.pixels, "units": np.asarray(units)[pick],
                "colors": got.double().cpu().numpy()}

    def free(self) -> None:
        self.scene = self.accel = self.samples = None


def reference(doc, config, traffic, seed, device, dtype, got) -> np.ndarray:
    """(P, 3) colors of the sampled pixels in their frames."""
    scene = ref.RefScene(doc, device, dtype)
    s = ref.Settings(**render_settings(config, traffic))
    total = scene.height * scene.width * s.spp
    pos = ref.positions(ref.ray_order(scene, s, traffic.get("scheduling")),
                        total)
    pixels, units = got["pixels"], got["units"]
    ids = (np.asarray(pixels)[:, None] * s.spp + np.arange(s.spp)).reshape(-1)
    unit = np.repeat(np.asarray(units), s.spp)
    at = pos[ids]
    chunk, slot = at // s.chunk, at % s.chunk
    out = []
    with torch.no_grad():
        for b in range(0, len(ids), RAY_BLOCK):
            keys, group = np.unique(
                np.stack([unit[b:b + RAY_BLOCK], chunk[b:b + RAY_BLOCK]], 1),
                axis=0, return_inverse=True)
            draws = ref.Draws(
                lambda u, c: Source(seed, int(u), int(c), device, dtype),
                keys.tolist(),
                torch.as_tensor(group.reshape(-1), device=device),
                torch.as_tensor(slot[b:b + RAY_BLOCK], device=device),
                s.chunk)
            tid = torch.as_tensor(ids[b:b + RAY_BLOCK], device=device)
            out.append(ref.render_ids(scene, scene.params, s, tid, draws)
                       .double().cpu())
    colors = torch.cat(out).reshape(len(pixels), s.spp, 3)
    acc = colors[:, 0]
    for k in range(1, s.spp):
        acc = acc + colors[:, k]
    return (acc / s.spp).numpy()


def as_answers(got: dict, colors: np.ndarray) -> dict:
    """The program's answers with the colors of another renderer (the
    control) in their place."""
    return dict(got, colors=colors)


def compare(got: dict, want: np.ndarray) -> dict:
    err = np.abs(np.asarray(got["colors"]) - want).max(axis=1)
    err = np.where(np.isfinite(err), err, np.inf)
    return {"pixels_off_pct": float(100.0 * np.mean(err > PIXEL_TOL))}


def unchanged():
    """The frame's image left as it was allocated (zeros)."""
    def make(inner):
        def render_frame(scene, cfg, **kw):
            img = inner(scene, cfg, **kw)
            return torch.zeros_like(img)
        return render_frame
    return patched("ops.render", "render_frame", make)


def half_batch():
    """The second half of every chunk's rays left out."""
    def make(inner):
        def render_chunk(*a, **kw):
            out = inner(*a, **kw)
            out = out.clone()
            out[out.shape[0] // 2:] = 0
            return out
        return render_chunk
    return patched("ops.render", "render_chunk", make)


def altered():
    """One ray in 16 of every chunk brighter by 0.05 where it is shaded."""
    def make(inner):
        def render_chunk(*a, **kw):
            out = inner(*a, **kw).clone()
            out[::16] += 0.05
            return out
        return render_chunk
    return patched("ops.render", "render_chunk", make)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered": altered}
