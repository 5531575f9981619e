"""The program under test, driven by a traffic mix.

The traffic file's `kind` names the general generator of its work, the
file `perfbench/kinds/<kind>.py` (found by pb/spec.py): "frames" renders
whole frames back to back, "sgd_steps" runs `ops/grad.py::train_step` on a
fixed batch of ray ids.  A kind's `Work` builds its state in `setup`,
warms up the shapes it will use, is put at the start of its window by
`begin`, runs one unit of work per `unit()` (host seconds, ending in a
device synchronize) and, once the window has closed, hands the answers it
owes to the check through `answers()`.  The port is imported here and in
the kinds, nowhere else in the harness.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import numpy as np
import torch

from . import scenes, spec
from .uniforms import Source


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def render_settings(config: dict, traffic: dict) -> dict:
    """The configuration's render settings under the traffic's own."""
    return {**config.get("render", {}), **traffic.get("render", {})}


def check_rng(seed: int, salt: int) -> np.random.Generator:
    return np.random.default_rng([abs(int(seed)), salt])


@contextmanager
def label(name: str):
    with torch.profiler.record_function(name):
        yield


class Work:
    """What every kind shares: the scene document, the port's scene and
    render configuration, the accelerator, and set-up spans."""

    rays_per_unit = 0

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.doc = scenes.scene_doc(config)
        self.render = render_settings(config, traffic)
        self.spans = {}
        self.next_unit = 0

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        with label(f"pb.setup.{name}"):
            yield
        sync(self.device)
        self.spans[name] = time.perf_counter() - t0

    def _load(self):
        import simd_raytracer_tpu_torch as T
        from simd_raytracer_tpu_torch.ops.render import build_accel
        with self.span("load"):
            scene = T.parse_scene_dict(self.doc)
            self.cfg = T.RenderConfig(**self.render)
        with self.span("accel_build"):
            accel = build_accel(scene, self.cfg)
            self.accel = None if accel is None else accel.to(self.device)
        self.has_accel = accel is not None
        with self.span("to_device"):
            self.scene = scene.to(self.device)

    def source(self, unit: int, chunk: int) -> Source:
        return Source(self.seed, unit, chunk, self.device)


def make(config: dict, traffic: dict, seed: int, device) -> Work:
    return spec.kind(traffic["kind"]).Work(config, traffic, seed, device)
