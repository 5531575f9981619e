"""Spans, counters, per-phase timing, device traces and wavefront
occupancy.

Counterpart of `simd_raytracer_tpu.utils.profiling`.  The reference times
one thing, the whole frame (src/main.cpp:16-21); this module reports
per-phase wall time (load, accel build, first call, render), primary rays
per second, per-bounce live-ray counts, and wraps any phase in a
torch.profiler trace.  On the card every timed phase ends in
torch.cuda.synchronize(), so it measures the work and not its enqueue.

The port's layers record into one record of spans and counters:

  * `span(name)` (or the `spanned(name)` decorator) times a block on the
    host: its calls, total and self nanoseconds (the total less its child
    spans'), and under a running torch profiler a `record_function` range
    `srt.<name>` on the profiler's timeline, the clock of the device's
    kernels;
  * `count(name, n)` adds to a counter.

Both record only while tracing is on: while a torch profiler records, or
inside a `recording()` block.  Off, a span or a counter costs one check
and never enters `record_function` (which costs about ten microseconds even
with no profiler running).  `record()` returns what the current record
holds and `reset()` clears it; the kd kernel's device counters are read
there, once.  The record is the process's and takes no lock: spans and
counters come from the thread that renders.

Set-up phases (`load`, `kernel_library`, `native_library`,
`accel_build`) happen once a process and always record, into the
process-wide PhaseTimer `SETUP`.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import os
import time
from typing import Dict, Optional

import torch


def _sync_cuda() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class PhaseTimer:
    """Collects named wall-time phases; re-entering a name accumulates.

    A phase ends in a synchronize of the current CUDA device once CUDA is
    initialized, so it times the work and not its enqueue.  A phase opened
    inside another is charged to itself alone: the enclosing phase keeps
    only its own time, so the phases add up to the wall time they cover
    (a parse that builds the native library charges the build to
    `native_library`, not to `load`)."""

    def __init__(self) -> None:
        self.seconds: Dict[str, float] = {}
        self._inner: list = []     # seconds of the phases inside each open one

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        self._inner.append(0.0)
        try:
            yield
            _sync_cuda()
        finally:
            dt = time.perf_counter() - t0
            inner = self._inner.pop()
            self.seconds[name] = self.seconds.get(name, 0.0) + dt - inner
            if self._inner:
                self._inner[-1] += dt

    def report(self) -> str:
        width = max((len(k) for k in self.seconds), default=0)
        return "\n".join(f"{k.ljust(width)}  {v:10.4f} s"
                         for k, v in self.seconds.items())


# Set-up phases of this process: load (models/loader.py), kernel_library
# (kernels.library), native_library (native._load), accel_build
# (ops/render.py::build_accel).
SETUP = PhaseTimer()

# The kd kernel's device counter (ops/intersect_kd.py::kd_select_cuda):
# triangles staged, pair slots its leaf rounds ran, pair tests run.
KD_COUNTS = ("kd.staged", "kd.slots", "kd.tests")


class Record:
    """Spans and counters recorded while tracing is on.

    spans: name -> [calls, total ns, self ns]; counts: a Counter (a name
    never counted reads 0); the kd kernel's int64 (3,) counter tensors,
    one a CUDA device, read by `read()`."""

    def __init__(self) -> None:
        self.clear()

    def clear(self) -> None:
        self.spans: Dict[str, list] = {}
        self.counts = collections.Counter()
        self.kd: Dict[torch.device, torch.Tensor] = {}

    def kd_counter(self, device: torch.device) -> torch.Tensor:
        c = self.kd.get(device)
        if c is None:
            c = self.kd[device] = torch.zeros(3, dtype=torch.int64,
                                              device=device)
        return c

    def merge(self, other: "Record") -> None:
        for name, (calls, total, own) in other.spans.items():
            s = self.spans.setdefault(name, [0, 0, 0])
            s[0] += calls
            s[1] += total
            s[2] += own
        self.counts.update(other.counts)
        for dev, c in other.kd.items():
            self.kd[dev] = c if dev not in self.kd else self.kd[dev] + c

    def read(self) -> dict:
        """{"spans": {name: {"calls", "total_s", "self_s"}}, "counts":
        {name: n}}, the kd kernel's counters read from the device."""
        counts = dict(self.counts)
        for c in self.kd.values():
            for name, n in zip(KD_COUNTS, c.tolist()):
                counts[name] = counts.get(name, 0) + n
        return {"spans": {k: {"calls": c, "total_s": t * 1e-9,
                              "self_s": s * 1e-9}
                          for k, (c, t, s) in self.spans.items()},
                "counts": counts}


_records = [Record()]    # the process-wide record, then open recording()s
_open: list = []         # open spans, innermost last


def tracing() -> bool:
    """Whether spans and counters record: a torch profiler is recording,
    or a recording() block is open."""
    return len(_records) > 1 or torch.autograd._profiler_enabled()


@contextlib.contextmanager
def recording():
    """Turn tracing on for the block and yield a fresh Record of it; on
    exit its spans and counts are added to the enclosing record."""
    rec = Record()
    _records.append(rec)
    try:
        yield rec
    finally:
        _records.remove(rec)
        _records[-1].merge(rec)


def record() -> dict:
    """What the current record holds since reset() (Record.read)."""
    return _records[-1].read()


def reset() -> None:
    """Empty the current record."""
    _records[-1].clear()


class _Span:
    __slots__ = ("name", "rf", "t0", "inner")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        self.inner = 0
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function("srt." + self.name)
            self.rf.__enter__()
        _open.append(self)
        return self

    def __exit__(self, *exc):
        _open.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        total = time.perf_counter_ns() - self.t0
        s = _records[-1].spans.setdefault(self.name, [0, 0, 0])
        s[0] += 1
        s[1] += total
        s[2] += total - self.inner
        if _open:
            _open[-1].inner += total
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records the block as span `name` while
    tracing is on, and does nothing else otherwise."""
    return _Span(name) if tracing() else _OFF


def spanned(name: str):
    """Decorator: while tracing, every call of the function is span
    `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not tracing():
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add n to counter `name` while tracing is on."""
    if tracing():
        _records[-1].counts[name] += n


def kd_counter(device: torch.device) -> Optional[torch.Tensor]:
    """The current record's kd kernel counter for a CUDA `device` while
    tracing is on; None otherwise (the kernel then counts nothing)."""
    if device.type != "cuda" or not tracing():
        return None
    return _records[-1].kd_counter(device)


def format_record(data: dict) -> str:
    """A table of record() data: spans by self milliseconds, then the
    counters."""
    spans = sorted(data["spans"].items(), key=lambda kv: -kv[1]["self_s"])
    lines = [f"{'span':<16}{'calls':>10}{'self ms':>12}{'total ms':>12}"]
    lines += [f"{k:<16}{v['calls']:>10}{1e3 * v['self_s']:>12.3f}"
              f"{1e3 * v['total_s']:>12.3f}" for k, v in spans]
    width = max((len(k) for k in data["counts"]), default=0)
    lines += [f"{k.ljust(width)}  {v}"
              for k, v in sorted(data["counts"].items())]
    return "\n".join(lines)


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
    entries; zeros once the wavefront has died), the chunk's
    `render.live.d<d>` counters.  uniforms: the chunk's
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
    with recording() as rec:
        render_chunk(scene, derive_geometry(scene), cfg,
                     torch.as_tensor(ray_ids, device=dev), uniforms, accel)
    return [rec.counts[f"render.live.d{k}"]
            for k in range(cfg.max_ray_depth + 1)]


def profile_render(scene_path: str, cfg=None, scale: float = 1.0,
                   repeats: int = 3, trace_dir: Optional[str] = None,
                   backward: bool = False, *, device="cuda") -> dict:
    """Phase-timed render of a scene file on `device` (the card unless the
    caller asks for "cpu") -> a metrics dict.

    Phases: load, accel_build (kdtree and sweep), first_call (the kernel
    build and a first frame), render (the best of `repeats` warm frames,
    under device_trace when trace_dir is given).  rays_per_sec = H*W*spp /
    render seconds.  spans, counts: the record() of the warm frames, the
    ones the trace holds.  With backward=True, one loss_and_grad step on the
    first min(H*W, chunk_size) ray ids against a zero target is timed too:
    grad_compile (the first, cold step), grad_seconds (the best of
    `repeats` warm steps) and grad_rays_per_sec (ids / grad_seconds)."""
    from ..config import RenderConfig
    from ..models.loader import parse_scene_file
    from ..ops.render import (TorchUniforms, build_accel, needs_accel,
                              render_frame, resolve_device)

    cfg = cfg or RenderConfig()
    dev = resolve_device(device)
    timer = PhaseTimer()

    with timer.phase("load"):
        scene = parse_scene_file(scene_path)
        if scale != 1.0:
            scene = scene.replace(height=max(8, int(scene.height * scale)),
                                  width=max(8, int(scene.width * scale)))

    accel = None
    if needs_accel(cfg):
        with timer.phase("accel_build"):
            accel = build_accel(scene, cfg)

    scene = scene.to(dev)
    with timer.phase("first_call"):
        render_frame(scene, cfg, device=dev, accel=accel)
        _sync(dev)

    best = float("inf")
    with device_trace(trace_dir), recording() as rec:
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
    metrics.update(rec.read())

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
