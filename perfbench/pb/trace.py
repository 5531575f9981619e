"""The traced run: torch.profiler over a few units of work, host labels
from outside the program, and the reduction from the trace to what the
per-layer readers and the `breakdown` read.

Host labels: the harness's own spans (`pb.frame`, `pb.step`, set-up
spans) and, in the traced run only, `record_function` wrappers that the
harness puts around the port's layer entry points (WRAPPED).  A name the
port no longer has is skipped.
"""

from __future__ import annotations

import functools
import importlib
import time
from contextlib import contextmanager

import torch

PORT = "simd_raytracer_tpu_torch"
# (attribute, label): the port's layer entry points.  Every module in
# MODULES that binds the attribute gets the wrapper, since the port
# imports some of them by name.
WRAPPED = (("frame_setup", "pb.frame_setup"),
           ("render_chunk", "pb.render_chunk"),
           ("fold_frame", "pb.fold_frame"),
           ("trace", "pb.trace"),
           ("shade", "pb.shade"),
           ("loss_and_grad", "pb.loss_and_grad"))
MODULES = ("ops.render", "ops.grad", "ops.shade", "ops.intersect")
SELECT_FACTORY = "make_select_fn"


def _labelled(fn, name):
    @functools.wraps(fn)
    def call(*a, **k):
        with torch.profiler.record_function(name):
            return fn(*a, **k)
    return call


def _select_factory(make):
    @functools.wraps(make)
    def build(*a, **k):
        return _labelled(make(*a, **k), "pb.select")
    return build


@contextmanager
def wrappers():
    """Label the port's layer entry points for the length of the block."""
    undo = []
    for mod_name in MODULES:
        try:
            mod = importlib.import_module(f"{PORT}.{mod_name}")
        except ImportError:
            continue
        for attr, name in WRAPPED:
            fn = getattr(mod, attr, None)
            if callable(fn):
                undo.append((mod, attr, fn))
                setattr(mod, attr, _labelled(fn, name))
        make = getattr(mod, SELECT_FACTORY, None)
        if callable(make):
            undo.append((mod, SELECT_FACTORY, make))
            setattr(mod, SELECT_FACTORY, _select_factory(make))
    try:
        yield
    finally:
        for mod, attr, fn in reversed(undo):
            setattr(mod, attr, fn)


def traced_window(work, units: int, backward: bool) -> dict:
    """Run `units` units of `work` under torch.profiler -> the trace's
    reduction (see reduce), with the backward's device seconds where
    `backward` asks for them (building the profiler's op tree is slow on
    a frame's many ops)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with wrappers(), profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function("pb.window"):
            for _ in range(units):
                work.unit()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    out = reduce(prof.profiler.kineto_results.events())
    out["backward_s"] = (backward_seconds(prof.events()) if backward
                         else None)
    out.update(window_s=window_s, units=units)
    return out


def _annotation(e) -> bool:
    is_user = getattr(e, "is_user_annotation", None)
    return (is_user is not None and is_user()) or e.name().startswith("pb.")


def short_name(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    name = name.removeprefix("void ")
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and not name.startswith("(anonymous", i):
            return name[:i].rstrip()[:160]
    return name[:160]


def _merge(spans):
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce(events) -> dict:
    """Device busy seconds (the union of every device event's interval),
    device seconds and launches by kernel name, and the device's idle
    time inside the `pb.window` span, named by the innermost host label
    open when each gap began."""
    dev, labels, window = [], [], None
    by_name = {}
    for e in events:
        on_device = e.device_type() == torch.autograd.DeviceType.CUDA
        span = (e.start_ns(), e.start_ns() + e.duration_ns())
        if _annotation(e):
            # A record_function range is mirrored onto the device's
            # timeline over the kernels it launched: a label, not work.
            if not on_device and e.name() == "pb.window":
                window = span
            elif not on_device and e.name().startswith("pb."):
                labels.append(span + (e.name(),))
        elif on_device:
            dev.append(span)
            n, t = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (n + 1, t + e.duration_ns())
    busy = _merge(dev)
    busy_ns = sum(b - a for a, b in busy)
    gaps = []
    if window is not None:
        edge = window[0]
        for a, b in busy + [[window[1], window[1]]]:
            a, b = max(a, window[0]), min(b, window[1])
            if a > edge:
                gaps.append((edge, a))
            edge = max(edge, b)
    idle = {}
    points = ([(a, 0, name) for a, _, name in labels]
              + [(b, 2, name) for _, b, name in labels]
              + [(a, 1, b - a) for a, b in gaps])
    stack = []
    for t, kind, what in sorted(points, key=lambda p: (p[0], -p[1])):
        if kind == 0:
            stack.append(what)
        elif kind == 2:
            if what in stack:
                del stack[len(stack) - 1 - stack[::-1].index(what)]
        else:
            name = stack[-1] if stack else "pb.window"
            idle[name] = idle.get(name, 0) + what
    kernels = {k: v for k, v in by_name.items()
               if not k.startswith(("Memcpy", "Memset"))}
    return {
        "busy_s": busy_ns * 1e-9,
        "device_s": {k: t * 1e-9 for k, (_, t) in by_name.items()},
        "launches": sum(n for n, _ in kernels.values()),
        "kernel_s": {k: t * 1e-9 for k, (_, t) in kernels.items()},
        "idle_s": {k: v * 1e-9 for k, v in idle.items()},
    }


def backward_seconds(function_events):
    """Device seconds of the kernels whose launching op ran inside
    autograd's backward (an `autograd::engine::evaluate_function` op);
    None when the trace holds no backward."""
    marker = "autograd::engine::evaluate_function"
    total, seen = 0.0, False
    for e in function_events:
        kernels = getattr(e, "kernels", None)
        if not kernels:
            continue
        p, inside = e, False
        while p is not None:
            if p.name.startswith(marker):
                inside = True
                break
            p = p.cpu_parent
        if inside:
            seen = True
            total += sum(k.duration for k in kernels) * 1e-6
    if not seen and not any(e.name.startswith(marker)
                            for e in function_events):
        return None
    return total


def breakdown(trace: dict) -> dict:
    top = {}
    for k, v in trace["device_s"].items():
        top[short_name(k)] = top.get(short_name(k), 0.0) + v
    top = sorted(top.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(trace["idle_s"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in gaps]}
