"""PyTorch port: the span-and-counter record of utils/profiling.py, the
spans and counters the render, select and gradient layers put in it,
and the set-up phases, against the JAX package's wavefront occupancy
where it has one."""

import json
import os
import time

import jax
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import simd_raytracer_tpu as J
import simd_raytracer_tpu_torch as T
from simd_raytracer_tpu.accel.build import (
    build_kdtree_for_scene as j_build_kdtree_for_scene)
from simd_raytracer_tpu.utils.profiling import (
    wavefront_occupancy as j_occupancy)
from simd_raytracer_tpu_torch import kernels
from simd_raytracer_tpu_torch.__main__ import main as cli_main
from simd_raytracer_tpu_torch.ops import (grad, intersect_brute,
                                          intersect_fast, intersect_kd,
                                          intersect_sweep)
from simd_raytracer_tpu_torch.ops.render import TorchUniforms, render_chunk
from simd_raytracer_tpu_torch.utils import profiling
from torch_parity import port_scene
from torch_scenes import mixed_doc

torch.set_num_threads(2)

DOC = mixed_doc(20, 24, g=12, subdiv=2)
PACKAGE = os.path.dirname(T.__file__)


@pytest.fixture(scope="module")
def scenes():
    js = J.parse_scene_dict(DOC)
    return js, port_scene(js)


def small(ts, **kw):
    return ts.replace(height=8, width=10), T.RenderConfig(
        max_ray_depth=3, chunk_size=32, **kw)


def test_spans_nest_and_self_times_add_up():
    with profiling.recording() as rec:
        with profiling.span("a"):
            time.sleep(0.002)
            for _ in range(2):
                with profiling.span("b"):
                    with profiling.span("c"):
                        time.sleep(0.001)
    calls = {k: v[0] for k, v in rec.spans.items()}
    assert calls == {"a": 1, "b": 2, "c": 2}
    (_, a_total, a_self), (_, b_total, b_self), (_, c_total, c_self) = (
        rec.spans[k] for k in "abc")
    assert a_total == a_self + b_total
    assert b_total == b_self + c_total
    assert c_total == c_self >= 2_000_000
    assert a_self >= 2_000_000
    data = rec.read()["spans"]
    assert data["a"]["total_s"] == pytest.approx(a_total * 1e-9)


def test_frame_self_times_add_up_to_the_frame(scenes):
    """Every span of a frame nests under `frame`: the self times of all
    of them sum to the frame's total, to the nanosecond."""
    _, ts = scenes
    scene, cfg = small(ts, occlusion_mode="march", intersector="fast",
                       diffuse_reflection_ray_count=1)
    with profiling.recording() as rec:
        T.render_frame(scene, cfg, device="cpu")
    spans = rec.spans
    assert spans["frame"][0] == 1
    assert sum(s[2] for s in spans.values()) == spans["frame"][1]
    for name in ("frame_setup", "chunk", "trace", "select", "shade",
                 "occlusion", "march", "wait", "fold", "table"):
        assert spans[name][0] > 0, name
    assert spans["chunk"][0] == spans["fold"][0] == -(-80 // 32)


def test_recording_nests_and_adds_to_the_enclosing_record():
    with profiling.recording() as outer:
        profiling.count("x", 2)
        with profiling.recording() as inner:
            profiling.count("x", 3)
            with profiling.span("s"):
                pass
        assert inner.counts["x"] == 3 and "s" in inner.spans
        assert profiling.record()["counts"]["x"] == 5
    assert outer.counts["x"] == 5 and outer.spans["s"][0] == 1
    with profiling.recording() as rec:
        profiling.count("y")
        profiling.reset()
        assert profiling.record() == {"spans": {}, "counts": {}}
    assert not rec.counts


def test_tracing_off_records_nothing_and_enters_no_range(scenes,
                                                          monkeypatch):
    _, ts = scenes
    entered = []

    class Counting:
        def __init__(self, name, *a):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    assert not profiling.tracing()
    profiling.reset()
    scene, cfg = small(ts, occlusion_mode="march", intersector="kdtree",
                       diffuse_reflection_ray_count=1)
    T.render_frame(scene, cfg, device="cpu")
    assert profiling.record() == {"spans": {}, "counts": {}}
    assert entered == []
    with profiling.recording():
        T.render_frame(scene, cfg, device="cpu")
    # A recording() block with no profiler running records, and still
    # enters no range.
    assert entered == []
    assert profiling.record()["spans"]["frame"]["calls"] == 1


def test_profiler_ranges_match_the_record(scenes):
    _, ts = scenes
    scene, cfg = small(ts, occlusion_mode="march", intersector="fast",
                       diffuse_reflection_ray_count=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.tracing()
        with profiling.recording() as rec:
            T.render_frame(scene, cfg, device="cpu")
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("srt."):
            ranges[e.name()[4:]] = ranges.get(e.name()[4:], 0) + 1
    for name in ("frame", "chunk", "trace", "shade", "wait"):
        assert ranges.get(name, 0) > 0, name
    assert ranges == {k: v["calls"] for k, v in rec.read()["spans"].items()}


@pytest.mark.parametrize("kw", [dict(), dict(intersector="kdtree")],
                         ids=["split", "kdtree"])
def test_live_counters_equal_jax_occupancy(scenes, kw):
    """Split at spp 1 is deterministic: the chunk's render.live.d<k>
    equal the JAX package's wavefront_occupancy."""
    js, ts = scenes
    cfg = T.RenderConfig(chunk_size=480, **kw)
    accel = T.ops.render.build_accel(ts, cfg)
    with profiling.recording() as rec:
        render_chunk(ts, T.derive_geometry(ts), cfg, torch.arange(480),
                     TorchUniforms.seeded(0, "cpu", ts.vertices.dtype),
                     accel)
    got = [rec.counts[f"render.live.d{k}"]
           for k in range(cfg.max_ray_depth + 1)]
    j_accel = (j_build_kdtree_for_scene(js)
               if kw.get("intersector") == "kdtree" else None)
    assert got == j_occupancy(js, J.RenderConfig(**kw, chunk_size=480),
                              jax.numpy.arange(480, dtype=np.int32),
                              accel=j_accel)
    assert rec.counts["render.live"] == sum(got)


@pytest.mark.parametrize("kw", [dict(bounce_mode="roulette"),
                                dict(diffuse_reflection_ray_count=2)],
                         ids=["roulette", "split-gi2"])
def test_live_rays_never_exceed_slots(scenes, kw):
    _, ts = scenes
    scene, cfg = small(ts, **kw)
    with profiling.recording() as rec:
        T.render_frame(scene, cfg, device="cpu")
    c = rec.counts
    assert 0 < c["render.live"] <= c["render.slots"]
    assert c["render.live"] == sum(
        c[f"render.live.d{k}"] for k in range(cfg.max_ray_depth + 1))
    # Every select call is counted once, with its rays.
    assert c["select.calls"] == rec.spans["select"][0]
    assert c["select.rays"] >= c["render.live"]


def test_gradient_spans(scenes):
    _, ts = scenes
    scene, cfg = small(ts, bounce_mode="roulette")
    params, skeleton = grad.split_params(scene)
    ids = torch.arange(16, dtype=torch.int32)
    with profiling.recording() as rec:
        grad.loss_and_grad(params, skeleton, cfg, ids,
                           torch.zeros((16, 3), dtype=scene.vertices.dtype),
                           TorchUniforms.seeded(0, "cpu",
                                                scene.vertices.dtype))
    s = rec.spans
    assert s["loss_and_grad"][0] == s["forward"][0] == s["backward"][0] == 1
    assert s["chunk"][0] == 1
    assert s["loss_and_grad"][1] >= s["forward"][1] + s["backward"][1]


def test_setup_phases(tmp_path):
    before = profiling.SETUP.seconds.get("load", 0.0)
    T.parse_scene_dict(DOC)
    after = profiling.SETUP.seconds["load"]
    assert after > before
    path = tmp_path / "scene.crtscene"
    path.write_text(json.dumps(DOC))
    # The Python parse of a file calls parse_scene_dict inside its own
    # `load` phase: the phase is charged once.
    t0 = time.perf_counter()
    T.parse_scene_file(str(path), use_native=False)
    wall = time.perf_counter() - t0
    assert 0 < profiling.SETUP.seconds["load"] - after <= wall


def test_phases_inside_phases_are_charged_once():
    t = profiling.PhaseTimer()
    t0 = time.perf_counter()
    with t.phase("outer"):
        with t.phase("inner"):
            time.sleep(0.02)
        with t.phase("outer"):
            pass
    wall = time.perf_counter() - t0
    assert t.seconds["inner"] >= 0.02
    assert t.seconds["outer"] < 0.02
    assert t.seconds["outer"] + t.seconds["inner"] <= wall


def test_profile_render_returns_the_traced_record(tmp_path):
    path = tmp_path / "scene.crtscene"
    path.write_text(json.dumps(DOC))
    cfg = T.RenderConfig(chunk_size=64, max_ray_depth=1)
    m = profiling.profile_render(str(path), cfg, scale=0.5, repeats=2,
                                 trace_dir=str(tmp_path / "trace"),
                                 device="cpu")
    assert m["spans"]["frame"]["calls"] == 2
    assert m["counts"]["render.slots"] > 0
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    frames = [e for e in events if e.get("name") == "srt.frame"
              and e.get("ph") == "X"]
    assert len(frames) == 2


def test_cli_profile_prints_spans_and_counters(tmp_path, capsys):
    path = tmp_path / "scene.crtscene"
    path.write_text(json.dumps(DOC))
    assert cli_main([str(path), "-o", str(tmp_path / "out.ppm"),
                     "--device", "cpu", "--width", "8", "--height", "6",
                     "--max-depth", "2", "--intersector", "kdtree",
                     "--profile"]) == 0
    out = capsys.readouterr().out
    for word in ("render", "self ms", "chunk", "shade", "render.slots",
                 "select.calls", "build.pack"):
        assert word in out, word


def test_one_counter_system():
    """The record is the port's one counter system, and only
    utils/profiling.py enters profiler ranges."""
    for mod, name in ((intersect_brute, "LAUNCHES"),
                      (intersect_sweep, "LAUNCHES"),
                      (intersect_kd, "LAUNCHES"), (intersect_kd, "PACKS"),
                      (intersect_fast, "LAUNCHES"),
                      (intersect_fast, "TABLES"),
                      (kernels, "build_seconds")):
        assert not hasattr(mod, name), (mod.__name__, name)
    users = []
    for root, _, files in os.walk(PACKAGE):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as src:
                    if "record_function" in src.read():
                        users.append(os.path.relpath(os.path.join(root, f),
                                                     PACKAGE))
    assert users == [os.path.join("utils", "profiling.py")]

