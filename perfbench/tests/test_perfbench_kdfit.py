"""The configuration `refbin1080_fit` and its cell's readers: the scene
is `refbin1080`'s, uncut, the traffic is every ray of its frame through
the refitted kd tree, the readers of the refit span and the kd kernel's
counters read the port's record in SGD steps, and nothing where there is
none, and a tiny run of the cell's steps agrees with the plain
reference."""

import copy
import hashlib
import os
import sys

import numpy as np
import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

from pb import program, scenes, spec  # noqa: E402
from simd_raytracer_tpu_torch.utils import profiling  # noqa: E402

NAME = "refbin1080_fit"
CELL = "refbin1080_fit.kd_refit"
READERS = ("train.refit_ms_per_step", "train.kd_pair_slot_pct")
UNITS = 4
SEED = 2147483907


def _digest(doc):
    h = hashlib.sha256()
    tris = 0
    for ob in doc["objects"]:
        h.update(np.asarray(ob["vertices"], np.float32).tobytes())
        t = np.asarray(ob["triangles"], np.int64)
        h.update(t.tobytes())
        tris += len(t) // 3
        if "uvs" in ob:
            h.update(np.asarray(ob["uvs"], np.float32).tobytes())
    return tris, h.hexdigest()[:16]


def test_scene_and_render_are_refbin1080s_uncut():
    bench = spec.Spec()
    config, base = bench.config(NAME), bench.config("refbin1080")
    doc = scenes.scene_doc(config)
    assert _digest(doc) == (4046, "3a008e526617c95c")
    assert _digest(doc) == _digest(scenes.scene_doc(base))
    assert len(doc["lights"]) == 2
    img = doc["settings"]["image_settings"]
    assert (img["height"], img["width"]) == (1080, 1920)
    assert bench.config_entry(NAME)["reduced"] == []
    assert config["reduced_from"] == {}
    # Its own source: the driver that renders the frame through the kd
    # tree it builds once (main.cpp), where refbin1080 cites the README.
    assert config["source"] == bench.config_entry(NAME)["source"] == (
        "https://github.com/MihailMihov/simd-raytracer/blob/main/src/"
        "main.cpp#L13-L41")
    assert config["source"] != base["source"]
    assert config["render"] == base["render"]
    assert config["guarantees"] == (base["guarantees"] + "; select winners"
                                    " over the step's current triangles")
    assert {k: v for k, v in config["assumed"].items()
            if k != "batch"} == base["assumed"]


def test_traffic_is_every_ray_of_the_frame_through_the_refitted_kd_tree():
    w = spec.Spec().workload(CELL)
    traffic = spec.traffic(w["traffic"])
    assert (w["config"], w["chips"]) == (NAME, 1)
    assert traffic["kind"] == "sgd_steps"
    assert traffic["rays"] == 1920 * 1080
    assert traffic["render"] == {"samples_per_pixel": 1,
                                 "bounce_mode": "split",
                                 "intersector": "kdtree",
                                 "occlusion_mode": "fast",
                                 "diffuse_reflection_ray_count": 0,
                                 "accel_refit": True}
    assert (traffic["lr"], traffic["target"]) == (0.01, 0.0)
    assert (traffic["warm_units"], traffic["trace_units"]) == (2, 4)
    assert traffic["check"] == {"steps": 3}
    assert set(spec.limits(CELL)) == {"loss_gap", "grad_gap", "change_gap"}


def test_the_cell_reports_the_train_metrics_and_its_own():
    bench = spec.Spec()
    e2e = {m["name"] for m in bench.metrics("end_to_end", CELL)}
    assert e2e == {"fwd_bwd_rays_per_s", "step_p95_ms", "setup_s"}
    layer = {m["name"] for m in bench.metrics("per_layer", CELL)}
    assert layer == {"train.device_idle_pct", "train.select_ms_per_step",
                     "train.backward_ms_per_step", "setup.accel_build_s",
                     "setup.load_s", "setup.libraries_s",
                     "train.shade_host_ms_per_step", *READERS}


def _run(kind="sgd_steps", traced=True):
    run = {"kind": kind}
    if traced:
        run["trace"] = {"units": UNITS, "busy_s": 0.1, "window_s": 1.0}
    return run


def test_readers_read_the_refit_span_and_the_kd_counters():
    with profiling.recording() as rec:
        for _ in range(UNITS):
            with profiling.span("refit"):
                pass
        profiling.count("kd.slots", 400)
        profiling.count("kd.tests", 300)
        data = rec.read()
        refit = spec.reader("train.refit_ms_per_step")
        assert refit(_run()) == pytest.approx(
            1e3 * data["spans"]["refit"]["total_s"] / UNITS)
        assert spec.reader("train.kd_pair_slot_pct")(_run()) == 75.0
        for name in READERS:
            assert spec.reader(name)(_run("frames")) is None
            assert spec.reader(name)(_run(traced=False)) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_in_an_empty_record(name):
    with profiling.recording():
        assert spec.reader(name)(_run()) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_of_a_port_without_the_record(name, monkeypatch):
    """A port without the record gives each reader nothing to read: None,
    and no raise."""
    monkeypatch.delattr(profiling, "record")
    assert spec.reader(name)(_run()) is None


def test_tiny_steps_of_the_cell_match_the_reference():
    """The cell's steps at 24x32 pixels on its own scene, every ray of
    the frame, on the CPU: the losses, first gradient and change of the
    compared steps against pb/reference.py, with one refit a step."""
    bench = spec.Spec()
    config = dict(copy.deepcopy(bench.config(NAME)), image_rows=24,
                  image_cols=32)
    traffic = dict(copy.deepcopy(spec.traffic("kd_refit")), rays=24 * 32)
    work = program.make(config, traffic, SEED, "cpu")
    work.setup()
    with profiling.recording() as rec:
        for _ in range(traffic["check"]["steps"]):
            work.unit()
    assert rec.counts["kd.refit.calls"] == traffic["check"]["steps"]
    got = work.answers()
    want = spec.kind("sgd_steps").reference(work.doc, config, traffic, SEED,
                                            "cpu", torch.float32)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    moved = 0
    for k, w in want["grads"].items():
        if not np.abs(w).max() > 0:
            assert not np.abs(got["grads"][k]).max() > 0, k
            continue
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(got["grads"][k], w, rtol=0,
                                   atol=1e-4 * scale, err_msg=k)
        moved += 1
    assert moved >= 6
