"""The configuration `hw15_scene2_spp128` and its cell's readers: the
scene is `hw15_scene2`'s, uncut, and the readers of the sweep's refit
span and reach counters read the port's record, and nothing where there
is none."""

import hashlib
import os
import sys

import numpy as np
import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

from pb import scenes, spec  # noqa: E402
from simd_raytracer_tpu_torch.utils import profiling  # noqa: E402

NAME = "hw15_scene2_spp128"
CELL = "hw15_scene2_spp128.sweep_refit"
READERS = ("train.refit_ms_per_step", "train.sweep_reach_pct")
UNITS = 4


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


def test_scene_is_hw15_scene2s_uncut():
    bench = spec.Spec()
    config, base = bench.config(NAME), bench.config("hw15_scene2")
    doc = scenes.scene_doc(config)
    assert _digest(doc) == (2012, "0c713aa6ccfb78fe")
    assert _digest(doc) == _digest(scenes.scene_doc(base))
    img = doc["settings"]["image_settings"]
    assert (img["height"], img["width"], img["bucket_size"]) == (1920, 1920,
                                                                 24)
    assert bench.config_entry(NAME)["reduced"] == []
    assert config["reduced_from"] == {}
    assert config["render"] == dict(base["render"], samples_per_pixel=128)
    assert config["assumed"] == base["assumed"]


def test_traffic_is_the_middle_million_ids_through_the_refitted_sweep():
    w = spec.Spec().workload(CELL)
    traffic = spec.traffic(w["traffic"])
    assert (w["config"], w["chips"]) == (NAME, 1)
    assert traffic["kind"] == "sgd_steps"
    assert traffic["rays"] == 8192 * 128
    assert traffic["render"] == {"bounce_mode": "roulette",
                                 "intersector": "sweep",
                                 "occlusion_mode": "fast",
                                 "accel_refit": True}
    assert (traffic["lr"], traffic["target"]) == (0.01, 0.0)
    assert traffic["check"] == {"steps": 3}
    assert set(spec.limits(CELL)) == {"loss_gap", "grad_gap", "change_gap"}


def _run(kind="sgd_steps", traced=True):
    run = {"kind": kind}
    if traced:
        run["trace"] = {"units": UNITS, "busy_s": 0.1, "window_s": 1.0}
    return run


def _fill():
    for _ in range(UNITS):
        with profiling.span("refit"):
            pass
    profiling.count("sweep.tiles_x_slices", 400)
    profiling.count("sweep.reached", 300)


def test_readers_read_the_refit_span_and_the_reach_counters():
    with profiling.recording() as rec:
        _fill()
        data = rec.read()
        refit = spec.reader("train.refit_ms_per_step")
        assert refit(_run()) == pytest.approx(
            1e3 * data["spans"]["refit"]["total_s"] / UNITS)
        assert spec.reader("train.sweep_reach_pct")(_run()) == 75.0
        for name in READERS:
            assert spec.reader(name)(_run("frames")) is None
            assert spec.reader(name)(_run(traced=False)) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_in_an_empty_record(name):
    with profiling.recording():
        assert spec.reader(name)(_run()) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_of_a_port_without_the_record(name, monkeypatch):
    """A port without the record (or without the refit, as this cell's
    parent) gives each reader nothing to read: None, and no raise."""
    monkeypatch.delattr(profiling, "record")
    assert spec.reader(name)(_run()) is None
