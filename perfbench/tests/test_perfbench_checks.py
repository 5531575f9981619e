"""The check that decides `correct`, on the CPU at a tiny size: the plain
reference agrees with the port, and the control (the reference in
bfloat16 in the program's place) and every planted fault come out not
correct under the committed limits.  On the card, `controls.py` reads the
same at each cell's own size."""

import copy
import os
import sys

import numpy as np
import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

import controls  # noqa: E402
from pb import check, program, spec  # noqa: E402

CELLS = [w["name"] for w in spec.Spec().data["workloads"]]
SEED = 2147483907
TINY = {"image_rows": 24, "image_cols": 32}


def tiny(cell):
    """The cell's configuration and traffic at 24x32 pixels, on the
    configuration's own scene, with chunks of 512 rays so a frame has
    several."""
    bench = spec.Spec()
    w = bench.workload(cell)
    config = dict(copy.deepcopy(bench.config(w["config"])), **TINY)
    config["render"]["chunk_size"] = 512
    traffic = copy.deepcopy(spec.traffic(w["traffic"]))
    if traffic["kind"] == "frames":
        traffic["check"]["pixels"] = 300
    else:
        traffic["rays"] = 512
    return config, traffic


_READINGS = {}


def readings(cell):
    if cell not in _READINGS:
        config, traffic = tiny(cell)
        variants = ["sound", "control"] + list(
            spec.kind(traffic["kind"]).FAULTS)
        _READINGS[cell] = controls.readings(config, traffic, SEED, "cpu", 2,
                                            variants)
    return _READINGS[cell]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_program_is_correct(cell):
    ok, rows = check.verdict(readings(cell)["sound"], spec.limits(cell))
    assert ok, rows


@pytest.mark.parametrize("variant", ["control", "unchanged", "half_batch",
                                     "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_are_not_correct(cell, variant):
    ok, rows = check.verdict(readings(cell)[variant], spec.limits(cell))
    assert not ok, rows


GI = {"diffuse_reflection_ray_count": 2, "samples_per_pixel": 2}
ROULETTE = {"bounce_mode": "roulette", "occlusion_mode": "fast"}


@pytest.mark.parametrize("cell,render", [
    (c, {}) for c in CELLS if ".train" not in c] + [
    ("hw15_scene2.gi", GI), ("hw15_scene2.gi", ROULETTE),
    ("refbin1080.kd", GI)])
def test_reference_frame_matches_the_port(cell, render):
    """Every pixel of a tiny frame, port (CPU path) against reference;
    also with more diffuse GI rays and samples, and under roulette."""
    config, traffic = tiny(cell)
    traffic["check"]["pixels"] = 24 * 32
    traffic["render"].update(render)
    work = program.make(config, traffic, SEED, "cpu")
    work.setup()
    work.unit()
    got = work.answers()
    want = spec.kind("frames").reference(work.doc, config, traffic, SEED,
                                         "cpu", torch.float32, got)
    assert np.abs(got["colors"] - want).max() < 1e-4
    assert np.abs(want - want.mean()).max() > 0.05   # not a flat image


def test_reference_gradients_match_the_port():
    """The window's first steps, from the scene's own parameters after
    the warm-up, against the reference."""
    config, traffic = tiny("hw15_scene2.train")
    work = program.make(config, traffic, SEED, "cpu")
    work.setup()
    for _ in range(traffic["check"]["steps"]):
        work.unit()
    got = work.answers()
    want = spec.kind("sgd_steps").reference(work.doc, config, traffic, SEED,
                                            "cpu", torch.float32)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    # Element by element, against the leaf's own scale.
    moved = 0
    for k, w in want["grads"].items():
        if not np.abs(w).max() > 0:
            # Unmoved leaves (uv: padded by the port) are not compared.
            assert not np.abs(got["grads"][k]).max() > 0, k
            continue
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(got["grads"][k], w, rtol=0,
                                   atol=1e-4 * scale, err_msg=k)
        moved += bool(np.abs(w).max() > 0)
    assert moved >= 6
