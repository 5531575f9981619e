"""The readers of the port's spans and counters, fed a synthetic run and a
record made inside `profiling.recording()`: each returns None on the
other kind of work, and on its own kind the number the record gives."""

import os
import sys
import time

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

from pb import spec  # noqa: E402
from simd_raytracer_tpu_torch.utils import profiling  # noqa: E402

UNITS = 3


def run_of(kind):
    return {"kind": kind, "trace": {"units": UNITS, "busy_s": 0.1,
                                    "window_s": 1.0}}


def fill():
    """Two chunks of a frame, each a shade (with a wait inside) and a
    wait of its own, and the counters of two bounces and one kd call."""
    for _ in range(2):
        with profiling.span("chunk"):
            with profiling.span("shade"):
                time.sleep(0.002)
                with profiling.span("wait"):
                    time.sleep(0.001)
            with profiling.span("wait"):
                time.sleep(0.001)
    for live, slots in ((96, 128), (40, 256)):
        profiling.count("render.live", live)
        profiling.count("render.slots", slots)
    profiling.count("kd.tests", 300)
    profiling.count("kd.slots", 400)


def expected(data):
    spans, counts = data["spans"], data["counts"]
    return {
        "frame.shade_host_ms_per_frame": 1e3 * spans["shade"]["self_s"]
        / UNITS,
        "train.shade_host_ms_per_step": 1e3 * spans["shade"]["self_s"]
        / UNITS,
        "frame.loop_host_ms_per_chunk": 1e3 * spans["chunk"]["self_s"] / 2,
        "frame.wait_ms_per_frame": 1e3 * spans["wait"]["total_s"] / UNITS,
        "frame.live_slot_pct": 100.0 * 136 / 384,
        "frame.kd_pair_slot_pct": 75.0,
    }


OWN_KIND = {"frame.shade_host_ms_per_frame": "frames",
            "frame.loop_host_ms_per_chunk": "frames",
            "frame.wait_ms_per_frame": "frames",
            "frame.live_slot_pct": "frames",
            "frame.kd_pair_slot_pct": "frames",
            "train.shade_host_ms_per_step": "sgd_steps"}
OTHER = {"frames": "sgd_steps", "sgd_steps": "frames"}


@pytest.mark.parametrize("metric", sorted(OWN_KIND))
def test_record_reader(metric):
    read = spec.reader(metric)
    kind = OWN_KIND[metric]
    with profiling.recording() as rec:
        fill()
        want = expected(rec.read())[metric]
        assert read(run_of(kind)) == pytest.approx(want)
        assert read(run_of(OTHER[kind])) is None
        assert read({"kind": kind}) is None       # an untraced run
    assert want > 0


@pytest.mark.parametrize("metric", sorted(OWN_KIND))
def test_record_reader_finds_nothing_in_an_empty_record(metric):
    with profiling.recording():
        assert spec.reader(metric)(run_of(OWN_KIND[metric])) is None


def test_setup_readers(monkeypatch):
    setup = profiling.PhaseTimer()
    monkeypatch.setattr(profiling, "SETUP", setup)
    load, libraries = spec.reader("setup.load_s"), spec.reader(
        "setup.libraries_s")
    assert load(run_of("frames")) is None
    assert libraries(run_of("frames")) is None
    setup.seconds.update(load=0.25, kernel_library=1.5)
    for kind in ("frames", "sgd_steps"):
        assert load(run_of(kind)) == 0.25
        assert libraries(run_of(kind)) == 1.5
    setup.seconds["native_library"] = 0.5
    assert libraries(run_of("frames")) == 2.0


def test_readers_of_a_port_without_the_record(monkeypatch):
    """The parent of these readers' PR has no record, no SETUP: each
    reader returns None and does not raise."""
    for name in ("record", "SETUP"):
        monkeypatch.delattr(profiling, name)
    for metric in sorted(OWN_KIND) + ["setup.load_s", "setup.libraries_s"]:
        assert spec.reader(metric)(run_of(OWN_KIND.get(metric, "frames"))) \
            is None
