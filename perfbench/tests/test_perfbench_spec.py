"""BENCHMARK.json against the benchmark's contract, and the files it
names found by name under perfbench/."""

import hashlib
import json
import os
import sys

import numpy as np
import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

from pb import scenes, spec  # noqa: E402

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    DATA = json.load(_f)
CELLS = [w["name"] for w in DATA["workloads"]]
METRICS = DATA["end_to_end"] + DATA["per_layer"]


def test_top_level_keys():
    assert set(DATA) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert DATA["paths"] == ["perfbench"]
    assert 1 <= DATA["run_seconds"] <= 51


def test_names_and_units_use_allowed_characters():
    names = ([c["name"] for c in DATA["configs"]] + CELLS
             + [m["name"] for m in METRICS]
             + [w["traffic"] for w in DATA["workloads"]]
             + [k for c in DATA["configs"] for k in c["reduced"]])
    for name in names:
        assert spec.NAME.match(name), name
    for m in METRICS:
        assert spec.UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [e["name"] for e in DATA[group]]
        assert len(seen) == len(set(seen)), group
    text = [c["why"] for c in DATA["configs"]] + [w["why"] for w in
            DATA["workloads"]] + [m["layer"] for m in DATA["per_layer"]]
    for t in text:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t


def test_bounds_and_sources():
    for m in DATA["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in DATA["per_layer"]:
        assert "bound" not in m
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    bench = spec.Spec()
    w = bench.workload(cell)
    assert w["chips"] == 1
    config = bench.config(w["config"])
    for key in bench.config_entry(w["config"])["reduced"]:
        assert key in config or key in config["render"]
        assert key in config["reduced_from"]
    traffic = spec.traffic(w["traffic"])
    kind = spec.kind(traffic["kind"])
    assert callable(kind.reference) and callable(kind.compare)
    assert set(kind.FAULTS) == {"unchanged", "half_batch", "altered"}
    assert spec.limits(cell)
    reported = bench.metrics("end_to_end", cell)
    names = {m["name"] for m in reported}
    assert "setup_s" in names and len(names) >= 2
    assert bench.metrics("per_layer", cell)


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_reader_is_found_by_name(metric):
    assert callable(spec.reader(metric))


@pytest.mark.parametrize("metric", [m["name"] for m in DATA["per_layer"]])
def test_per_layer_cells_report_the_metric_they_move(metric):
    m = next(p for p in DATA["per_layer"] if p["name"] == metric)
    moved = next(e for e in DATA["end_to_end"] if e["name"] == m["moves"])
    for cell in m["workloads"]:
        assert cell in CELLS
        assert cell in moved.get("workloads", CELLS)


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


@pytest.mark.parametrize("name,tris,digest,size", [
    ("hw15_scene2", 2012, "0c713aa6ccfb78fe", (1920, 1920)),
    ("refbin1080", 4046, "3a008e526617c95c", (1080, 1920))])
def test_configuration_scene_is_frozen(name, tris, digest, size):
    config = spec.Spec().config(name)
    doc = scenes.scene_doc(config)
    assert _digest(doc) == (tris, digest)
    img = doc["settings"]["image_settings"]
    assert (img["height"], img["width"]) == size
    assert config["assumed"]["triangles"] == tris
    assert len(doc["lights"]) == config["assumed"]["lights"]
    assert len(doc["materials"]) == config["assumed"]["materials"]
    assert img["bucket_size"] == config["assumed"]["bucket_size"]


def test_scene_from_a_crtscene_file(tmp_path):
    """A configuration may name a `.crtscene` document instead of a
    generator; its image size is the configuration's."""
    doc = scenes.scene_doc(spec.Spec().config("refbin1080"))
    path = tmp_path / "scene.crtscene"
    path.write_text(json.dumps(doc))
    got = scenes.scene_doc({"image_rows": 48, "image_cols": 64,
                            "scene": {"file": str(path)}})
    assert _digest(got) == _digest(doc)
    img = got["settings"]["image_settings"]
    assert (img["height"], img["width"]) == (48, 64)


@pytest.mark.parametrize("folder,name", [("scenes", "no_such_scene"),
                                         ("kinds", "no_such_kind"),
                                         ("metrics", "no_such_metric")])
def test_a_name_without_a_file_is_refused(folder, name):
    with pytest.raises(KeyError):
        spec.module(folder, name)
