"""`BENCHMARK.json` and the files it names, found by name.

- a configuration: the `file` of its entry under `configs`, whose scene
  is a generator `perfbench/scenes/<generator>.py` or a `.crtscene` file
  (see scenes.py);
- a traffic mix: `perfbench/traffic/<traffic>.json`, whose `kind` of
  work is `perfbench/kinds/<kind>.py` (see program.py);
- a metric, end to end or per layer: its reader `perfbench/metrics/<name>.py`,
  whose `read(run)` returns a number, or None where it finds nothing;
- a cell's limits for `correct`: `perfbench/limits/<workload>.json`.

A cell, configuration, traffic mix or metric is added with new files and
new entries in `BENCHMARK.json`; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    def __init__(self, path: str = os.path.join(ROOT, "BENCHMARK.json")):
        self.path = path
        self.data = _load_json(path)

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload named {name!r} in {self.path}")

    def config_entry(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no configuration named {name!r}")

    def config(self, name: str) -> dict:
        return _load_json(os.path.join(ROOT, self.config_entry(name)["file"]))

    def metrics(self, group: str, workload: str) -> list:
        """The entries of `group` ("end_to_end" or "per_layer") that the
        cell reports: those listing it, and those without a list whose
        end-to-end metric (for a per-layer one, the one it moves) the
        cell reports."""
        e2e = {m["name"] for m in self.data["end_to_end"]
               if workload in m.get("workloads", [workload])}
        out = []
        for m in self.data[group]:
            if "workloads" in m:
                if workload in m["workloads"]:
                    out.append(m)
            elif group == "end_to_end" or m["moves"] in e2e:
                out.append(m)
        return out


def traffic(name: str) -> dict:
    return _load_json(os.path.join(BENCH_DIR, "traffic", f"{name}.json"))


def limits(workload: str) -> dict:
    return _load_json(os.path.join(BENCH_DIR, "limits", f"{workload}.json"))


_MODULES = {}


def module(folder: str, name: str):
    """The module `perfbench/<folder>/<name>.py`, loaded once."""
    key = (folder, name)
    if key not in _MODULES:
        path = os.path.join(BENCH_DIR, folder, f"{name}.py")
        if not os.path.isfile(path):
            raise KeyError(f"no file {path}")
        mod_name = f"pb_{folder}_" + re.sub(r"\W", "_", name)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[key] = mod
    return _MODULES[key]


def kind(name: str):
    """The kind of work `perfbench/kinds/<name>.py`: its `Work` class,
    `reference(...)`, `compare(got, want)`, `FAULTS` and `BACKWARD`."""
    return module("kinds", name)


def reader(metric: str):
    """The `read(run)` function of `perfbench/metrics/<metric>.py`."""
    return module("metrics", metric).read
